"""Stream milliseconds per multiple-scattering forward of the layering
(``nemesis.layering``: ``build_layers`` and the dust renormalisation,
eager; this forward has no ``nemesis.path``): the forward cells' reader
(``layering_ms.fwd``) on this cell."""

from nembench.harness import manifest

read = manifest.metric("layering_ms.fwd").read
