"""Stream milliseconds per multiple-scattering forward of the k-table
interpolation (``nemesis.kinterp``, NG = 10 at 2,048 waves and 39
layers): the forward cells' reader (``kinterp_ms.fwd``) on this cell."""

from nembench.harness import manifest

read = manifest.metric("kinterp_ms.fwd").read
