"""Stream milliseconds per multiple-scattering forward of the random
overlap (``nemesis.overlap``: kernel 1's 6 combines at R = 79,872 and NG
= 10, and their preparation): the forward cells' reader
(``overlap_ms.fwd``) on this cell."""

from nembench.harness import manifest

read = manifest.metric("overlap_ms.fwd").read
