"""Host milliseconds per multiple-scattering forward of the traced window:
the forward cells' reader (``host_ms_per_call.fwd``, the inclusive host
time of ``nemesis.forward``) on this cell, where it holds the dispatch of
the ladders' and the path's launches and the waits on the scattering
core's host reads."""

from nembench.harness import manifest

read = manifest.metric("host_ms_per_call.fwd").read
