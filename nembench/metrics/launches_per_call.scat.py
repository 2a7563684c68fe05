"""Kernels launched per multiple-scattering forward in the traced window,
tile by tile: the forward cells' reader (``launches_per_call.fwd``) on
this cell."""

from nembench.harness import manifest

read = manifest.metric("launches_per_call.fwd").read
