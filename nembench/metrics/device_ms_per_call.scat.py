"""Device milliseconds per multiple-scattering forward of the traced window
(the adding-doubling's 5x5 algebra most of it): the forward cells' reader
(``device_ms_per_call.fwd``) on this cell."""

from nembench.harness import manifest

read = manifest.metric("device_ms_per_call.fwd").read
