"""Share of the traced window of multiple-scattering forwards in which no
operation ran on the card (the host dispatching the ladders' small
launches, reading their bounds and Hansen's tests): the forward cells'
reader (``device_idle_pct.fwd``) on this cell."""

from nembench.harness import manifest

read = manifest.metric("device_idle_pct.fwd").read
