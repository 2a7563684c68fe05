"""Stream milliseconds per forward of the scattering core's phase
matrices (the program's span ``nemesis.scatter.phase``: the phase-matrix
stacks with Hansen's normalisation, and a reflecting ground's BRDF
Fourier matrix), waits for the host included."""

from nembench.harness import spans


def read(ctx):
    return spans.stream_ms(ctx, ("nemesis.scatter.phase",))
