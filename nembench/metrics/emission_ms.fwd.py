"""Stream milliseconds per forward of the continua and the radiative
transfer (the program's spans ``nemesis.cia``, ``.rayleigh``, ``.dust``
and ``.spectrum``: the gather onto the path, emission, g-integration),
waits for the host included."""

from nembench.harness import spans


def read(ctx):
    return spans.stream_ms(ctx, ("nemesis.cia", "nemesis.rayleigh",
                                 "nemesis.dust", "nemesis.spectrum"))
