"""Stream milliseconds per forward-plus-Jacobian evaluation of the
continua and the radiative transfer with their tangents (the program's
spans ``nemesis.cia``, ``.rayleigh``, ``.dust`` and ``.spectrum``), waits
for the host included."""

from nembench.harness import jac_spans


def read(ctx):
    return jac_spans.stream_ms(ctx, ("nemesis.cia", "nemesis.rayleigh",
                                     "nemesis.dust", "nemesis.spectrum"))
