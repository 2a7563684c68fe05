"""Stream milliseconds per forward-plus-Jacobian evaluation of layering
and path with their tangents (the program's spans ``nemesis.layering``
and ``nemesis.path``), waits for the host included."""

from nembench.harness import jac_spans


def read(ctx):
    return jac_spans.stream_ms(ctx, ("nemesis.layering", "nemesis.path"))
