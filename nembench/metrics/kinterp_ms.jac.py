"""Stream milliseconds per forward-plus-Jacobian evaluation of the k-table
interpolation (the program's span ``nemesis.kinterp``: k and its
derivative factors), waits for the host included."""

from nembench.harness import jac_spans


def read(ctx):
    return jac_spans.stream_ms(ctx, ("nemesis.kinterp",))
