"""Stream milliseconds per forward-plus-Jacobian evaluation of the random
overlap (the program's span ``nemesis.overlap``: each gas's tangent
formed and ``mix_gas_k``'s combines with all the tangents), waits for the
host included."""

from nembench.harness import jac_spans


def read(ctx):
    return jac_spans.stream_ms(ctx, ("nemesis.overlap",))
