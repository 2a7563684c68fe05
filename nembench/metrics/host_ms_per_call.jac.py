"""Host milliseconds per forward-plus-Jacobian evaluation of the traced
window: the inclusive host time of the program's ``nemesis.jacobian``
span, the host's dispatch of an evaluation's launches (the card runs
behind it or waits for it)."""

from nembench.harness import jac_spans


def read(ctx):
    return jac_spans.host_ms(ctx)
