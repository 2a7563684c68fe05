"""Milliseconds in which an operation ran on the card, per
forward-plus-Jacobian evaluation of the traced window: the whole
evaluation's device time, which bounds what any one kernel's gain can
save."""


def read(ctx):
    if ctx.trace.busy_s <= 0.0 or not ctx.traced_calls:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.traced_calls
