"""Share of the traced window of forward-plus-Jacobian evaluations in which
no operation ran on the card."""


def read(ctx):
    if ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
