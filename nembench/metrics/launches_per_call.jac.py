"""Kernels launched on the card per forward-plus-Jacobian evaluation in the
traced window (copies and fills not counted)."""


def read(ctx):
    kernels = ctx.trace.kernels()
    if not kernels or not ctx.traced_calls:
        return None
    return len(kernels) / ctx.traced_calls
