"""Share of the random-overlap combine's least time (``bounds.
combine_bound_ms``, presorted runs: the tables rise along g) in the
device time of its kernels, over the traced forwards."""

from nembench.harness import bounds

KERNELS = ("combine_primal_kernel",)


def read(ctx):
    seconds = ctx.trace.seconds_matching(KERNELS)
    if seconds <= 0.0:
        return None
    spec = ctx.spec
    per_call_ms = (len(spec["gas_id"]) - 1) * bounds.combine_bound_ms(
        spec["nwave"] * spec["nlay"], spec["ng"], ctx.itemsize)
    return 100.0 * per_call_ms * 1e-3 * ctx.traced_calls / seconds
