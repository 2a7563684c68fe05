"""Share of the random-overlap combine's least time with the Jacobian's
tangents (``tangent_bounds.fused_combine_bound_ms``: NGAS - 1 combines of
R = NWAVE x NLAY rows with NX tangents each, an evaluation) in the
device time of the kernels that compute the combine's tangents, over the
traced evaluations."""

from nembench.harness import tangent_bounds

KERNELS = ("combine_tan_kernel",)


def read(ctx):
    seconds = ctx.trace.seconds_matching(KERNELS)
    if seconds <= 0.0:
        return None
    spec = ctx.spec
    sv = spec["state_vector"]
    nx = sv["temperature_levels"] + len(sv["gas_scales"])
    one_ms = tangent_bounds.fused_combine_bound_ms(
        spec["nwave"] * spec["nlay"], spec["ng"], nx, ctx.itemsize)
    per_call_ms = (len(spec["gas_id"]) - 1) * one_ms
    return 100.0 * per_call_ms * 1e-3 * ctx.traced_calls / seconds
