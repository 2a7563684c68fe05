"""Share of the line-by-line synthesis's least time (``bounds.
lbl_bound_ms`` on each traced call's layers, worked out by the reference)
in the device time of its line and pair passes."""

from nembench.harness import bounds

KERNELS = ("line_kernel", "pair_kernel")


def read(ctx):
    seconds = ctx.trace.seconds_matching(KERNELS)
    if seconds <= 0.0:
        return None
    ref, ln = ctx.reference, ctx.spec["lines"]
    bound_ms = 0.0
    for t, mult in ctx.traced_states:
        params = (x.cpu().numpy() for x in ref.line_parameters(t, mult))
        bound_ms += bounds.lbl_bound_ms(ref.lines.nu, *params, ref.wave,
                                        ln["wn_calc"], ln["wn_approx"],
                                        ctx.itemsize)
    return 100.0 * bound_ms * 1e-3 / seconds
