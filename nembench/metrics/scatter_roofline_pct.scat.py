"""Share [%] of the adding-doubling's least time in its device time: the
least time of one forward's ladders and path combines at the
configuration's own profiles (``scatter_bounds.least_ms`` on the
reference's optical depths there) over the smaller of two readings per
forward that each hold the device time of the doubling and the adding:
the stream milliseconds of the program's spans
``nemesis.scatter.doubling`` and ``nemesis.scatter.adding`` (the host's
gaps inside them included) and the trace's device milliseconds of the
whole forward (the other layers' kernels included). None without the
spans' stream times."""

from nembench.harness import scatter_bounds, spans

SPANS = ("nemesis.scatter.doubling", "nemesis.scatter.adding")


def read(ctx):
    ms = spans.stream_ms(ctx, SPANS)
    if not ms:
        return None
    if ctx.trace.busy_s > 0.0:
        ms = min(ms, 1e3 * ctx.trace.busy_s / ctx.traced_calls)
    taut = ctx.reference.base_optical_depth().cpu().numpy()
    sc = ctx.spec["scattering"]
    least = scatter_bounds.least_ms(taut, sc["nf"], sc["nmu"],
                                    len(ctx.spec["aerosol"]["mode_scale"]),
                                    ctx.itemsize)
    return 100.0 * least / ms
