"""Host reads per forward of the scattering core's data-dependent loops:
the program's counters ``scatter.hansen_reads`` (one a Hansen sweep) and
``scatter.ladder_reads`` (one a doubling ladder's bound, a wave tile)
summed, the mean over the traced forwards' records. None where the
records keep no counters."""

from nembench.harness import spans

COUNTERS = ("scatter.hansen_reads", "scatter.ladder_reads")


def read(ctx):
    recs = spans.records(ctx)
    held = [getattr(r, "counters", None) for r in recs]
    if not recs or None in held:
        return None
    return sum(c.get(name, 0) for c in held for name in COUNTERS) / len(recs)
