"""Peak allocated GiB of a forward-plus-Jacobian evaluation: the mean over
the traced evaluations of the allocator's peak from each one's start to
its end (the program's ``nemesis.jacobian`` records)."""

from nembench.harness import jac_spans


def read(ctx):
    return jac_spans.peak_gib(ctx)
