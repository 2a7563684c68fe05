"""Stream milliseconds per forward of the k-table interpolation (the
program's span ``nemesis.kinterp``), waits for the host included."""

from nembench.harness import spans


def read(ctx):
    return spans.stream_ms(ctx, ("nemesis.kinterp",))
