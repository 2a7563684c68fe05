"""Stream milliseconds per forward of the layers' doubling ladders (the
program's span ``nemesis.scatter.doubling``, once a wave tile: every
layer's R, T and J), waits for the host included."""

from nembench.harness import spans


def read(ctx):
    return spans.stream_ms(ctx, ("nemesis.scatter.doubling",))
