"""Stream milliseconds per forward of the layers' adding and the paths'
radiances (the program's span ``nemesis.scatter.adding``, once a wave
tile: the combines along the path, the angle interpolation and the
azimuth sum), waits for the host included."""

from nembench.harness import spans


def read(ctx):
    return spans.stream_ms(ctx, ("nemesis.scatter.adding",))
