"""Host milliseconds per forward of the traced window: the inclusive host
time of the program's ``nemesis.forward`` span, the host's dispatch of a
forward's launches (the card runs behind it or waits for it)."""

from nembench.harness import spans


def read(ctx):
    return spans.host_ms(ctx)
