"""Stream milliseconds per forward of layering and path (the program's
spans ``nemesis.layering`` and ``nemesis.path``): the card's timeline from
each span's first to its last event, waits for the host included."""

from nembench.harness import spans


def read(ctx):
    return spans.stream_ms(ctx, ("nemesis.layering", "nemesis.path"))
