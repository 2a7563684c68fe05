"""Stream milliseconds per forward of the random overlap (the program's
span ``nemesis.overlap``: ``mix_gas_k``'s combines and their preparation),
waits for the host included; at least the combine kernel's device time."""

from nembench.harness import spans


def read(ctx):
    return spans.stream_ms(ctx, ("nemesis.overlap",))
