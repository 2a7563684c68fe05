"""Stream milliseconds per forward of the line-by-line synthesis at run
time (the program's spans ``nemesis.lbl.pack``, ``.synth`` and
``.continuum``), waits for the host included; at least the line and pair
passes' device time."""

from nembench.harness import spans


def read(ctx):
    return spans.stream_ms(ctx, ("nemesis.lbl.pack", "nemesis.lbl.synth",
                                 "nemesis.lbl.continuum"))
