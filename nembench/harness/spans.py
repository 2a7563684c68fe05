"""What the per-layer metrics of source ``program_span`` read: the
program's records of the traced window's forwards
(``archnemesis_tpu_torch.utils.profiling.forward_records``). Only a
forward run while a profiler records leaves one, so the window's forwards
are the last ``ctx.traced_calls`` records. A program that keeps no
records gives None to every reader."""


def records(ctx) -> list:
    """The traced window's forward records; [] where there are none."""
    from archnemesis_tpu_torch.utils import profiling

    read = getattr(profiling, "forward_records", None)
    if read is None or not ctx.traced_calls:
        return []
    return read(ctx.traced_calls)


def host_ms(ctx):
    """Mean inclusive host milliseconds of ``nemesis.forward`` per
    forward."""
    recs = records(ctx)
    return sum(r.host_ms for r in recs) / len(recs) if recs else None


def stream_ms(ctx, names):
    """Mean stream milliseconds per forward of the spans ``names``
    together; None without records, without stream times (no CUDA events)
    or where no forward opened any of the spans."""
    recs = records(ctx)
    total, seen = 0.0, False
    for r in recs:
        for name in names:
            stat = r.spans.get(name)
            if stat is None:
                continue
            if stat.stream_ms is None:
                return None
            total, seen = total + stat.stream_ms, True
    return total / len(recs) if seen else None
