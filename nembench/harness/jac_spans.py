"""What the per-layer metrics of the Jacobian cells read from the program:
the records of the traced window's forward-plus-Jacobian evaluations
(``archnemesis_tpu_torch.utils.profiling.jacobian_records``), each the
layer spans summed over the forwards the evaluation ran, and its peak of
allocated bytes. Only an evaluation run while a profiler records leaves
one, so the window's evaluations are the last ``ctx.traced_calls``
records. A program that keeps no such records gives None to every
reader."""


def records(ctx) -> list:
    """The traced window's evaluation records; [] where there are none."""
    from archnemesis_tpu_torch.utils import profiling

    read = getattr(profiling, "jacobian_records", None)
    if read is None or not ctx.traced_calls:
        return []
    return read(ctx.traced_calls)


def stream_ms(ctx, names):
    """Mean stream milliseconds per evaluation of the spans ``names``
    together; None without records, without stream times (no CUDA events)
    or where no evaluation opened any of the spans."""
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


def peak_gib(ctx):
    """Mean over the evaluations of their peak allocated GiB; None where
    no record holds one (off the card)."""
    peaks = [r.peak_bytes for r in records(ctx)]
    if not peaks or None in peaks:
        return None
    return sum(peaks) / len(peaks) / 2**30


def host_ms(ctx):
    """Mean inclusive host milliseconds of the evaluations' own span; None
    without records."""
    recs = records(ctx)
    if not recs:
        return None
    return sum(r.host_ms for r in recs) / len(recs)
