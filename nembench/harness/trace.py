"""What a traced window reads from ``torch.profiler``: device operations
with their times, the busy share of the window, and what the host was
doing while the device was idle."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

WINDOW_RANGE = "nembench.window"


@dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6


@dataclass
class Trace:
    """The device operations of one traced window (``ops``, in start
    order), the window's length and the idle gaps' host activity."""

    ops: list
    window_s: float
    busy_s: float
    idle_by_host: dict = field(default_factory=dict)

    def kernels(self) -> list:
        """Device operations that are kernels (not copies or fills)."""
        return [op for op in self.ops
                if not op.name.startswith(("Memcpy", "Memset"))]

    def seconds_matching(self, patterns) -> float:
        """Device seconds of the kernels whose names contain one of
        ``patterns``."""
        return sum(op.seconds for op in self.kernels()
                   if any(p in op.name for p in patterns))

    def top_ops(self, n: int = 10) -> list:
        by_name = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.seconds
        return [[k, v] for k, v in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.idle_by_host.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof) -> Trace:
    """The ``Trace`` of a ``torch.profiler.profile`` whose window was
    wrapped in ``record_function(WINDOW_RANGE)``."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == WINDOW_RANGE
              and e.device_type == DeviceType.CPU]
    if not window:
        raise RuntimeError("the traced window's range is missing")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    ops, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name == WINDOW_RANGE or getattr(e, "is_user_annotation", False):
            continue  # ranges the host marked, not device work
        if t <= w0 or s >= w1:
            continue
        if e.device_type == DeviceType.CUDA:
            ops.append(DeviceOp(e.name, max(s, w0), min(t, w1)))
        else:
            host.append((s, t, e.name))
    ops.sort(key=lambda op: op.start_us)
    busy = _merge((op.start_us, op.end_us) for op in ops)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # idle gaps inside the window, each put to the innermost host event
    # that covers its middle
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        best = None
        # host events nest: the innermost covering one is among the last
        # that started before the middle
        for j in range(i - 1, max(-1, i - 200), -1):
            hs, he, name = host[j]
            if he >= mid and (best is None or he - hs < best[1] - best[0]):
                best = (hs, he, name)
        key = best[2] if best else "(no host event)"
        idle[key] = idle.get(key, 0.0) + (e - s) * 1e-6
    return Trace(ops=ops, window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                 idle_by_host=idle)
