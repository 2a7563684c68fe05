"""Tracing and profiling (port of the JAX package's ``utils/profiling.py``;
the reference has none beyond wall-clock brackets, ``Retrievals.py:78,
331-333``).

Three layers, in PyTorch's idiom:
- ``trace(logdir)``: ``torch.profiler.profile`` with CPU and CUDA
  activities around a block; a Chrome trace (``trace.json``) is written
  into ``logdir`` (view it in Perfetto or ``chrome://tracing``).
- ``annotate(name)``: the program's span. Off (one flag read, nothing
  else) unless a ``torch.profiler`` is recording; on, a
  ``record_function`` range in the trace, the host clock at its ends and,
  on the card, a CUDA event on the stream at each end. ``forward_nadir``
  opens ``nemesis.forward`` around its body and one flat span per layer
  inside it (``nemesis.layering``, ``.path``, ``.kinterp``, ``.overlap``,
  ``.lbl.pack``, ``.lbl.synth``, ``.lbl.continuum``, ``.cia``,
  ``.rayleigh``, ``.dust``, ``.spectrum``); each traced forward leaves one
  ``ForwardRecord`` in a ring of the last ``RING`` forwards:
  ``forward_records(n)``, ``report()``, ``clear()``.
  ``retrieval/oe.py:forward_and_jacobian`` opens ``nemesis.jacobian``
  around a forward-plus-Jacobian evaluation; each traced evaluation
  leaves one ``JacobianRecord`` in a ring of its own
  (``jacobian_records(n)``): the layer spans summed over the forwards run
  inside it (one on the port's path; a caller that pushes the tangents in
  chunks inside the span runs one a chunk) and, on the card, the peak of
  allocated bytes since its start.
- ``count(name)``: the program's counters (``counters``, e.g. the
  scattering core's ``scatter.hansen_reads``, ``scatter.ladder_reads``
  and ``scatter.tiles``). Always on (one dictionary add); inside a traced
  forward the record's ``counters`` take the same adds, so a count can be
  read per forward.
- ``stopwatch(name)`` + the module-level ``timings`` registry: wall-clock
  stage timing that synchronises the CUDA device of every tensor of the
  block's result before it stops the clock, so the numbers mean what they
  say under asynchronous launches.

A forward's layers, traced::

    with profiling.trace("build/fwd_trace"):
        forward_nadir(...)
    print(profiling.report())

``report()`` gives each span's calls, host self time (its own host time
less its child spans') and stream time (the card's timeline between its
two events, waits for the host included) per forward; in the Chrome trace
the ``nemesis.*`` rows lie above the kernels they launched, on the
profiler's clock.

``trace`` and ``device_memory_report`` run on the CUDA card unless the
caller passes ``device="cpu"``: without a card they raise.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter, defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, ContextManager, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from archnemesis_tpu_torch.utils.device import resolve_device


class Timings:
    """Accumulates named wall-clock samples: ``timings.report()``."""

    def __init__(self) -> None:
        self._samples: Dict[str, List[float]] = defaultdict(list)

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def clear(self) -> None:
        self._samples.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_s": sum(xs) / len(xs),
                "min_s": min(xs),
                "max_s": max(xs),
            }
        return out

    def report(self) -> str:
        rows = sorted(
            self.summary().items(), key=lambda kv: -kv[1]["total_s"]
        )
        lines = [f"{'stage':<40} {'n':>5} {'total':>10} {'mean':>10}"]
        for name, s in rows:
            lines.append(
                f"{name:<40} {s['count']:>5d} {s['total_s']:>9.3f}s "
                f"{s['mean_s']:>9.4f}s"
            )
        return "\n".join(lines)


timings = Timings()


def _tensors(value: Any) -> Iterator[torch.Tensor]:
    """Every tensor in a nested list, tuple or dict (or a dataclass's
    fields)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)
    elif hasattr(value, "__dataclass_fields__"):
        for name in value.__dataclass_fields__:
            yield from _tensors(getattr(value, name))


def _sync(value: Any) -> None:
    """Synchronise the CUDA device of every tensor in ``value`` (no-op for
    CPU tensors and host values)."""
    devices = {t.device for t in _tensors(value) if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stopwatch(name: str, result: Any = None,
              registry: Timings = None) -> Iterator[list]:
    """Time a block; pass ``result=`` (or set ``box[0]`` inside) to
    synchronise on device values before stopping the clock."""
    reg = registry if registry is not None else timings
    t0 = time.perf_counter()
    box: list = [result]
    try:
        yield box
    finally:
        if box[0] is not None:
            _sync(box[0])
        reg.add(name, time.perf_counter() - t0)


FORWARD_SPAN = "nemesis.forward"
JACOBIAN_SPAN = "nemesis.jacobian"
RING = 256  # forwards (and, apart, evaluations) kept by the span records


@dataclass
class SpanStat:
    """One span name's share of a forward: its calls, its host self time
    [ns] and its stream time [ms] (None without CUDA events)."""

    calls: int = 0
    host_self_ns: int = 0
    stream_ms: Optional[float] = None


@dataclass
class ForwardRecord:
    """The spans of one traced forward: ``spans`` by name, the forward's
    own among them (its self times: what lies between its layer spans),
    and the forward's inclusive host and stream times. Stream times are
    resolved when the records are read (``Spans.records``)."""

    host_ms: float
    spans: Dict[str, SpanStat]
    stream_ms: Optional[float] = None
    # the program's counts made inside the forward (``count``)
    counters: Dict[str, int] = field(default_factory=dict)
    # (name, start, end) stream intervals still to resolve, and the
    # events the record holds in the order recorded: the forward's own
    # first and last
    _intervals: list = field(default_factory=list, repr=False)
    _events: list = field(default_factory=list, repr=False)


@dataclass
class JacobianRecord:
    """One traced forward-plus-Jacobian evaluation: its own span's stat
    and, once resolved, each layer span summed over ``forwards`` (the
    records of the forwards it ran); its inclusive host and stream times;
    ``peak_bytes``, the allocator's peak of allocated bytes from its start
    to its end (None off the card)."""

    host_ms: float
    spans: Dict[str, SpanStat]
    forwards: List[ForwardRecord] = field(default_factory=list)
    peak_bytes: Optional[int] = None
    stream_ms: Optional[float] = None
    counters: Dict[str, int] = field(default_factory=dict)
    _intervals: list = field(default_factory=list, repr=False)
    _events: list = field(default_factory=list, repr=False)


class _Frame:
    __slots__ = ("name", "t0", "child_ns", "start", "end", "record",
                 "root", "edges")

    def __init__(self, name, t0, record, root=None):
        self.name, self.t0, self.record = name, t0, record
        self.root = self if root is None else root
        self.child_ns, self.start, self.end, self.edges = 0, None, None, []


class Spans:
    """The open spans of this process (a stack) and the records of its
    last ``RING`` traced forwards. CUDA events come from a pool: a
    record's events go back to it once resolved, which a closing forward
    does, without waiting, for records whose work the card has finished."""

    def __init__(self) -> None:
        self._records: deque = deque(maxlen=RING)
        self._pending: deque = deque()
        self._jacobians: deque = deque(maxlen=RING)
        self._jac_pending: deque = deque()
        self._stack: List[_Frame] = []
        self._free: list = []

    def _event(self, frame: _Frame):
        ev = self._free.pop() if self._free else torch.cuda.Event(
            enable_timing=True)
        ev.record()
        frame.record._events.append(ev)
        return ev

    def open(self, name: str, t0: int) -> Optional[_Frame]:
        """Push a span opened at host time ``t0`` [ns]; None for a span
        outside any forward or evaluation (a range in the trace only). A
        forward starts a record of its own, also inside an evaluation."""
        stack = self._stack
        if name == FORWARD_SPAN or (name == JACOBIAN_SPAN and not stack):
            kind = ForwardRecord if name == FORWARD_SPAN else JacobianRecord
            frame = _Frame(name, t0, kind(host_ms=0.0, spans={}))
            timed = (torch.cuda.is_initialized()
                     and not torch.cuda.is_current_stream_capturing())
            if timed and kind is JacobianRecord:
                torch.cuda.reset_peak_memory_stats()
        elif stack:
            root = stack[-1].root
            frame = _Frame(name, t0, root.record, root)
            timed = root.start is not None
        else:
            return None
        if timed:
            frame.start = self._event(frame)
        stack.append(frame)
        return frame

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name`` of the innermost open record
        (nothing outside a traced forward or evaluation)."""
        if self._stack:
            held = self._stack[-1].record.counters
            held[name] = held.get(name, 0) + n

    def stop_stream(self, frame: _Frame) -> None:
        """The span's end event, before its range closes."""
        if frame.start is not None:
            frame.end = self._event(frame)

    def close(self, frame: _Frame, t1: int, failed: bool) -> None:
        """Pop ``frame``, closed at host time ``t1`` [ns], into its
        record; a closing forward or evaluation files its record (unless
        it raised) and resolves finished ones."""
        stack = self._stack
        stack.pop()
        ns = t1 - frame.t0
        record = frame.record
        stat = record.spans.setdefault(frame.name, SpanStat())
        stat.calls += 1
        stat.host_self_ns += ns - frame.child_ns
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_ns += ns
        if frame.root is not frame:
            if frame.start is not None:
                record._intervals.append((frame.name, frame.start, frame.end))
                if parent is frame.root:
                    parent.edges += (frame.start, frame.end)
            return
        record.host_ms = ns * 1e-6
        if frame.start is not None and isinstance(record, ForwardRecord):
            # the forward's self stream time: the gaps between its layers
            bounds = [frame.start, *frame.edges, frame.end]
            record._intervals += [(frame.name, bounds[i], bounds[i + 1])
                                  for i in range(0, len(bounds), 2)]
        if failed:
            self._free += record._events
            return
        if isinstance(record, JacobianRecord):
            if frame.start is not None:
                record.peak_bytes = int(torch.cuda.max_memory_allocated())
            self._jacobians.append(record)
            self._jac_pending.append(record)
        else:
            self._records.append(record)
            if record._events:
                self._pending.append(record)
            if parent is not None:
                parent.root.record.forwards.append(record)
        while self._pending and self._pending[0]._events[-1].query():
            self._resolve(self._pending.popleft())
        while self._jac_pending and self._jacobian_done(self._jac_pending[0]):
            self._resolve_jacobian(self._jac_pending.popleft())

    def _resolve(self, record: ForwardRecord) -> None:
        for name, start, end in record._intervals:
            stat = record.spans[name]
            stat.stream_ms = (stat.stream_ms or 0.0) + start.elapsed_time(end)
        record.stream_ms = record._events[0].elapsed_time(record._events[-1])
        self._free += record._events
        record._intervals, record._events = [], []

    @staticmethod
    def _jacobian_done(record: JacobianRecord) -> bool:
        """Whether the card has finished the evaluation and every forward
        of it is resolved."""
        return (not any(f._events for f in record.forwards)
                and (not record._events or record._events[-1].query()))

    def _resolve_jacobian(self, record: JacobianRecord) -> None:
        """Sum the layer spans of the evaluation's (resolved) forwards into
        its record and take its stream time."""
        for f in record.forwards:
            for name, stat in f.spans.items():
                total = record.spans.setdefault(name, SpanStat())
                total.calls += stat.calls
                total.host_self_ns += stat.host_self_ns
                if stat.stream_ms is not None:
                    total.stream_ms = (total.stream_ms or 0.0) + stat.stream_ms
        if record._events:
            record.stream_ms = record._events[0].elapsed_time(
                record._events[-1])
            self._free += record._events
            record._events = []

    def records(self, n: Optional[int] = None) -> List[ForwardRecord]:
        """The last ``n`` (None: all kept) records, oldest first, their
        stream times resolved (waits for the card where it must)."""
        while self._pending:
            record = self._pending.popleft()
            record._events[-1].synchronize()
            self._resolve(record)
        kept = list(self._records)
        return kept if n is None else kept[max(len(kept) - n, 0):]

    def jacobian_records(self, n: Optional[int] = None
                         ) -> List[JacobianRecord]:
        """The last ``n`` (None: all kept) evaluations' records, oldest
        first, resolved (waits for the card where it must)."""
        self.records()
        while self._jac_pending:
            record = self._jac_pending.popleft()
            if record._events:
                record._events[-1].synchronize()
            self._resolve_jacobian(record)
        kept = list(self._jacobians)
        return kept if n is None else kept[max(len(kept) - n, 0):]

    def clear(self) -> None:
        """Drop every record (the open spans stay open)."""
        for record in (*self._pending, *self._jac_pending):
            self._free += record._events
        self._pending.clear()
        self._records.clear()
        self._jac_pending.clear()
        self._jacobians.clear()

    def report(self, n: Optional[int] = None) -> str:
        """Per forward, mean over the last ``n`` records: each span's
        calls, host self ms and stream ms, then the forward's inclusive
        times."""
        recs = self.records(n)
        if not recs:
            return "no traced forwards"
        names = list(dict.fromkeys(k for r in recs for k in r.spans))

        def mean(values):
            values = list(values)
            return None if None in values else sum(values) / len(recs)

        def ms(x):
            return f"{'-':>12}" if x is None else f"{x:>12.4f}"

        lines = [f"{'span (per forward, ' + str(len(recs)) + ' forwards)':<40}"
                 f" {'calls':>6} {'host self ms':>12} {'stream ms':>12}"]
        for name in names:
            stats = [r.spans.get(name, SpanStat(stream_ms=0.0)) for r in recs]
            lines.append(
                f"{name:<40} {mean(s.calls for s in stats):>6.1f}"
                f" {ms(mean(s.host_self_ns * 1e-6 for s in stats))}"
                f" {ms(mean(s.stream_ms for s in stats))}")
        lines.append(f"{FORWARD_SPAN + ' (inclusive)':<40} {1.0:>6.1f}"
                     f" {ms(mean(r.host_ms for r in recs))}"
                     f" {ms(mean(r.stream_ms for r in recs))}")
        return "\n".join(lines)


spans = Spans()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("_name", "_range", "_frame")

    def __init__(self, name: str) -> None:
        self._name = name

    def __enter__(self) -> None:
        t0 = time.perf_counter_ns()
        self._range = _autograd_profiler.record_function(self._name)
        self._range.__enter__()
        self._frame = spans.open(self._name, t0)

    def __exit__(self, exc_type, exc, tb) -> bool:
        frame = self._frame
        if frame is not None:
            spans.stop_stream(frame)
        self._range.__exit__(exc_type, exc, tb)
        if frame is not None:
            spans.close(frame, time.perf_counter_ns(), exc_type is not None)
        return False


def annotate(name: str) -> ContextManager[None]:
    """The program's span ``name``: with no ``torch.profiler`` recording,
    nothing (one flag read); while one records, a ``record_function`` range
    in its trace and, inside a ``nemesis.forward`` span, the host and
    stream times of the span's forward record."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


counters: Counter = Counter()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the program's counter ``name`` (``counters``) and,
    inside a traced forward, to its record's."""
    counters[name] += n
    spans.count(name, n)


def forward_records(n: Optional[int] = None) -> List[ForwardRecord]:
    """The last ``n`` traced forwards' records (``spans.records``)."""
    return spans.records(n)


def jacobian_records(n: Optional[int] = None) -> List[JacobianRecord]:
    """The last ``n`` traced forward-plus-Jacobian evaluations' records
    (``spans.jacobian_records``)."""
    return spans.jacobian_records(n)


def clear() -> None:
    """Drop the traced forwards' and evaluations' records."""
    spans.clear()


def report(n: Optional[int] = None) -> str:
    """Table of each span's host self ms and stream ms per forward."""
    return spans.report(n)


@contextlib.contextmanager
def trace(logdir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU and, on the card,
    CUDA activity) and write its Chrome trace to ``logdir/trace.json``.
    ``device=None`` is the CUDA card (raises without one); ``"cpu"``
    records CPU activity only. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_report(device=None) -> Dict[str, Dict[str, int]]:
    """Allocator statistics (``torch.cuda.memory_stats``, integers) of every
    CUDA card, keyed ``cuda:<i>``. ``device=None`` needs a card (raises
    without one); ``device="cpu"`` returns {} as the CPU keeps no such
    statistics."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            k: int(v) for k, v in stats.items() if isinstance(v, (int, float))
        }
    return out
