"""Tracing and profiling (port of the JAX package's ``utils/profiling.py``;
the reference has none beyond wall-clock brackets, ``Retrievals.py:78,
331-333``).

Three layers, in PyTorch's idiom:
- ``trace(logdir)``: ``torch.profiler.profile`` with CPU and CUDA
  activities around a block; a Chrome trace (``trace.json``) is written
  into ``logdir`` (view it in Perfetto or ``chrome://tracing``).
- ``annotate(name)``: a named region inside a trace
  (``torch.profiler.record_function``), for marking forward / jacobian /
  OE-update phases.
- ``stopwatch(name)`` + the module-level ``timings`` registry: wall-clock
  stage timing that synchronises the CUDA device of every tensor of the
  block's result before it stops the clock, so the numbers mean what they
  say under asynchronous launches.

``trace`` and ``device_memory_report`` run on the CUDA card unless the
caller passes ``device="cpu"``: without a card they raise.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List

import torch

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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in a captured profile (``record_function``); harmless
    outside a trace."""
    with torch.profiler.record_function(name):
        yield


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
