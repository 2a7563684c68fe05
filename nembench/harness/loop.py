"""One run of a cell: set-up, warm-up, the measured window of a closed
loop, the traced window, and the comparison with the reference."""

from __future__ import annotations

import gc
import math
import subprocess
import time
from dataclasses import dataclass

import numpy as np
import torch

from nembench.harness import manifest as mf
from nembench.harness import trace as tr
from nembench.harness import traffic as tf


@dataclass
class Context:
    """What a per-layer metric's reader reads: the configuration's sizes,
    the traced window, the states of its calls and the float64 reference."""

    spec: dict
    trace: object  # trace.Trace
    traced_calls: int
    traced_states: list  # (t, mult) of each traced call, float64
    reference: object
    itemsize: int


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(book: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, spec=None, program=None,
             min_calls: int = 0) -> dict:
    """The result line's object of one run (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checks``).

    ``spec`` replaces the configuration's sizes (the tests' cut sizes);
    ``program`` replaces the port (a callable ``(spec, seed, device) ->``
    object with ``forward(t, mult)``: the control, or a broken program);
    the window runs ``min_calls`` calls at least."""
    cell = mf.cell(book, cell_name)
    sizes, module = mf.config(cell["config"])
    spec = spec or sizes
    mix = mf.traffic(cell["traffic"])
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise mf.ManifestError(f"traffic {cell['traffic']}: the generator "
                               "runs a closed loop of one client")
    kind = mf.call(mix["call"])
    on_card = torch.device(device).type == "cuda"
    card = power_limit() if on_card else "cpu"

    prog = (program or module.Program)(spec, seed, device)
    base_t = module.profiles(spec)["t"]
    t_all, mult_all = tf.states(mix, base_t, len(spec["scaled_gases"]), seed,
                                device)
    dtype = getattr(torch, spec["dtype"])
    t_run, mult_run = t_all.to(dtype), mult_all.to(dtype)
    nstate = t_all.shape[0]

    def call(i):
        return kind.call(prog, t_run[i % nstate], mult_run[i % nstate])

    for i in range(mix["warmup_calls"]):
        call(i)
    if trace:
        # the profiler's first start in a process sets up its tracer
        with torch.profiler.profile(activities=_activities(on_card)):
            call(0)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    outputs, prof = [], None
    t0 = time.perf_counter()

    def done():
        return (time.perf_counter() - t0 >= seconds
                and len(outputs) >= max(min_calls, 1))

    if trace:
        # the traced window: the window's first ``trace_calls`` calls
        with torch.profiler.profile(activities=_activities(on_card)) as prof:
            with torch.profiler.record_function(tr.WINDOW_RANGE):
                while len(outputs) < mix["trace_calls"] and not done():
                    outputs.append(call(len(outputs)))
        traced_calls = len(outputs)
    while not done():
        outputs.append(call(len(outputs)))
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    n_done = len(outputs)
    del prog, t_run, mult_run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    failed = sum(int(not kind.finite(y)) for y in outputs)
    ref = module.Reference(spec, seed, device, torch.float64)
    calls, waves = tf.check_sample(mix, n_done, spec["nwave"], seed)
    readings = {name: [] for name in kind.CHECKS}
    for i in calls:
        got = kind.compare(ref, outputs[i], t_all[i % nstate],
                           mult_all[i % nstate], waves)
        for name in kind.CHECKS:
            readings[name].append(got[name])
    # the worst reading of each number; a non-finite one is no number and
    # fails its check as "nan"
    checks = {name: {"value": (max(v) if all(map(math.isfinite, v))
                               else "nan"),
                     "limit": spec["limits"][name]}
              for name, v in readings.items()}
    correct = failed == 0 and all(
        isinstance(c["value"], float) and c["value"] <= c["limit"]
        for c in checks.values())

    group = "per_layer" if trace else "end_to_end"
    result = {"correct": correct, "attempted": n_done, "failed": failed,
              "metrics": {}, "device": {
                  "platform": "gpu" if on_card else "cpu",
                  "kind": (torch.cuda.get_device_name(device) if on_card
                           else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak),
                  "card": card}}
    if not trace:
        values = {"setup_s": setup_s,
                  **kind.end_to_end(spec, n_done, elapsed)}
    else:
        trace_data = tr.read(prof)
        ctx = Context(spec=spec, trace=trace_data,
                      traced_calls=traced_calls,
                      traced_states=[(t_all[i % nstate], mult_all[i % nstate])
                                     for i in range(traced_calls)],
                      reference=ref, itemsize=dtype.itemsize)
        values = {m["name"]: mf.metric(m["name"]).read(ctx)
                  for m in mf.metrics_of(book, group, cell_name)}
        result["device"].update(busy_s=trace_data.busy_s,
                                window_s=trace_data.window_s)
        result["breakdown"] = {"device_ops": trace_data.top_ops(),
                               "idle_gaps": trace_data.top_idle()}
    for m in mf.metrics_of(book, group, cell_name):
        if values.get(m["name"]) is not None:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    result["checks"] = checks
    return result


def _activities(on_card):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts
