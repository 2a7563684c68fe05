"""The multiple-scattering forward's spans and counters
(``forward.forward_scattering_nadir``, ``rt/scattering.py``): one
``nemesis.forward`` record per traced forward holding the layering's and
the scattering core's spans, the counters' rise per forward, nothing done
with no profiler recording, and the benchmark's readers of the records
(``nembench/metrics/*.scat.py``). On the card (``cuda``), the spans add no
launch and change no bit.

The configuration ``jupiter_scatter_ms`` cut to 64 waves in 4 tiles of
16, NG = 4, 11 levels, 8 layers. No JAX here: the ``cuda`` test runs on
the card."""

import contextlib
import copy

import numpy as np
import pytest
import torch

from archnemesis_tpu_torch.utils import profiling
from nembench.harness import manifest as mf
from nembench.harness import scatter_bounds
from nembench.harness import traffic as tf

CONFIG = "jupiter_scatter_ms"
TILES = 4
SPANS = {"nemesis.layering", "nemesis.kinterp", "nemesis.overlap",
         "nemesis.rayleigh", "nemesis.dust", "nemesis.scatter.phase",
         "nemesis.scatter.doubling", "nemesis.scatter.adding"}
COUNTERS = ("scatter.hansen_reads", "scatter.ladder_reads", "scatter.tiles")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _forward(device="cpu", dtype="float64"):
    """A no-argument forward of the cut configuration on ``device``."""
    spec = copy.deepcopy(mf.config(CONFIG)[0])
    spec.update(nwave=64, ng=4, table_ng=8, nlevel=11, nlay=8, nint=11,
                dtype=dtype)
    spec["scattering"]["wave_tile"] = 64 // TILES
    _, module = mf.config(CONFIG)
    program = module.Program(spec, 3, device)
    t, mult = tf.states(dict(mf.traffic("scat_stream"), states=1),
                        module.profiles(spec)["t"], 5, 7, device)
    dt = getattr(torch, dtype)
    return lambda: program.forward(t[0].to(dt), mult[0].to(dt))


@pytest.fixture(scope="module")
def forward():
    return _forward()


def _counts():
    return {name: profiling.counters[name] for name in COUNTERS}


def _traced(fn, calls, device="cpu"):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = [fn() for _ in range(calls)]
        if device != "cpu":
            torch.cuda.synchronize()
    return out, prof


def test_traced_forward_records_the_scattering_spans(forward):
    """Two traced forwards file two records, each with the layering's, the
    opacities' and the three scattering spans (the phase once, the
    doubling and the adding once a tile) and the counters' adds of its
    own forward; the spectrum is the untraced one bit for bit."""
    untraced = forward()
    before = _counts()
    out, _ = _traced(forward, 2)
    for y in out:
        assert torch.equal(y, untraced)
    records = profiling.forward_records(2)
    assert len(records) == 2
    for r in records:
        assert set(r.spans) == SPANS | {profiling.FORWARD_SPAN}
        assert r.spans["nemesis.scatter.phase"].calls == 1
        assert r.spans["nemesis.scatter.doubling"].calls == TILES
        assert r.spans["nemesis.scatter.adding"].calls == TILES
        assert r.counters["scatter.tiles"] == TILES
        assert r.counters["scatter.ladder_reads"] == TILES
        # one sweep at least for each of the three phase functions
        assert r.counters["scatter.hansen_reads"] >= 3
        assert r.counters == records[0].counters
    after = _counts()
    for name in COUNTERS:
        assert after[name] - before[name] == 2 * records[0].counters[name]


def test_spans_are_off_outside_a_profiler(forward, monkeypatch):
    """With no profiler recording no span does work and no record is
    filed; the counters still rise by the tiles a forward."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span did work with no profiler recording")

    profiling.clear()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling.spans, "open", refuse)
    before = _counts()
    assert torch.isfinite(forward()).all()
    assert profiling.forward_records() == []
    after = _counts()
    assert after["scatter.tiles"] - before["scatter.tiles"] == TILES
    assert after["scatter.ladder_reads"] - before["scatter.ladder_reads"] \
        == TILES


def _record(host_ms, stream, counters):
    spans = {name: profiling.SpanStat(calls=1, host_self_ns=1000,
                                      stream_ms=ms)
             for name, ms in stream.items()}
    return profiling.ForwardRecord(host_ms=host_ms, spans=spans,
                                   stream_ms=sum(stream.values()),
                                   counters=counters)


class _Reference:
    """A reference whose base optical depths are ``taut``."""

    def __init__(self, taut):
        self.taut = taut

    def base_optical_depth(self):
        return torch.as_tensor(self.taut)


TAUT = np.exp(np.random.default_rng(5).uniform(-12.0, 8.0, (16, 4, 8)))
LEAST_MS = scatter_bounds.least_ms(TAUT, 2, 5, 2, 4)
READS = {
    "scatter_phase_ms.scat": lambda r: r.spans["nemesis.scatter.phase"
                                               ].stream_ms,
    "doubling_ms.scat": lambda r: r.spans["nemesis.scatter.doubling"
                                          ].stream_ms,
    "adding_ms.scat": lambda r: r.spans["nemesis.scatter.adding"].stream_ms,
    "host_ms_per_call.scat": lambda r: r.host_ms,
    "host_syncs_per_call.scat": lambda r: (
        r.counters["scatter.hansen_reads"]
        + r.counters["scatter.ladder_reads"]),
    "layering_ms.scat": lambda r: r.spans["nemesis.layering"].stream_ms,
    "kinterp_ms.scat": lambda r: r.spans["nemesis.kinterp"].stream_ms,
    "overlap_ms.scat": lambda r: r.spans["nemesis.overlap"].stream_ms,
}
# a traced window of 3 forwards: 7.2 s of 9 s busy
TRACE = type("Trace", (), {"busy_s": 7.2, "window_s": 9.0})


@pytest.mark.parametrize("name", sorted(READS) + [
    "scatter_roofline_pct.scat"])
def test_metric_reads_the_traced_forwards(name, monkeypatch):
    """The reader's value is the mean over the last ``traced_calls``
    records (the roofline: the least time over the smaller of the mean
    stream time of the doubling and the adding and the trace's device
    time a forward); None on an empty ring, and where the records keep no
    counters or no stream times (the parent's program)."""
    book = mf.load()
    entry = next(m for m in book["per_layer"] if m["name"] == name)
    assert entry["workloads"] == ["jupiter_scatter_ms.scat_stream"]
    assert entry["moves"] == "fwd_waves_per_s"
    reader = mf.metric(name)
    spec = mf.config(CONFIG)[0]
    ctx = type("Ctx", (), {"traced_calls": 3, "spec": spec, "itemsize": 4,
                           "reference": _Reference(TAUT), "trace": TRACE})()
    spans = profiling.Spans()
    monkeypatch.setattr(profiling, "spans", spans)
    assert reader.read(ctx) is None

    rng = np.random.default_rng(11)
    records = [_record(float(rng.uniform(500, 900)),
                       {n: float(rng.uniform(1, 800))
                        for n in sorted(SPANS | {profiling.FORWARD_SPAN})},
                       {"scatter.hansen_reads": int(rng.integers(50, 60)),
                        "scatter.ladder_reads": 16, "scatter.tiles": 16})
               for _ in range(5)]
    spans._records.extend(records)
    last = records[-3:]
    if name == "scatter_roofline_pct.scat":
        ms = np.mean([r.spans["nemesis.scatter.doubling"].stream_ms
                      + r.spans["nemesis.scatter.adding"].stream_ms
                      for r in last])
        want = 100.0 * LEAST_MS / min(ms, 2400.0)
    else:
        want = np.mean([READS[name](r) for r in last])
    assert reader.read(ctx) == pytest.approx(want, rel=1e-12)

    if name == "host_syncs_per_call.scat":
        for r in records:
            del r.counters
        assert reader.read(ctx) is None
    elif name != "host_ms_per_call.scat":
        for r in records:
            for s in r.spans.values():
                s.stream_ms = None
        assert reader.read(ctx) is None


def test_roofline_reads_the_smaller_time(monkeypatch):
    """Where the trace's device time a forward is below the spans' stream
    time (the host's gaps inside the spans), the roofline divides by it;
    without a device time in the trace, by the stream time."""
    reader = mf.metric("scatter_roofline_pct.scat")
    spans = profiling.Spans()
    monkeypatch.setattr(profiling, "spans", spans)
    stream = {"nemesis.scatter.doubling": 900.0,
              "nemesis.scatter.adding": 600.0}
    spans._records.extend(_record(2000.0, stream, {}) for _ in range(2))
    for busy_s, ms in ((2.0, 1000.0), (4.0, 1500.0), (0.0, 1500.0)):
        trace = type("Trace", (), {"busy_s": busy_s, "window_s": 5.0})
        ctx = type("Ctx", (), {"traced_calls": 2, "itemsize": 4,
                               "spec": mf.config(CONFIG)[0], "trace": trace,
                               "reference": _Reference(TAUT)})()
        assert reader.read(ctx) == pytest.approx(100.0 * LEAST_MS / ms,
                                                 rel=1e-12)


@pytest.mark.parametrize("name", ["device_ms_per_call",
                                  "device_idle_pct", "launches_per_call"])
def test_device_metrics_read_the_trace(name):
    """The scattering cell's device readers read the traced window as the
    forward cells' do: the same numbers from the same trace, None from an
    empty one."""
    from nembench.harness import trace as tr

    book = mf.load()
    entry = next(m for m in book["per_layer"]
                 if m["name"] == f"{name}.scat")
    assert entry["workloads"] == ["jupiter_scatter_ms.scat_stream"]
    assert entry["source"] == "device_trace"
    ops = [tr.DeviceOp(n, s, s + 40.0) for n, s in (
        ("gemm", 0.0), ("Memcpy DtoH", 50.0), ("elementwise", 100.0))]
    for trace, traced in ((tr.Trace(ops=ops, window_s=5e-4, busy_s=1.2e-4),
                           2),
                          (tr.Trace(ops=[], window_s=5e-4, busy_s=0.0), 2)):
        ctx = type("Ctx", (), {"trace": trace, "traced_calls": traced})()
        got = mf.metric(f"{name}.scat").read(ctx)
        assert got == mf.metric(f"{name}.fwd").read(ctx)
        assert (got is None) == (not trace.ops)


@pytest.fixture
def cuda():
    """The card, or a skip: the forward's combine kernel is built with
    nvcc and has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the combine kernel is built with "
                    "nvcc and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_add_no_launch_on_the_card(cuda, monkeypatch):
    """On the card in float32: the traced forward's spectrum is the
    untraced one's bit for bit, and the profiler sees as many kernels in a
    traced forward as in one whose spans are taken out."""
    from torch.autograd import DeviceType

    fn = _forward(cuda, "float32")
    fn()
    untraced = fn().cpu()

    def kernels(prof):
        # a span's range shows on the card's timeline as a user
        # annotation of its name, which is no launch
        return sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(("Memcpy", "Memset",
                                              "nemesis.")))

    out, with_spans = _traced(fn, 1, cuda)
    assert torch.equal(out[0].cpu(), untraced)
    records = profiling.forward_records(1)
    assert records[0].spans["nemesis.scatter.doubling"].stream_ms > 0
    for module in ("archnemesis_tpu_torch.forward",
                   "archnemesis_tpu_torch.rt.scattering"):
        monkeypatch.setattr(f"{module}.annotate",
                            lambda name: contextlib.nullcontext())
    out, without = _traced(fn, 1, cuda)
    assert torch.equal(out[0].cpu(), untraced)
    counts = (kernels(with_spans), kernels(without))
    assert counts[0] == counts[1] > 0, counts
