"""The program's spans (``utils/profiling.py:annotate``) inside
``forward_nadir``: off outside a profiler, one record per traced forward
inside one, the same spectrum either way, and the benchmark's readers of
the records (``nembench/metrics/*.py`` of source ``program_span``).

Cut sizes on the CPU: ``jupiter_fdret`` thinned to 8 channels and 8
layers (correlated-k with CIA and dust) and the runtime line-by-line deck
``co_runtime`` with a pseudo-continuum attached."""

import dataclasses

import numpy as np
import pytest
import torch

from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.forward import forward_nadir, make_forward_config
from archnemesis_tpu_torch.io.legacy import load_deck
from archnemesis_tpu_torch.retrievals import make_retrieval_setup
from archnemesis_tpu_torch.rt.emission import TANGENT_SPAN
from archnemesis_tpu_torch.utils import profiling
from nembench.harness import manifest as mf
from port_cases import (
    CO_RUNTIME,
    one_torch_thread,  # noqa: F401 (a fixture)
    thin_fdret,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LAYERS = {
    "ck": {"nemesis.layering", "nemesis.path", "nemesis.kinterp",
           "nemesis.overlap", "nemesis.cia", "nemesis.rayleigh",
           "nemesis.dust", "nemesis.spectrum"},
    "lbl": {"nemesis.layering", "nemesis.path", "nemesis.lbl.pack",
            "nemesis.lbl.synth", "nemesis.lbl.continuum",
            "nemesis.rayleigh", "nemesis.spectrum"},
}


def _pseudo_continuum():
    """A made-up pre-binned weak-line set over the deck's lines
    (``tests/test_torch_runtime.py:seeded_pseudo_continuum``'s form)."""
    rng = np.random.default_rng(3)
    n_bins = 40
    edges = np.linspace(2100.0, 2200.0, n_bins + 1)
    return convert.pseudo_continuum(dict(
        t_ref=296.0, p_ref=1.0, mass=28.0, abundance=0.98,
        wn_bin_center=0.5 * (edges[1:] + edges[:-1]),
        wn_bin_width=np.diff(edges),
        strength_sum=10.0 ** rng.uniform(-24.0, -20.0, n_bins),
        lsw_e_lower=rng.uniform(0.0, 3000.0, n_bins),
        lsw_gamma_self=rng.uniform(0.05, 0.09, n_bins),
        lsw_n_self=rng.uniform(0.6, 0.8, n_bins),
        lsw_gamma_amb=rng.uniform(0.04, 0.08, n_bins),
        lsw_n_amb=rng.uniform(0.6, 0.8, n_bins),
        pf_temp=np.linspace(50.0, 400.0, 36),
        pf_q=np.linspace(20.0, 160.0, 36) ** 1.05,
    ))


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """deck name -> a no-argument forward on the CPU."""
    setup = make_retrieval_setup(
        thin_fdret(tmp_path_factory.mktemp("spans_ck"), nchan=8, nlay=8),
        "cirstest", device="cpu")
    xa = torch.as_tensor(setup.sv.xa, dtype=setup.dtype)

    deck = load_deck(CO_RUNTIME, "cirstest")
    nconv = int(deck.geometry.nconv[0])
    vconv = deck.geometry.vconv[:nconv, 0]
    # every eighth wave of the grid: the spans, not the synthesis, are tested
    rt = dataclasses.replace(deck.ktables, wave=deck.ktables.wave[::8])
    rt = dataclasses.replace(rt.windowed(vconv.min(), vconv.max()),
                             pseudo_continuum=(_pseudo_continuum(),),
                             include_continuum=(True,))
    cfg = make_forward_config(deck.atmosphere, rt, None,
                              iray=deck.settings.iray,
                              ispace=deck.settings.ispace, gasgiant=True)

    def lbl():
        return forward_nadir(deck.atmosphere, deck.layer_config, rt, None,
                             None, deck.surface, cfg, emiss_ang=0.0,
                             device="cpu")

    return {"ck": lambda: setup.forward_fn(xa), "lbl": lbl}


def _traced(fn, calls):
    """(outputs, profiler) of ``calls`` calls of ``fn`` under a CPU
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = [fn() for _ in range(calls)]
    return out, prof


def test_spans_are_off_outside_a_profiler(forwards, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span did work with no profiler recording")

    before = len(profiling.forward_records())
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling.spans, "open", refuse)
    assert torch.isfinite(forwards["ck"]()).all()
    with profiling.annotate("nemesis.layering"):
        pass
    assert len(profiling.forward_records()) == before


@pytest.mark.parametrize("deck", ["ck", "lbl"])
def test_traced_forward_records_its_layers(forwards, deck):
    """Every layer's range lies in its forward's range in the profile, the
    ring gains one record per forward, the host self times add up to no
    more than the forward's time, and the spectrum is the untraced one bit
    for bit."""
    from torch.autograd import DeviceType

    untraced = forwards[deck]()
    before = len(profiling.forward_records())
    out, prof = _traced(forwards[deck], 2)
    for y in out:
        assert torch.equal(y, untraced)
    ranges = [e for e in prof.events() if e.name.startswith("nemesis.")
              and e.device_type == DeviceType.CPU]
    outer = [e.time_range for e in ranges if e.name == profiling.FORWARD_SPAN]
    assert len(outer) == 2
    inner = [e for e in ranges if e.name != profiling.FORWARD_SPAN]
    assert {e.name for e in inner} == LAYERS[deck]
    for e in inner:
        assert any(r.start <= e.time_range.start and e.time_range.end <= r.end
                   for r in outer), e.name

    records = profiling.forward_records(2)
    assert len(profiling.forward_records()) == min(before + 2, profiling.RING)
    for r in records:
        assert set(r.spans) == LAYERS[deck] | {profiling.FORWARD_SPAN}
        assert all(s.calls >= 1 and s.host_self_ns >= 0
                   for s in r.spans.values())
        self_ns = sum(s.host_self_ns for s in r.spans.values())
        assert 0 < self_ns <= r.host_ms * 1e6 + 1  # ns from float ms
        assert r.stream_ms is None
        assert all(s.stream_ms is None for s in r.spans.values())
    assert "nemesis.overlap" in profiling.report(2) or deck == "lbl"


def test_span_outside_a_forward_is_a_range_only():
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("nemesis.kinterp"):
            torch.ones(4).sum()
    assert any(e.name == "nemesis.kinterp" for e in prof.events())
    assert profiling.forward_records() == []
    assert profiling.report() == "no traced forwards"


class _FakeEvent:
    """A CUDA event on a made-up stream whose clock advances 1 ms at each
    record; ``made`` counts the events created."""

    clock, made = 0.0, 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1

    def record(self):
        type(self).clock += 1.0
        self.at = type(self).clock

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_stream_times_from_the_events(monkeypatch):
    """Each span's stream time is the time between its events, the
    forward's own is the gaps between its layers, the two add up to the
    forward's stream time, and a second forward reuses the first's
    events."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(profiling, "spans", profiling.Spans())
    monkeypatch.setattr(_FakeEvent, "made", 0)

    def forward():
        with profiling.annotate(profiling.FORWARD_SPAN):
            for name in ("a", "b", "a"):
                with profiling.annotate(name):
                    pass

    _traced(forward, 2)
    assert _FakeEvent.made == 8
    for r in profiling.forward_records():
        # events at 1 (forward), 2-3 (a), 4-5 (b), 6-7 (a), 8 (forward)
        assert r.stream_ms == 7.0
        assert {n: (s.calls, s.stream_ms) for n, s in r.spans.items()} == {
            "a": (2, 2.0), "b": (1, 1.0), profiling.FORWARD_SPAN: (1, 4.0)}
    assert "b" in profiling.report()


def _record(host_ms, stream):
    """A forward record with these inclusive host ms and span stream ms."""
    spans = {name: profiling.SpanStat(calls=1, host_self_ns=1000,
                                      stream_ms=ms)
             for name, ms in stream.items()}
    return profiling.ForwardRecord(host_ms=host_ms, spans=spans,
                                   stream_ms=sum(stream.values()))


READS = {
    "host_ms_per_call.fwd": lambda r: r.host_ms,
    "layering_ms.fwd": lambda r: (r.spans["nemesis.layering"].stream_ms
                                  + r.spans["nemesis.path"].stream_ms),
    "kinterp_ms.fwd": lambda r: r.spans["nemesis.kinterp"].stream_ms,
    "overlap_ms.fwd": lambda r: r.spans["nemesis.overlap"].stream_ms,
    "lbl_ms.fwd": lambda r: (r.spans["nemesis.lbl.pack"].stream_ms
                             + r.spans["nemesis.lbl.synth"].stream_ms
                             + r.spans["nemesis.lbl.continuum"].stream_ms),
    "emission_ms.fwd": lambda r: sum(r.spans[f"nemesis.{n}"].stream_ms
                                     for n in ("cia", "rayleigh", "dust",
                                               "spectrum")),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_metric_reads_the_traced_forwards(name, monkeypatch):
    """The reader's value is the mean over the last ``traced_calls``
    records; None on an empty ring and where no stream time was taken."""
    book = mf.load()
    entry = next(m for m in book["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["workloads"]
    reader = mf.metric(name)
    ctx = type("Ctx", (), {"traced_calls": 3})()
    spans = profiling.Spans()
    monkeypatch.setattr(profiling, "spans", spans)
    assert reader.read(ctx) is None

    names = set().union(*LAYERS.values()) | {profiling.FORWARD_SPAN}
    rng = np.random.default_rng(11)
    records = [_record(float(rng.uniform(5, 50)),
                       {n: float(rng.uniform(0.1, 20)) for n in sorted(names)})
               for _ in range(5)]
    spans._records.extend(records)
    want = np.mean([READS[name](r) for r in records[-3:]])
    assert reader.read(ctx) == pytest.approx(want, rel=1e-12)

    if name != "host_ms_per_call.fwd":
        for r in records:
            for s in r.spans.values():
                s.stream_ms = None
        assert reader.read(ctx) is None


def _cut_jacobian():
    """(fn, x) of ``jupiter_ck_oe`` at 64 waves, NG = 8, 11 levels, 8
    layers: NX = 16."""
    import copy

    from nembench.harness import traffic as tf

    spec = copy.deepcopy(mf.config("jupiter_ck_oe")[0])
    spec.update(nwave=64, ng=8, nlevel=11, nlay=8, nint=11, dtype="float64")
    spec["state_vector"]["temperature_levels"] = 11
    _, module = mf.config("jupiter_ck_oe")
    program = module.Program(spec, 1, "cpu")
    t, mult = tf.states(dict(mf.traffic("jac_iter"), states=1),
                        module.profiles(spec)["t"], 5, 7, "cpu")
    x, fn = program.state_function(t[0], mult[0])
    return fn, x


def _chunked_jacobian(fn, x, chunk):
    """The Jacobian pushed through ``chunk`` tangents at a time inside one
    ``nemesis.jacobian`` span: a forward pass a chunk."""
    basis = torch.eye(x.shape[0], dtype=x.dtype)
    with profiling.annotate(profiling.JACOBIAN_SPAN):
        _, cols = torch.func.vmap(lambda v: torch.func.jvp(fn, (x,), (v,)),
                                  chunk_size=chunk)(basis)
    return None, cols.movedim(0, -1)


@pytest.mark.parametrize("chunk_size, passes", [(None, 1), (6, 3)])
def test_traced_jacobian_leaves_one_record(chunk_size, passes):
    """One record per evaluation, chunked or not, holding each layer span
    summed over the forwards it ran (which file their own records too);
    the peak field is there (None off the card); the counter counts the
    evaluations."""
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian

    fn, x = _cut_jacobian()
    calls = forward_and_jacobian.calls
    profiling.clear()
    _, kk = forward_and_jacobian(fn, x)
    out, _ = _traced(
        lambda: (forward_and_jacobian(fn, x) if chunk_size is None
                 else _chunked_jacobian(fn, x, chunk_size)), 1)
    traced = out[0][1]
    assert torch.allclose(traced, kk, rtol=1e-12, atol=0)
    assert forward_and_jacobian.calls == calls + 1 + (chunk_size is None)

    (record,) = profiling.jacobian_records()
    forwards = profiling.forward_records()
    assert len(forwards) == passes and record.forwards == forwards
    assert record.peak_bytes is None and record.stream_ms is None
    assert record.spans[profiling.JACOBIAN_SPAN].calls == 1
    # the emission's tangents in one call, inside ``nemesis.spectrum``
    assert set(record.spans) == (LAYERS["ck"] - {"nemesis.cia", "nemesis.dust"}
                                 | {profiling.FORWARD_SPAN,
                                    profiling.JACOBIAN_SPAN,
                                    TANGENT_SPAN})
    for name, stat in record.spans.items():
        if name == profiling.JACOBIAN_SPAN:
            continue
        assert stat.calls == sum(f.spans[name].calls for f in forwards)
        assert stat.host_self_ns == sum(f.spans[name].host_self_ns
                                        for f in forwards)
    inner = sum(f.host_ms for f in forwards)
    assert inner <= record.host_ms + 1e-6


def test_untraced_jacobian_leaves_no_record(monkeypatch):
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian

    def refuse(*args, **kwargs):
        raise AssertionError("a span did work with no profiler recording")

    fn, x = _cut_jacobian()
    profiling.clear()
    calls = forward_and_jacobian.calls
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.spans, "open", refuse)
    forward_and_jacobian(fn, x)
    assert forward_and_jacobian.calls == calls + 1
    assert profiling.jacobian_records() == []


def test_jacobian_stream_times_and_peak(monkeypatch):
    """An evaluation's record sums its forwards' stream times, takes its own
    from its two events, and holds the allocator's peak since its start."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    resets = []
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda: resets.append(1))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda: 12345 * len(resets))
    monkeypatch.setattr(profiling, "spans", profiling.Spans())

    def evaluation():
        with profiling.annotate(profiling.JACOBIAN_SPAN):
            for _ in range(2):
                with profiling.annotate(profiling.FORWARD_SPAN):
                    with profiling.annotate("a"):
                        pass

    _traced(evaluation, 2)
    records = profiling.jacobian_records()
    assert len(records) == 2 and len(resets) == 2
    for i, r in enumerate(records):
        # events at 1 (evaluation), 2-5 and 6-9 (forwards, "a" at 3-4 and
        # 7-8), 10 (evaluation)
        assert r.stream_ms == 9.0 and r.peak_bytes == 12345 * (i + 1)
        assert {n: (s.calls, s.stream_ms) for n, s in r.spans.items()
                if n != profiling.JACOBIAN_SPAN} == {
            "a": (2, 2.0), profiling.FORWARD_SPAN: (2, 4.0)}
    assert len(profiling.forward_records()) == 4


def _jac_record(stream, peak, host_ms=1.0):
    spans = {name: profiling.SpanStat(calls=1, host_self_ns=1000,
                                      stream_ms=ms)
             for name, ms in stream.items()}
    return profiling.JacobianRecord(host_ms=host_ms, spans=spans,
                                    peak_bytes=peak)


JAC_READS = {
    "layering_ms.jac": lambda r: (r.spans["nemesis.layering"].stream_ms
                                  + r.spans["nemesis.path"].stream_ms),
    "kinterp_ms.jac": lambda r: r.spans["nemesis.kinterp"].stream_ms,
    "overlap_ms.jac": lambda r: r.spans["nemesis.overlap"].stream_ms,
    "emission_ms.jac": lambda r: sum(r.spans[f"nemesis.{n}"].stream_ms
                                     for n in ("cia", "rayleigh", "dust",
                                               "spectrum")),
    "peak_mem_gib.jac": lambda r: r.peak_bytes / 2**30,
    "host_ms_per_call.jac": lambda r: r.host_ms,
}


@pytest.mark.parametrize("name", sorted(JAC_READS))
def test_jacobian_metric_reads_the_traced_evaluations(name, monkeypatch):
    """The reader's value is the mean over the last ``traced_calls``
    evaluation records; None on an empty ring, where no stream time was
    taken and where no peak was (the host time is always taken)."""
    book = mf.load()
    entry = next(m for m in book["per_layer"] if m["name"] == name)
    assert entry["workloads"] == ["jupiter_ck_oe.jac_iter"]
    reader = mf.metric(name)
    ctx = type("Ctx", (), {"traced_calls": 3})()
    spans = profiling.Spans()
    monkeypatch.setattr(profiling, "spans", spans)
    assert reader.read(ctx) is None

    names = set(LAYERS["ck"])
    rng = np.random.default_rng(12)
    records = [_jac_record({n: float(rng.uniform(0.1, 20))
                            for n in sorted(names)},
                           int(rng.integers(2**30, 2**35)),
                           float(rng.uniform(50, 500)))
               for _ in range(5)]
    spans._jacobians.extend(records)
    want = np.mean([JAC_READS[name](r) for r in records[-3:]])
    assert reader.read(ctx) == pytest.approx(want, rel=1e-12)

    if name == "host_ms_per_call.jac":
        return
    for r in records:
        r.peak_bytes = None
        for s in r.spans.values():
            s.stream_ms = None
    assert reader.read(ctx) is None
