"""The nadir forward's layering and path as CUDA graphs
(``archnemesis_tpu_torch/rt/layer_graph.py``): on the CPU, that the
layering and path read nothing back from the device and copy nothing from
the host once their constants are made, that the graph declines wherever
a graph cannot stand in for the eager code, and the benchmark's reader of
the replay span; on the card (``cuda``), the replays' bits against the
eager code's, their counters, the forward's diagnostics, ``jacfwd`` and
the absence of synchronisation.

The atmospheres are those of the benchmark's forward cells
(``nembench/configs/jupiter_ck.json``, ``co_lbl.json``: 81 and 61 levels
into 71 and 40 layers of 101 samples) and the Jupiter layering golden with
its dust, renormalised. No JAX here: the port against the JAX package is
``tests/test_torch_layers.py``."""

import collections
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from archnemesis_tpu_torch import forward as fwd
from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
from archnemesis_tpu_torch.enums import PathCalc
from archnemesis_tpu_torch.forward import apply_dust_renorm
from archnemesis_tpu_torch.rt import layer_graph
from archnemesis_tpu_torch.rt.layer import build_layers
from archnemesis_tpu_torch.rt.layer_graph import layering_and_path
from archnemesis_tpu_torch.rt.path import nadir_path
from archnemesis_tpu_torch.utils import profiling
from archnemesis_tpu_torch.utils.device import device_constant
from nembench.harness import manifest as mf

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "jupiter_layering.npz")
CASES = ("jupiter_ck", "co_lbl", "golden")
ANGLES = (0.0, 180.0, 0.0)
# viewing geometries of one atmosphere, more than the runner keeps layouts
GEOMETRIES = [(float(e), 180.0 - 3.0 * i, 10.0 * i)
              for i, e in enumerate(np.linspace(0.0, 65.0, 12))]
# what copies host data to the device, or reads the device on the host
HOST_OPS = {"_local_scalar_dense", "_to_copy", "lift_fresh",
            "lift_fresh_copy"}


def _case(name: str, device, dtype=torch.float32):
    """(Atmosphere, LayerConfig) of a benchmark cell's layering or of the
    golden's (with dust and its renormalisation)."""
    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device
                               ).to(dtype)

    if name == "golden":
        d = np.load(GOLDEN)
        ndust = d["DUST"].shape[1]
        atm = Atmosphere(
            h=dev(d["H"]), p=dev(d["P"]), t=dev(d["T"]), vmr=dev(d["VMR"]),
            dust=dev(d["DUST"]), parah2=dev(d["PARAH2"]),
            molwt=dev(d["MOLWT"]), radius=dev(d["RADIUS"]),
            latitude=dev(d["LATITUDE"]),
            dust_renorm=dev(np.linspace(0.0, 0.7, ndust)),
            dust_units_flag=tuple(int(x) for x in d["DUST_UNITS_FLAG"])
            or None)
        cfg = LayerConfig(nlay=int(d["NLAY"]), laytyp=int(d["LAYTYP"]),
                          layint=int(d["LAYINT"]),
                          layht=max(float(d["LAYHT"]), float(d["H"][0])))
        return atm, cfg
    spec, module = mf.config(name)
    prof, pr = module.profiles(spec), spec["profile"]
    n = spec["nlevel"]
    atm = Atmosphere(
        h=dev(prof["h"]), p=dev(prof["p"]), t=dev(prof["t"]),
        vmr=dev(prof["vmr"]), dust=dev(np.zeros((n, 0))),
        parah2=dev(np.zeros(n)), molwt=dev(np.full(n, pr["molwt_kg"])),
        radius=dev(pr["radius_m"]), latitude=dev(pr["latitude"]))
    cfg = LayerConfig(nlay=spec["nlay"], laytyp=1, layint=1,
                      nint=spec["nint"], layht=float(prof["h"][0]))
    return atm, cfg


def _state(atm: Atmosphere, i: int) -> Atmosphere:
    """The i-th state: temperatures and VMRs moved smoothly from ``atm``'s
    (new tensors, as the benchmark's calls make them)."""
    x = torch.linspace(0.0, 1.0, atm.h.shape[0], dtype=atm.t.dtype,
                       device=atm.t.device)
    t = atm.t + 3.0 * (i + 1) * torch.sin((i + 2.0) * x)
    vmr = atm.vmr * (1.0 + 0.1 * (i + 1) * torch.cos((i + 1.0) * x))[:, None]
    return dataclasses.replace(atm, t=t, vmr=vmr)


def _eager(atm, cfg, angles=ANGLES):
    """The nadir forward's layering and path, eagerly."""
    emiss_ang, sol_ang, azi_ang = angles
    layers = apply_dust_renorm(build_layers(atm, cfg, layang=0.0), atm)
    return layers, nadir_path(layers, atm.radius, atm.h[-1], emiss_ang,
                              sol_ang=sol_ang, azi_ang=azi_ang,
                              imod=PathCalc.THERMAL_EMISSION)


def _equal(got, want, where=None):
    for g, w in zip(got, want):
        for field, value in _fields(w).items():
            assert torch.equal(_fields(g)[field], value), (where, field)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def counters(monkeypatch):
    """The runner's counters at 0 and a cache of its own."""
    monkeypatch.setattr(layer_graph, "_graphs", collections.OrderedDict())
    for name in ("captures", "replays", "eager"):
        monkeypatch.setattr(layering_and_path, name, 0)
    return layering_and_path


@pytest.fixture
def cuda():
    """The card, or a skip: CUDA graphs capture only on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs capture only there")
    return torch.device("cuda")


# --- CPU


@pytest.mark.parametrize("name", CASES)
def test_layer_reads_nothing_back_and_copies_nothing(name):
    """Once its constants are made, the layering and the path dispatch no
    read of a tensor's value on the host and no copy of host data: the
    operations a CUDA graph cannot capture."""
    atm, cfg = _case(name, "cpu")
    want = _eager(atm, cfg)
    with _Count() as count:
        got = _eager(_state(atm, 0), cfg)
        got = _eager(atm, cfg)
    assert not HOST_OPS & set(count.ops), count.ops
    assert sum(count.ops.values()) > 300  # the layer is counted at all
    _equal(got, want)


def test_mutation_of_a_host_array_does_not_reach_its_constant():
    """A constant made from a numpy array holds its own copy: writing into
    the array later changes neither the cached tensor nor the next
    result."""
    a = np.array([1.0, 2.0, 3.0])
    t = device_constant(a, torch.float64, "cpu")
    a[0] = 7.0
    assert t.tolist() == [1.0, 2.0, 3.0]
    assert device_constant(a, torch.float64, "cpu").tolist() == [7.0, 2.0,
                                                                  3.0]


def test_constants_made_under_inference_mode_serve_outside_it():
    """A constant first asked for under ``torch.inference_mode`` comes
    from the cache there and is a normal tensor, the same one outside
    it."""
    a = np.array([0.25, 4.5, -1.0, 8.125])
    with torch.inference_mode():
        t = device_constant(a, torch.float32, "cpu")
        assert device_constant(a, torch.float32, "cpu") is t
    assert not t.is_inference()
    assert device_constant(a, torch.float32, "cpu") is t
    x = torch.ones(4, requires_grad=True)
    (x * t).sum().backward()  # an inference tensor could not be saved
    assert x.grad.tolist() == a.tolist()


def _transformed(kind, fn, t):
    if kind == "jacfwd":
        return torch.func.jacfwd(fn)(t)
    if kind == "vmap":
        return torch.func.vmap(fn)(torch.stack([t, t + 1.0]))
    if kind == "requires_grad":
        return fn(t.clone().requires_grad_(True))
    return fn(t)


@pytest.mark.parametrize("kind", ["cpu", "jacfwd", "vmap", "requires_grad"])
def test_graph_declines_and_runs_eagerly(counters, kind):
    """On the CPU, under ``jacfwd`` and ``vmap`` and with a tensor that
    requires grad, the runner counts an eager call and captures nothing;
    the inputs are not plain under each transform."""
    atm, cfg = _case("jupiter_ck", "cpu", torch.float64)
    plain = []

    def temps(t):
        state = dataclasses.replace(atm, t=t)
        plain.append(layer_graph._plain(state.t))
        layers, _ = layering_and_path(state, cfg, *ANGLES)
        return layers.temp

    out = _transformed(kind, temps, atm.t)
    assert torch.isfinite(out).all()
    assert (counters.eager, counters.captures, counters.replays) == (1, 0, 0)
    assert plain == [kind == "cpu"]


def test_tensor_angles_decline():
    """A tensor angle (a location's under ``vmap``) is no key."""
    atm, cfg = _case("jupiter_ck", "cpu")
    assert layer_graph._key(atm, cfg, (torch.tensor(0.0), 0.0, 0.0)) is None


@pytest.mark.parametrize("kind", ["plain", "requires_grad", "no_grad",
                                  "jacfwd", "vmap"])
def test_other_inputs_are_held_to_the_rule(kind):
    """The forward's other inputs (here a k-table structure of the cell)
    keep the graph off where one of their tensors is under a transform,
    carries a tangent or requires grad with grad enabled: autograd would
    save the graphs' outputs, which the next replay overwrites."""
    prog = _program("cpu")
    seen = []

    def rule(k):
        others = (prog.ktab.replace(k=k), None, None, prog.surf, None)
        tensors = list(layer_graph._tensors(others))
        assert any(t is k for t in tensors) and len(tensors) > 6
        seen.append(all(layer_graph._plain(t) for t in tensors))
        return k.sum()

    k = prog.ktab.k.reshape(-1)[:8]  # a few values: jacfwd's is n x n
    if kind == "no_grad":
        with torch.no_grad():
            rule(k.clone().requires_grad_(True))
    else:
        _transformed({"plain": "cpu"}.get(kind, kind), rule, k)
    assert seen == [kind in ("plain", "no_grad")]


def _records(with_replay: int, without: int) -> list:
    def record(replayed):
        names = ["nemesis.layering", "nemesis.path"] + (
            [layer_graph.REPLAY_SPAN] if replayed else [])
        return profiling.ForwardRecord(
            host_ms=1.0, spans={n: profiling.SpanStat(calls=1, stream_ms=0.1)
                                for n in names})
    return ([record(False)] * 3 + [record(True)] * with_replay
            + [record(False)] * without)


def test_layering_graph_pct_reads_the_replay_span(monkeypatch):
    """``layering_graph_pct.fwd``: the share of the last ``traced_calls``
    records that hold the replay span; None on an empty ring."""
    book = mf.load()
    entry = next(m for m in book["per_layer"]
                 if m["name"] == "layering_graph_pct.fwd")
    assert (entry["source"], entry["unit"], entry["layer"],
            entry["moves"]) == ("program_span", "%", "layering and path",
                                "fwd_waves_per_s")
    assert entry["workloads"] == ["jupiter_ck.fwd_stream",
                                  "co_lbl.fwd_stream"]
    reader = mf.metric("layering_graph_pct.fwd")
    assert reader.REPLAY_SPAN == layer_graph.REPLAY_SPAN
    ctx = type("Ctx", (), {"traced_calls": 4})()
    spans = profiling.Spans()
    monkeypatch.setattr(profiling, "spans", spans)
    assert reader.read(ctx) is None
    spans._records.extend(_records(3, 1))
    assert reader.read(ctx) == 75.0
    spans._records.extend(_records(4, 0))
    assert reader.read(ctx) == 100.0


# --- the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_replays_equal_the_eager_bits(cuda, counters, name):
    """Over three consecutive states, each replay's layers and path equal
    the eager code's bit for bit; one capture, three replays; ``own``
    copies are distinct tensors with the same bits."""
    atm, cfg = _case(name, cuda)
    for i in range(3):
        state = _state(atm, i)
        _equal(layering_and_path(state, cfg, *ANGLES), _eager(state, cfg), i)
    assert (counters.captures, counters.replays, counters.eager) == (1, 3, 0)
    own = layering_and_path(atm, cfg, *ANGLES, own=True)
    shared = layering_and_path(atm, cfg, *ANGLES)
    for o, s in zip(own, shared):
        for field, value in _fields(s).items():
            # an empty tensor (no dust) has no storage to tell apart
            assert (_fields(o)[field].data_ptr() != value.data_ptr()
                    or not value.numel())
            assert torch.equal(_fields(o)[field], value), field


@pytest.mark.cuda
def test_viewing_geometries_replay_one_layout(cuda, counters):
    """Forwards over more viewing geometries of one atmosphere than the
    runner keeps layouts (a retrieval's nadir points) capture once and
    replay every geometry, each equal to the eager code at its angles bit
    for bit, in two passes over the geometries."""
    atm, cfg = _case("jupiter_ck", cuda)
    assert len(GEOMETRIES) > layer_graph.KEPT
    for sweep in range(2):
        for i, angles in enumerate(GEOMETRIES):
            state = _state(atm, i)
            _equal(layering_and_path(state, cfg, *angles),
                   _eager(state, cfg, angles), (sweep, angles))
    assert (counters.captures, counters.replays,
            counters.eager) == (1, 2 * len(GEOMETRIES), 0)


def _program(device):
    spec, module = mf.config("jupiter_ck")
    spec = dict(spec, nwave=64)
    return module.Program(spec, 7, device)


def _forward(prog, atm, ktab=None, **kw):
    return fwd.forward_nadir(atm, prog.laycfg, ktab or prog.ktab, None, None,
                             prog.surf, prog.cfg, emiss_ang=0.0,
                             device=prog.device, **kw)


def _eager_runner(atm, laycfg, emiss_ang, sol_ang, azi_ang, others=(),
                  own=False):
    return _eager(atm, laycfg, (emiss_ang, sol_ang, azi_ang))


@pytest.mark.cuda
def test_forward_diagnostics_are_their_own(cuda, counters, monkeypatch):
    """The diagnostics of two consecutive forwards are distinct tensors,
    each holding its own forward's layers and path; the spectra are the
    eager forward's bits."""
    prog = _program(cuda)
    states = [_state(prog.atm, i) for i in range(2)]
    runs = [_forward(prog, s, return_diagnostics=True) for s in states]
    assert counters.replays == 2 and counters.captures == 1
    assert (runs[0][1]["layers"].temp.data_ptr()
            != runs[1][1]["layers"].temp.data_ptr())

    monkeypatch.setattr(fwd, "layering_and_path", _eager_runner)
    for (spec, diag), state in zip(runs, states):
        _equal((diag["layers"], diag["path"]), _eager(state, prog.laycfg))
        assert torch.equal(spec, _forward(prog, state))


@pytest.mark.cuda
def test_forward_under_inference_mode(cuda, counters, monkeypatch):
    """Forwards under ``torch.inference_mode`` replay a layout of their
    own (its buffers are inference tensors) and a forward outside it
    captures another, without a raise; every spectrum is the eager
    forward's bits."""
    prog = _program(cuda)
    states = [_state(prog.atm, i) for i in range(3)]
    with torch.inference_mode():
        specs = [_forward(prog, s) for s in states[:2]]
    specs.append(_forward(prog, states[2]))
    with torch.inference_mode():
        specs.append(_forward(prog, states[2]))
    assert (counters.captures, counters.replays, counters.eager) == (2, 4, 0)
    monkeypatch.setattr(fwd, "layering_and_path", _eager_runner)
    for spec, state in zip(specs, states + states[2:]):
        assert torch.equal(spec, _forward(prog, state))


@pytest.mark.cuda
def test_gradients_are_not_overwritten(cuda, counters):
    """Two layouts laid out before one ``backward()`` through a tensor of
    the forward's other inputs that requires grad: the runner runs them
    eagerly, so autograd keeps each call's own layers, and the gradient of
    the sum is the sum of each call's gradient."""
    atm, cfg = _case("jupiter_ck", cuda)
    states = [_state(atm, i) for i in range(2)]
    w = torch.linspace(0.5, 1.5, cfg.nlay, dtype=atm.t.dtype, device=cuda,
                       requires_grad=True)

    def loss(state):
        layers, path = layering_and_path(state, cfg, *ANGLES, others=(w,))
        return (layers.amount.sum(-1) * w).sum() + (path.scale[:, 0] * w).sum()

    sum(loss(s) for s in states).backward()
    both = w.grad.clone()
    assert (counters.captures, counters.replays, counters.eager) == (0, 0, 2)
    w.grad = None
    each = torch.zeros_like(both)
    for s in states:
        loss(s).backward()
        each += w.grad
        w.grad = None
    assert torch.equal(both, each)
    prog = _program(cuda)
    _forward(prog, prog.atm,
             prog.ktab.replace(k=prog.ktab.k.clone().requires_grad_(True)))
    assert (counters.captures, counters.eager) == (0, 5)


@pytest.mark.cuda
def test_forward_under_jacfwd_declines_and_matches(cuda, counters):
    """A card forward under ``jacfwd`` runs the layering eagerly (no
    capture, no replay) and its primal layers equal the replayed ones."""
    atm, cfg = _case("jupiter_ck", cuda)

    def temps(t):
        layers, _ = layering_and_path(dataclasses.replace(atm, t=t), cfg,
                                      *ANGLES)
        return layers.temp, layers.temp

    jac, primal = torch.func.jacfwd(temps, has_aux=True)(atm.t)
    assert (counters.eager, counters.captures, counters.replays) == (1, 0, 0)
    replayed, _ = layering_and_path(atm, cfg, *ANGLES)
    assert torch.equal(primal, replayed.temp)
    assert torch.isfinite(jac).all() and jac.abs().sum() > 0


@pytest.mark.cuda
def test_replays_do_not_synchronise_and_leave_their_span(cuda, counters):
    """After the capture, replays run under ``set_sync_debug_mode("error")``
    without a raise; a traced forward's record holds the replay span twice
    (the layering's and the path's) beside the layering and path spans."""
    atm, cfg = _case("co_lbl", cuda)
    layering_and_path(atm, cfg, *ANGLES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(4):
            layering_and_path(_state(atm, i), cfg, *ANGLES)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (counters.captures, counters.replays) == (1, 5)

    prog = _program(cuda)
    _forward(prog, prog.atm)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        _forward(prog, _state(prog.atm, 1))
    record = profiling.forward_records(1)[0]
    assert record.spans[layer_graph.REPLAY_SPAN].calls == 2
    assert {"nemesis.layering", "nemesis.path"} <= set(record.spans)
