"""The multiple-scattering cell ``jupiter_scatter_ms.scat_stream`` at a
cut width on the CPU: the port's adding-doubling forward
(``forward.forward_scattering_nadir``) against the plain reference
``nembench/reference/scattering.py`` in float64, the reference against
the ``scatter_core`` golden, the cell through the harness, the bfloat16
control and planted faults not correct, the reference's isolation from
the program, and the least-time count of ``nembench/harness/
scatter_bounds.py``.

Cut sizes: ``jupiter_scatter_ms`` at 64 waves spread over its window
(bands and windows), NG = 4, 11 levels, 8 layers (NMU = 5, NF = 2, NPHI
= 100 as configured)."""

import copy
import dataclasses
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from archnemesis_tpu_torch.rt import scattering as sc
from nembench.control import run_control
from nembench.harness import loop
from nembench.harness import manifest as mf
from nembench.harness import scatter_bounds
from nembench.harness import traffic as tf
from nembench.reference import scattering as ref_sc
from port_cases import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CELL = "jupiter_scatter_ms.scat_stream"
CONFIG = "jupiter_scatter_ms"
SEED = 2**31 + 11
CORE_GOLDEN = "tests/goldens/scatter_core.npz"


def cut(dtype: str) -> dict:
    """``jupiter_scatter_ms`` at a width a CPU test holds."""
    spec = copy.deepcopy(mf.config(CONFIG)[0])
    spec.update(nwave=64, grid_nwave=64, ng=4, table_ng=8, nlevel=11,
                nlay=8, nint=11, dtype=dtype)
    return spec


def _states(spec, n, seed):
    _, module = mf.config(CONFIG)
    return tf.states(dict(mf.traffic("scat_stream"), states=n),
                     module.profiles(spec)["t"], len(spec["scaled_gases"]),
                     seed, "cpu")


def test_port_matches_the_reference_in_float64():
    """The port's spectrum is the reference's at every wave to 1e-8: the
    two sum in other orders (the overlap's sort, Gauss-Jordan with and
    without pivoting, Hansen's sweeps stopped per wave or over all) and
    agree to ~1e-13 (6e-14 measured)."""
    spec = cut("float64")
    _, module = mf.config(CONFIG)
    program = module.Program(spec, SEED, "cpu")
    reference = module.Reference(spec, SEED, "cpu")
    t, mult = _states(spec, 2, 5)
    for i in range(2):
        got = program.forward(t[i], mult[i])
        want = reference.forward(t[i], mult[i], np.arange(spec["nwave"]))
        assert want.min() > 0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8,
                                   atol=0)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


@pytest.mark.parametrize("key", ["RAD_thermal", "RAD_sun",
                                 "RAD_surface_sun"])
def test_reference_matches_the_scatter_core_golden(key):
    """The reference on the golden's core inputs (one two-term HG mode,
    Rayleigh, NF = 2, four waves, two paths) against archNEMESIS's
    radiances, at the port's own golden test's tolerance (rtol 1e-10)."""
    d = np.load(CORE_GOLDEN)
    nwave, nmu, nf = d["vwaves"].shape[0], d["MU"].shape[0], int(d["NF"])
    surface = None
    if key == "RAD_surface_sun":  # a Lambert ground of albedo 0.3
        surface = np.zeros((nwave, nmu, nmu, nf + 1))
        surface[..., 0] = 0.3 / np.pi
    f, g1, g2 = (_t(d[k])[:, None, None, None] for k in ("f", "g1", "g2"))
    got = ref_sc.radiance(
        d["MU"], d["WTMU"], nf, int(d["NPHI"]),
        [lambda c: ref_sc.henyey_greenstein2(c[None], f, g1, g2)],
        _t(d["bnu"]), _t(d["taus"]), _t(d["tauray"]),
        _t(d["tauscat_aero"]), _t(d["lfrac"]), _t(d["radg"]),
        _t(d["solar"]) * float(key != "RAD_thermal"), d["SOL_ANGS"],
        d["EMISS_ANGS"], d["APHIS"],
        surface=None if surface is None else _t(surface))
    np.testing.assert_allclose(got.numpy(), d[key], rtol=1e-10, atol=0)


def _sunlit_core(seed):
    """Seeded core inputs where sunlight and Rayleigh's phase shape the
    radiance: 6 waves, 3 g, 5 layers, one HG mode, a bright Sun."""
    rng = np.random.default_rng(seed)
    nwave, ng, nlay = 6, 3, 5
    tauray = rng.uniform(0.05, 0.5, (nwave, nlay))
    tauscat = rng.uniform(0.05, 1.0, (nwave, nlay))
    taus = (tauray + tauscat)[:, None, :] + rng.uniform(
        0.0, 0.3, (nwave, ng, nlay))
    return dict(
        bnu=rng.uniform(1e-8, 5e-8, (nwave, nlay)), taus=taus, tauray=tauray,
        tauscat=tauscat, lfrac=np.ones((nwave, 1, nlay)),
        radg=rng.uniform(1e-8, 3e-8, (nwave, 5)),
        solar=np.full(nwave, 4e-7), hg=(0.8, 0.7, -0.4))


@pytest.mark.parametrize("fault", [None, "fourier_components_dropped",
                                   "rayleigh_phase_dropped"])
def test_port_core_against_the_reference_in_sunlight(fault):
    """Where sunlight and Rayleigh scattering shape the radiance, the
    port's core is the reference's to 1e-10; the port without the Fourier
    components above 0, or without Rayleigh's phase function, misses it by
    more than 1e-3, on inputs of their own (the cell's check sees both
    faults too: ``test_planted_fault_is_not_correct``)."""
    inp = _sunlit_core(17)
    mu, wt = np.polynomial.legendre.leggauss(10)
    mu, wt = mu[mu > 0], wt[mu > 0]
    f, g1, g2 = inp["hg"]
    angles = dict(sol_ang=[30.0, 50.0], emiss_ang=[20.0, 40.0],
                  azi_ang=[0.0, 120.0])
    want = ref_sc.radiance(
        mu, wt, 2, 100, [lambda c: ref_sc.henyey_greenstein2(c, f, g1, g2)],
        *(_t(inp[k]) for k in ("bnu", "taus", "tauray", "tauscat", "lfrac",
                               "radg", "solar")), **angles)
    nf = 0 if fault == "fourier_components_dropped" else 2
    quad = sc.ScatterQuadrature(mu=tuple(mu), wtmu=tuple(wt), nf=nf, nphi=100)
    got = sc.scloud11wave(
        quad, [lambda c: sc.henyey_greenstein2(c, f, g1, g2)],
        **{k: _t(inp[k]) for k in ("bnu", "taus", "tauray", "tauscat",
                                   "lfrac", "radg", "solar")},
        iray=fault != "rayleigh_phase_dropped", **angles)
    err = ((got - want).abs() / want.abs()).max().item()
    if fault is None:
        assert err < 1e-10
    else:
        assert err > 1e-3


def _run(spec, program=None, trace=False, calls=2):
    return loop.run_cell(mf.load(), CELL, SEED, 0.0, trace, "cpu",
                         time.perf_counter(), spec=spec, program=program,
                         min_calls=calls)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cell_on_the_cpu(dtype):
    """In float64 the port's checked spectrum is the reference's (to 1e-10,
    6e-14 measured); in float32 the run is correct under the cell's limit
    (1.6e-4 measured). Either way the result line holds the cell's
    end-to-end metrics."""
    result = _run(cut(dtype))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"fwd_waves_per_s", "setup_s"}
    if dtype == "float64":
        assert result["checks"]["spec_rel_err"]["value"] < 1e-10


def _patched(fault):
    """A context that plants ``fault`` in the port's scattering core."""
    if fault == "series_everywhere":
        # the series E + Rsub R1 in place of every inverse
        combine = sc._combine
        return mock.patch.object(
            sc, "_combine", lambda *args, thresh, frob_of_rsq: combine(
                *args, thresh=float("inf"), frob_of_rsq=frob_of_rsq))
    if fault == "ladder_one_step":
        double = sc._double_layer
        return mock.patch.object(
            sc, "_double_layer", lambda *args: double(*args[:9], 1))
    if fault == "ladder_one_short":
        # nn - 1 doublings of the same thin layer: a layer of half the
        # optical depth
        double = sc._double_layer
        return mock.patch.object(
            sc, "_double_layer",
            lambda *args: double(*args[:3], args[3] / 2, *args[4:]))
    combine_path = sc.combine_path
    return mock.patch.object(
        sc, "combine_path", lambda rl, tl, jl, j_on, **kw: combine_path(
            rl.flip(0), tl.flip(0), jl.flip(0), j_on, **kw))


def broken(fault):
    """A program factory: the port with ``fault`` planted in its
    scattering core."""

    def factory(spec, seed, device):
        _, module = mf.config(CONFIG)
        program = module.Program(spec, seed, device)
        if fault == "fourier_components_dropped":
            program.quad = dataclasses.replace(program.quad, nf=0)
            return program
        if fault == "rayleigh_phase_dropped":
            forward = program._forward
            program._forward = lambda *args, **kw: forward(
                *args, **{**kw, "iray_phase": False})
            return program

        class Broken:
            def forward(self, t, mult):
                with _patched(fault):
                    return program.forward(t, mult)

        return Broken()

    return factory


@pytest.mark.parametrize("fault", [
    "ladder_one_step", "ladder_one_short", "layers_added_top_first",
    "fourier_components_dropped", "rayleigh_phase_dropped",
    "series_everywhere"])
def test_planted_fault_is_not_correct(fault):
    """Faults in the ladder, in the adding, in the Fourier sum, in the
    phase function and in the inverse's branch fail the check: in reflected
    sunlight each shapes the spectrum (at this cut: 0.15, 2.8e-2 and
    2.5e-3 for the last three, the cell's limit 5e-4)."""
    result = _run(cut("float32"), program=broken(fault))
    assert not result["correct"], result["checks"]


def test_control_is_not_correct():
    result = run_control(mf.load(), CELL, 20261019, "cpu",
                         spec=cut("float32"))
    assert not result["correct"], result["checks"]
    # in bfloat16 the path's Gauss-Jordan inverses give no finite spectrum
    check = result["checks"]["spec_rel_err"]
    assert check["value"] == "nan" or check["value"] > check["limit"]


def test_reference_loads_nothing_of_the_program():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c",
         "import nembench.reference.scattering, nembench.harness."
         "scatter_bounds\nimport sys\nprint(' '.join(sorted({m.split('.')[0]"
         " for m in sys.modules})))"],
        cwd=root, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": root})
    loaded = set(out.stdout.split())
    assert "nembench" in loaded
    assert not loaded & {"archnemesis_tpu_torch", "archnemesis_tpu", "jax",
                         "jaxlib"}


def test_bound_counts_the_ladders_and_the_path():
    """archNEMESIS's doubling count per layer (int(log2 tau + 12), at most
    35, none below 1 or at tau <= 0) plus NLAY - 1 path combines per (wave,
    g), for each Fourier component; a combine of 5 x 5 layers on its series
    branch is 1,460 operations; the bytes are the inputs and the radiance,
    once."""
    taut = np.array([[[2.0**-12, 2.0**-11.5, 1.0, 2.0**30, 0.0]]])
    # nn: 0, 0 (int(0.5)), 12, 35 (capped), none
    assert scatter_bounds.doublings(taut) == 12 + 35
    assert scatter_bounds.combines(taut, nf=2) == 3 * (47 + 4)
    assert scatter_bounds.combine_ops(5) == 1460
    # 5 optical depths; 5 x (3 + 2) per-layer words; 3 components x 3
    # phase functions x 2 x 25; 1 radiance
    assert scatter_bounds.io_bytes((1, 1, 5), 2, 5, 2, 4) == 4 * (
        5 + 25 + 450 + 1)
    assert scatter_bounds.least_ms(taut, 2, 5, 2, 4) == pytest.approx(
        3 * 51 * 1460 / 67e12 * 1e3, rel=1e-12)


def test_bound_holds_an_on_chip_ladder():
    """A kernel that keeps every ladder and the path on the chip, at the
    float32 peak, reads at most 100 %: its time is its operations (every
    combine with its inverse, as the series branch may not be taken) or
    the inputs and radiance at HBM bandwidth, whichever is the larger;
    deeper ladders raise the bound."""
    rng = np.random.default_rng(3)
    for shape in [(128, 10, 39), (16, 4, 8), (1, 1, 80)]:
        taut = np.exp(rng.uniform(-14.0, 10.0, shape))
        n = scatter_bounds.combines(taut, 2)
        ops = n * (scatter_bounds.combine_ops(5) + 2 * 5**3)
        io = scatter_bounds.io_bytes(shape, 2, 5, 2, 4)
        kernel_ms = max(ops / 67e12, io / 3.35e12) * 1e3
        assert scatter_bounds.least_ms(taut, 2, 5, 2, 4) <= kernel_ms
        deeper = scatter_bounds.least_ms(taut * 2.0**10, 2, 5, 2, 4)
        assert deeper > scatter_bounds.least_ms(taut, 2, 5, 2, 4)


def test_manifest_holds_the_scattering_cell():
    book = mf.load()
    cell = mf.cell(book, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "scat_stream", 1)
    names = [m["name"] for m in mf.metrics_of(book, "per_layer", CELL)]
    assert names == ["scatter_phase_ms.scat", "doubling_ms.scat",
                     "adding_ms.scat", "host_ms_per_call.scat",
                     "host_syncs_per_call.scat", "scatter_roofline_pct.scat",
                     "device_ms_per_call.scat", "device_idle_pct.scat",
                     "launches_per_call.scat", "layering_ms.scat",
                     "kinterp_ms.scat", "overlap_ms.scat"]
    for name in names:
        mf.metric(name)
    sizes, _ = mf.config(CONFIG)
    base, _ = mf.config("jupiter_ck")
    for key in ("gas_id", "iso_id", "scaled_gases", "planet", "nlevel",
                "nint", "profile", "dtype"):
        assert sizes[key] == base[key], key
    # jupiter_ck's table moved to the window: its bands' place, width and
    # strength
    moved = ("band_min", "band_max", "band_width", "scale")
    assert {k: v for k, v in sizes["ktable"].items() if k not in moved} \
        == {**{k: v for k, v in base["ktable"].items() if k not in moved},
            "band_seed": 0}
    assert (sizes["wave_min"], sizes["wave_max"]) == (10000.0, 12500.0)
    assert (sizes["nwave"], sizes["grid_nwave"], sizes["ng"],
            sizes["nlay"]) == (2048, 2048, 10, 39)
    assert sizes["table_ng"] == base["ng"]
    assert sizes["scattering"] == {"nmu": 5, "nf": 2, "nphi": 100,
                                   "wave_tile": 128}
    assert sizes["solar"]["t_eff_k"] == 5778.0
    assert set(sizes["limits"]) == {"spec_rel_err"}
