"""The thermal emission's forward-mode rule (``rt/emission.py:
path_emission_spectrum``, ``ops/tangent_cuda.py:emission_tangent``):
``forward.py:path_spectrum`` under tangents against the ops it ran before
(``thermal_emission_spectrum`` on the gathered optical depths, then the
g-integration) under ``torch.func``, and against the JAX package's
``jax.jacfwd``, in float64; the cases where it stays out; and on the card
(``cuda``: skipped without one) the kernel against the plain version and
its one launch an evaluation.

Tolerances: against today's ops under ``jacfwd`` 1e-10 of each column's
peak (the rule sums the layers from the far end of the path, the ops'
rules from the near end: the two agree to a few units in the last place
of the column's largest terms); against JAX the same, its transmissions'
difference in place of expm1 costs some 1e-14 at these optical depths."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu_torch.core.spectra import SurfaceSpec
from archnemesis_tpu_torch.enums import PathCalc
from archnemesis_tpu_torch.forward import path_spectrum
from archnemesis_tpu_torch.ops import tangent_cuda
from archnemesis_tpu_torch.rt.emission import thermal_emission_spectrum
from archnemesis_tpu_torch.rt.path import Paths
from archnemesis_tpu_torch.utils.interp import interp1d_extrap
from port_cases import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NX = 5  # tau scale, tau shape, path scale, temperatures, surface


@dataclasses.dataclass(frozen=True)
class _Cfg:
    gasgiant: bool
    ispace: int = 0


@pytest.fixture
def cuda():
    """The card, or a skip: the kernel is built with nvcc and has no CPU
    mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is built with nvcc "
                    "and has no CPU mode")
    return torch.device("cuda")


def make_case(kind: str, nwave=9, ng=4, nlay=7, nloc=None, seed=0,
              ispace=0) -> dict:
    """Numpy inputs of one geometry: ``nadir`` (a gas giant seen from
    above), ``surface`` (a solid surface with a temperature and an
    emissivity), ``limb`` (three paths, masked tails, no ground); with
    ``nloc`` a leading location axis on the optical depths and paths."""
    rng = np.random.default_rng(seed)
    lead = () if nloc is None else (nloc,)
    if kind == "limb":
        layinc, mask = chip_smoke.limb_layers(nlay, [0, 2, 4])
    else:
        layinc = np.arange(nlay - 1, -1, -1, dtype=np.int64)[:, None]
        mask = np.ones((nlay, 1))
    nlayin, npath = layinc.shape
    depth = np.exp(np.linspace(-3.0, 1.5, nlay))  # deeper layers thicker
    case = dict(
        kind=kind, ispace=ispace,
        wave=(np.linspace(250.0, 1400.0, nwave) if ispace == 0
              else np.linspace(7.0, 40.0, nwave)),
        del_g=0.5 * np.polynomial.legendre.leggauss(ng)[1],
        # (..., NWAVE, NLAY, NG) as the random overlap leaves it
        tau=(depth[:, None] * rng.uniform(0.05, 1.5, lead + (nwave, nlay,
                                                             ng))),
        a=rng.normal(0.0, 1.0, lead + (nwave, nlay, ng)),
        b=np.linspace(-1.0, 1.0, nlay)[:, None] * np.ones((nlay, ng)),
        layinc=np.broadcast_to(layinc, lead + layinc.shape).copy(),
        mask=np.broadcast_to(mask, lead + mask.shape).copy(),
        scale=rng.uniform(1.0, 2.5, lead + (nlayin, npath)),
        c=rng.normal(0.0, 0.3, lead + (nlayin, npath)),
        emtemp=rng.uniform(110.0, 290.0, lead + (nlayin, npath)),
        d=rng.normal(0.0, 0.2, lead + (nlayin, npath)),
        tsurf=250.0, vem=np.linspace(200.0, 1500.0, 5),
        emis=rng.uniform(0.7, 1.0, 5),
        x=np.array([0.3, -0.2, 0.1, 0.05, 0.02]),
    )
    return case


def _state(xp, x, case):
    """(tautot (NWAVE, NG, NLAY), scale, emtemp, tsurf, emissivity on
    vem) at state x, in numpy-like namespace ``xp`` (torch or jax.numpy)
    on the case's arrays (already in that namespace)."""
    tau = case["tau"] * xp.exp(x[0] * case["a"] + x[1] * case["b"])
    tau = xp.swapaxes(tau, -1, -2)  # (NWAVE, NG, NLAY), a permuted view
    scale = case["scale"] * (1.0 + x[2] * case["c"])
    emtemp = case["emtemp"] * (1.0 + x[3] * case["d"])
    tsurf = case["tsurf"] * (1.0 + x[4])
    emis = case["emis"] * (1.0 - 0.5 * x[4])
    return tau, scale, emtemp, tsurf, emis


def _torch_case(case, dtype=torch.float64, device="cpu"):
    out = {}
    for k, v in case.items():
        if isinstance(v, np.ndarray):
            kind = torch.int64 if v.dtype == np.int64 else dtype
            out[k] = torch.as_tensor(v, dtype=kind, device=device)
        else:
            out[k] = v
    return out


def _paths(layinc, scale, emtemp, mask, kind, like):
    zeros = like.new_zeros(layinc.shape[-1])
    return Paths(layinc=layinc, scale=scale, emtemp=emtemp, mask=mask,
                 sol_ang=zeros, emiss_ang=zeros, azi_ang=zeros,
                 imod=PathCalc.THERMAL_EMISSION,
                 surface_visible=kind != "limb")


def spectrum(tc, x, old=False, emission_layer=None):
    """The port's (NWAVE, NPATH) spectrum of case ``tc`` at state x: by
    ``path_spectrum``, or with ``old`` by the ops it ran before this rule
    (the gathered optical depths through ``thermal_emission_spectrum``)."""
    tau, scale, emtemp, tsurf, emis = _state(torch, x, tc)
    layinc, mask = tc["layinc"], tc["mask"]
    kind = tc["kind"]
    cfg = _Cfg(gasgiant=kind != "surface", ispace=tc["ispace"])
    wave, del_g = tc["wave"], tc["del_g"]
    surf = None
    if kind == "surface":
        surf = SurfaceSpec(tsurf=tsurf, vem=tc["vem"], emissivity=emis,
                           galb=wave.new_tensor(-1.0), gasgiant=False)
    if not old:
        path = _paths(layinc, scale, emtemp, mask, kind, wave)
        return path_spectrum(cfg, wave, tau, path, surf, del_g,
                             emission_layer=emission_layer)
    if surf is not None:
        emissivity, t_s = interp1d_extrap(tc["vem"], emis, wave), tsurf
    else:
        emissivity, t_s = torch.zeros_like(wave), wave.new_tensor(-1.0)
    emission_path = (None if emission_layer is None
                     else emission_layer[:, layinc] * scale[None])
    spec = thermal_emission_spectrum(
        wave, tau[:, :, layinc] * scale[None, None], emtemp, mask, t_s,
        emissivity, kind != "limb", cfg.gasgiant, ispace=tc["ispace"],
        emission_path=emission_path)
    return torch.einsum("wgp,g->wp", spec, del_g)


def assert_columns_close(got, want, rel):
    """Each column (the last axis: a state element) within ``rel`` of its
    peak."""
    got, want = np.asarray(got), np.asarray(want)
    peak = np.abs(want).reshape(-1, want.shape[-1]).max(axis=0)
    assert (peak > 0).all()
    err = np.abs(got - want).reshape(-1, want.shape[-1]).max(axis=0)
    assert (err <= rel * peak).all(), err / peak


@pytest.mark.parametrize("kind, ispace", [("nadir", 0), ("surface", 0),
                                          ("limb", 0), ("nadir", 1)])
def test_jacobian_equals_todays_ops(kind, ispace):
    """jacfwd through the rule against jacfwd through the ops, with the
    primal bit for bit; every state element moves the spectrum."""
    tc = _torch_case(make_case(kind, ispace=ispace))
    x = tc["x"]
    calls = tangent_cuda.emission_tangent.calls
    assert torch.equal(spectrum(tc, x), spectrum(tc, x, old=True))
    got = torch.func.jacfwd(lambda z: spectrum(tc, z))(x)
    assert tangent_cuda.emission_tangent.calls == calls + 1
    want = torch.func.jacfwd(lambda z: spectrum(tc, z, old=True))(x)
    cols = slice(None) if kind == "surface" else slice(0, 4)
    assert_columns_close(got[..., cols], want[..., cols], 1e-10)
    if kind != "surface":  # no surface: its element moves nothing
        assert torch.equal(got[..., 4], torch.zeros_like(got[..., 4]))


def test_single_tangent_jvp():
    """One ``torch.func.jvp``: the tangent Function called outside any
    vmap, on one tangent."""
    tc = _torch_case(make_case("surface", seed=3))
    v = torch.linspace(-1.0, 1.0, NX, dtype=torch.float64)
    calls = tangent_cuda.emission_tangent.calls
    y, dy = torch.func.jvp(lambda z: spectrum(tc, z), (tc["x"],), (v,))
    assert tangent_cuda.emission_tangent.calls == calls + 1
    y0, dy0 = torch.func.jvp(lambda z: spectrum(tc, z, old=True),
                             (tc["x"],), (v,))
    assert torch.equal(y, y0)
    assert_columns_close(dy[:, :, None], dy0[:, :, None], 1e-10)


@pytest.mark.parametrize("nest", ["jacfwd_of_vmap", "vmap_of_jacfwd"])
def test_locations_under_vmap(nest):
    """Three locations' paths (the multi-location forward's vmap) inside
    and outside ``jacfwd``: one call of the rule for all of them, the
    Jacobians of the ops."""
    nloc = 3
    tc = _torch_case(make_case("limb", nloc=nloc, seed=5))
    xs = tc["x"][None] * torch.linspace(0.5, 1.5, nloc,
                                        dtype=torch.float64)[:, None]
    # the arrays with a location axis, vmapped over
    parts = {k: v for k, v in tc.items() if isinstance(v, torch.Tensor)
             and v.dim() > 0 and v.shape[0] == nloc}

    def jac(old):
        def one(z, part):
            return spectrum({**tc, **part}, z, old=old)

        if nest == "jacfwd_of_vmap":
            return torch.func.jacfwd(
                lambda z: torch.func.vmap(one)(z, parts))(xs)
        return torch.func.vmap(torch.func.jacfwd(one))(xs, parts)

    calls = tangent_cuda.emission_tangent.calls
    got = jac(old=False)
    assert tangent_cuda.emission_tangent.calls == calls + 1
    want = jac(old=True)
    assert_columns_close(got[..., :4], want[..., :4], 1e-10)
    assert torch.equal(got[..., 4], torch.zeros_like(got[..., 4]))


def test_stays_out_without_tangents_or_with_layer_emission():
    """No tangent (a forward, a vmap over states), or a non-LTE layer
    emission: the ops of before, and no call of the rule; with the layer
    emission the Jacobian is still the ops'."""
    tc = _torch_case(make_case("nadir", seed=7))
    x = tc["x"]
    calls = tangent_cuda.emission_tangent.calls
    spectrum(tc, x)
    torch.func.vmap(lambda z: spectrum(tc, z))(torch.stack([x, 0.5 * x]))
    emission = torch.rand(tc["wave"].shape[0], tc["tau"].shape[-2],
                          generator=torch.Generator().manual_seed(1),
                          dtype=torch.float64) * 1e-7
    got = torch.func.jacfwd(
        lambda z: spectrum(tc, z, emission_layer=emission))(x)
    assert tangent_cuda.emission_tangent.calls == calls
    want = torch.func.jacfwd(
        lambda z: spectrum(tc, z, old=True, emission_layer=emission))(x)
    assert torch.equal(got, want)


def test_emission_fused_pct_reads_the_tangent_span(monkeypatch):
    """``emission_fused_pct.jac``: the share of the last ``traced_calls``
    evaluation records that hold the rule's span; None on an empty ring;
    and a traced Jacobian leaves the span in its record."""
    from archnemesis_tpu_torch.rt.emission import TANGENT_SPAN
    from archnemesis_tpu_torch.utils import profiling
    from nembench.harness import manifest as mf

    entry = next(m for m in mf.load()["per_layer"]
                 if m["name"] == "emission_fused_pct.jac")
    assert (entry["source"], entry["unit"], entry["layer"], entry["moves"],
            entry["workloads"]) == (
        "program_span", "%", "Rayleigh, emission, g-integration",
        "fwd_waves_per_s", ["jupiter_ck_oe.jac_iter"])
    reader = mf.metric("emission_fused_pct.jac")
    assert reader.TANGENT_SPAN == TANGENT_SPAN
    ctx = type("Ctx", (), {"traced_calls": 4})()
    spans = profiling.Spans()
    monkeypatch.setattr(profiling, "spans", spans)
    assert reader.read(ctx) is None

    def record(fused):
        names = ["nemesis.spectrum"] + [TANGENT_SPAN] * fused
        return profiling.JacobianRecord(
            host_ms=1.0, spans={n: profiling.SpanStat(calls=1)
                                for n in names}, peak_bytes=None)

    spans._jacobians.extend([record(False)] * 2 + [record(True)] * 3
                            + [record(False)])
    assert reader.read(ctx) == 75.0
    spans._jacobians.extend([record(True)] * 4)
    assert reader.read(ctx) == 100.0


def _jax_spectrum(case, x):
    """The JAX package's ``path_spectrum`` of the case at state x."""
    import jax.numpy as jnp

    from archnemesis_tpu.core.spectra import SurfaceSpec as JaxSurface
    from archnemesis_tpu.enums import PathCalc as JaxPathCalc
    from archnemesis_tpu.forward import path_spectrum as jax_path_spectrum
    from archnemesis_tpu.rt.path import Paths as JaxPaths

    jc = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in case.items()}
    tau, scale, emtemp, tsurf, emis = _state(jnp, x, jc)
    kind = case["kind"]
    zeros = jnp.zeros(case["layinc"].shape[-1])
    path = JaxPaths(layinc=jc["layinc"], scale=scale, emtemp=emtemp,
                    mask=jc["mask"], sol_ang=zeros, emiss_ang=zeros,
                    azi_ang=zeros, imod=JaxPathCalc.THERMAL_EMISSION,
                    surface_visible=kind != "limb")
    surf = None
    if kind == "surface":
        surf = JaxSurface(tsurf=tsurf, vem=jc["vem"], emissivity=emis,
                          galb=jnp.asarray(-1.0), gasgiant=False)
    cfg = _Cfg(gasgiant=kind != "surface", ispace=case["ispace"])
    return jax_path_spectrum(cfg, jc["wave"], tau, path, surf, jc["del_g"])


@pytest.mark.parametrize("kind", ["nadir", "surface", "limb"])
def test_jacobian_equals_jax(kind):
    """The rule's Jacobian against the JAX package's ``jax.jacfwd``."""
    import jax

    case = make_case(kind, seed=11)
    tc = _torch_case(case)
    got = torch.func.jacfwd(lambda z: spectrum(tc, z))(tc["x"]).numpy()
    want = np.asarray(jax.jacfwd(lambda z: _jax_spectrum(case, z))(
        jax.numpy.asarray(case["x"])))
    cols = slice(None) if kind == "surface" else slice(0, 4)
    assert_columns_close(got[..., cols], want[..., cols], 1e-10)


def test_plain_version_is_the_tangent_of_the_ops():
    """``emission_tangent_plain`` on a multi-location limb case: each
    tangent is the jvp of the g-integrated ops of each location's paths."""
    kw = chip_smoke.emission_tangent_case(torch.float64, "cpu", kind="limb",
                                          nwave=5, ng=3, nlay=6, n_tan=2,
                                          nloc=2)
    got = tangent_cuda.emission_tangent(**kw)
    nb, group = 2, kw["group"]
    for b in range(nb):
        ps = slice(b * group, (b + 1) * group)

        def ops(tau, scale, emtemp):
            spec = thermal_emission_spectrum(
                kw["wave"], tau[:, :, kw["layinc"][:, ps]] * scale[None,
                                                                    None],
                emtemp, kw["mask"][:, ps], None, None, False, True)
            return torch.einsum("wgp,g->wp", spec, kw["del_g"])

        for t in range(2):
            _, want = torch.func.jvp(
                ops, (kw["tau"][b], kw["scale"][:, ps], kw["emtemp"][:, ps]),
                (kw["dtau"][t, b], kw["dscale"][t, :, ps],
                 kw["demtemp"][t, :, ps]))
            assert_columns_close(got[t, :, ps][..., None], want[..., None],
                                 1e-12)


def _kernel_vs_plain(kw, device):
    """(max error over each tangent's peak, launches) of the kernel on the
    card against the plain version in float64 on the CPU."""
    ref = tangent_cuda.emission_tangent_plain(**{
        k: (v.cpu().double() if isinstance(v, torch.Tensor)
            and v.is_floating_point() else
            v.cpu() if isinstance(v, torch.Tensor) else v)
        for k, v in kw.items()})
    before = tangent_cuda.emission_tangent.launches
    got = tangent_cuda.emission_tangent(**kw)
    torch.cuda.synchronize(device)
    launched = tangent_cuda.emission_tangent.launches - before
    return chip_smoke.emission_tangent_errors(got.cpu(), ref), launched


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rel", [
    (torch.float32, chip_smoke.EMISSION_F32_REL), (torch.float64, 1e-12)])
@pytest.mark.parametrize("kind, nloc", [("nadir", None), ("limb", None),
                                        ("nadir", 3)])
def test_kernel_matches_plain_on_card(cuda, dtype, rel, kind, nloc):
    """Nadir, limb (three paths, masked tails, no ground) and three
    locations' paths in one launch, float32 and float64, within ``rel``
    of each tangent's peak of the float64 plain version."""
    kw = chip_smoke.emission_tangent_case(dtype, cuda, kind=kind,
                                          nwave=301, nloc=nloc,
                                          n_tan=86 if nloc is None else 9)
    err, launched = _kernel_vs_plain(kw, cuda)
    assert launched == 1
    assert err < rel


@pytest.mark.cuda
def test_one_launch_an_evaluation_on_card(cuda):
    """jacfwd of the spectrum on the card: one launch, the CPU's
    Jacobian."""
    case = make_case("surface", nwave=33, ng=20, nlay=30, seed=13)
    got = {}
    for device in ("cpu", cuda):
        tc = _torch_case(case, device=device)
        before = tangent_cuda.emission_tangent.launches
        got[str(device)] = torch.func.jacfwd(
            lambda z: spectrum(tc, z))(tc["x"]).cpu()
        if device == cuda:
            assert tangent_cuda.emission_tangent.launches == before + 1
    assert_columns_close(got[str(cuda)], got["cpu"], 1e-12)
