"""The nadir thermal-emission forward of the PyTorch port vs the JAX package
and the reference golden.

- the jupiter_nadir deck, read with the port's readers: layer optical depths
  and spectrum within rtol 1e-8 of JAX ``forward_nadir`` (float64), and
  within the JAX tests' rtol 1e-5 of ``tests/goldens/jupiter_nadir_fm.npz``
  (SPECONV included);
- the synthetic 7-gas headline configuration cut to 64 waves (20 g x 71
  layers x 7 gases): port vs JAX in float64, and port float32 vs float64
  within 1e-4 max / 1e-5 median relative error;
- the LBL-table and transmission/absorption branches vs JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.enums import PathCalc as JaxPathCalc
from archnemesis_tpu.enums import SpectralCalculationMode as JaxMode
from archnemesis_tpu.forward import forward_nadir as jax_forward_nadir
from archnemesis_tpu.forward import path_spectrum as jax_path_spectrum
from archnemesis_tpu.ops.convolution import (
    conv_channel_interp as jax_conv_channel_interp,
)
from archnemesis_tpu.rt.layer import build_layers as jax_build_layers
from archnemesis_tpu.rt.path import nadir_path as jax_nadir_path
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.enums import PathCalc, SpectralCalculationMode
from archnemesis_tpu_torch.forward import forward_nadir, path_spectrum
from archnemesis_tpu_torch.rt.layer import build_layers
from archnemesis_tpu_torch.rt.path import nadir_path
from chip_smoke import F32_BOUNDS, cast, deck_forward, golden_deck, rel_err
from port_cases import (
    FM_GOLDEN,
    flat,
    jax_golden_deck,
    jax_headline_deck,
    np64,
    to_port,
)

TAUS = ("taugas", "taucia", "tauray", "taudust", "tauscat", "tautot")


def _jax_forward(deck):
    atm, laycfg, ktab, cia, aero, surf, cfg = deck

    @jax.jit
    def fwd(atm, ktab, cia, aero, surf):
        return jax_forward_nadir(atm, laycfg, ktab, cia, aero, surf, cfg,
                                 emiss_ang=0.0, sol_ang=180.0,
                                 return_diagnostics=True)

    spec, diag = fwd(atm, ktab, cia, aero, surf)
    return np.asarray(spec), {k: np.asarray(diag[k]) for k in TAUS}


def _port_forward(deck):
    atm, laycfg, ktab, cia, aero, surf, cfg = deck
    spec, diag = forward_nadir(atm, laycfg, ktab, cia, aero, surf, cfg,
                               emiss_ang=0.0, sol_ang=180.0,
                               return_diagnostics=True, device="cpu")
    return np64(spec), {k: np64(diag[k]) for k in TAUS}


@pytest.fixture(scope="module")
def deck_runs():
    jdeck = jax_golden_deck()
    deck = golden_deck("cpu")
    spec, conv, diag = deck_forward(deck, "cpu")
    return dict(jax=_jax_forward(jdeck), port_spec=np64(spec),
                port_conv=np64(conv), port_diag={k: np64(diag[k]) for k in TAUS},
                jdeck=jdeck, deck=deck)


@pytest.mark.parametrize("name", TAUS + ("spec",))
def test_deck_matches_jax(deck_runs, name):
    jspec, jdiag = deck_runs["jax"]
    if name == "spec":
        got, want = deck_runs["port_spec"], jspec[:, 0]
    else:
        got, want = deck_runs["port_diag"][name], jdiag[name]
    atol = 1e-14 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=atol, err_msg=name)


@pytest.mark.parametrize("name,key", [("taugas", "TAUGAS"),
                                      ("taucia", "TAUCIA"),
                                      ("tauray", "TAURAY"),
                                      ("taudust", "TAUDUST"),
                                      ("tautot", "TAUTOT"),
                                      ("speconv", "SPECONV")])
def test_deck_matches_golden(deck_runs, name, key):
    dfm = np.load(FM_GOLDEN)
    if name == "speconv":
        nconv = int(dfm["NCONV"][0])
        got, want = deck_runs["port_conv"], dfm["SPECONV"][:nconv, 0]
        # the port's channel interpolation is the JAX package's
        jconv = np.asarray(jax_conv_channel_interp(
            dfm["WAVE"], deck_runs["jax"][0][:, 0], dfm["VCONV"][:nconv, 0]))
        np.testing.assert_allclose(got, jconv, rtol=1e-8, atol=0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        return
    got, want = deck_runs["port_diag"][name], dfm[key]
    atol = 1e-14 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=name)


def test_converted_deck_equals_read_deck(deck_runs):
    """The JAX deck carried across with ``convert`` holds exactly the numbers
    of the deck read with the port's readers."""
    converted = to_port(deck_runs["jdeck"])
    for a, b in zip(converted, deck_runs["deck"]):
        assert type(a) is type(b)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                torch.testing.assert_close(x, y, rtol=0, atol=0,
                                           msg=f"{type(a).__name__}.{f.name}")
            else:
                assert x == y, (type(a).__name__, f.name)


def test_deck_float32_within_bounds_of_float64(deck_runs):
    _, conv32, _ = deck_forward(cast(deck_runs["deck"], torch.float32), "cpu")
    assert conv32.dtype == torch.float32
    r = rel_err(np64(conv32), deck_runs["port_conv"])
    assert r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1], (
        r.max(), np.median(r))


@pytest.fixture(scope="module")
def headline_runs():
    jdeck = jax_headline_deck(64)
    deck = to_port(jdeck)
    return dict(jax=_jax_forward(jdeck), port=_port_forward(deck), deck=deck)


@pytest.mark.parametrize("name", TAUS + ("spec",))
def test_headline_matches_jax(headline_runs, name):
    (jspec, jdiag), (spec, diag) = headline_runs["jax"], headline_runs["port"]
    got, want = (spec, jspec) if name == "spec" else (diag[name], jdiag[name])
    assert got.shape == want.shape
    atol = 1e-14 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=atol, err_msg=name)


def test_headline_float32_within_bounds_of_float64(headline_runs):
    from archnemesis_tpu_torch.synthetic import headline_deck

    atm, laycfg, ktab, surf, cfg = headline_deck(64, torch.float32, "cpu")
    assert ktab.logk is not None
    spec = forward_nadir(atm, laycfg, ktab, None, None, surf, cfg,
                         emiss_ang=0.0, device="cpu")
    assert spec.dtype == torch.float32 and spec.shape == (64, 1)
    r = rel_err(np64(spec), headline_runs["port"][0])
    assert r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1], (
        r.max(), np.median(r))


def test_headline_deck_is_the_arrays():
    """``headline_deck`` in float64 holds exactly ``headline_arrays``."""
    from archnemesis_tpu_torch.synthetic import headline_arrays, headline_deck

    a = headline_arrays(16)
    atm, _, ktab, _, _ = headline_deck(16, torch.float64, "cpu")
    for name, x in (("h", atm.h), ("vmr", atm.vmr), ("wave", ktab.wave),
                    ("k", ktab.k), ("del_g", ktab.del_g)):
        np.testing.assert_array_equal(x.numpy(), a[name], err_msg=name)


@pytest.fixture(scope="module")
def lbl_case(headline_runs):
    """The headline configuration at 16 waves with NG=1 tables (the
    LBL-table mode): JAX and port structures."""
    jatm, jlaycfg, jktab, _, _, jsurf, jcfg = jax_headline_deck(16)
    jktab = jktab.replace(k=jktab.k[:, :, :1], g_ord=jktab.g_ord[:1],
                          del_g=np.ones(1), ilbl=JaxMode.LINE_BY_LINE_TABLES)
    jcfg = dataclasses.replace(jcfg, del_g=(1.0,))
    jdeck = (jatm, jlaycfg, jktab, None, None, jsurf, jcfg)
    return jdeck, to_port(jdeck)


def test_lbl_table_branch_matches_jax(lbl_case):
    jdeck, deck = lbl_case
    assert deck[2].ilbl == SpectralCalculationMode.LINE_BY_LINE_TABLES
    (jspec, jdiag), (spec, diag) = _jax_forward(jdeck), _port_forward(deck)
    assert diag["taugas"].shape == (16, 1, 71)
    np.testing.assert_allclose(diag["taugas"], jdiag["taugas"], rtol=1e-10)
    np.testing.assert_allclose(spec, jspec, rtol=1e-10)


def test_runtime_lbl_branch_raises(lbl_case):
    """k-tables flagged ILBL=1 are refused: the runtime branch synthesises
    from a RuntimeLBL's line lists (tests/test_torch_runtime_*.py)."""
    _, (atm, laycfg, ktab, _, _, surf, cfg) = lbl_case
    ktab = ktab.replace(ilbl=SpectralCalculationMode.LINE_BY_LINE_RUNTIME)
    with pytest.raises(TypeError, match="needs a RuntimeLBL"):
        forward_nadir(atm, laycfg, ktab, None, None, surf, cfg,
                      emiss_ang=0.0, device="cpu")


@pytest.mark.parametrize("imod", ["ABSORBTION", "PLANCK_FUNCTION_AT_BIN_CENTRE"])
def test_path_spectrum_branches_match_jax(headline_runs, imod):
    """The absorption and transmission branches of ``path_spectrum``, on
    each package's own optical depths of the headline configuration."""
    jatm, jlaycfg, jktab, _, _, jsurf, jcfg = jax_headline_deck(64)
    atm, laycfg, ktab, _, _, surf, cfg = headline_runs["deck"]
    jpath = jax_nadir_path(jax_build_layers(jatm, jlaycfg), jatm.radius,
                           jatm.h[-1], 40.0, imod=JaxPathCalc[imod])
    path = nadir_path(build_layers(atm, laycfg), atm.radius, atm.h[-1], 40.0,
                      imod=PathCalc[imod])
    jtautot = jnp.asarray(headline_runs["jax"][1]["tautot"])
    tautot = torch.as_tensor(headline_runs["port"][1]["tautot"])
    want = np.asarray(jax_path_spectrum(jcfg, jktab.wave, jtautot, jpath,
                                        jsurf, jktab.del_g))
    got = path_spectrum(cfg, ktab.wave, tautot, path, surf, ktab.del_g)
    np.testing.assert_allclose(np64(got), want, rtol=1e-8, atol=1e-300)


def test_forward_config_carried_across():
    jcfg = jax_golden_deck()[-1]
    cfg = convert.forward_config(flat(jcfg))
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


def _reflection_case(gasgiant: bool, seed: int = 16):
    """Inputs of ``thermal_emission_spectrum`` with a visible surface and
    the solar reflection term: three paths, the first with both angles
    under 90, the second with the solar angle at 95, the third with the
    emission angle at 91."""
    rng = np.random.default_rng(seed)
    nwave, ng, nlay, npath = 12, 3, 6, 3
    return dict(
        wave=np.linspace(600.0, 720.0, nwave),
        tau_path=rng.uniform(0.01, 0.4, (nwave, ng, nlay, npath)),
        emtemp=rng.uniform(120.0, 260.0, (nlay, npath)),
        mask=np.ones((nlay, npath)),
        tsurf=np.asarray(240.0),
        emissivity=rng.uniform(0.8, 1.0, nwave),
        surface_visible=True,
        gasgiant=gasgiant,
        solflux=rng.uniform(1e-7, 5e-7, nwave),
        reflectance=rng.uniform(0.05, 0.3, nwave),
        sol_ang=np.array([40.0, 95.0, 20.0]),
        emiss_ang=np.array([30.0, 10.0, 91.0]),
    )


@pytest.mark.parametrize("gasgiant", [False, True])
def test_surface_reflection_matches_jax(gasgiant):
    """The surface-reflection branch of ``thermal_emission_spectrum`` in
    float64 at rtol 1e-10 against JAX, called with JAX's parameters by
    keyword; the term is zero on the paths with an angle of 90 or more."""
    from archnemesis_tpu.rt.emission import (
        thermal_emission_spectrum as jax_emission,
    )
    from archnemesis_tpu_torch.rt.emission import thermal_emission_spectrum

    case = _reflection_case(gasgiant)
    flags = ("surface_visible", "gasgiant")
    want = np.asarray(jax_emission(**{
        k: (v if k in flags else jnp.asarray(v)) for k, v in case.items()}))
    port = {k: (v if k in flags else torch.as_tensor(v))
            for k, v in case.items()}
    got = np64(thermal_emission_spectrum(**port))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    bare = np64(thermal_emission_spectrum(**{
        k: v for k, v in port.items() if k not in ("solflux",
                                                     "reflectance")}))
    np.testing.assert_array_equal(got[:, :, 1:], bare[:, :, 1:])
    assert (got[:, :, 0] > bare[:, :, 0] * (1.0 + 1e-6)).all()
