"""The instrument functions of the PyTorch port that depend on the state,
against the JAX package and the reference golden
(``tests/goldens/ils_models.npz``): the double-Gaussian ILS weights and
models 228-230 (rtol 1e-12 against JAX, 5e-4 against the golden, the
interpolation limit of the reference's sample-then-interpolate filters),
and the filter integration with a retrieved Doppler shift on
``tests/test_instrument_ext.py``'s synthetic filter (rtol 1e-12 against
the JAX loop over channels, its tangent in the velocity at rtol 1e-8 of
``jax.grad``); and the ``models_ils`` deck through the retrieval set-up
(``chip_smoke.models_ils_deck``: jupiter_nadir's channels cut to 600-1300
cm-1 with FWHM < 0, model 0, the ILS of model 229 and a retrieved Doppler
shift, 447) and a filter-integration deck
(``port_cases.models_filter_deck``: IFORM = Integrated_radiance with
model 447), each forward at the a priori against JAX's at rtol 1e-8 and a
JVP column per model family within 1e-8 of its peak
(``port_cases.models_deck_case``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu.models import MODEL_REGISTRY as JAX_MODELS
from archnemesis_tpu.models.base import ModelEntry as JEntry
from archnemesis_tpu.models.base import ProfileTarget as JTarget
from archnemesis_tpu.ops import convolution as jconv
from archnemesis_tpu_torch.models import MODEL_REGISTRY
from archnemesis_tpu_torch.ops import convolution as pconv
from port_cases import (  # noqa: F401
    models_deck_case,
    models_filter_deck,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the JVP columns of the models_ils deck, one per model family (ILS,
# measurement): (model id, offset in its block)
ILS_COLUMNS = {"ils_229_fwhm": (229, 4), "doppler_447": (447, 0)}


@pytest.fixture(scope="module")
def d():
    return np.load(chip_smoke.ILS_GOLDEN)


def _jentry(model_id, nx, extra=()):
    return JEntry(varident=(model_id, 0, model_id), model_id=model_id, ix=0,
                  nx=nx, target=JTarget.NOT_ATMOSPHERIC, extra=extra)


def _extra(model_id, d):
    if model_id != 230:
        return ()
    return (2, tuple((float(lo), float(hi))
                     for lo, hi in zip(d["LIML"], d["LIMH"])))


def test_double_gauss_weights_match_jax():
    rng = np.random.default_rng(2)
    wave = np.linspace(1000.0, 1100.0, 700)
    vconv = np.linspace(1010.0, 1090.0, 30)
    off = rng.uniform(-0.5, 0.5, (30, 2))
    fw = rng.uniform(0.6, 3.0, (30, 2))
    amp = np.stack([np.ones(30), rng.uniform(0.1, 0.6, 30)], axis=1)
    want = np.asarray(jconv.double_gauss_ils_weights(
        jnp.asarray(wave), jnp.asarray(vconv), jnp.asarray(off),
        jnp.asarray(fw), jnp.asarray(amp)))
    got = pconv.double_gauss_ils_weights(
        wave, torch.as_tensor(vconv), torch.as_tensor(off),
        torch.as_tensor(fw), torch.as_tensor(amp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-12)


def test_double_gauss_weights_float32_mask_before_normalising():
    """In float32 the far Gaussians underflow to 0; the support mask keeps
    every row finite and normalised. The weights follow float64 within the
    float32 rounding of the grid (|wave| eps / sigma ~ 1e-3 of a row's
    peak at FWHM 0.3 cm-1 near 1000 cm-1)."""
    wave = np.linspace(1000.0, 1100.0, 700)
    vconv = np.linspace(1010.0, 1090.0, 30)
    args = [np.zeros((30, 2)), np.full((30, 2), 0.3),
            np.stack([np.ones(30), np.full(30, 0.4)], axis=1)]
    w64 = pconv.double_gauss_ils_weights(
        wave, torch.as_tensor(vconv), *map(torch.as_tensor, args))
    w32 = pconv.double_gauss_ils_weights(
        wave.astype(np.float32), torch.as_tensor(vconv, dtype=torch.float32),
        *(torch.as_tensor(a, dtype=torch.float32) for a in args))
    assert torch.isfinite(w32).all()
    np.testing.assert_allclose(w32.double().sum(dim=1).numpy(), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(w32.double().numpy(), w64.numpy(), rtol=0,
                               atol=5e-3 * float(w64.max()))


@pytest.mark.parametrize("model_id", [228, 229, 230])
def test_ils_model_matches_jax(model_id, d):
    nx = {228: 8, 229: 7, 230: 14}[model_id]
    x = chip_smoke.ils_parameters(model_id, d)
    extra = _extra(model_id, d)
    want = JAX_MODELS[model_id].apply_ils(
        _jentry(model_id, nx, extra), 0, jnp.asarray(d["VCONV"]),
        jnp.asarray(x))
    got = MODEL_REGISTRY[model_id].apply_ils(
        chip_smoke.model_entry(model_id, nx, extra), 0,
        torch.as_tensor(d["VCONV"]), torch.as_tensor(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-300)


@pytest.mark.parametrize("name", ["m228_ils", "m229_ils", "m230_ils"])
def test_golden(name):
    chip_smoke.model_golden_cases()[name]("cpu")


def test_ils_jacobian_matches_jax(d):
    """``torch.func.jacfwd`` through model 229's parameters and the ILS
    weights against ``jax.jacfwd``, within 1e-8 of the peak."""
    x = chip_smoke.ils_parameters(229, d)
    jac = torch.func.jacfwd(lambda p: chip_smoke.ils_model_spectrum(
        229, p, "cpu", d)[1])(torch.as_tensor(x)).numpy()

    def jf(p):
        vc, off, fw, amp = JAX_MODELS[229].apply_ils(
            _jentry(229, 7), 0, jnp.asarray(d["VCONV"]), p)
        w = jconv.double_gauss_ils_weights(jnp.asarray(d["WAVE"]), vc, off,
                                           fw, amp)
        return jconv.apply_ils(w, jnp.asarray(d["SPEC"]))

    want = np.asarray(jax.jacfwd(jf)(jnp.asarray(x)))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(jac, want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


@pytest.fixture(scope="module")
def filt():
    """The synthetic three-channel filter of tests/test_instrument_ext.py."""
    rng = np.random.default_rng(7)
    wave = np.linspace(1200.0, 1210.0, 801)
    spec = 1.0 + 0.3 * np.sin(wave) + 0.05 * rng.standard_normal(wave.size)
    vconv = np.array([1202.0, 1205.0, 1208.0])
    nfil = np.array([21, 31, 11], dtype="int32")
    nmax = nfil.max()
    vfil = np.zeros((nmax, 3))
    afil = np.zeros((nmax, 3))
    for j, hw in enumerate([0.8, 1.2, 0.5]):
        n = nfil[j]
        vfil[:n, j] = np.linspace(vconv[j] - hw, vconv[j] + hw, n)
        afil[:n, j] = np.exp(-(((vfil[:n, j] - vconv[j]) / (0.5 * hw)) ** 2))
    return wave, spec, nfil, vfil, afil


@pytest.mark.parametrize("v,nominal,ispace", [
    (3.0, None, 0), (0.0, None, 0), (2.9, 3.0, 0), (-40.0, -40.0, 0),
    (3.0, None, 1)])
def test_integrate_filter_matches_jax(filt, v, nominal, ispace):
    wave, spec, nfil, vfil, afil = filt
    want = np.asarray(jconv.integrate_filter_apply(
        wave, jnp.asarray(spec), nfil, vfil, afil, v_doppler=v,
        ispace=ispace, v_doppler_nominal=nominal))
    got = pconv.integrate_filter_apply(
        wave, torch.as_tensor(spec), nfil, vfil, afil, v_doppler=v,
        ispace=ispace, v_doppler_nominal=nominal).numpy()
    assert np.abs(want).min() > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # the static weight matrix of the nominal grid gives the same numbers
    if nominal is None:
        wc = pconv.doppler_corrected_wave(wave, v, ispace)
        w = pconv.integrate_filter_weights(
            wc, np.array([1202.0, 1205.0, 1208.0]), nfil, vfil, afil)
        np.testing.assert_allclose(w @ spec, got, rtol=1e-10)


def test_integrate_filter_channel_with_one_member_is_zero(filt):
    """A channel whose filter span holds fewer than two calc points
    integrates to 0, as in the JAX loop."""
    wave, spec, nfil, vfil, afil = filt
    vfil, nfil = vfil.copy(), nfil.copy()
    vfil[:2, 2] = [1208.0, 1208.005]  # narrower than one grid step
    nfil[2] = 2
    got = pconv.integrate_filter_apply(wave, torch.as_tensor(spec), nfil,
                                       vfil, afil, v_doppler=1.0).numpy()
    want = np.asarray(jconv.integrate_filter_apply(
        wave, jnp.asarray(spec), nfil, vfil, afil, v_doppler=1.0))
    assert got[2] == want[2] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_integrate_filter_tangent_in_doppler_matches_jax_grad(filt):
    wave, spec, nfil, vfil, afil = filt

    def jf(v):
        return jnp.sum(jconv.integrate_filter_apply(
            wave, jnp.asarray(spec), nfil, vfil, afil, v_doppler=v,
            ispace=0, v_doppler_nominal=3.0))

    def pf(v):
        return pconv.integrate_filter_apply(
            wave, torch.as_tensor(spec), nfil, vfil, afil, v_doppler=v,
            ispace=0, v_doppler_nominal=3.0)

    want = float(jax.grad(jf)(3.0))
    jac = torch.func.jacfwd(pf)(torch.tensor(3.0, dtype=torch.float64))
    np.testing.assert_allclose(float(jac.sum()), want, rtol=1e-8)


# --- the "dynamic" ILS through the retrieval set-up


@pytest.fixture(scope="module")
def ils(tmp_path_factory):
    return models_deck_case(tmp_path_factory, chip_smoke.models_ils_deck,
                            ILS_COLUMNS)


def test_models_ils_setup(ils):
    """89 state elements on 350 channels; every channel's FWHM spans
    several calc points (2.5 cm-1) and the calc range the set-up widens
    for the ILS stays inside the k-tables (5-1500 cm-1)."""
    from archnemesis_tpu_torch.retrieval.statevector import apply_ils_models

    port = ils["port"]
    assert port.sv.nx == 89 and ils["y"].shape == (350,)
    vconv = port.vconv_list[0]
    vc, off, fw, _ = (t.numpy() for t in apply_ils_models(
        port.sv, port.sv.xa, 0, torch.as_tensor(vconv)))
    assert fw.min() > 3 * 2.5
    half = 2.5 * fw.max() + np.abs(off).max()
    assert 5.0 < vc.min() - 1.5 * half and vc.max() + 1.5 * half < 1500.0


def test_models_ils_forward_matches_jax(ils):
    assert np.all(ils["y"] > 0)
    np.testing.assert_allclose(ils["y"], ils["jy"], rtol=1e-8, atol=0)


@pytest.mark.parametrize("column", list(ILS_COLUMNS))
def test_models_ils_jvp_matches_jax(ils, column):
    got, want = ils["dy"][column], ils["jdy"][column]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


# --- filter integration with a retrieved Doppler shift through the set-up

FILTER_COLUMNS = {"doppler_447": (447, 0), "temperature_0": (0, 40)}


@pytest.fixture(scope="module")
def filt_deck(tmp_path_factory):
    return models_deck_case(tmp_path_factory, models_filter_deck,
                            FILTER_COLUMNS)


def test_filter_integration_forward_matches_jax(filt_deck):
    """IFORM = Integrated_radiance with model 447: the set-up integrates
    each channel's filter on the grid the state moves, per evaluation."""
    assert filt_deck["y"].shape == (15,) and np.all(filt_deck["y"] > 0)
    np.testing.assert_allclose(filt_deck["y"], filt_deck["jy"], rtol=1e-8,
                               atol=0)


@pytest.mark.parametrize("column", list(FILTER_COLUMNS))
def test_filter_integration_jvp_matches_jax(filt_deck, column):
    got, want = filt_deck["dy"][column], filt_deck["jdy"][column]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-8 * np.abs(want).max())

