"""Solar occultation (``forward_so``, ``forward_so_aotf``,
``make_retrieval_setup_so``) and the Titan FOV deck of the PyTorch port
against the JAX package and the reference goldens (``mars_so_fm``,
``mars_so_aotf_fm``, ``titan_fov_fm``), the Mars deck read from its
``.npz`` export where the card reads it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu.enums import InstrumentLineshape as JShape
from archnemesis_tpu.forward import forward_so as jax_forward_so
from archnemesis_tpu.forward import forward_so_aotf as jax_forward_aotf
from archnemesis_tpu.forward import make_forward_config as jax_cfg
from archnemesis_tpu.forward import so_geometry as jax_so_geometry
from archnemesis_tpu.io.hdf5 import load_deck_hdf5 as jax_load_h5
from archnemesis_tpu.ops.convolution import apply_ils as jax_apply_ils
from archnemesis_tpu.ops.convolution import ils_weights_lbl
from archnemesis_tpu.retrieval.statevector import apply_state as jax_apply
from archnemesis_tpu.retrieval.statevector import read_apr as jax_read_apr
from archnemesis_tpu.retrievals import make_retrieval_setup_so as jax_setup_so
from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
from archnemesis_tpu_torch.retrievals import (
    make_retrieval_setup_so,
    retrieval_nemesis,
)
from port_cases import SO_H5, np64, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DECK, RUN = chip_smoke.SO_DECK, chip_smoke.SO_RUN
TANHE_SHIFT = 0.37  # km, inside the tangent paths' span


@pytest.fixture(scope="module")
def decks():
    return chip_smoke.so_deck(), jax_load_h5(SO_H5)


def _jax_tables(kt, wave, pad=0.0):
    w = np.asarray(kt.wave)
    sel = np.where((w >= wave.min() - pad) & (w <= wave.max() + pad))[0]
    return kt.replace(wave=w[sel], k=np.asarray(kt.k)[:, sel])


def _jax_state(deck, ones=False, hydrostat=False):
    sv = jax_read_apr(f"{DECK}/{RUN}.apr", deck.atmosphere)
    x = np.ones_like(sv.xa) if ones else sv.xa
    return jax_apply(deck.atmosphere, x, sv, adjust_hydrostat=hydrostat)


@pytest.mark.parametrize("shift", [None, TANHE_SHIFT],
                         ids=["static", "tanhe_shift"])
def test_forward_so_matches_jax(decks, shift):
    """The golden case of tests/test_forward_so.py in both packages: the
    layering, paths, layer optical depths, the path transmissions and the
    convolved spectrum at rtol 1e-10, with the static stencil and with a
    tangent-height shift (model 777's differentiable search)."""
    deck, jdeck = decks
    got, _, diag = chip_smoke.so_golden_spectrum(
        deck, "cpu",
        tanhe_shift=None if shift is None else torch.tensor(shift,
                                                            dtype=torch.float64))
    d = np.load(chip_smoke.SO_GOLDEN)
    atm = _jax_state(jdeck)
    ktw = _jax_tables(jdeck.ktables, d["WAVE"])
    cfg = jax_cfg(atm, ktw, None, iray=jdeck.settings.iray,
                  ispace=jdeck.settings.ispace, gasgiant=True)
    geo = jax_so_geometry(atm, jdeck.layer_config, d["TANHE"])
    spec, jdiag = jax_forward_so(atm, jdeck.layer_config, ktw, None,
                                 jdeck.aerosol, cfg, geo,
                                 return_diagnostics=True, tanhe_shift=shift)
    nconv = int(d["NCONV"][0])
    w = ils_weights_lbl(d["WAVE"], d["VCONV"][:nconv, 0], jdeck.geometry.fwhm,
                        JShape(jdeck.settings.ishape))
    want = np.asarray(jax_apply_ils(jnp.asarray(w), spec))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-300)
    np.testing.assert_allclose(np64(diag["layers"].baseh),
                               np.asarray(jdiag["layers"].baseh), rtol=1e-12)
    np.testing.assert_array_equal(np64(diag["paths"].layinc),
                                  np.asarray(jdiag["paths"].layinc))
    # atol: XLA flushes the deepest tangents' subnormal transmissions to 0
    for name in ("taugas", "tautot", "spec_paths"):
        np.testing.assert_allclose(np64(diag[name]),
                                   np.asarray(jdiag[name]), rtol=1e-10,
                                   atol=np.finfo(np.float64).tiny,
                                   err_msg=name)
    np.testing.assert_allclose(np64(diag["paths"].scale),
                               np.asarray(jdiag["paths"].scale), rtol=1e-12)


def test_forward_so_aotf_matches_jax(decks):
    """The three-order AOTF sum of tests/test_forward_so_aotf.py in both
    packages, at rtol 1e-10."""
    deck, jdeck = decks
    got, _ = chip_smoke.aotf_golden_spectrum(deck, "cpu")
    d = np.load(chip_smoke.AOTF_GOLDEN)
    atm = _jax_state(jdeck, ones=True)
    nconv = int(d["NCONV"][0])
    kts, cfgs, convs = [], [], []
    for o in range(d["VCONV_AOTF"].shape[2]):
        wave_o = d[f"WAVE_O{o}"]
        kt = _jax_tables(jdeck.ktables, wave_o, pad=1e-9)
        kts.append(kt)
        cfgs.append(jax_cfg(atm, kt, None, iray=jdeck.settings.iray,
                            ispace=jdeck.settings.ispace, gasgiant=True))
        w = ils_weights_lbl(wave_o, d["VCONV_AOTF"][:nconv, 0, o],
                            jdeck.geometry.fwhm,
                            JShape(jdeck.settings.ishape))
        convs.append(functools.partial(lambda wv, s, w: jax_apply_ils(w, s),
                                       w=jnp.asarray(w)))
    geo = jax_so_geometry(atm, jdeck.layer_config, d["TANHE"])
    want = np.asarray(jax_forward_aotf(atm, jdeck.layer_config, kts, None,
                                       jdeck.aerosol, cfgs, geo, convs,
                                       d["TRANS_AOTF"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("name", ["mars_so_fm", "mars_so_aotf_fm",
                                  "titan_fov_fm"])
def test_goldens(decks, name):
    """The reference goldens at the JAX tests' tolerances (SO and AOTF rtol
    1e-6 / atol 1e-10, Titan rtol 1e-5), the Mars deck from the export."""
    chip_smoke.occultation_golden_cases()[name](decks[0], "cpu")


@pytest.fixture(scope="module")
def setups():
    return (make_retrieval_setup_so(DECK, RUN, device="cpu"),
            jax_setup_so(DECK, RUN))


def test_so_setup_matches_jax(setups):
    """``forward_fn`` at the a priori (6,015 channels over 15 tangent
    heights) at rtol 1e-10, and the JVP of each of the two state columns
    within 1e-10 of its peak."""
    port, jx = setups
    assert port.sv.nx == 2 and port.y.shape == jx.y.shape
    np.testing.assert_array_equal(port.y, jx.y)
    np.testing.assert_array_equal(np.diag(port.se), np.diag(jx.se))
    x = torch.as_tensor(port.sv.xa)
    got = port.forward_fn(x).numpy()
    want = np.asarray(jx.forward_fn(jnp.asarray(jx.sv.xa)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-300)
    for col in range(2):
        v = np.zeros(2)
        v[col] = 1.0
        _, dy = torch.func.jvp(port.forward_fn, (x,), (torch.as_tensor(v),))
        _, jdy = jax.jvp(jx.forward_fn, (jnp.asarray(jx.sv.xa),),
                         (jnp.asarray(v),))
        jdy = np.asarray(jdy)
        err = np.abs(dy.numpy() - jdy).max() / np.abs(jdy).max()
        assert err < 1e-10, (col, err)


def test_so_setup_reads_the_export(setups):
    """The set-up on the ``.npz`` export equals the one on the ``.h5``."""
    port, _ = setups
    export = make_retrieval_setup_so(DECK, RUN, device="cpu",
                                     deck_file=chip_smoke.SO_EXPORT)
    x = torch.as_tensor(port.sv.xa)
    torch.testing.assert_close(export.forward_fn(x), port.forward_fn(x),
                               rtol=0, atol=0)


def test_float32_so_setup_holds_float64(setups):
    """float32 within 1e-4 of float64 (spectrum) and each Jacobian column
    within ``JAC_F32_BOUND`` of its peak: the window and the ILS weights
    come from the float64 grid (a float32 grid at 4,167 cm-1 moved the
    0.16 cm-1 Gaussian's weights by 3e-4 and the spectrum by 4.9e-3)."""
    port, _ = setups
    s32 = make_retrieval_setup_so(DECK, RUN, device="cpu",
                                  dtype=torch.float32)
    x = torch.as_tensor(port.sv.xa)
    y64, k64 = forward_and_jacobian(port.forward_fn, x)
    y32, k32 = forward_and_jacobian(s32.forward_fn, x.float())
    assert s32.deck.ktables.wave.dtype == torch.float32
    np.testing.assert_array_equal(
        s32.deck.ktables.wave.double().numpy(),
        port.deck.ktables.wave.float().double().numpy())
    r = chip_smoke.rel_err(y32.double().numpy(), y64.numpy())
    assert r.max() < chip_smoke.F32_BOUNDS[0], r.max()
    col_err, misses = chip_smoke.jacobian_column_misses(k32, k64,
                                                        port.sv.entries)
    assert not misses, col_err


def test_so_retrieval_one_iteration():
    """``retrieval_nemesis(nemesis_so=True)`` on the export: one OE step,
    finite, phi not rising."""
    res = retrieval_nemesis(DECK, RUN, nemesis_so=True, niter=1,
                            write_outputs=False, device="cpu",
                            deck_file=chip_smoke.SO_EXPORT)
    assert res.kk.shape == (6015, 2) and np.all(np.isfinite(res.xn))
    assert res.phi_history[-1] <= res.phi_history[0]


def _so_copy(tmp_path, blocks) -> str:
    """A copy of the SO deck (run file and .apr, the tables linked beside
    it at ``../ltatables``) whose .apr also holds the model fixture blocks
    ``blocks`` (``tests/fixtures/models``)."""
    import os
    import shutil

    os.symlink(os.path.abspath("tests/fixtures/ltatables"),
               tmp_path / "ltatables")
    deck = tmp_path / "so"
    deck.mkdir()
    shutil.copy(SO_H5, deck)
    apr = open(f"{DECK}/{RUN}.apr").read().splitlines()
    apr[1] = f"\t{int(apr[1]) + len(blocks)}"
    text = "\n".join(apr) + "\n" + "".join(chip_smoke._apr_block(b)
                                          for b in blocks)
    (deck / f"{RUN}.apr").write_text(text)
    return str(deck)


def test_so_setup_with_model_777_matches_jax(tmp_path):
    """A retrieved tangent-height shift (model 777) through
    ``apply_domain`` and the stencil's differentiable search: forward and
    the shift's JVP column against the JAX set-up's at 1e-10."""
    deck = _so_copy(tmp_path, ["m777_tanhe"])
    port = make_retrieval_setup_so(deck, RUN, device="cpu")
    jx = jax_setup_so(deck, RUN)
    assert port.sv.nx == 3 and port.sv.entries[-1].model_id == 777
    x = torch.as_tensor(port.sv.xa)
    v = torch.zeros(3, dtype=torch.float64)
    v[2] = 1.0
    y, dy = torch.func.jvp(port.forward_fn, (x,), (v,))
    jy, jdy = jax.jvp(jx.forward_fn, (jnp.asarray(jx.sv.xa),),
                      (jnp.asarray(v.numpy()),))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-10,
                               atol=1e-300)
    jdy = np.asarray(jdy)
    assert np.abs(jdy).max() > 0
    assert np.abs(dy.numpy() - jdy).max() / np.abs(jdy).max() < 1e-10


def test_model_447_with_static_weights_raises(tmp_path):
    """A retrieved Doppler velocity with the deck's static FWHM > 0 weights
    is refused, as the JAX set-up refuses it."""
    deck = _so_copy(tmp_path, ["m447_doppler"])
    with pytest.raises(NotImplementedError, match="447"):
        make_retrieval_setup_so(deck, RUN, device="cpu")
