"""Primary transit (``forward_transit``, ``make_retrieval_setup_transit``)
of the PyTorch port against the JAX package and the reference golden
``mars_transit_fm``: the Mars SO deck made a transit run as
tests/test_retrieval_transit.py makes it (IFORM = TransitDepth and a
``Stellar`` group), as an ``.h5`` for both packages and as an edited
``.npz`` export for the card."""

import os
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu.enums import InstrumentLineshape as JShape
from archnemesis_tpu.forward import forward_transit as jax_forward_transit
from archnemesis_tpu.forward import make_forward_config as jax_cfg
from archnemesis_tpu.io.hdf5 import load_deck_hdf5 as jax_load_h5
from archnemesis_tpu.ops.convolution import apply_ils as jax_apply_ils
from archnemesis_tpu.ops.convolution import ils_weights_lbl
from archnemesis_tpu.retrieval.statevector import apply_state as jax_apply
from archnemesis_tpu.retrieval.statevector import read_apr as jax_read_apr
from archnemesis_tpu.retrievals import (
    make_retrieval_setup_transit as jax_setup_transit,
)
from archnemesis_tpu_torch.core.spectra import cast_deck
from archnemesis_tpu_torch.forward import forward_transit, make_forward_config
from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
from archnemesis_tpu_torch.retrievals import make_retrieval_setup_transit
from port_cases import SO_H5, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DECK, RUN = chip_smoke.SO_DECK, chip_smoke.SO_RUN


@pytest.fixture(scope="module")
def decks():
    return chip_smoke.so_deck(), jax_load_h5(SO_H5)


def test_forward_transit_matches_jax(decks):
    """The golden case of tests/test_disc_transit.py in both packages (the
    .apr state with the hydrostatic rebalance): the path transmissions and
    the convolved depth at rtol 1e-10."""
    deck, jdeck = decks
    got, _, trans = chip_smoke.transit_golden_spectrum(deck, "cpu")
    d = np.load(chip_smoke.TRANSIT_GOLDEN)
    sv = jax_read_apr(f"{DECK}/{RUN}.apr", jdeck.atmosphere)
    atm = jax_apply(jdeck.atmosphere, sv.xa, sv, adjust_hydrostat=True)
    w = np.asarray(jdeck.ktables.wave)
    sel = np.where((w >= d["WAVE"].min()) & (w <= d["WAVE"].max()))[0]
    ktw = jdeck.ktables.replace(wave=w[sel],
                                k=np.asarray(jdeck.ktables.k)[:, sel])
    cfg = jax_cfg(atm, ktw, jdeck.cia, iray=jdeck.settings.iray,
                  ispace=jdeck.settings.ispace, gasgiant=True)
    depth, diag = jax_forward_transit(
        atm, jdeck.layer_config, ktw, jdeck.cia, None, cfg,
        stellar_radius_km=float(d["STELLAR_RADIUS_KM"]),
        return_diagnostics=True)
    ils = ils_weights_lbl(np.asarray(ktw.wave), d["VCONV"],
                          jdeck.geometry.fwhm, JShape(jdeck.settings.ishape))
    want = np.asarray(jax_apply_ils(jnp.asarray(ils), depth))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)
    assert trans.shape == (d["WAVE"].size, jdeck.layer_config.nlay - 1)
    np.testing.assert_allclose(trans.numpy(), np.asarray(diag["trans"]),
                               rtol=1e-10, atol=np.finfo(np.float64).tiny)


def test_golden(decks):
    """``mars_transit_fm`` at rtol 1e-5 (tests/test_disc_transit.py), the
    deck from the export."""
    chip_smoke.occultation_golden_cases()["mars_transit_fm"](decks[0], "cpu")


def test_float32_transit_depth_holds_float64(decks):
    """``1 - trans`` in float32 (the JAX package's order of operations)
    keeps the depth within 1e-6 of float64: the planet's disc dominates
    the depth, and the transmissions stay below 0.9981 (no cancellation
    of numbers near 1 worth ``-expm1``)."""
    deck, _ = decks
    d = np.load(chip_smoke.TRANSIT_GOLDEN)
    out = {}
    for dtype in (torch.float64, torch.float32):
        atm = chip_smoke._so_state(deck, "cpu", hydrostat=True)
        atm = cast_deck(atm, dtype)
        kt = cast_deck(chip_smoke.golden_tables(deck.ktables, d["WAVE"]),
                       dtype)
        cfg = make_forward_config(atm, kt, None, iray=0, ispace=0)
        depth, diag = forward_transit(
            atm, deck.layer_config, kt, None, None, cfg,
            stellar_radius_km=float(d["STELLAR_RADIUS_KM"]),
            return_diagnostics=True, device="cpu")
        out[dtype] = depth.double(), diag["trans"].double()
    (d64, t64), (d32, t32) = out[torch.float64], out[torch.float32]
    assert float(t64.max()) < 0.9981
    assert float(((d32 - d64).abs() / d64).max()) < 1e-6
    # the absorbed fraction itself, 1 - T, within 1e-5 of its peak: the
    # float32 layer amounts carry up to 5e-6 (the CPU reads 2.0e-6 here)
    a64, a32 = 1.0 - t64, 1.0 - t32
    assert float((a32 - a64).abs().max() / a64.abs().max()) < 1e-5


@pytest.fixture(scope="module")
def transit_run(tmp_path_factory):
    """(deck dir, edited .h5, edited .npz export): the transit run as both
    packages read it from the .h5, and as the card reads it."""
    base = tmp_path_factory.mktemp("transit")
    deck = base / "so"
    deck.mkdir()
    os.symlink(os.path.abspath("tests/fixtures/ltatables"), base / "ltatables")
    shutil.copy(f"{DECK}/{RUN}.apr", deck)
    h5 = deck / f"{RUN}.h5"
    shutil.copy(SO_H5, h5)
    with h5py.File(h5, "a") as f:
        f["Measurement/IFORM"][...] = 2  # TransitDepth
        g = f.create_group("Stellar")
        for key, value in chip_smoke.TRANSIT_STELLAR.items():
            g[key] = value
    npz = chip_smoke.transit_deck_file(str(base / "transit.npz"))
    return str(deck), str(h5), npz


@pytest.fixture(scope="module")
def setups(transit_run):
    deck, _, npz = transit_run
    return (make_retrieval_setup_transit(deck, RUN, device="cpu"),
            jax_setup_transit(deck, RUN),
            make_retrieval_setup_transit(DECK, RUN, device="cpu",
                                         deck_file=npz))


def test_transit_setup_matches_jax(setups):
    """``forward_fn`` at the a priori against the JAX set-up's at 1e-10
    (both read the .h5; the hydrostatic rebalance inside the state map),
    each state column's JVP within 1e-9 of its peak, and the set-up on the
    edited export equal to the one on the .h5."""
    port, jx, export = setups
    x = torch.as_tensor(port.sv.xa)
    got = port.forward_fn(x).numpy()
    want = np.asarray(jx.forward_fn(jnp.asarray(jx.sv.xa)))
    assert got.shape == port.y.shape == (6015,)
    assert np.all(got > 0) and np.all(got < 100)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    torch.testing.assert_close(export.forward_fn(x), port.forward_fn(x),
                               rtol=0, atol=0)
    for col in range(port.sv.nx):
        v = np.zeros(port.sv.nx)
        v[col] = 1.0
        _, dy = torch.func.jvp(port.forward_fn, (x,), (torch.as_tensor(v),))
        _, jdy = jax.jvp(jx.forward_fn, (jnp.asarray(jx.sv.xa),),
                         (jnp.asarray(v),))
        jdy = np.asarray(jdy)
        assert np.abs(jdy).max() > 0
        err = np.abs(dy.numpy() - jdy).max() / np.abs(jdy).max()
        assert err < 1e-9, (col, err)


def test_float32_transit_setup_holds_float64(setups, transit_run):
    """float32 within 1e-4 of float64 (spectrum) and each Jacobian column
    within ``JAC_F32_BOUND`` of its peak."""
    port = setups[0]
    s32 = make_retrieval_setup_transit(DECK, RUN, device="cpu",
                                       dtype=torch.float32,
                                       deck_file=transit_run[2])
    x = torch.as_tensor(port.sv.xa)
    y64, k64 = forward_and_jacobian(port.forward_fn, x)
    y32, k32 = forward_and_jacobian(s32.forward_fn, x.float())
    r = chip_smoke.rel_err(y32.double().numpy(), y64.numpy())
    assert r.max() < chip_smoke.F32_BOUNDS[0], r.max()
    col_err, misses = chip_smoke.jacobian_column_misses(k32, k64,
                                                        port.sv.entries)
    assert not misses, col_err


def test_transit_refusals(tmp_path):
    """An IFORM other than TransitDepth and a deck without a stellar radius
    are refused, as the JAX set-up refuses them."""
    with pytest.raises(ValueError, match="TransitDepth"):
        make_retrieval_setup_transit(DECK, RUN, device="cpu",
                                     deck_file=chip_smoke.SO_EXPORT)
    npz = chip_smoke.transit_deck_file(str(tmp_path / "t.npz"))
    flat = dict(np.load(npz))
    flat["Stellar/RADIUS"] = np.asarray(0.0)
    np.savez(tmp_path / "r0.npz", **flat)
    with pytest.raises(ValueError, match="stellar radius"):
        make_retrieval_setup_transit(DECK, RUN, device="cpu",
                                     deck_file=str(tmp_path / "r0.npz"))
