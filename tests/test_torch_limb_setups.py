"""The limb set-ups of the PyTorch port beyond ``jupiter_limb`` itself
(``tests/test_torch_limb.py``): a limb FOV point (EMISS_ANG < 0) of the
nadir set-up against the JAX package's set-up on the same deck, its
scattering guard, the limb set-up on an HDF5 run file, and
``retrieval_nemesis(nemesis_l=True)``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from archnemesis_tpu.retrievals import make_retrieval_setup as jax_setup
from archnemesis_tpu_torch.retrievals import (
    make_retrieval_setup,
    make_retrieval_setup_limb,
    retrieval_nemesis,
)
from port_cases import copy_deck, one_torch_thread  # noqa: F401

DECK = chip_smoke.LIMB_DECK

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _limb_point_deck(tmp_path_factory):
    """A copy of ``jupiter_fdret`` whose single FOV point looks at the limb
    (EMISS_ANG = -1) at a tangent height SOL_ANG = 30 km."""
    d = copy_deck(tmp_path_factory, "limbpoint")
    spx = os.path.join(d, "cirstest.spx")
    toks = open(spx).read().split("\n")
    geo = toks[3].split()
    geo[2], geo[3] = "30.0", "-1.0"
    toks[3] = " ".join(geo)
    open(spx, "w").write("\n".join(toks))
    return d


def test_limb_fov_point_of_the_nadir_setup_matches_jax(tmp_path_factory):
    """``make_retrieval_setup`` with a limb FOV point (which raised before
    limb paths were ported): ``forward_limb`` at SOL_ANG through the nadir
    set-up's instrument function, equal to the JAX set-up at 1e-10."""
    d = _limb_point_deck(tmp_path_factory)
    port = make_retrieval_setup(d, "cirstest", device="cpu")
    jx = jax_setup(d, "cirstest")
    got = port.forward_fn(port.sv.xa).numpy()
    want = np.asarray(jax.jit(jx.forward_fn)(jnp.asarray(jx.sv.xa)))
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_limb_fov_point_with_scattering_raises(tmp_path_factory):
    d = copy_deck(tmp_path_factory, "limbscat", deck=chip_smoke.SCAT_DECK)
    spx = os.path.join(d, "cirstest.spx")
    toks = open(spx).read().split("\n")
    geo = toks[3].split()
    geo[3] = "-1.0"
    toks[3] = " ".join(geo)
    open(spx, "w").write("\n".join(toks))
    with pytest.raises(NotImplementedError, match="limb"):
        make_retrieval_setup(d, "cirstest", device="cpu")


def test_limb_retrieval_one_iteration(tmp_path_factory):
    """``retrieval_nemesis(nemesis_l=True)``, one OE iteration, on a copy of
    ``jupiter_limb`` whose .apr retrieves a tangent-height shift (model
    777, the stencil's differentiable search) and a C2H2 scaling (model 2):
    NX = 2, so its Jacobian fits the CPU (the deck's own 81 columns carry
    (81, 363, 20, 126, 6) tangents, 3.6 GB a tensor)."""
    d = chip_smoke.blocks_deck(DECK, str(tmp_path_factory.mktemp("limbdrv")),
                               ("m777_tanhe", "m2_scale"))
    res = retrieval_nemesis(d, "cirstest", niter=1, nemesis_l=True,
                            write_outputs=False, device="cpu")
    assert res.kk.shape == (303, 2)
    assert np.all(np.isfinite(res.yn)) and np.all(np.abs(res.kk).max(0) > 0)
    assert res.phi_history[-1] <= res.phi_history[0]


def test_hdf5_limb_deck_raises(tmp_path_factory):
    """An HDF5 run file (which raised before item 4 was ported): the JAX
    package's ``write_deck_hdf5`` of ``jupiter_limb`` in a copy of the
    deck. Both packages read it alike, field by field, and the limb set-up
    on it gives the legacy deck's spectrum (held to the JAX set-up in
    tests/test_torch_limb.py) within 1e-12."""
    from archnemesis_tpu.io.hdf5 import load_deck_hdf5 as jax_load_h5
    from archnemesis_tpu.io.hdf5 import write_deck_hdf5
    from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
    from archnemesis_tpu_torch.io.hdf5 import load_deck_hdf5
    from port_cases import assert_same_structure

    d = copy_deck(tmp_path_factory, "limbh5", deck=DECK)
    h5 = os.path.join(d, "cirstest.h5")
    write_deck_hdf5(h5, jax_load_deck(d, "cirstest"))
    got, want = load_deck_hdf5(h5), jax_load_h5(h5)
    for part in ("atmosphere", "layer_config", "geometry", "settings",
                 "ktables", "cia", "aerosol", "surface", "stellar"):
        assert_same_structure(getattr(got, part), getattr(want, part), part)
    setup = make_retrieval_setup_limb(d, "cirstest", device="cpu")
    assert setup.deck.apr_path == os.path.join(d, "cirstest.apr")
    legacy = make_retrieval_setup_limb(DECK, "cirstest", device="cpu")
    np.testing.assert_allclose(setup.forward_fn(setup.sv.xa).numpy(),
                               legacy.forward_fn(legacy.sv.xa).numpy(),
                               rtol=1e-12, atol=0)
