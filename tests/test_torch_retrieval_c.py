"""The combined multi-angle scattering set-up of the PyTorch port
(``make_retrieval_setup_c``, reference nemesisCfm ForwardModel_0.py:1526 +
calc_path_C :3571): one layering and one adding-doubling evaluation serve
every geometry as a path batch. On ``jupiter_scatter`` (NGEOM = 1) it
equals the nadir set-up (rtol 1e-10), as ``tests/test_retrieval_c.py``
holds the JAX package's; a three-angle copy equals JAX's set-up on the
same copy and three single-angle copies (the JAX test has only NGEOM = 1);
its guards raise ``ValueError``; and ``retrieval_nemesis(nemesis_c=True)``
runs one OE iteration."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu.retrievals import (
    make_retrieval_setup_c as jax_setup_c,
)
from archnemesis_tpu_torch.retrievals import (
    make_retrieval_setup,
    make_retrieval_setup_c,
    retrieval_nemesis,
)
from port_cases import DECK, one_torch_thread  # noqa: F401

SCAT = chip_smoke.SCAT_DECK

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_matches_the_nadir_setup():
    sc = make_retrieval_setup_c(SCAT, "cirstest", device="cpu")
    sn = make_retrieval_setup(SCAT, "cirstest", device="cpu")
    np.testing.assert_array_equal(sc.y, sn.y)
    x = torch.as_tensor(sc.sv.xa)
    y_c = sc.forward_fn(x)
    assert y_c.shape == (sc.y.size,)
    torch.testing.assert_close(y_c, sn.forward_fn(x), rtol=1e-10, atol=0)


def _cloud_tangent(setup):
    """The unit tangent of the cloud's optical depth (model 47)."""
    v = np.zeros(setup.sv.nx)
    v[next(e for e in setup.sv.entries if e.model_id == 47).ix] = 1.0
    return v


def test_three_angles_match_jax(tmp_path):
    """The three-angle copy through the JAX package's set-up (jitted):
    the forward and the JVP of the cloud's optical depth."""
    deck = chip_smoke.c_angle_deck(str(tmp_path), chip_smoke.C_ANGLES)
    port = make_retrieval_setup_c(deck, "cirstest", device="cpu")
    jx = jax_setup_c(deck, "cirstest")
    np.testing.assert_array_equal(port.y, jx.y)
    np.testing.assert_array_equal(port.sv.xa, jx.sv.xa)
    v = _cloud_tangent(port)
    y, dy = torch.func.jvp(port.forward_fn, (torch.as_tensor(port.sv.xa),),
                           (torch.as_tensor(v),))
    jy, jdy = jax.jit(lambda x, t: jax.jvp(jx.forward_fn, (x,), (t,)))(
        jnp.asarray(jx.sv.xa), jnp.asarray(v))
    jy, jdy = np.asarray(jy), np.asarray(jdy)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-10, atol=0)
    np.testing.assert_allclose(dy.numpy(), jdy, rtol=1e-10,
                               atol=1e-12 * np.abs(jdy).max())
    # the angles change the spectrum
    n = jy.size // 3
    assert np.abs(jy[:n] - jy[-n:]).max() > 1e-3 * np.abs(jy).max()


def test_three_angles_equal_three_single_angle_setups(tmp_path):
    """One path batch of three viewing angles against one set-up per
    angle, and a JVP through the batch against the single-angle JVPs (the
    cloud's optical depth, model 47)."""
    angles = chip_smoke.C_ANGLES
    three = make_retrieval_setup_c(
        chip_smoke.c_angle_deck(str(tmp_path / "all"), angles), "cirstest",
        device="cpu")
    singles = [make_retrieval_setup_c(
        chip_smoke.c_angle_deck(str(tmp_path / f"a{i}"), [a]), "cirstest",
        device="cpu") for i, a in enumerate(angles)]
    assert three.deck.geometry.ngeom == 3
    x = torch.as_tensor(three.sv.xa)
    v = torch.as_tensor(_cloud_tangent(three))
    y3, dy3 = torch.func.jvp(three.forward_fn, (x,), (v,))
    parts = [torch.func.jvp(s.forward_fn, (x,), (v,)) for s in singles]
    torch.testing.assert_close(y3, torch.cat([p[0] for p in parts]),
                               rtol=1e-10, atol=0)
    torch.testing.assert_close(dy3, torch.cat([p[1] for p in parts]),
                               rtol=1e-10, atol=1e-12 * dy3.abs().max())
    # the angles change the spectrum
    n = three.y.size // 3
    assert (y3[:n] - y3[-n:]).abs().max() > 1e-3 * y3.abs().max()


def test_guards_raise(tmp_path):
    # thermal emission (ISCAT=0): not a scattering deck
    with pytest.raises(ValueError, match="MULTIPLE_SCATTERING"):
        make_retrieval_setup_c(DECK, "cirstest", device="cpu")
    # up- and down-looking geometries mixed
    mixed = chip_smoke.c_angle_deck(str(tmp_path / "mixed"), (30.0, 120.0))
    with pytest.raises(ValueError, match="upward-looking"):
        make_retrieval_setup_c(mixed, "cirstest", device="cpu")
    # two FOV points in one geometry
    two = chip_smoke.copy_deck(SCAT, str(tmp_path / "two"))
    spx = os.path.join(two, "cirstest.spx")
    lines = open(spx).read().splitlines()
    lines[2] = "         2"
    lines.insert(4, lines[3])
    open(spx, "w").write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="one FOV point"):
        make_retrieval_setup_c(two, "cirstest", device="cpu")


def test_combined_retrieval_one_iteration(tmp_path):
    """``retrieval_nemesis(nemesis_c=True)``, one OE iteration, on a copy of
    ``jupiter_scatter`` whose .apr retrieves a C2H2 scaling (model 2): NX
    = 1, one tangent through the adding-doubling."""
    d = chip_smoke.blocks_deck(SCAT, str(tmp_path), ("m2_scale",))
    res = retrieval_nemesis(d, "cirstest", niter=1, nemesis_c=True,
                            write_outputs=False, device="cpu")
    assert res.kk.shape == (res.yn.shape[0], 1) and np.abs(res.kk).max() > 0
    assert np.all(np.isfinite(res.yn))
    assert res.phi_history[-1] <= res.phi_history[0]
