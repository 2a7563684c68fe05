"""The JVP columns of the PyTorch port's limb set-up
(``make_retrieval_setup_limb`` on ``jupiter_limb``, NX = 81) against the
JAX package's, each held against the JAX witness that computes it the way
the port does: the jitted JAX forward inside the weighting functions, the
eager JAX forward where jitting moves JAX's JVP, and on the top levels a
JAX forward whose emission takes the transmissions' difference with expm1,
as the port's does (``rt/emission.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu import forward as jfwd
from archnemesis_tpu.retrievals import (
    make_retrieval_setup_limb as jax_setup_limb,
)
from archnemesis_tpu_torch.retrievals import make_retrieval_setup_limb
from port_cases import one_torch_thread  # noqa: F401

DECK = chip_smoke.LIMB_DECK
# JVP columns held to 1e-8 of their peaks against JAX's jitted forward
JVP_COLUMNS = (20, 30, 45)
# columns where JAX's jitted JVP leaves its eager one: jitted, the JAX
# forward rounds the plain difference of two transmissions near 1 another
# way (1.8e-9 of the spectrum at 60 km), and its JVP differs from the eager
# JVP by 4.6e-8 of column 40's peak and 1.1e-8 of column 24's. A central
# difference of the jitted forward follows the jitted JVP (7.7e-10 on
# column 40); the port holds the eager JVP (column 40: 1.8e-12)
EAGER_COLUMNS = (24, 40)
# the top levels, whose thin layers the JAX emission's plain difference of
# transmissions rounds away (6.1e-6 of column 80's peak) and the port's
# expm1 keeps: held against JAX's forward with expm1 in that difference
TOP_COLUMNS = tuple(range(72, 81))

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def limb_setups():
    port = make_retrieval_setup_limb(DECK, "cirstest", device="cpu")
    jx = jax_setup_limb(DECK, "cirstest")
    return port, jx, jax.jit(jx.forward_fn)


def test_jvp_columns_match_jax(limb_setups):
    port, jx, jfn = limb_setups
    got, basis = _port_jvps(port, JVP_COLUMNS)
    want = np.asarray(jax.vmap(lambda v: jax.jvp(
        jfn, (jnp.asarray(jx.sv.xa),), (v,))[1])(jnp.asarray(basis)))
    err = _column_errors(got, want)
    assert err.max() < 1e-8, err


def _port_jvps(port, columns):
    basis = torch.zeros(len(columns), port.sv.nx, dtype=torch.float64)
    basis[torch.arange(len(columns)), list(columns)] = 1.0
    x = torch.as_tensor(port.sv.xa)
    return torch.func.vmap(lambda v: torch.func.jvp(
        port.forward_fn, (x,), (v,))[1])(basis).numpy(), basis.numpy()


def _column_errors(got, want):
    peak = np.abs(want).max(axis=1)
    assert peak.min() > 0
    return np.abs(got - want).max(axis=1) / peak


def test_jvp_columns_match_eager_jax(limb_setups):
    port, jx, _ = limb_setups
    got, basis = _port_jvps(port, EAGER_COLUMNS)
    want = np.asarray(jax.vmap(lambda v: jax.jvp(
        jx.forward_fn, (jnp.asarray(jx.sv.xa),), (v,))[1])(
            jnp.asarray(basis)))
    err = _column_errors(got, want)
    assert err.max() < 1e-10, err


def _expm1_emission(wave, tau_path, emtemp, mask, tsurf, emissivity,
                    surface_visible, gasgiant, solflux=None,
                    reflectance=None, sol_ang=None, emiss_ang=None,
                    emission_path=None, ispace=0):
    """JAX's limb emission (archnemesis_tpu/rt/emission.py, its parameters
    in its order) with T_{j-1} - T_j taken as T_{j-1} (-expm1(-tau_j))."""
    from archnemesis_tpu.ops.planck import planck

    assert not surface_visible and emission_path is None
    assert solflux is None and reflectance is None
    tau = tau_path * mask[None, None, :, :]
    tr = jnp.exp(-jnp.cumsum(tau, axis=2))
    trold = jnp.concatenate([jnp.ones_like(tr[:, :, :1, :]),
                             tr[:, :, :-1, :]], axis=2)
    bb = planck(wave[:, None, None], emtemp[None, :, :], ispace)
    return jnp.einsum("wgjp,wjp->wgp", trold * (-jnp.expm1(-tau)),
                      bb * mask[None, :, :])


def test_top_columns_match_jax_with_expm1_emission(limb_setups,
                                                   monkeypatch):
    port, jx, _ = limb_setups
    monkeypatch.setattr(jfwd, "thermal_emission_spectrum", _expm1_emission)
    got, basis = _port_jvps(port, TOP_COLUMNS)
    xa = jnp.asarray(jx.sv.xa)
    want = np.asarray(jax.jit(jax.vmap(lambda v: jax.jvp(
        jx.forward_fn, (xa,), (v,))[1]))(jnp.asarray(basis)))
    err = _column_errors(got, want)
    assert err.max() < 1e-8, err
