"""The port's Mie stack (``archnemesis_tpu_torch/ops/mie.py``) and the
models of the scattering retrieval (47 and 444) against the JAX package on
the same inputs. The JAX Mie tests hold the JAX package against the live
reference (``tests/test_mie.py``); here the port is held to JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
from archnemesis_tpu.models.base import MODEL_REGISTRY as JREG
from archnemesis_tpu.ops import mie as jmie
from archnemesis_tpu.retrieval.statevector import read_apr as jax_read_apr
from archnemesis_tpu_torch.io.legacy import load_deck
from archnemesis_tpu_torch.models.base import MODEL_REGISTRY as TREG
from archnemesis_tpu_torch.ops import mie as tmie
from archnemesis_tpu_torch.retrieval.statevector import _unlog, read_apr
from port_cases import one_torch_thread  # noqa: F401

THETA = np.array([0.0, 10.0, 25.0, 40.0, 55.0, 70.0, 80.0, 90.0])
WAVEL = np.array([0.8, 1.4, 2.5])
REFIND = np.stack(
    [np.array([1.42, 1.38, 1.33]), np.array([0.01, 0.05, 0.002])], axis=1
)
R0 = 0.015 * WAVEL.min()
DECK = "tests/fixtures/jupiter_scatter"

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("cases", [
    # standard gamma on an explicit Simpson grid
    [(1, (0.3, 0.2, (1 - 3 * 0.2) / 0.2), (0.015, 1.5, 0.015))],
    # log-normal with the reference's auto rs (rs[1] < rs[0])
    [(2, (0.4, 0.25, 0.0), (R0, 0.0, R0))],
    # single size (the class wrapper sets rs[:] = r0, Scatter_0.py:1327)
    [(4, (0.7, 0.0, 0.0), (0.7, 0.7, 0.7))],
    # isotropic, double HG and dipole
    [(5, (0.0,), (0.015, 1.0, 0.015)),
     (6, (0.4, 0.6, -0.3), (0.015, 1.0, 0.015)),
     (7, (0.2, 0.0, 0.0), (0.015, 1.0, 0.015))],
], ids=["gamma", "lognormal_auto", "single_size", "iso_hg_dipole"])
def test_makephase_matches_jax(cases):
    for iscat, pars, rs in cases:
        pars = np.asarray(pars, float)
        want = jmie.makephase(WAVEL, iscat, pars, rs, REFIND, THETA)
        got = tmie.makephase(WAVEL, iscat, pars, rs, REFIND, THETA,
                             device="cpu")
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
        for g, w, name in zip((got[0], got[1], got[3]),
                              (want[0], want[1], want[3]),
                              ("xscat", "xext", "phase")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                       err_msg=f"iscat={iscat} {name}")


def test_kramers_kronig_matches_jax():
    vi = np.linspace(800.0, 4000.0, 60)
    k_im = 0.01 + 0.2 * np.exp(-0.5 * ((vi - 2200.0) / 300.0) ** 2)
    for v, k in ((vi, k_im), (vi[::-1].copy(), k_im[::-1].copy())):
        np.testing.assert_allclose(
            tmie.kk_new_sub(v, k, 1500.0, 1.4, device="cpu").numpy(),
            np.asarray(jmie.kk_new_sub(v, k, 1500.0, 1.4)), rtol=1e-10)


def test_subfithgm_matches_jax():
    thetax = np.linspace(0.0, 180.0, 37)
    true = (0.7, 0.55, -0.35)
    ph = tmie._henyey2_np(np.cos(np.deg2rad(thetax)), *true)
    f, g1, g2, _ = tmie.subfithgm(thetax, ph[None, :])
    assert abs(f[0] - true[0]) < 0.02 and abs(g1[0] - true[1]) < 0.01
    assert abs(g2[0] - true[2]) < 0.01
    # on a Mie phase function, against the JAX fitter on the same input
    _, _, thx, ph_mie = tmie.makephase(WAVEL[:1], 4, (0.5, 0.0, 0.0),
                                       (0.0, 0.0, 0.0), REFIND[:1], THETA,
                                       device="cpu")
    got = tmie.subfithgm(thx, ph_mie)
    want = jmie.subfithgm(thx, ph_mie.numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-8)


def test_makephase_jacfwd_matches_central_difference():
    def f(r0):
        _, xe, _, _ = tmie.makephase(
            WAVEL, 4, torch.stack([r0, r0 * 0.0, r0 * 0.0]), (0.0, 0.0, 0.0),
            REFIND, THETA, nmax=80, n_start=150)
        return torch.sum(xe)

    r0 = torch.tensor(0.6, dtype=torch.float64)
    g = torch.func.jacfwd(f)(r0)
    fd = (f(r0 + 1e-5) - f(r0 - 1e-5)) / 2e-5
    assert torch.isfinite(g)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-4)


@pytest.fixture(scope="module")
def apr():
    """(port deck, port state vector, JAX deck, JAX state vector) of the
    Jupiter scattering deck: models 0, 47 (aerosol 1) and 444."""
    tdeck = load_deck(DECK, "cirstest")
    jdeck = jax_load_deck(DECK, "cirstest")
    return (tdeck, read_apr(tdeck.apr_path, tdeck.atmosphere),
            jdeck, jax_read_apr(jdeck.apr_path, jdeck.atmosphere))


def test_read_apr_matches_jax(apr):
    _, sv, _, jsv = apr
    assert [e.model_id for e in sv.entries] == [0, 47, 444]
    assert sv.entries == tuple(
        type(sv.entries[0])(**{**e.__dict__, "target": type(
            sv.entries[0].target)(e.target.value)}) for e in jsv.entries)
    for name in ("xa", "sa", "lx", "inum"):
        np.testing.assert_array_equal(getattr(sv, name), getattr(jsv, name))


def _entry(sv, model_id):
    return next(e for e in sv.entries if e.model_id == model_id)


def test_model47_matches_jax(apr):
    tdeck, sv, jdeck, jsv = apr
    e, je = _entry(sv, 47), _entry(jsv, 47)
    x = _unlog(sv, torch.as_tensor(sv.xa))[e.ix:e.ix + e.nx]
    jx = jnp.exp(jnp.asarray(jsv.xa))[je.ix:je.ix + je.nx]
    got = TREG[47].apply(e, tdeck.atmosphere, x)
    want = JREG[47].apply(je, jdeck.atmosphere, jx)
    np.testing.assert_allclose(got.dust.numpy(), np.asarray(want.dust),
                               rtol=1e-10)
    np.testing.assert_allclose(got.dust_renorm.numpy(),
                               np.asarray(want.dust_renorm), rtol=1e-10)


def test_model444_matches_jax(apr):
    """KEXT/KSCA of the aerosol from Kramers-Kronig and Mie inside the
    forward; the JAX side jitted (its eager scans are slow)."""
    tdeck, sv, jdeck, jsv = apr
    e, je = _entry(sv, 444), _entry(jsv, 444)
    x = _unlog(sv, torch.as_tensor(sv.xa))[e.ix:e.ix + e.nx]
    got = TREG[444].apply_scatter(e, tdeck.aerosol, x, ispace=0)

    @jax.jit
    def jax_optics(jx):
        out = JREG[444].apply_scatter(je, jdeck.aerosol, jx, ispace=0)
        return out.kext, out.ksca

    kext, ksca = jax_optics(jnp.exp(jnp.asarray(jsv.xa))[je.ix:je.ix + je.nx])
    # rtol 1e-10; the aerosol grid's first point (5 cm-1, a 2 mm
    # wavelength: the smallest size parameters) sits nine orders under the
    # peak, where Mie's series cancels: it differs by 9e-9 relative, 4e-20
    # absolute, so each column also gets an atol of 1e-12 of its peak
    for g, w in ((got.kext, kext), (got.ksca, ksca)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-12 * np.abs(w).max())
    # the other aerosol column is untouched
    other = [j for j in range(got.kext.shape[1]) if j != e.extra[0]]
    torch.testing.assert_close(got.kext[:, other],
                               tdeck.aerosol.kext[:, other], rtol=0, atol=0)
