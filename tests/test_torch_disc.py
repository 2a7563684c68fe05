"""The disc-averaged geometry of the PyTorch port: ``rt/disc.py`` against
the reference's quadrature tables (``disc_quadrature.npz``, all five
cases) and the JAX package; ``forward.forward_disc`` (one layering and one
set of layer optical depths for every ray, the rays' nadir paths in
chunks) against the explicit per-ray weighted sum of ``forward_nadir`` and
against the JAX package's vmapped forward; ``make_retrieval_setup_disc``
against the reference golden (``jupiter_disc_fm.npz``, nmu = 3, at
``tests/test_retrieval_disc.py``'s tolerances); and
``retrieval_nemesis(nemesis_disc=True)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu import forward as jfwd
from archnemesis_tpu import retrievals as jret
from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
from archnemesis_tpu.rt.disc import disc_quadrature as jax_quadrature
from archnemesis_tpu_torch import forward as tfwd
from archnemesis_tpu_torch import retrievals as tret
from archnemesis_tpu_torch.io.legacy import load_deck
from archnemesis_tpu_torch.retrievals import (
    make_retrieval_setup_disc,
    retrieval_nemesis,
)
from archnemesis_tpu_torch.rt.disc import disc_quadrature, gauss_lobatto
from port_cases import DECK, one_torch_thread, thin_fdret  # noqa: F401

QUAD_GOLDEN = "tests/goldens/disc_quadrature.npz"
# a narrow window of jupiter_nadir's tables for the forward comparisons
WINDOW = (600.0, 612.0)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("case", range(5))
def test_disc_quadrature_matches_reference(case):
    d = np.load(QUAD_GOLDEN)
    assert int(d["ncases"]) == 5
    nmu = int(d[f"case{case}_nmu"])
    phase = float(d[f"case{case}_phase"])
    q = disc_quadrature(nmu=nmu, phase=phase)
    for key, name in (("flat", "flat"), ("flon", "flon"), ("sol_ang", "sol"),
                      ("emiss_ang", "emiss"), ("azi_ang", "azi")):
        np.testing.assert_allclose(q[key], d[f"case{case}_{name}"],
                                   atol=1e-9, err_msg=key)
    np.testing.assert_allclose(q["wgeom"], d[f"case{case}_wgeom"],
                               rtol=1e-12)
    assert abs(q["wgeom"].sum() - 1.0) < 1e-12
    want = jax_quadrature(nmu=nmu, phase=phase)
    for key in q:
        np.testing.assert_array_equal(q[key], want[key], err_msg=key)


def test_gauss_lobatto_integrates_polynomials():
    x, w = gauss_lobatto(6)
    assert x[0] == -1.0 and x[-1] == 1.0
    # exact to degree 2n - 3
    for k in range(10):
        exact = (1.0 - (-1.0) ** (k + 1)) / (k + 1)
        assert abs(np.sum(w * x**k) - exact) < 1e-13


@pytest.fixture(scope="module")
def narrow():
    """Both packages' jupiter_nadir deck, tables cut to ``WINDOW``, with
    the nmu = 3 quadrature."""
    deck = load_deck(DECK, "cirstest")
    jdeck = jax_load_deck(DECK, "cirstest")
    ktw = tret._windowed_ktab(deck, *WINDOW)
    jktw = jret._windowed_ktab(jdeck, *WINDOW)
    st = deck.settings
    cfg = tfwd.make_forward_config(deck.atmosphere, ktw, deck.cia,
                                   iray=st.iray, ispace=st.ispace,
                                   gasgiant=deck.surface.gasgiant)
    jcfg = jfwd.make_forward_config(jdeck.atmosphere, jktw, jdeck.cia,
                                    iray=st.iray, ispace=st.ispace,
                                    gasgiant=jdeck.surface.gasgiant)
    port = (deck.atmosphere, deck.layer_config, ktw, deck.cia, deck.aerosol,
            deck.surface, cfg)
    jx = (jdeck.atmosphere, jdeck.layer_config, jktw, jdeck.cia,
          jdeck.aerosol, jdeck.surface, jcfg)
    return port, jx, disc_quadrature(nmu=3)


def test_forward_disc_equals_the_per_ray_sum(narrow):
    """The shared opacities and batched nadir paths give the weighted sum
    of one ``forward_nadir`` per ray (rtol 1e-12), in one chunk, in chunks
    of 5 rays and through ``point_fn``."""
    port, _, quad = narrow
    got = tfwd.forward_disc(*port, quad, device="cpu")
    chunked = tfwd.forward_disc(*port, quad, ray_chunk=5, device="cpu")
    want, rays = 0.0, {}
    for e, s, a, w in zip(quad["emiss_ang"], quad["sol_ang"],
                          quad["azi_ang"], quad["wgeom"]):
        rays[(e, s, a)] = tfwd.forward_nadir(
            *port, emiss_ang=e, sol_ang=s, azi_ang=a, device="cpu")[:, 0]
        want = want + w * rays[(e, s, a)]
    assert got.shape == (port[2].wave.shape[0],) and len(quad["wgeom"]) == 16
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    torch.testing.assert_close(chunked, want, rtol=1e-12, atol=0)
    by_point = tfwd.forward_disc(
        *port, quad, point_fn=lambda e, s, a: rays[(e, s, a)])
    torch.testing.assert_close(by_point, want, rtol=1e-12, atol=0)


def test_forward_disc_matches_jax(narrow):
    port, jx, quad = narrow
    got = tfwd.forward_disc(*port, quad, device="cpu").numpy()
    want = np.asarray(jax.jit(lambda a: jfwd.forward_disc(
        a, *jx[1:], quad))(jx[0]))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_forward_disc_jvp_matches_jax(narrow):
    """One tangent through the disc: the atmosphere's temperature."""
    port, jx, quad = narrow
    atm, jatm = port[0], jx[0]
    dt = np.linspace(0.5, 1.5, atm.t.shape[0])

    def tf(t):
        return tfwd.forward_disc(atm.replace(t=t), *port[1:], quad,
                                 device="cpu")

    def jf(t):
        return jfwd.forward_disc(jatm.replace(t=t), *jx[1:], quad)

    _, got = torch.func.jvp(tf, (atm.t,), (torch.as_tensor(dt),))
    _, want = jax.jit(lambda t, v: jax.jvp(jf, (t,), (v,)))(
        jnp.asarray(jatm.t), jnp.asarray(dt))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


def test_ray_chunk_keeps_the_jacobian_tangents_under_budget():
    # jupiter_nadir's window: 599 waves x 20 g x 71 layers, 81 tangents
    per_ray = 599 * 20 * 71 * 82 * 8
    chunk = tfwd.disc_ray_chunk(599, 20, 71, 81, 8)
    assert chunk == 7
    assert (chunk * per_ray <= tfwd.DISC_BLOCK_BYTES
            < (chunk + 1) * per_ray)
    assert tfwd.disc_ray_chunk(599, 20, 71, 10**6, 8) == 1


def test_disc_setup_matches_reference_golden():
    d = np.load(chip_smoke.DISC_GOLDEN)
    assert int(d["nmu"]) == 3 and float(d["phase"]) == 0.0
    setup = make_retrieval_setup_disc(DECK, "cirstest", nmu=3, device="cpu")
    got = setup.forward_fn(setup.sv.xa).numpy()
    want = d["SPECONV"]
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=np.abs(want).max() * 1e-8)


def test_disc_retrieval_one_iteration(tmp_path):
    """``retrieval_nemesis(nemesis_disc=True)`` (nmu = 5, 47 rays), one OE
    iteration, on ``jupiter_fdret`` thinned to 8 channels and 8 layers
    (``port_cases.thin_fdret``) with an .apr that retrieves a C2H2 scaling
    (model 2): NX = 1, so its Jacobian fits the CPU."""
    import shutil

    d = thin_fdret(tmp_path / "thin", nchan=8, nlay=8)
    shutil.copy(f"{chip_smoke.MODELS_FIXTURES}/m2_scale/test.apr",
                f"{d}/cirstest.apr")
    res = retrieval_nemesis(d, "cirstest", niter=1, nemesis_disc=True,
                            write_outputs=False, device="cpu")
    assert res.kk.shape[1] == 1 and np.abs(res.kk).max() > 0
    assert np.all(np.isfinite(res.yn))
    assert res.phi_history[-1] <= res.phi_history[0]
