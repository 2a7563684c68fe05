"""Optimal-estimation algebra and loop of the PyTorch port: the four cases
of tests/test_oe.py on the reference golden, and the nonlinear toy of
tests/test_retrieval_e2e.py with the JAX loop's own phi history."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.retrieval.oe import coreret_oe as jax_coreret_oe
from archnemesis_tpu_torch.retrieval.oe import (
    assess,
    calc_gain_matrix,
    calc_next_xn,
    calc_phi,
    calc_serr,
    coreret_oe,
)

GOLDEN = "tests/goldens/jupiter_oe.npz"


@pytest.fixture(scope="module")
def d():
    return {k: torch.as_tensor(v) for k, v in np.load(GOLDEN).items()}


def test_gain_matrix(d):
    dd, aa = calc_gain_matrix(d["KK"], d["SA"], d["SE"])
    np.testing.assert_allclose(dd.numpy(), d["DD"].numpy(), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(aa.numpy(), d["AA"].numpy(), rtol=1e-6,
                               atol=1e-12)


def test_phi(d):
    phi, chisq = calc_phi(d["Y"], d["YN"], d["XN"], d["XA"], d["SE"], d["SA"])
    np.testing.assert_allclose(float(phi), float(d["PHI"]), rtol=1e-8)
    np.testing.assert_allclose(float(chisq), float(d["CHISQ"]), rtol=1e-8)


def test_next_xn(d):
    x = calc_next_xn(d["XA"], d["XN"], d["Y"], d["YN"], d["DD"], d["AA"])
    np.testing.assert_allclose(x.numpy(), d["X_OUT"].numpy(), rtol=1e-6,
                               atol=1e-10)


def test_serr_shapes(d):
    sm, sn, st = calc_serr(d["DD"], d["AA"], d["SE"], d["SA"])
    nx = d["XA"].shape[0]
    assert sm.shape == (nx, nx)
    np.testing.assert_allclose(st.numpy(), (sm + sn).numpy())
    np.testing.assert_allclose(st.numpy(), st.numpy().T, rtol=1e-8)


def test_assess(d):
    from archnemesis_tpu.retrieval.oe import assess as jax_assess

    want = jax_assess(jnp.asarray(d["KK"].numpy()),
                      jnp.asarray(d["SA"].numpy()),
                      jnp.asarray(d["SE"].numpy()))
    got = assess(d["KK"], d["SA"], d["SE"])
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-10)
    assert got[3] == want[3]


def _toy():
    rng = np.random.default_rng(3)
    nx, ny = 6, 40
    a_np = rng.normal(size=(ny, nx)) / np.sqrt(nx)
    x_true = rng.normal(size=nx) * 0.5
    lin = a_np @ x_true
    y = np.exp(lin) + 0.1 * lin**2
    se = np.diag(np.full(ny, (0.01 * np.abs(y).mean()) ** 2))
    return a_np, x_true, y, se, np.zeros(nx), np.eye(nx)


def test_oe_loop_matches_jax_on_nonlinear_toy(tmp_path):
    """The LM accept/reject/brake loop: same accepted iterations, same phi
    history (rtol 1e-8: the two linear solvers differ by rounding), same
    final state as the JAX loop."""
    a_np, x_true, y, se, xa, sa = _toy()
    a_j, a_t = jnp.asarray(a_np), torch.as_tensor(a_np)
    want = jax_coreret_oe(
        lambda x: jnp.exp(a_j @ x) + 0.1 * (a_j @ x) ** 2,
        xa, sa, y, se, lx=np.zeros(6, dtype=int), niter=15, philimit=0.01)
    got = coreret_oe(
        lambda x: torch.exp(a_t @ x) + 0.1 * (a_t @ x) ** 2,
        xa, sa, y, se, lx=np.zeros(6, dtype=int), niter=15, philimit=0.01,
        record_itr=True, progress_dir=str(tmp_path), device="cpu")
    assert got.n_iter == want.n_iter and got.converged == want.converged
    np.testing.assert_allclose(got.phi_history, want.phi_history, rtol=1e-8)
    np.testing.assert_allclose(got.xn, want.xn, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(got.st, want.st, rtol=1e-6, atol=1e-14)
    np.testing.assert_allclose(got.kk, want.kk, rtol=1e-8, atol=1e-12)
    assert got.phi < 1e-2 * got.phi_history[0]
    np.testing.assert_allclose(got.xn, x_true, atol=0.05)
    assert isinstance(got.xn, np.ndarray) and got.st.shape == (6, 6)
    assert len(got.itr_records) >= got.n_iter
    assert (tmp_path / "progress.txt").read_text().count("\n") >= 2
    assert (tmp_path / "phi_chisq.txt").exists()


def test_oe_loop_options():
    """x0 restarts the loop where it is given, a failing state_check raises
    the brake, and float32 runs in float32."""
    a_np, _, y, se, xa, sa = _toy()
    a_t = torch.as_tensor(a_np)

    def fwd(x):
        return torch.exp(a_t @ x) + 0.1 * (a_t @ x) ** 2

    kw = dict(lx=np.zeros(6, dtype=int), philimit=0.01, device="cpu")
    base = coreret_oe(fwd, xa, sa, y, se, niter=2, **kw)
    x0 = coreret_oe(fwd, xa, sa, y, se, niter=0, x0=base.xn, **kw)
    np.testing.assert_allclose(x0.xn, base.xn, rtol=0, atol=0)
    assert x0.phi_history[0] == pytest.approx(base.phi, rel=1e-10)
    seen = []
    braked = coreret_oe(fwd, xa, sa, y, se, niter=1,
                        state_check=lambda x: seen.append(1) or len(seen) > 2,
                        **kw)
    assert len(seen) == 3 and braked.n_iter <= 1
    f32 = coreret_oe(lambda x: torch.exp(a_t.float() @ x), xa, sa, y, se,
                     niter=1, dtype=torch.float32, **kw)
    assert f32.kk.dtype == np.float32
