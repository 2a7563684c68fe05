"""Nested sampling in the PyTorch port (``retrieval/nested.py``) against the
JAX package: the same sampler's host logic on the same seed draws the same
points, so ``coreret_ns`` on ``tests/test_nested.py``'s Gaussian problems
gives JAX's evidence and samples (rtol 1e-10), with the analytic checks of
that file; the parameters under the prior floor stay at XA; the batched
likelihood (``torch.func.vmap`` over states, in chunks) equals a loop of
the forward on a thinned ``jupiter_fdret``, through the forward's host
reads (the hydrostatic iteration) under ``vmap``; and
``retrieval_method=1`` runs through ``retrieval_nemesis``."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.retrieval import nested as jax_nested
from archnemesis_tpu_torch.retrieval import nested
from archnemesis_tpu_torch.retrievals import (
    make_retrieval_setup,
    retrieval_nemesis,
)
from archnemesis_tpu_torch.rt.atmosphere import adjust_hydrostat_h
from port_cases import one_torch_thread, thin_fdret  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NDIM = 3
PRIOR_SIG = np.array([1.0, 2.0, 0.5])
MU = np.array([0.7, -1.0, 0.2])
LIKE_SIG = np.array([0.3, 0.5, 0.2])


def _port_loglike(x):
    mu, sig = x.new_tensor(MU), x.new_tensor(LIKE_SIG)
    return torch.sum(-0.5 * ((x - mu) / sig) ** 2
                     - torch.log(sig * np.sqrt(2.0 * np.pi)))


def _jax_loglike(x):
    return jnp.sum(-0.5 * ((x - MU) / LIKE_SIG) ** 2
                   - jnp.log(LIKE_SIG * jnp.sqrt(2.0 * jnp.pi)))


def _assert_same(got, want):
    assert got.n_iter == want.n_iter and got.n_like == want.n_like
    np.testing.assert_allclose(got.logz, want.logz, rtol=1e-10)
    np.testing.assert_allclose(got.logz_err, want.logz_err, rtol=1e-10)
    np.testing.assert_allclose(got.samples, np.asarray(want.samples),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.logl, want.logl, rtol=1e-10)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-10,
                               atol=1e-300)
    np.testing.assert_allclose(got.means, want.means, rtol=1e-10, atol=1e-12)


def test_gaussian_evidence_and_posterior_match_jax():
    """tests/test_nested.py's 3-D Gaussian problem: the JAX result at rtol
    1e-10, and the analytic evidence and posterior."""
    kw = dict(n_live=300, evidence_tolerance=0.01, seed=2)
    got = nested.coreret_ns(
        _port_loglike,
        nested.gaussian_prior_transform(np.zeros(NDIM), PRIOR_SIG,
                                        device="cpu"),
        NDIM, device="cpu", **kw)
    want = jax_nested.coreret_ns(
        _jax_loglike,
        jax_nested.gaussian_prior_transform(np.zeros(NDIM), PRIOR_SIG),
        NDIM, **kw)
    _assert_same(got, want)
    tot = PRIOR_SIG**2 + LIKE_SIG**2
    logz_true = float(np.sum(-0.5 * MU**2 / tot
                             - 0.5 * np.log(2.0 * np.pi * tot)))
    assert abs(got.logz - logz_true) < max(3.0 * got.logz_err, 0.15)
    np.testing.assert_allclose(got.means, MU * PRIOR_SIG**2 / tot, atol=0.06)
    post_std = np.sqrt(1.0 / (1.0 / PRIOR_SIG**2 + 1.0 / LIKE_SIG**2))
    np.testing.assert_allclose(got.stds, post_std, rtol=0.25)
    assert got.n_iter > 300 and np.isclose(got.weights.sum(), 1.0)


def test_chunking_changes_no_likelihood():
    """The batched likelihood of 300 points (the first batch of the run
    above) in chunks of 7, of ``STATE_CHUNK`` and in one call: equal bit
    for bit, and equal to the JAX package's vmapped likelihood."""
    transform = nested.gaussian_prior_transform(np.zeros(NDIM), PRIOR_SIG,
                                                device="cpu")
    u = np.random.default_rng(2).uniform(size=(300, NDIM))
    got = [nested.batched_loglike(_port_loglike, transform, chunk=c,
                                  device="cpu")(u)
           for c in (7, nested.STATE_CHUNK, 300)]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], got[2])
    jtransform = jax_nested.gaussian_prior_transform(np.zeros(NDIM),
                                                     PRIOR_SIG)
    want = np.asarray(jax.vmap(lambda x: _jax_loglike(jtransform(x)))(
        jnp.asarray(u)))
    np.testing.assert_allclose(got[0], want, rtol=1e-12)


def _fake_setup(port: bool):
    """A two-parameter 'set-up' whose second prior sigma is 0: the forward
    reads both parameters, the measurement constrains the first."""
    xa, sa = np.array([1.0, 5.0]), np.diag([0.25, 0.0])
    if port:
        def forward_fn(x):
            return torch.stack([x[0] * x[1] / 5.0, x[0] ** 2])
    else:
        def forward_fn(x):
            return jnp.stack([x[0] * x[1] / 5.0, x[0] ** 2])
    return SimpleNamespace(
        sv=SimpleNamespace(xa=xa, sa=sa), y=np.array([1.2, 1.44]),
        se=np.diag([0.01, 0.04]), forward_fn=forward_fn,
        device=torch.device("cpu"), dtype=torch.float64)


def test_fixed_parameters_held_at_xa():
    """``run_setup_ns`` holds a parameter under the prior floor at XA
    exactly, and gives the JAX package's result."""
    kw = dict(n_live=100, evidence_tolerance=0.05, seed=0)
    got = nested.run_setup_ns(_fake_setup(True), **kw)
    want = jax_nested.run_setup_ns(_fake_setup(False), **kw)
    assert np.all(got.samples[:, 1] == 5.0)
    assert abs(got.means[0] - 1.2) < 0.05
    _assert_same(got, want)


@pytest.fixture(scope="module")
def thin_deck(tmp_path_factory):
    # thinner than the JAX slow test's deck (32 channels, 16 layers): the
    # CPU's plain combine costs ~0.3 s a state there
    return thin_fdret(tmp_path_factory.mktemp("thin"), nchan=8, nlay=8)


def test_batched_likelihood_equals_a_loop(thin_deck):
    """``vmap`` over 7 states in chunks of 3, through the hydrostatic
    iteration's host reads, equal to one forward per state."""
    setup = make_retrieval_setup(thin_deck, "cirstest", device="cpu")
    loglike, transform, ndim = nested.setup_loglike(setup)
    assert ndim == setup.sv.nx
    u = np.random.default_rng(1).uniform(size=(7, ndim))
    got = nested.batched_loglike(loglike, transform, chunk=3,
                                 device="cpu")(u)
    want = np.array([float(loglike(transform(torch.as_tensor(row))))
                     for row in u])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_hydrostatic_iteration_under_vmap_equals_each_row(thin_deck):
    """Rows that stop after different numbers of iterations: each row of
    the batched rebalance equals its own unbatched call."""
    setup = make_retrieval_setup(thin_deck, "cirstest", device="cpu")
    atm = setup.deck.atmosphere
    scale = torch.tensor([0.7, 1.0, 1.6], dtype=torch.float64)

    def one(s):
        return adjust_hydrostat_h(atm.replace(t=atm.t * s)).h

    got = torch.func.vmap(one)(scale)
    for i, s in enumerate(scale):
        torch.testing.assert_close(got[i], one(s), rtol=1e-12, atol=0)


def test_nested_sampling_through_retrieval_nemesis(thin_deck):
    """``retrieval_nemesis(retrieval_method=1)`` with the JAX slow test's
    sampler settings (n_live 16, batch 16, at most 100 iterations)."""
    res = retrieval_nemesis(
        thin_deck, "cirstest", retrieval_method=1, write_outputs=False,
        device="cpu",
        ns_kwargs=dict(n_live=16, evidence_tolerance=5.0, seed=2, batch=16,
                       max_iter=100))
    assert isinstance(res, nested.NSResult)
    assert np.isfinite(res.logz) and res.n_iter <= 100
    assert res.samples.ndim == 2 and np.isfinite(res.samples).all()
    assert np.isclose(res.weights.sum(), 1.0)


def test_unknown_retrieval_method_raises():
    with pytest.raises(ValueError, match="retrieval_method"):
        retrieval_nemesis("tests/fixtures/jupiter_fdret", "cirstest",
                          retrieval_method=2, device="cpu")
