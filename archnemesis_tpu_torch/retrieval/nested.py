"""Nested-sampling retrieval (reference NestedSampling_0.py coreretNS:291).

Port of the JAX package's ``retrieval/nested.py``: a self-contained
MultiNest-style sampler in which every expensive step is a BATCH of
likelihood evaluations. Candidate replacement points are proposed in
blocks and run through one ``torch.func.vmap`` of the forward function,
in chunks of ``STATE_CHUNK`` states, so the device sees a (chunk, nx)
state matrix instead of one state per call.

Algorithm: classic nested sampling (Skilling 2006) with MultiNest-style
bounding-ellipsoid rejection sampling (Feroz+ 2009) in the unit cube:

- priors enter as a unit-cube transform u -> x (gaussian XA +/- sqrt(SA)
  by default, matching coreretNS:348-364)
- each iteration replaces the worst live point with a point sampled
  uniformly inside the enlarged bounding ellipsoid of the live set,
  subject to L > L_worst
- evidence accumulates with the standard trapezoid shrinkage
  X_i = exp(-i/N); termination when the maximum remaining contribution
  drops below ``evidence_tolerance`` in log-evidence
- the surviving live points are folded in at the end

Everything here is float64 host numpy with ``np.random.default_rng(seed)``,
as in the JAX package, so both draw the same points; only the batched
likelihood runs on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from archnemesis_tpu_torch.utils.device import resolve_device

# states per vmapped likelihood call: the first batch holds all n_live
# points (400 by default), and each state's forward holds its own
# opacities on the card
STATE_CHUNK = 64


@dataclass
class NSResult:
    logz: float
    logz_err: float
    samples: np.ndarray  # (NSAMP, NDIM) posterior draws (physical space)
    weights: np.ndarray  # (NSAMP,) normalised posterior weights
    logl: np.ndarray  # (NSAMP,)
    means: np.ndarray  # (NDIM,) posterior means
    stds: np.ndarray  # (NDIM,) posterior standard deviations
    n_like: int  # total likelihood evaluations
    n_iter: int


def gaussian_prior_transform(xa, sa_diag_sqrt, device=None):
    """Unit-cube -> physical transform for gaussian priors XA +/- sigma
    (the reference's scipy.stats.norm(...).ppf, NestedSampling_0.py:357),
    in float64 on ``device`` (None = the CUDA card)."""
    device = resolve_device(device)
    xa = torch.as_tensor(np.asarray(xa, dtype=np.float64), device=device)
    sig = torch.as_tensor(np.asarray(sa_diag_sqrt, dtype=np.float64),
                          device=device)

    def transform(u):
        return xa + sig * torch.special.ndtri(u)

    return transform


def _sample_ellipsoid(rng, mean, chol, n):
    """n uniform draws from the ellipsoid {mean + chol @ z : |z| <= 1}."""
    d = mean.shape[0]
    z = rng.normal(size=(n, d))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    r = rng.uniform(size=(n, 1)) ** (1.0 / d)
    return mean[None, :] + (z * r) @ chol.T


def batched_loglike(loglike_fn: Callable, prior_transform: Callable,
                    chunk: int = STATE_CHUNK, device=None) -> Callable:
    """(n, ndim) host unit-cube points -> (n,) float64 log-likelihoods:
    ``torch.func.vmap`` of loglike(prior_transform(u)) over chunks of
    ``chunk`` points (each row's value does not depend on the chunking)."""
    device = resolve_device(device)
    one = torch.func.vmap(lambda u: loglike_fn(prior_transform(u)))

    def run(u):
        u = torch.as_tensor(np.asarray(u, dtype=np.float64), device=device)
        out = [one(u[i:i + chunk]) for i in range(0, u.shape[0], chunk)]
        return torch.cat(out).detach().cpu().double().numpy()

    return run


def coreret_ns(
    loglike_fn: Callable,
    prior_transform: Callable,
    ndim: int,
    n_live: int = 400,
    evidence_tolerance: float = 0.5,
    enlarge: float = 1.25,
    batch: int = 64,
    max_iter: int = 100000,
    seed: int = 0,
    verbose: bool = False,
    device=None,
):
    """Run nested sampling.

    loglike_fn(x) -> scalar log-likelihood tensor, a plain function of
    tensors: it is vmapped over (STATE_CHUNK, ndim) matrices of physical
    states. prior_transform(u) -> x maps the unit cube to physical space
    (float64 on ``device``, None = the CUDA card).
    """
    rng = np.random.default_rng(seed)

    batched = batched_loglike(loglike_fn, prior_transform, device=device)

    u_live = rng.uniform(size=(n_live, ndim))
    l_live = batched(u_live)
    n_like = n_live

    # dead-point records
    dead_u: list[np.ndarray] = []
    dead_logl: list[float] = []
    log_x_prev = 0.0  # log prior volume
    logz = -np.inf
    h_info = 0.0
    dlog = -1.0 / n_live

    it = 0
    for it in range(1, max_iter + 1):
        iworst = int(np.argmin(l_live))
        l_min = float(l_live[iworst])
        log_x = it * dlog
        # prior-volume shell weight: w_i = X_{i-1} - X_i
        log_w = log_x_prev + np.log1p(-np.exp(dlog))
        logz_new = np.logaddexp(logz, l_min + log_w)
        if np.isfinite(logz_new):
            prev = (
                np.exp(logz - logz_new) * (h_info + logz)
                if np.isfinite(logz)
                else 0.0
            )
            h_info = (
                np.exp(l_min + log_w - logz_new) * l_min + prev - logz_new
            )
        logz = logz_new
        dead_u.append(u_live[iworst].copy())
        dead_logl.append(l_min)
        log_x_prev = log_x

        # termination: the maximum possible remaining contribution would
        # change logZ by less than the tolerance (MultiNest criterion)
        l_max = float(l_live.max())
        if np.logaddexp(logz, l_max + log_x) - logz < evidence_tolerance:
            break

        # replacement: ellipsoidal rejection in the unit cube
        mean = u_live.mean(axis=0)
        cov = np.cov(u_live.T) if ndim > 1 else np.array([[u_live.var()]])
        cov = np.atleast_2d(cov) + 1e-12 * np.eye(ndim)
        # scale so the ellipsoid encloses all live points, then enlarge
        inv = np.linalg.inv(cov)
        d2 = np.einsum("ij,jk,ik->i", u_live - mean, inv, u_live - mean)
        chol = np.linalg.cholesky(cov * d2.max() * enlarge**2)

        found = False
        for _ in range(200):
            cand = _sample_ellipsoid(rng, mean, chol, batch)
            ok = np.all((cand > 0.0) & (cand < 1.0), axis=1)
            if not ok.any():
                continue
            cand = cand[ok]
            l_cand = batched(cand)
            n_like += cand.shape[0]
            good = np.nonzero(l_cand > l_min)[0]
            if good.size:
                j = int(good[0])
                u_live[iworst] = cand[j]
                l_live[iworst] = l_cand[j]
                found = True
                break
        if not found:
            # likelihood plateau / degenerate ellipsoid: keep a copy of a
            # random surviving point (standard fallback)
            j = int(rng.integers(n_live))
            u_live[iworst] = u_live[j]
            l_live[iworst] = l_live[j]

        if verbose and it % 100 == 0:
            print(f"ns iter {it}: logz={logz:.4f} l_min={l_min:.2f} "
                  f"n_like={n_like}")

    # fold in the remaining live points at X_final / n_live each
    log_x_final = it * dlog
    order = np.argsort(l_live)
    for idx in order:
        log_w = log_x_final - np.log(n_live)
        logz_new = np.logaddexp(logz, l_live[idx] + log_w)
        if np.isfinite(logz_new):
            prev = (
                np.exp(logz - logz_new) * (h_info + logz)
                if np.isfinite(logz)
                else 0.0
            )
            h_info = (
                np.exp(l_live[idx] + log_w - logz_new) * l_live[idx]
                + prev
                - logz_new
            )
        logz = logz_new
        dead_u.append(u_live[idx].copy())
        dead_logl.append(float(l_live[idx]))

    dead_u_arr = np.asarray(dead_u)
    dead_logl_arr = np.asarray(dead_logl)
    # posterior weights: w_i = L_i dX_i / Z
    n_dead = it
    log_dx = np.empty(n_dead + n_live)
    # shell i has log-width log(X_{i-1} - X_i) = (i-1) dlog + log(1-e^dlog)
    log_dx[:n_dead] = dlog * np.arange(n_dead) + np.log1p(-np.exp(dlog))
    log_dx[n_dead:] = log_x_final - np.log(n_live)
    log_wt = dead_logl_arr + log_dx - logz
    wt = np.exp(log_wt - log_wt.max())
    wt /= wt.sum()

    u_dead = torch.as_tensor(dead_u_arr, device=resolve_device(device))
    x_dead = (torch.func.vmap(prior_transform)(u_dead)
              .detach().cpu().double().numpy())
    means = (wt[:, None] * x_dead).sum(axis=0)
    stds = np.sqrt((wt[:, None] * (x_dead - means) ** 2).sum(axis=0))
    logz_err = float(np.sqrt(max(h_info, 0.0) / n_live))

    return NSResult(
        logz=float(logz),
        logz_err=logz_err,
        samples=x_dead,
        weights=wt,
        logl=dead_logl_arr,
        means=means,
        stds=stds,
        n_like=n_like,
        n_iter=it,
    )


def run_retrieval_ns(
    deck_dir: str,
    runname: str,
    n_live: int = 400,
    evidence_tolerance: float = 0.5,
    seed: int = 0,
    verbose: bool = False,
    sigma_floor: float = 1e-5,
    device=None,
    dtype=torch.float64,
):
    """Nested-sampling retrieval on a legacy deck (reference
    coreretNS:291): gaussian priors from XA +/- sqrt(diag(SA)),
    log-likelihood -chi^2/2 against the measurement vector. Parameters with
    prior sigma below ``sigma_floor`` are held fixed at XA (reference
    vars_to_vary, NestedSampling_0.py:352)."""
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    setup = make_retrieval_setup(deck_dir, runname, device=device,
                                 dtype=dtype)
    return setup, run_setup_ns(
        setup, n_live=n_live, evidence_tolerance=evidence_tolerance,
        seed=seed, verbose=verbose, sigma_floor=sigma_floor,
    )


def setup_loglike(setup, sigma_floor: float = 1e-5):
    """(loglike, prior_transform, ndim) of a RetrievalSetup: gaussian
    priors on the parameters whose prior sigma exceeds ``sigma_floor``
    (the others held at XA), -chi^2/2 of ``setup.forward_fn`` (in the
    setup's type, the sum in float64) against the measurement vector."""
    device = setup.device
    xa = np.asarray(setup.sv.xa, dtype=np.float64)
    sig = np.sqrt(np.diag(np.asarray(setup.sv.sa)))
    vary = np.nonzero(sig > sigma_floor)[0]
    fixed = np.nonzero(~(sig > sigma_floor))[0]
    y = torch.as_tensor(np.asarray(setup.y, dtype=np.float64), device=device)
    inv_err2 = torch.as_tensor(1.0 / np.diag(setup.se), device=device)

    sub_transform = gaussian_prior_transform(xa[vary], sig[vary],
                                             device=device)
    xa_fixed = torch.as_tensor(xa[fixed], device=device)
    # the varying parameters first, then the fixed ones, put back in
    # state-vector order by one gather
    back = torch.as_tensor(np.argsort(np.concatenate([vary, fixed])),
                           device=device)

    def prior_transform(u):
        return torch.cat([sub_transform(u), xa_fixed])[back]

    def loglike(x_full):
        yn = setup.forward_fn(x_full.to(setup.dtype)).double()
        return -0.5 * torch.sum((yn - y) ** 2 * inv_err2)

    return loglike, prior_transform, int(vary.size)


def run_setup_ns(
    setup,
    n_live: int = 400,
    evidence_tolerance: float = 0.5,
    seed: int = 0,
    verbose: bool = False,
    sigma_floor: float = 1e-5,
    **ns_kwargs,
):
    """Nested sampling over an already-built RetrievalSetup (any geometry's
    set-up), on the setup's device. Factored out so retrieval_nemesis can
    dispatch retrieval_method=1 (reference Retrievals.py:298-307)."""
    loglike, prior_transform, ndim = setup_loglike(setup, sigma_floor)
    return coreret_ns(
        loglike,
        prior_transform,
        ndim=ndim,
        n_live=n_live,
        evidence_tolerance=evidence_tolerance,
        seed=seed,
        verbose=verbose,
        device=setup.device,
        **ns_kwargs,
    )
