"""Optimal-estimation retrieval (Rodgers formalism + Levenberg-Marquardt
brake).

Port of the JAX package's ``retrieval/oe.py``. Mirrors the reference
``OptimalEstimation_0`` math (OptimalEstimation_0.py: calc_gain_matrix:545,
calc_phiret:573, calc_next_xn:655, calc_serr:679, coreretOE loop
:1173-1586) with one structural change: the Jacobian K comes from
``torch.func.jacfwd`` of the pure forward function instead of the
reference's finite-difference fan-out / hand-written analytic-gradient twin
code path.

The LM accept/reject loop runs on the host (it is inherently sequential and
data-dependent); each iteration's forward+Jacobian evaluation is one
``jacfwd`` pass that also returns the spectrum. The linear algebra runs on
the forward function's device (``torch.linalg.solve`` and ``@``, outside
any hand-written kernel, as the JAX package leaves it to XLA).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from archnemesis_tpu_torch.utils.device import resolve_device
from archnemesis_tpu_torch.utils.profiling import JACOBIAN_SPAN, annotate


def calc_gain_matrix(kk, sa, se):
    """dd = SA K^T (K SA K^T + SE)^-1 via linear solves; aa = dd K
    (reference calc_gain_matrix:545)."""
    sa_kt = sa @ kk.T  # (NX, NY)
    m = kk @ sa_kt + se
    dd = torch.linalg.solve(m.T, sa_kt.T).T  # (NX, NY)
    aa = dd @ kk
    return dd, aa


def assess(kk, sa, se):
    """Retrieval-conditioning diagnostic (reference assess
    OptimalEstimation_0.py:612-653): compares the average diagonal of
    K SA K^T + SE against SE. Returns (avg_b, avg_se, avg_ratio,
    underconstrained) and logs the reference's warning when the mean
    elementwise ratio exceeds 10 (solution likely exact / insufficient
    constraint)."""
    import logging

    b = kk @ (sa @ kk.T) + se
    db = torch.diagonal(b)
    dse = torch.diagonal(se)
    ny = db.shape[0]
    sum1 = float(torch.sum(db)) / ny
    sum2 = float(torch.sum(dse)) / ny
    sum3 = float(torch.sum(db / dse)) / ny
    under = sum3 > 10.0
    lgr = logging.getLogger(__name__)
    lgr.info("Assess: avg diag(K Sx Kt) = %g, avg diag(Se) = %g, "
             "ratio = %g, avg elementwise ratio = %g",
             sum1, sum2, sum1 / sum2, sum3)
    if under:
        lgr.info("ASSESS WARNING: insufficient constraint, solution "
                 "likely to be exact")
    return sum1, sum2, sum3, under


def calc_phi(y, yn, xn, xa, se, sa):
    """phi = (yn-y)^T SE^-1 (yn-y) + (xn-xa)^T SA^-1 (xn-xa); chisq is the
    measurement part / NY (reference calc_phiret:573)."""
    b = yn - y
    d = xn - xa
    meas_cost = b @ torch.linalg.solve(se, b)
    apr_cost = d @ torch.linalg.solve(sa, d)
    return meas_cost + apr_cost, meas_cost / y.shape[0]


def calc_next_xn(xa, xn, y, yn, dd, aa):
    """x_{n+1} = xa + dd (y - yn) - aa (xa - xn) (reference calc_next_xn:655)."""
    return xa + dd @ (y - yn) - aa @ (xa - xn)


def calc_serr(dd, aa, se, sa):
    """Measurement (SM), smoothing (SN), and total (ST) error covariances
    (reference calc_serr:679)."""
    sm = dd @ se @ dd.T
    b = aa - torch.eye(aa.shape[0], dtype=aa.dtype, device=aa.device)
    sn = b @ sa @ b.T
    return sm, sn, sm + sn


def forward_and_jacobian(forward_fn: Callable, x):
    """(forward_fn(x), its Jacobian (NY, NX)) in one forward-mode
    evaluation: all NX tangents ride one pass through the forward model, and
    the spectrum comes along as the Jacobian's auxiliary output.

    The evaluation is the span ``nemesis.jacobian`` (one record per traced
    evaluation, ``utils.profiling.jacobian_records``); ``.calls`` counts
    the evaluations."""
    forward_and_jacobian.calls += 1

    def with_aux(z):
        yn = forward_fn(z)
        return yn, yn

    with annotate(JACOBIAN_SPAN):
        kk, yn = torch.func.jacfwd(with_aux, has_aux=True)(x)
    return yn, kk


forward_and_jacobian.calls = 0


@dataclass
class OEResult:
    xn: np.ndarray
    yn: np.ndarray
    kk: np.ndarray
    phi: float
    chisq: float
    sm: np.ndarray
    sn: np.ndarray
    st: np.ndarray
    dd: np.ndarray
    aa: np.ndarray
    n_iter: int
    phi_history: List[float]
    converged: bool
    itr_records: Optional[list] = None


def coreret_oe(
    forward_fn: Callable,
    xa: np.ndarray,
    sa: np.ndarray,
    y: np.ndarray,
    se: np.ndarray,
    lx: np.ndarray,
    niter: int = 10,
    philimit: float = 0.1,
    state_check: Optional[Callable] = None,
    verbose: bool = False,
    record_itr: bool = False,
    x0: Optional[np.ndarray] = None,
    progress_dir: Optional[str] = None,
    device=None,
    dtype=torch.float64,
) -> OEResult:
    """Run the OE iteration loop (reference coreretOE:1173).

    forward_fn(xn) -> yn takes and returns tensors on ``device`` (None = the
    CUDA card; raises without one unless ``device="cpu"``) in ``dtype``,
    and must be pure and ``torch.func.jacfwd``-able. The host inputs (xa,
    sa, y, se) become tensors there; the result holds numpy arrays.

    state_check(xn) -> bool (host callable, optional): physical-validity
    check used by the Marquardt brake (reference re-runs subprofretg to
    detect negative temperatures, :1439-1444). Returning False increases
    the brake.

    x0: optional starting state (checkpoint resume from a .itr record,
    reference from_itr OptimalEstimation_0.py:55); defaults to xa.

    progress_dir: when set, write the reference's live observability files
    there — ``progress.txt`` appended per iteration and ``phi_chisq.txt``
    with the full phi/chisq/state history at the end
    (OptimalEstimation_0.py:1285,1361-1363,1524).
    """
    import os

    def _progress_line(it, state, phi_v, chisq_v, xn_v):
        xs = " ".join(f"{float(x):09.3E}" for x in xn_v)
        return f"{it:04d} | {state:<16s} | {float(phi_v):09.3E} | " \
               f"{float(chisq_v):09.3E} | {xs}\n"

    progress_path = (
        os.path.join(progress_dir, "progress.txt") if progress_dir else None
    )
    progress_history = []
    device = resolve_device(device)

    def dev(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    xa, sa, y, se = dev(xa), dev(sa), dev(y), dev(se)
    lx = np.asarray(lx)

    def fwd_and_jac(x):
        return forward_and_jacobian(forward_fn, x)

    def host(v):
        return v.detach().cpu().numpy()

    xn = xa if x0 is None else dev(x0)
    yn, kk = fwd_and_jac(xn)
    # conditioning diagnostic before the first iteration (reference
    # coreretOE calls assess() once the first Jacobian exists, :1368)
    assess(kk, sa, se)
    phi, chisq = calc_phi(y, yn, xn, xa, se, sa)
    ophi = float(phi)
    phi_history = [ophi]
    if verbose:
        print(f"iter 0: phi={ophi:.6e} chisq={float(chisq):.6e}")
    progress_history.append((0, float(phi), float(chisq), host(xn)))
    if progress_path is not None:
        head = "iter | state            | phi       | chisq     | xn\n"
        with open(progress_path, "w") as f:
            f.write(head)
            f.write(_progress_line(0, "PHI INITIAL", phi, chisq, host(xn)))

    alambda = 1.0
    converged = False
    n_done = 0
    itr_records = [] if record_itr else None
    for it in range(niter):
        if record_itr:
            itr_records.append(dict(
                chisq=float(chisq), phi=float(phi),
                xn1=host(xn), yn1=host(yn),
                yn=host(yn), kk=host(kk),
            ))
        dd, aa = calc_gain_matrix(kk, sa, se)
        x_out = calc_next_xn(xa, xn, y, yn, dd, aa)

        # Marquardt brake with validity re-checks
        while True:
            if alambda > 1e30:
                raise RuntimeError("Death spiral in Marquardt braking")
            xn1 = xn + (x_out - xn) / (1.0 + alambda)
            xn1_host = host(xn1)
            bad_log = bool(
                np.any(((xn1_host > 85) | (xn1_host < -85)) & (lx == 1))
            )
            if bad_log or (state_check is not None and not state_check(xn1_host)):
                alambda *= 10.0
                continue
            break

        yn1, kk1 = fwd_and_jac(xn1)
        phi1, chisq1 = calc_phi(y, yn1, xn1, xa, se, sa)

        accepted = float(phi1) <= ophi
        progress_history.append(
            (it + 1, float(phi1), float(chisq1), xn1_host)
        )
        if progress_path is not None:
            with open(progress_path, "a") as f:
                f.write(_progress_line(
                    it + 1,
                    "PHI REDUCED" if accepted else "PHI INCREASED",
                    phi1, chisq1, xn1_host,
                ))
        if accepted:
            xn, yn, kk = xn1, yn1, kk1
            phi, chisq = phi1, chisq1
            n_done += 1
            tphi = 100.0 * (ophi - float(phi)) / ophi
            phi_history.append(float(phi))
            if verbose:
                print(
                    f"iter {it+1}: accepted phi={float(phi):.6e} "
                    f"chisq={float(chisq):.6e} lambda={alambda:.2e} tphi={tphi:.3f}%"
                )
            if 0.0 <= tphi <= philimit and alambda < 1.0:
                converged = True
                break
            ophi = float(phi)
            alambda *= 0.3
        else:
            if verbose:
                print(
                    f"iter {it+1}: rejected phi={float(phi1):.6e} "
                    f"(> {ophi:.6e}); lambda -> {alambda*10:.2e}"
                )
            alambda *= 10.0

    if progress_dir is not None:
        with open(os.path.join(progress_dir, "phi_chisq.txt"), "w") as f:
            f.write("iter | phi       | chisq     | xn\n")
            for it_i, phi_i, chisq_i, xn_i in progress_history:
                xs = " ".join(f"{float(x):09.3E}" for x in xn_i)
                f.write(f"{it_i:04d} | {phi_i:09.3E} | {chisq_i:09.3E} | {xs}\n")

    dd, aa = calc_gain_matrix(kk, sa, se)
    sm, sn, st = calc_serr(dd, aa, se, sa)
    phi, chisq = calc_phi(y, yn, xn, xa, se, sa)
    return OEResult(
        xn=host(xn),
        yn=host(yn),
        kk=host(kk),
        phi=float(phi),
        chisq=float(chisq),
        sm=host(sm),
        sn=host(sn),
        st=host(st),
        dd=host(dd),
        aa=host(aa),
        n_iter=n_done,
        phi_history=phi_history,
        converged=converged,
        itr_records=itr_records,
    )
