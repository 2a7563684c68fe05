"""Mie scattering: cross-sections and phase functions for aerosol
populations (the reference's Scatter_0 Mie stack: dmie:1399, miescat:1600,
makephase:1835, kk_new_sub:2169, subfithgm:1948).

Port of the JAX package's ``ops/mie.py``. The reference's per-radius
``while`` Mie series runs as a fixed-length Python loop over the multipole
order n, batched over the (wavelength, radius) grid, with the reference's
convergence test (|a_n|^2+|b_n|^2 < 1e-14) applied as a masked "done" flag
so results match the early-exit series exactly; no value is read back to
the host. Everything is differentiable with ``torch.func.jacfwd``, so model
444 (retrieved particle size + imaginary refractive index) gets exact
Jacobians instead of the reference's finite differences.

Conventions follow the reference: refractive index m = n_r - i*n_i,
radii/wavelengths in microns, cross sections returned in cm^2.
"""

from __future__ import annotations

import numpy as np
import torch

from archnemesis_tpu_torch.utils.device import resolve_device
from archnemesis_tpu_torch.utils.interp import interp


def _log_derivative(mx, n_start: int, nmax: int):
    """Downward recurrence for the Mie logarithmic-derivative ratios
    (reference dmie acap recurrence, Scatter_0.py:1469-1472):
    A_{n_start} = 0;  A_n = (n+1)/mx - 1/((n+1)/mx + A_{n+1}).
    Returns [A_1, ..., A_nmax] (a list of complex tensors of mx's shape).
    n_start must exceed 1.1*|m|x for convergence; any larger static value
    gives the same result to machine precision (downward recurrences are
    self-correcting).
    """
    rrfx = 1.0 / mx
    a = torch.zeros_like(mx)
    out = [None] * nmax
    for nn in range(n_start - 1, 0, -1):
        t = (nn + 1.0) * rrfx
        a = t - 1.0 / (t + a)
        if nn <= nmax:
            out[nn - 1] = a
    return out


def mie_single(x, m_re, m_im, cos_th, nmax: int, n_start: int):
    """Mie series for homogeneous spheres (reference dmie Scatter_0.py:1399),
    batched: size parameters x = 2*pi*r/lambda (any shape), refractive
    index m_re - i*m_im broadcastable against x, scattering angles given by
    cos_th (NTHETA,), theta <= 90 deg.

    Returns (qext, qscat, ctbrqs, i_fwd, i_bwd): the first three of x's
    shape, i_fwd/i_bwd = |S1|^2 + |S2|^2 at theta and at 180-theta of
    shape x.shape + (NTHETA,). ctbrqs is <cos(theta)> * qscat. nmax/n_start
    are static series caps; terms after the reference's
    |a_n|^2+|b_n|^2 < 1e-14 cutoff are masked out so the result equals the
    early-terminated series.
    """
    dtype = x.dtype
    m = torch.complex(m_re.to(dtype), -m_im.to(dtype))
    rx = 1.0 / x
    dn = _log_derivative(m * x, n_start, nmax)  # A_1..A_nmax

    cos_th = cos_th.to(dtype)
    si2 = 1.0 - cos_th * cos_th

    def col(v):
        return v[..., None]

    # Riccati-Bessel start: psi_n = Re(w_n), chi_n = Im(w_n)
    # (Scatter_0.py:1496-1501)
    w_m1 = torch.complex(torch.cos(x), -torch.sin(x))  # w_{-1}
    w_0 = torch.complex(torch.sin(x), torch.cos(x))  # w_0
    w_1 = rx * w_0 - w_m1

    def coeffs(n, d_n, w_nm1, w_n):
        ta = d_n / m + n * rx
        tb = d_n * m + n * rx
        a = (ta * w_n.real - w_nm1.real) / (ta * w_n - w_nm1)
        b = (tb * w_n.real - w_nm1.real) / (tb * w_n - w_nm1)
        return a, b

    a1, b1 = coeffs(1.0, dn[0], w_0, w_1)

    # n = 1 seed (pi_1 = 1, tau_1 = cos) with coefficient (2n+1)/(n(n+1))
    pi0 = torch.zeros_like(cos_th)
    pi1 = torch.ones_like(cos_th)
    tau0 = torch.zeros_like(cos_th)
    tau1 = cos_th
    c1 = 1.5
    s1f = c1 * (col(a1) * pi1 + col(b1) * tau1)
    s2f = c1 * (col(a1) * tau1 + col(b1) * pi1)
    s1b = c1 * (col(a1) * pi1 - col(b1) * tau1)
    s2b = c1 * (-col(a1) * tau1 + col(b1) * pi1)
    qe = 3.0 * (a1 + b1).real
    qs = 3.0 * (torch.abs(a1) ** 2 + torch.abs(b1) ** 2)
    ct = torch.zeros_like(qe)
    w_nm1, w_n, ap, bp = w_0, w_1, a1, b1
    done = torch.zeros(x.shape, dtype=torch.bool, device=x.device)

    for ni in range(2, nmax + 1):
        n = float(ni)
        t0 = 2.0 * n - 1.0
        pi2 = (t0 * pi1 * cos_th - n * pi0) / (n - 1.0)
        tau2 = cos_th * (pi2 - pi0) - t0 * si2 * pi1 + tau0
        # freeze the Riccati-Bessel recurrence once the series has
        # converged: chi_n grows without bound past n ~ x and would
        # overflow to inf/NaN in the masked-out lanes (poisoning the
        # derivatives)
        w_np = torch.where(done, w_n, t0 * rx * w_n - w_nm1)
        a, b = coeffs(n, dn[ni - 1], w_n, w_np)
        a = torch.where(done, ap, a)
        b = torch.where(done, bp, b)

        live = torch.where(done, 0.0, 1.0).to(dtype)
        g1 = (n - 1.0) * (n + 1.0) / n
        g2 = t0 / (n * (n - 1.0))
        ct = ct + live * (
            g1 * (ap * torch.conj(a) + bp * torch.conj(b)).real
            + g2 * (ap * torch.conj(bp)).real
        )
        t2 = 2.0 * n + 1.0
        qe = qe + live * t2 * (a + b).real
        term = torch.abs(a) ** 2 + torch.abs(b) ** 2
        qs = qs + live * t2 * term
        cn = t2 / (n * (n + 1.0))
        sgn = -1.0 if ni % 2 == 0 else 1.0
        lc = col(live) * cn
        s1f = s1f + lc * (col(a) * pi2 + col(b) * tau2)
        s2f = s2f + lc * (col(a) * tau2 + col(b) * pi2)
        s1b = s1b + lc * sgn * (col(a) * pi2 - col(b) * tau2)
        s2b = s2b + lc * sgn * (col(b) * pi2 - col(a) * tau2)
        done = done | (term < 1e-14)
        pi0, pi1, tau0, tau1 = pi1, pi2, tau1, tau2
        w_nm1, w_n, ap, bp = w_n, w_np, a, b

    scale = 2.0 * rx * rx
    i_fwd = torch.abs(s1f) ** 2 + torch.abs(s2f) ** 2
    i_bwd = torch.abs(s1b) ** 2 + torch.abs(s2b) ** 2
    return qe * scale, qs * scale, 2.0 * ct * scale, i_fwd, i_bwd


def size_distribution_number(iscat: int, rr, dsize):
    """n(r) for the supported distributions (reference miescat
    Scatter_0.py:1760-1777). dsize = (a, b, c/alpha) as tensors."""
    aa, bb, cc = dsize[0], dsize[1], dsize[2]
    if iscat == 1:  # standard gamma
        return torch.where(bb != 0.0, rr**cc * torch.exp(-rr / (aa * bb)),
                           1.0)
    if iscat == 2:  # log-normal
        return torch.where(
            bb != 0.0,
            1.0
            / (rr * bb * np.sqrt(2.0 * np.pi))
            * torch.exp(-((torch.log(rr) - torch.log(aa)) ** 2)
                        / (2.0 * bb**2)),
            1.0,
        )
    if iscat == 3:  # MCS modified gamma
        return torch.where(bb != 0.0, rr**aa * torch.exp(-bb * rr**cc), 1.0)
    if iscat == 4:  # single size
        return torch.ones_like(rr)
    raise ValueError(f"iscat={iscat} has no size distribution")


def _distribution_rmax(iscat: int, dsize):
    """Peak radius of the distribution (reference miescat
    Scatter_0.py:1693-1712), used by the auto-termination cutoff."""
    aa, bb, cc = dsize[0], dsize[1], dsize[2]
    if iscat == 1:
        return cc * aa * bb
    if iscat == 2:
        return torch.exp(torch.log(aa) - bb**2)
    if iscat == 3:
        return (aa / (bb * cc)) ** (1.0 / cc)
    return torch.zeros_like(aa)


def _simpson_weights(inr: int, delr, open_ended: bool):
    """Reference Simpson weights (Scatter_0.py:1786-1792): delr/3 at the
    ends (first point always; last point only in explicit mode), else
    alternating 2delr/3 (even m) / 4delr/3 (odd m). Host numpy: the grid is
    static."""
    m = np.arange(inr)
    vv = np.where(m % 2 == 0, 2.0 / 3.0, 4.0 / 3.0)
    vv[0] = 1.0 / 3.0
    if not open_ended:
        vv[-1] = 1.0 / 3.0
    return vv * delr


def miescat_grid(
    xlam,
    iscat: int,
    dsize,
    radii,
    weights,
    m_re,
    m_im,
    cos_th,
    nmax: int,
    n_start: int,
    open_ended: bool = False,
):
    """Size-distribution-averaged Mie properties (reference miescat
    Scatter_0.py:1600), batched over wavelengths: integrate
    qext/qscat/intensities over a static radius grid with Simpson weights.

    xlam, m_re, m_im: (NWAVE,); radii, weights: (NR,) tensors; cos_th:
    (NTHETA,). In open_ended mode the reference stops integrating once r
    exceeds the distribution peak AND n(r)*qscat drops below 1e-6 of its
    running max (Scatter_0.py:1778-1783); reproduced here with a cumulative
    mask over the (sufficiently long) static grid.

    Returns (xscat, xext, i_avg): cross sections (NWAVE,) in cm^2 and i_avg
    (NWAVE, 2*NTHETA), the distribution-weighted 0.5*(M1+M2) at the forward
    angles then at their supplements (see makephase).
    """
    x = 2.0 * np.pi * radii[None, :] / xlam[:, None]  # (NWAVE, NR)
    qe, qs, _, i_f, i_b = mie_single(
        x, m_re[:, None], m_im[:, None], cos_th, nmax, n_start)

    anr = size_distribution_number(iscat, radii, dsize)  # (NR,)

    if open_ended:
        # which radii count is a static mask of primal values
        rmax = _distribution_rmax(iscat, dsize).detach()
        nq = (anr[None, :] * qs).detach()
        nqmax = torch.cummax(nq, dim=1).values
        stop = (radii[None, :] >= rmax) & (nq <= 1e-6 * nqmax)
        stop_cum = torch.cumsum(stop.to(torch.int32), dim=1)
        stopped_before = torch.cat(
            [torch.zeros_like(stop_cum[:, :1]), stop_cum[:, :-1]], dim=1
        ) > 0
        live = torch.where(stopped_before, 0.0, 1.0).to(x.dtype)
    else:
        live = torch.ones_like(x)

    w = weights * anr * live  # (NWAVE, NR)
    area = np.pi * radii**2
    kscat = torch.sum(w * area * qs, dim=1)
    kext = torch.sum(w * area * qe, dim=1)
    anorm = torch.sum(w, dim=1)
    phas0 = torch.sum(
        w[..., None] * 0.5 * torch.cat([i_f, i_b], dim=-1), dim=1
    )
    xscat = kscat / anorm * 1e-8
    xext = kext / anorm * 1e-8
    i_avg = (xlam * xlam)[:, None] * phas0 / (np.pi * kscat)[:, None]
    return xscat, xext, i_avg


def _theta_fold(theta):
    """Fold angles to <=90 and build the 0..180 output set (reference
    makephase Scatter_0.py:1884-1900). Returns (theta_half, thetax,
    n_unique) as numpy (static geometry)."""
    theta = np.asarray(theta, float)
    half = np.where(theta > 90.0, 180.0 - theta, theta)
    half = np.unique(half)
    ntheta = half.size
    nphas = 2 * ntheta - 1 if 90.0 in half else 2 * ntheta
    thetax = np.zeros(nphas)
    thetax[:ntheta] = half
    for i in range(ntheta, nphas):
        thetax[i] = 180.0 - thetax[nphas - i - 1]
    return half, thetax, nphas


def radius_grid(rs, cap: int = 2048):
    """Static radius grid from the reference's rs = (r1, r2, delr) spec
    (Scatter_0.py:1675-1686): explicit when r2 >= r1 (padded to even count),
    else open-ended with ``cap`` points. Host numpy."""
    r1, r2, delr = float(rs[0]), float(rs[1]), float(rs[2])
    if r2 < r1:
        inr = cap
        open_ended = True
    else:
        inr = 1 + int((r2 - r1) / delr)
        if inr > 1 and inr % 2 != 0:
            inr += 1
        open_ended = False
    radii = r1 + np.arange(inr) * delr
    return radii, _simpson_weights(inr, delr, open_ended), open_ended


def _henyey2(calpha, f, g1, g2):
    x1 = (1.0 - g1 * g1) / (1.0 + g1 * g1 - 2.0 * g1 * calpha) ** 1.5
    x2 = (1.0 - g2 * g2) / (1.0 + g2 * g2 - 2.0 * g2 * calpha) ** 1.5
    return f * x1 + (1.0 - f) * x2


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def makephase(
    wavel,
    iscat: int,
    pars,
    rs,
    refindx,
    theta,
    nmax: int | None = None,
    n_start: int | None = None,
    rs_cap: int = 2048,
    dtype=None,
    device=None,
):
    """Cross sections and phase functions for one aerosol population over a
    wavelength grid (reference makephase Scatter_0.py:1835).

    wavel (NWAVE,) microns; refindx (NWAVE, 2) real/imag refractive index;
    theta (NTHETA,) degrees 0..90 (larger folds to 180-theta).
    iscat: 1 gamma / 2 log-normal / 3 MCS gamma / 4 single size /
    5 isotropic / 6 double-HG / 7 dipole. ``pars``/``refindx`` may be
    tensors (model 444 differentiates through them), which set the device
    and type; host inputs become tensors of ``dtype`` (float64 by default)
    on ``device`` (None = CUDA; raises without a card unless
    ``device="cpu"``).

    Float32 is not safe for the Mie distributions (1-4): for some size
    parameters the float32 series stalls just above its 1e-14 cutoff and
    overflows (model 444 runs in float64).

    Returns (xscat, xext, thetax, phas): cross sections (NWAVE,) cm^2,
    output angles (NPHAS,) 0..180 deg (host numpy), phase (NWAVE, NPHAS)
    normalised so that the integral over 4pi of p/(4pi) is 1 (the
    reference's "normalised to X" convention before its /4pi).
    """
    for v in (pars, refindx, wavel):
        if isinstance(v, torch.Tensor):
            dtype = v.dtype if dtype is None else dtype
            device = v.device if device is None else device
            break
    else:
        device = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype

    def t(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(v, dtype=np.float64),
                               dtype=dtype, device=device)

    wavel_host = wavel
    wavel = t(wavel)
    theta_half, thetax, nphas = _theta_fold(theta)
    nth = theta_half.size
    cos_half = t(np.cos(np.deg2rad(theta_half)))
    calpha_x = t(np.cos(np.deg2rad(thetax)))
    nwave = wavel.shape[0]

    if iscat in (1, 2, 3, 4):
        pars = t(pars)
        dsize = torch.cat(
            [pars, pars.new_zeros(max(0, 3 - pars.shape[0]))])[:3]
        refindx = t(refindx)
        if iscat == 4:
            # single size: one-point "grid" (Scatter_0.py:1327-1329)
            radii = dsize[:1]
            weights = t(np.array([1.0]))
            open_ended = False
        else:
            radii_np, weights_np, open_ended = radius_grid(rs, cap=rs_cap)
            radii, weights = t(radii_np), t(weights_np)
        if n_start is None or nmax is None:
            # static series caps over the whole (r, lambda, m) grid, with
            # the reference's 1.1*|m|x margin and 150 floor
            # (Scatter_0.py:1458), read from the host values: pass explicit
            # nmax/n_start when the inputs are differentiated
            xmax = float(2.0 * np.pi * np.max(_host(radii))
                         / np.min(_host(wavel_host)))
        if n_start is None:
            ri = _host(refindx)
            mmax = float(np.max(np.abs(ri[:, 0] + 1j * ri[:, 1])))
            n_start = max(150, int(1.2 * mmax * xmax) + 20)
        if nmax is None:
            nmax = min(n_start,
                       max(60, int(xmax + 4.05 * xmax ** (1.0 / 3.0)) + 20))

        xscat, xext, i_all = miescat_grid(
            wavel, iscat, dsize, radii, weights, refindx[:, 0],
            refindx[:, 1], cos_half, nmax, n_start, open_ended,
        )
        # i_all columns: fwd theta_half then bwd; the thetax tail is
        # 180-theta_half[nphas-i-1]: bwd angle j corresponds to
        # 180-theta_half[j], so the tail is the bwd block reversed, without
        # the duplicated 90-degree point when present
        i_fwd = i_all[:, :nth]
        tail = torch.flip(i_all[:, nth:], dims=(1,))
        if nphas == 2 * nth - 1:
            tail = tail[:, 1:]
        phas = torch.cat([i_fwd, tail], dim=1)
        return xscat, xext, thetax, phas

    zeros = wavel.new_zeros(nwave)
    if iscat == 5:  # isotropic
        return zeros, zeros.clone(), thetax, wavel.new_ones((nwave, nphas))

    if iscat == 6:  # double Henyey-Greenstein
        pars = t(pars)
        phase_row = _henyey2(calpha_x, pars[0], pars[1], pars[2])
        return zeros, zeros.clone(), thetax, phase_row.expand(nwave, nphas)

    if iscat == 7:  # dipole (Scatter_0.py:1919-1937)
        pars = t(pars)
        refindx = t(refindx)
        rr = pars[0]
        nc = torch.complex(refindx[:, 0], -refindx[:, 1])
        x = 2.0 * np.pi * rr / wavel
        ratio = (nc**2 - 1.0) / (nc**2 + 2.0)
        qsca = (8.0 / 3.0) * x**4 * torch.abs(ratio)
        qabs = -4.0 * x * ratio.imag
        qext = qsca + qabs
        gsec = np.pi * (rr * 1e-4) ** 2
        xext = qext * gsec
        xscat = xext * (qsca / qext)
        phas = (0.75 * (1.0 + calpha_x**2)).expand(nwave, nphas)
        return xscat, xext, thetax, phas

    raise ValueError(f"iscat={iscat} not supported")


def kk_new_sub(vi, k_im, vm, nm, device=None):
    """Kramers-Kronig: real refractive index from the imaginary spectrum
    and an anchor n(vm)=nm (reference kk_new_sub Scatter_0.py:2169), as one
    (N, N) kernel + trapezoid. ``vi`` is a host grid; ``k_im`` a tensor
    (model 444 differentiates through it) or a host array, made a float64
    tensor on ``device`` (None = CUDA; raises without a card unless
    ``device="cpu"``)."""
    vi = np.asarray(vi, dtype=np.float64)
    if not isinstance(k_im, torch.Tensor):
        k_im = torch.as_tensor(np.asarray(k_im, dtype=np.float64),
                               device=resolve_device(device))
    rev = bool(vi[0] > vi[-1])
    va = k_im.new_tensor(vi[::-1].copy() if rev else vi)
    ka = torch.flip(k_im, dims=(0,)) if rev else k_im

    km = interp(k_im.new_tensor(vm), va, ka)
    v2 = va**2
    alpha = v2[None, :] - v2[:, None]  # (i, j)
    beta = v2[None, :] - vm**2
    d1 = (ka * va)[None, :] - (ka * va)[:, None]
    d2 = (ka * va)[None, :] - km * vm
    y = torch.where(
        (alpha != 0.0) & (beta != 0.0),
        d1 / torch.where(alpha == 0.0, 1.0, alpha)
        - d2 / torch.where(beta == 0.0, 1.0, beta),
        0.0,
    )
    dv = va[1:] - va[:-1]
    integral = torch.sum(0.5 * (y[:, 1:] + y[:, :-1]) * dv[None, :], dim=1)
    na = nm - (2.0 / np.pi) * integral
    return torch.flip(na, dims=(0,)) if rev else na


def subfithgm(theta, phase, tol: float = 1e-8, nc_max: int = 5,
              nover: int = 1000):
    """Fit a double Henyey-Greenstein to phase functions in log space with
    a bounded Levenberg-Marquardt loop (reference subfithgm
    Scatter_0.py:1948, mrqminl:2017). Host numpy, as in the JAX package:
    an offline property-fitting utility (IMIE=0 deck preparation).

    theta (NPHAS,) degrees; phase (NWAVE, NPHAS) normalised to 4pi.
    Returns (f, g1, g2, rms) each (NWAVE,).
    """
    theta = np.asarray(theta, float)
    phase = np.atleast_2d(_host(phase))
    calpha = np.cos(np.deg2rad(theta))
    nwave = phase.shape[0]

    def hg(x):
        return _henyey2_np(calpha, x[0], x[1], x[2])

    def jac_fd(x, base):
        kk = np.zeros((theta.size, 3))
        for j in range(3):
            xt = x.copy()
            dx = 0.01
            xt[j] = x[j] + dx
            if j == 0 and xt[j] > 0.99:
                xt[j] = x[j] - dx
            if j == 1 and xt[j] > 0.98:
                xt[j] = x[j] - dx
            kk[:, j] = (hg(xt) - base) / (xt[j] - x[j])
        return kk

    bounds_lo = np.array([1e-6, 0.0, -0.98])
    bounds_hi = np.array([0.999999, 0.98, -0.1])

    f = np.zeros(nwave)
    g1 = np.zeros(nwave)
    g2 = np.zeros(nwave)
    rms = np.zeros(nwave)
    for iw in range(nwave):
        lph = np.log(phase[iw])
        x = np.array([0.5, 0.5, -0.5])

        def cof(xv):
            base = hg(xv)
            kk = jac_fd(xv, base) / base[:, None]
            resid = lph - np.log(base)
            alpha = kk.T @ kk
            beta = kk.T @ resid
            chisq = float(resid @ resid)
            return alpha, beta, chisq

        alpha, beta, chisq = cof(x)
        ochisq = chisq
        alamda = 1000.0
        nc = 0
        for _ in range(nover):
            prev = chisq
            covar = alpha + np.diag(np.diag(alpha) * alamda)
            try:
                da = np.linalg.solve(covar, beta)
            except np.linalg.LinAlgError:
                break
            xt = np.clip(x + da, bounds_lo, bounds_hi)
            alpha_t, beta_t, chisq_t = cof(xt)
            if chisq_t <= ochisq:
                alamda *= 0.9
                x, alpha, beta = xt, alpha_t, beta_t
                chisq = ochisq = chisq_t
                rel = abs(chisq - prev) / (chisq + prev + 1e-30)
                if rel < tol:
                    nc += 1
                    if nc > nc_max:
                        break
                else:
                    nc = 0
            else:
                alamda = min(alamda * 1.5, 1e36)
        f[iw], g1[iw], g2[iw] = x
        rms[iw] = np.sqrt(chisq)
    return f, g1, g2, rms


def _henyey2_np(calpha, f, g1, g2):
    x1 = (1.0 - g1 * g1) / (1.0 + g1 * g1 - 2.0 * g1 * calpha) ** 1.5
    x2 = (1.0 - g2 * g2) / (1.0 + g2 * g2 - 2.0 * g2 * calpha) ** 1.5
    return f * x1 + (1.0 - f) * x2
