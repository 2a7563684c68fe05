"""Plane-parallel multiple scattering by the matrix operator method
(adding-doubling), in plain tensor operations of the type of the inputs.

The equations are Plass, Hansen & Kattawar (1973, Appl. Opt. 12, 314) as
NEMESIS uses them (Irwin et al. 2008, JQSRT 109, 1136) and archNEMESIS
writes them in ``Multiple_Scattering_Core.py``:

- ``phasint2``: each phase function's azimuthal Fourier components over
  NPHI + 1 trapezoid azimuths, 1 / (2 pi) for component 0 and 1 / pi for
  the others, between the quadrature's zenith cosines in the same (``+``)
  and opposite (``-``) hemispheres;
- ``hansen``: the component-0 ``+`` matrix renormalised, sweep by sweep,
  until every column's reflection plus transmission is 1 within 1e-14;
  the factors scale the ``+`` matrices of every component;
- ``calc_rtj_matrix``: each layer's reflection R, transmission T and
  thermal source J: by ``double1`` where it scatters (a layer of
  tau 2^-nn, nn = int(log2(tau) + 12) capped at 35, doubled nn times by
  ``add``), exp(-tau / mu) where it only absorbs, the identity where it
  is empty;
- ``add`` / ``addp``: one layer on top of another, (E - Rsub R1)^-1 where
  the test norm (``add``: ||R1||_F; ``addp``: ||Rsub R1||_F) exceeds 0.1
  / 0.01, its series E + Rsub R1 otherwise;
- ``scloud11wave_core``: the layers added from the far end up, the
  upward radiance at the top from the ground's and the Sun's, the
  bilinear interpolation in the emission and solar zenith cosines
  (``angle_quadrature``) and the sum over the azimuth's Fourier
  components.

Departures from archNEMESIS: every (wave, g, layer) at once (a batch of
small matrices; an element's doubling stops at its own nn through a
mask) and one Fourier component after another with no convergence break
(all NF + 1 are summed); the inverse by Gauss-Jordan elimination with
partial pivoting in the inputs' type (archNEMESIS inverts in float64);
Hansen's sweeps stop per wave (archNEMESIS runs a wave at a time) or
after 10,000; the Rayleigh phase function is always in the scattering;
lookdown only (emission angle below 90 degrees). Imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nembench.reference import nadir

# archNEMESIS's doubling: a thin layer of tau 2^-nn, nn = int(log2 tau +
# IPOW0), doubled at most NN_MAX times
IPOW0, NN_MAX = 12, 35
# Hansen's renormalisation: its test and its most sweeps
HANSEN_TOL, HANSEN_SWEEPS = 1.0e-14, 10_000
# the series / inverse branches of ``add`` (doubling) and ``addp`` (path)
DOUBLING_THRESH, PATH_THRESH = 0.1, 0.01


def henyey_greenstein2(c, f, g1, g2):
    """Two-term Henyey-Greenstein phase function over 4 pi at the cosines
    ``c``."""
    def hg(g):
        return (1.0 - g * g) / (1.0 + g * g - 2.0 * g * c) ** 1.5

    return (f * hg(g1) + (1.0 - f) * hg(g2)) / (4.0 * math.pi)


def rayleigh_phase(c):
    """Rayleigh's phase function over 4 pi."""
    return 0.75 * (1.0 + c * c) / (4.0 * math.pi)


def fourier_phase(phase, mu, nphi: int, ic: int):
    """(plus, minus): component ``ic`` of ``phase`` between the zenith
    cosines ``mu`` (NMU,) in the same and in opposite hemispheres,
    (..., NMU, NMU) with ``phase``'s leading axes."""
    phi = torch.arange(nphi + 1, dtype=mu.dtype, device=mu.device) * (
        2.0 * math.pi / nphi)
    w = torch.full_like(phi, 2.0 * math.pi / nphi)
    w[0] = w[-1] = math.pi / nphi
    w = w * torch.cos(ic * phi) / (2.0 * math.pi if ic == 0 else math.pi)
    sin = torch.sqrt(1.0 - mu * mu)
    across = (sin[:, None] * sin[None, :])[..., None] * torch.cos(phi)
    along = (mu[:, None] * mu[None, :])[..., None]
    plus = (across + along).clamp(-1.0, 1.0)
    minus = (across - along).clamp(-1.0, 1.0)
    return ((phase(plus) * w).sum(-1), (phase(minus) * w).sum(-1))


def hansen_factors(plus0, minus0, wt):
    """Hansen's (1971) factors of the component-0 ``+`` matrices
    (..., NMU, NMU): swept per leading element until its worst column
    misses 1 by less than ``HANSEN_TOL``, or ``HANSEN_SWEEPS`` sweeps."""
    refl = 2.0 * math.pi * (minus0 * wt[:, None]).sum(-2)  # (..., NMU)
    fc = torch.ones_like(plus0)
    for _ in range(HANSEN_SWEEPS):
        trans = 2.0 * math.pi * (plus0 * fc * wt[:, None]).sum(-2)
        open_ = (refl + trans - 1.0).abs().amax(-1) >= HANSEN_TOL
        if not bool(open_.any()):
            break
        x = (1.0 - refl) / trans
        step = 0.5 * (x[..., :, None] + x[..., None, :])
        fc = torch.where(open_[..., None, None], fc * step, fc)
    return fc


def inverse(a):
    """(..., n, n) inverses by Gauss-Jordan elimination with partial
    pivoting."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    m = torch.cat([a, eye.expand(a.shape)], dim=-1)
    rows = torch.arange(n, device=a.device)
    for k in range(n):
        p = k + m[..., k:, k].abs().argmax(dim=-1, keepdim=True)
        swap = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        m = torch.gather(m, -2, swap[..., None].expand(m.shape))
        pivot = m[..., k:k + 1, :] / m[..., k:k + 1, k:k + 1]
        m = torch.where((rows == k)[:, None], pivot,
                        m - m[..., :, k:k + 1] * pivot)
    return m[..., n:]


def add(top, sub, thresh: float, test_product: bool):
    """(R, T, J) of layer ``top`` (R1, T1, J1) laid on ``sub`` (Rsub, Tsub,
    Jsub), radiance leaving through ``top``."""
    r1, t1, j1 = top
    rsub, tsub, jsub = sub
    eye = torch.eye(r1.shape[-1], dtype=r1.dtype, device=r1.device)
    rr = rsub @ r1
    test = rr if test_product else r1
    big = torch.sqrt((test * test).sum((-2, -1)))[..., None, None] > thresh
    acom = torch.where(big, inverse(eye - rr), eye + rr)
    ccom = t1 @ acom
    return (r1 + ccom @ rsub @ t1, ccom @ tsub,
            j1 + ccom @ (rsub @ j1 + jsub))


def layer_rtj(taut, omega, plus, minus, planck_bc, mu, wt, ic: int):
    """(R, T, J) of every layer, (..., NMU, NMU) and (..., NMU, 1):
    ``taut``, ``omega``, ``planck_bc`` (...,), ``plus``, ``minus`` the
    layer's mean phase matrices (..., NMU, NMU) of component ``ic``."""
    nmu = mu.shape[0]
    eye = torch.eye(nmu, dtype=mu.dtype, device=mu.device)
    source = 1.0 if ic == 0 else 0.0
    con = (omega * math.pi * (2.0 if ic == 0 else 1.0))[..., None, None]
    gplus = (eye - con * plus * wt) / mu[:, None]
    gminus = con * minus * wt / mu[:, None]
    safe = torch.where(taut > 0, taut, 1.0)
    nn = torch.trunc(torch.log2(safe) + IPOW0).clamp(max=NN_MAX)
    tau0 = torch.where(nn >= 1, safe * torch.exp2(-nn), safe)
    tau0 = tau0[..., None, None]
    r = tau0 * gminus
    t = eye - tau0 * gplus
    j = (source * (1.0 - omega) * planck_bc)[..., None, None] * tau0 / mu[
        :, None]
    for step in range(int(nn.max()) if nn.numel() else 0):
        rn, tn, jn = add((r, t, j), (r, t, j), DOUBLING_THRESH, False)
        go = (nn > step)[..., None, None]
        r, t, j = (torch.where(go, a, b) for a, b in ((rn, r), (tn, t),
                                                      (jn, j)))
    # a layer that only absorbs, and an empty one
    trans = torch.exp(-safe[..., None] / mu)  # (..., NMU)
    t_abs = torch.diag_embed(trans)
    j_abs = (source * planck_bc[..., None] * (1.0 - trans))[..., None]
    scatters = ((taut > 0) & (omega > 0))[..., None, None]
    empty = (taut <= 0)[..., None, None]
    zero = torch.zeros_like(r)
    r = torch.where(scatters, r, zero)
    t = torch.where(empty, eye, torch.where(scatters, t, t_abs))
    j = torch.where(empty, 0.0, torch.where(scatters, j, j_abs))
    return r, t, j


def _bracket(z, mu):
    """(i, w): archNEMESIS's ``angle_quadrature`` on the descending
    cosines ``mu`` (host numpy): the last i with mu[i] >= z > mu[i + 1]
    (0 above mu[0], NMU - 2 at or below mu[-1]) and z's linear weight
    towards mu[i + 1]."""
    n = len(mu)
    i = 0
    for k in range(n - 1):
        if mu[k] >= z > mu[k + 1]:
            i = k
    if z <= mu[-1]:
        i = n - 2
    if z > mu[0]:
        i = 0
    return i, (mu[i] - z) / (mu[i] - mu[i + 1])


def radiance(mu, wt, nf: int, nphi: int, modes, bnu, taut, tauray,
             tauscat, frac, radg, solar, sol_ang, emiss_ang, azi_ang,
             surface=None):
    """Upward radiance at the top, (NWAVE, NG, NPATH).

    ``mu``, ``wt``: the quadrature's zenith cosines and weights, ascending
    (host sequences); ``modes``: the aerosol modes' phase functions of
    (NWAVE, 1, 1, 1)-broadcast cosines, each ``c -> p``; ``bnu`` (NWAVE,
    NLAY) the layers' Planck radiance; ``taut`` (NWAVE, NG, NLAY) total
    optical depth; ``tauray``, ``tauscat`` (NWAVE, NLAY) Rayleigh and
    aerosol scattering optical depths; ``frac`` (NWAVE, NMODE, NLAY) each
    mode's share of ``tauscat``; ``radg`` (NWAVE, NMU) the ground's
    upward radiance in ``mu``'s order; ``solar`` (NWAVE,) the Sun's flux;
    the path angles in degrees (sequences of NPATH); ``surface`` (NWAVE,
    NMU, NMU, NF + 1) the ground's BRDF components (emission cosine,
    solar cosine, both in ``mu``'s order) or None (no reflecting ground).
    Layer 0 lies furthest from the observer.
    """
    like = dict(dtype=taut.dtype, device=taut.device)
    order = np.argsort(-np.asarray(mu, np.float64))  # descending
    mu_h = np.asarray(mu, np.float64)[order]
    mu_t = torch.as_tensor(mu_h, **like)
    wt_t = torch.as_tensor(np.asarray(wt, np.float64)[order], **like)
    index = torch.as_tensor(order, device=taut.device)
    radg = radg[:, index]
    if surface is not None:
        surface = surface[:, index][:, :, index]
    nwave, ng, nlay = taut.shape
    nmu = mu_t.shape[0]

    # the total single scattering albedo held to [0, 1], and the aerosol's
    # part of it left once Rayleigh's is taken (scloud11wave_core)
    safe = torch.where(taut > 0, taut, 1.0)
    omega_in = ((tauscat + tauray)[:, None, :] / safe).clamp(0.0, 1.0)
    aer = (taut * omega_in - tauray[:, None, :]).clamp(min=0.0)
    scat = aer + tauray[:, None, :]
    omega = torch.where(taut > 0, scat / safe, 0.0)
    scat_safe = torch.where(scat > 0, scat, 1.0)
    w_ray = (tauray[:, None, :] / scat_safe)[..., None, None]
    w_aer = (aer / scat_safe)[..., None, None]  # (NWAVE, NG, NLAY, 1, 1)

    def phase(fn, ic):
        return fourier_phase(fn, mu_t, nphi, ic)

    fns = [rayleigh_phase, *modes]
    # Hansen's factors from component 0, per phase function and wave
    factors = []
    for fn in fns:
        plus0, minus0 = phase(fn, 0)
        plus0 = plus0.expand(nwave, nmu, nmu)
        minus0 = minus0.expand(nwave, nmu, nmu)
        factors.append(hansen_factors(plus0, minus0, wt_t))

    sol = []  # per path: solar node, weight, emission node, weight, on
    for s, e in zip(np.atleast_1d(sol_ang), np.atleast_1d(emiss_ang)):
        z0 = math.cos(math.radians(180.0 - s if s > 90.0 else s))
        i0, u = _bracket(z0, mu_h)
        ie, t = _bracket(math.cos(math.radians(e)), mu_h)
        sol.append((i0, u, ie, t, 1.0 if s <= 90.0 else 0.0))
    azi = np.atleast_1d(np.asarray(azi_ang, np.float64))

    out = torch.zeros((nwave, ng, len(sol)), **like)
    for ic in range(nf + 1):
        plus_ray, minus_ray = phase(rayleigh_phase, ic)
        plus = w_ray * (plus_ray * factors[0])[:, None, None]
        minus = w_ray * minus_ray.expand(nwave, nmu, nmu)[:, None, None]
        for m, fn in enumerate(modes):
            p, q = phase(fn, ic)
            share = w_aer * frac[:, m][:, None, :, None, None]
            plus = plus + share * (p * factors[m + 1])[:, None, None]
            minus = minus + share * q.expand(nwave, nmu, nmu)[:, None, None]
        r, t, j = layer_rtj(taut, omega, plus, minus, bnu[:, None, :],
                            mu_t, wt_t, ic)

        source = 1.0 if ic == 0 else 0.0
        if surface is None:
            acc = (r[:, :, 0], t[:, :, 0], j[:, :, 0])
            first = 1
        else:
            rs = (2.0 * math.pi * surface[..., ic] * mu_t * wt_t
                  * (0.5 / float((mu_t * wt_t).sum())))
            rs = rs[:, None].expand(nwave, ng, nmu, nmu)
            js = (source * radg)[:, None, :, None].expand(nwave, ng, nmu, 1)
            acc = (rs, torch.zeros_like(rs), js)
            first = 0
        for lay in range(first, nlay):
            acc = add((r[:, :, lay], t[:, :, lay], j[:, :, lay]), acc,
                      PATH_THRESH, True)
        r_top, t_top, j_top = acc

        ground = (source * radg)[:, None, :, None]  # (NWAVE, 1, NMU, 1)
        up = (t_top @ ground + source * j_top)[..., 0]  # (NWAVE, NG, NMU)
        weight = (1.0 if ic == 0 else 2.0)
        for k, (i0, u, ie, t_e, on) in enumerate(sol):
            beam = on * solar / (2.0 * math.pi)  # (NWAVE,)
            cols = [up + r_top[..., i0 + d] * (beam / wt_t[i0 + d])[:, None,
                                                                    None]
                    for d in (0, 1)]
            drad = ((1 - t_e) * (1 - u) * cols[0][..., ie]
                    + t_e * (1 - u) * cols[0][..., ie + 1]
                    + (1 - t_e) * u * cols[1][..., ie]
                    + t_e * u * cols[1][..., ie + 1])
            out[..., k] += weight * math.cos(ic * math.radians(azi[k])) * drad
    return out


def dust_columns(h, p, dust, nlay: int, nint: int, layht: float):
    """(NLAY, NDUST) [particles m-2] of ``dust`` (NLEVEL, NDUST) [particles
    m-3] through the layers of ``nadir.layers`` (the same bases and
    Simpson samples): its integral along the vertical."""
    base = torch.maximum(h.new_tensor(layht), h[0])
    pbot = nadir.interp_extrap(h, p, base)
    frac = torch.arange(nlay, dtype=h.dtype, device=h.device) / nlay
    basep = torch.exp(torch.log(pbot) * (1 - frac) + torch.log(p[-1]) * frac)
    baseh = nadir.interp_extrap(p.flip(0), h.flip(0), basep)
    delh = torch.cat([baseh[1:] - baseh[:-1], (h[-1] - baseh[-1])[None]])
    s = torch.linspace(0.0, 1.0, nint, dtype=h.dtype, device=h.device)
    hgt = baseh[:, None] + delh[:, None] * s[None, :]
    dust_s = nadir.interp_extrap(h, dust, hgt.reshape(-1)).reshape(
        nlay, nint, -1)
    w = h.new_tensor(nadir.simpson_weights(nint))
    return torch.einsum("lik,i->lk", dust_s, w) * (delh / (nint - 1))[:,
                                                                      None]
