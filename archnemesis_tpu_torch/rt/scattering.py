"""Plane-parallel multiple scattering: adding-doubling / matrix-operator
method.

Port of the array-of-structures (AoS) core of the JAX package's
``rt/scattering.py`` (reference ``Multiple_Scattering_Core.py``
scloud11wave_core:652 and its helpers): every stage is batched over the
(Fourier component, wave, g, layer) axes as (..., nmu, nmu) stacks, so the
card sees large batched matrix products and inverses. Three data-dependent
loops of the reference are Python loops here, their bounds read once from
primal values (which every tangent of ``torch.func.jacfwd`` shares):

- the tau-dependent doubling count of ``double1`` (Multiple_Scattering_
  Core.py:322, ``nn = int(log2(taut)+12)``) runs ``min(max(nn), NN_MAX)``
  doubling steps with per-element masking (an element stops where the
  reference stops it);
- the Hansen (1971) normalisation sweep (:201) runs until its global test
  drops under 1e-14 (one host read per sweep);
- the layer-adding scan is a loop over layers.

The per-wavelength Fourier convergence break (:949-958) becomes a full
fixed-NF evaluation. Branch thresholds (Frobenius-norm series-vs-inverse
switches in ``add``:277 and ``addp``:482) follow the reference exactly.

Float32 runs this same AoS algebra with the unrolled Gauss-Jordan inverse
``_inv_small``; float64 uses ``torch.linalg.inv``. The JAX package's float32
struct-of-arrays "rows" core exists for the TPU's (8, 128) register tile and
has no counterpart here. The phase-matrix stacks are built in float64 and
cast to the run's type (their Hansen test of 1e-14 needs float64).

Spans (``utils/profiling.annotate``, off unless a profiler records):
``nemesis.scatter.phase`` around the phase-matrix stacks with Hansen's
normalisation (once a forward) and, in ``forward.py``, the BRDF Fourier
matrix; per wave tile ``nemesis.scatter.doubling`` around ``layer_rtj``
with its ladder and ``nemesis.scatter.adding`` around ``combine_path``,
the angle interpolation and the azimuth sum. Counters
(``utils/profiling.count``): ``scatter.hansen_reads`` (a host read a
Hansen sweep), ``scatter.ladder_reads`` (a host read a ladder bound) and
``scatter.tiles`` (a core call a wave tile).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from archnemesis_tpu_torch.utils.profiling import annotate, count

# Doubling ladder depth: supports taut up to 2^(NN_MAX-12) ~ 8.4e6 before
# the initial thin layer stops getting thinner (reference ipow0 = 12).
NN_MAX = 35


@dataclass(frozen=True)
class ScatterQuadrature:
    """Static zenith quadrature + azimuth expansion config (.set file;
    reference Scatter_0 NMU/MU/WTMU/NF/NPHI)."""

    mu: tuple  # (NMU,) ascending as in the .set file
    wtmu: tuple
    nf: int
    nphi: int

    @property
    def nmu(self) -> int:
        return len(self.mu)

    # Descending ordering used inside the core (reference :724 mu = mu1[::-1])
    @property
    def mu_desc(self) -> np.ndarray:
        return np.asarray(self.mu, dtype=np.float64)[::-1].copy()

    @property
    def wtmu_desc(self) -> np.ndarray:
        return np.asarray(self.wtmu, dtype=np.float64)[::-1].copy()


# ---------------------------------------------------------------------------
# Phase functions and their azimuth Fourier integration
# ---------------------------------------------------------------------------


def henyey_greenstein2(calpha, f, g1, g2):
    """Two-term Henyey-Greenstein phase function /4pi (reference phasint2
    iscat==2 branch, Multiple_Scattering_Core.py:163-174)."""
    hg11 = 1.0 - g1 * g1
    hg12 = 2.0 - hg11
    hg21 = 1.0 - g2 * g2
    hg22 = 2.0 - hg21
    p = (
        f * hg11 / torch.sqrt(hg12 - 2.0 * g1 * calpha) ** 3
        + (1.0 - f) * hg21 / torch.sqrt(hg22 - 2.0 * g2 * calpha) ** 3
    )
    return p / (4.0 * np.pi)


def _angle_grids(mu_desc: np.ndarray, nphi: int):
    """Static (nmu, nmu, nphi+1) cos(scattering angle) grids for the + and -
    hemispheres (reference phasint2:146-158), host float64."""
    mu = np.asarray(mu_desc)
    phi = np.arange(nphi + 1) * (2.0 * np.pi / nphi)
    sth = np.sqrt(1.0 - mu**2)
    sth_sth = sth[:, None] * sth[None, :]
    mu_mu = mu[:, None] * mu[None, :]
    cpl = sth_sth[:, :, None] * np.cos(phi)[None, None, :] + mu_mu[:, :, None]
    cmi = sth_sth[:, :, None] * np.cos(phi)[None, None, :] - mu_mu[:, :, None]
    return np.clip(cpl, -1.0, 1.0), np.clip(cmi, -1.0, 1.0), phi


def _phi_weights(ic: int, nphi: int, phi: np.ndarray) -> np.ndarray:
    """Trapezoid azimuth weights x cos(ic phi) (reference phasint2:179-191)."""
    dphi = 2.0 * np.pi / nphi
    wphi = np.full(phi.shape, dphi)
    wphi[0] = 0.5 * dphi
    wphi[-1] = 0.5 * dphi
    wphi = wphi / (2.0 * np.pi) if ic == 0 else wphi / np.pi
    return wphi * np.cos(ic * phi)


def phase_matrices(phase_fn, mu_desc, nphi: int, ic: int, device=None):
    """Azimuth-integrated phase matrices (pplpl, pplmi), each (..., nmu, nmu),
    for a broadcastable elementwise ``phase_fn(calpha)`` of a float64
    tensor (reference phasint2)."""
    cpl, cmi, phi = _angle_grids(mu_desc, nphi)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    w = t(_phi_weights(ic, nphi, phi))
    pplpl = torch.einsum("...k,k->...", phase_fn(t(cpl)), w)
    pplmi = torch.einsum("...k,k->...", phase_fn(t(cmi)), w)
    return pplpl, pplmi


def _rayleigh(c):
    return 0.75 * (1.0 + c * c) / (4.0 * np.pi)


def rayleigh_phase_matrices(mu_desc, nphi: int, ic: int, device=None):
    return phase_matrices(_rayleigh, mu_desc, nphi, ic, device=device)


def hansen_normalise(pplpl, pplmi, wtmu):
    """Hansen (1971) renormalisation factor fc for the ic=0 phase matrices
    (reference hansen, Multiple_Scattering_Core.py:201-234).

    pplpl/pplmi: (..., nmu, nmu) batched. Returns (pplpl * fc, fc). The
    reference's triangular in-place sweep preserves fc symmetry, so one
    sweep is fc <- fc * 0.5*(x_i + x_j) with x_j = (1-rsum_j)/tsum_j. The
    sweeps stop once the largest |rsum + tsum - 1| over the whole batch is
    under 1e-14, or after 10,000 sweeps; the test is read on the host once
    per sweep.
    """
    x1 = 2.0 * np.pi
    wt = pplpl.new_tensor(np.asarray(wtmu))
    rsum = torch.einsum("...ij,i->...j", pplmi, wt) * x1  # (..., nmu)

    def test_of(fc):
        tsum = torch.einsum("...ij,i,...ij->...j", pplpl, wt, fc) * x1
        count("scatter.hansen_reads")
        return tsum, float(torch.max(torch.abs(rsum + tsum - 1.0)))

    fc = torch.ones_like(pplpl)
    _, test = test_of(fc)
    it = 0
    while test >= 1e-14 and it < 10000:
        tsum, test = test_of(fc)
        if test >= 1e-14:
            x = (1.0 - rsum) / tsum  # (..., nmu)
            fc = fc * 0.5 * (x[..., :, None] + x[..., None, :])
        it += 1
    return pplpl * fc, fc


# ---------------------------------------------------------------------------
# R/T/J algebra (all (..., nmu, nmu) batched)
# ---------------------------------------------------------------------------


def _frob(r):
    return torch.sqrt(torch.sum(r * r, dim=(-2, -1)))


def _inv_small(a):
    """Batched inverse of small (..., n, n) matrices by unrolled
    Gauss-Jordan elimination (no pivoting), as the JAX package's float32
    AoS body takes it. No pivoting is safe here: every inverse in the
    doubling/adding algebra is of ``E - Rsub@R1`` with spectral radius < 1
    (passive layers), which is strictly diagonally dominant in practice.
    """
    n = a.shape[-1]
    m = a
    inv = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    keep_all = ~torch.eye(n, dtype=torch.bool, device=a.device)
    for k in range(n):
        pivot = m[..., k : k + 1, k : k + 1]
        mk = m[..., k : k + 1, :] / pivot
        ik = inv[..., k : k + 1, :] / pivot
        factor = m[..., :, k : k + 1]
        keep = keep_all[:, k : k + 1]
        m = torch.where(keep, m - factor * mk, mk)
        inv = torch.where(keep, inv - factor * ik, ik)
    return inv


def _inv_combine(m):
    """Inverse used by the R/T/J algebra: the unrolled Gauss-Jordan in
    float32, ``torch.linalg.inv`` (LAPACK-ordered on the CPU) in float64,
    where the reference-parity tests hold rtol 1e-10."""
    if m.dtype == torch.float32:
        return _inv_small(m)
    return torch.linalg.inv(m)


def _combine(r1, t1, j1, rsub, tsub, jsub, j_on, thresh: float,
             frob_of_rsq: bool):
    """Combine layer (r1,t1,j1) on top of (rsub,tsub,jsub) (reference add:277
    for homogeneous doubling [thresh=0.1 on frob(r1)] and addp:482 for the
    heterogeneous path sum [thresh=0.01 on frob(rsub@r1)]).

    ``j_on``: True where the batch element is the ic=0 Fourier component
    (the only one carrying a thermal/ground source; the reference keeps J
    untouched for ic>0): a Python bool, or a boolean tensor broadcastable
    against the (..., nmu, 1) J shape.

    The series branch acom = e + rsq (error < 1e-4 at the thresholds) is kept
    for parity with the reference numerics.
    """
    nmu = r1.shape[-1]
    e = torch.eye(nmu, dtype=r1.dtype, device=r1.device)
    rsq = rsub @ r1
    norm = _frob(rsq) if frob_of_rsq else _frob(r1)
    inv = _inv_combine(e - rsq)
    series = e + rsq
    acom = torch.where(norm[..., None, None] > thresh, inv, series)
    ccom = t1 @ acom
    rans = r1 + (ccom @ rsub) @ t1
    tans = ccom @ tsub
    if isinstance(j_on, bool):
        jans = (ccom @ (rsub @ j1 + jsub) + j1) if j_on else j1
    else:
        jans = torch.where(j_on, ccom @ (rsub @ j1 + jsub) + j1, j1)
    return rans, tans, jans


def _double_layer(pplpl, pplmi, omega, taut, bc, cc_diag, mminv_diag,
                  j_on, con_fac, nn_max: int = NN_MAX):
    """Core of double1 with precomputed cc (quadrature weights) and 1/mu
    diagonals. All leading dims batched, the Fourier-component axis
    included (``con_fac`` = 1+del(0,ic) and ``j_on`` = [ic==0] broadcast
    against omega).

    The ladder runs min(max(nn), nn_max) steps, the bound read once on the
    host: only the largest per-element doubling count matters; elements
    with a smaller nn are frozen by the mask exactly where the reference
    stops.
    """
    nmu = cc_diag.shape[0]
    e = torch.eye(nmu, dtype=pplpl.dtype, device=pplpl.device)
    con = (omega * np.pi * con_fac)[..., None, None]

    # GPLPL = MMINV (E - CON PPLPL CC); GPLMI = MMINV CON PPLMI CC
    gplpl = mminv_diag[:, None] * (e - con * (pplpl * cc_diag[None, :]))
    gplmi = mminv_diag[:, None] * (con * (pplmi * cc_diag[None, :]))

    # doubling count (reference: nn = int(log2(taut)+12), xfac = 2^-nn)
    nn = torch.trunc(torch.log2(taut) + 12.0).to(torch.int32)
    nn = torch.clamp(nn, max=nn_max)
    xfac = torch.where(nn >= 1, 2.0 ** (-nn.to(taut.dtype)), 1.0)
    tau0 = (taut * xfac)[..., None, None]

    t1 = e - tau0 * gplpl
    r1 = tau0 * gplmi
    j1 = ((1.0 - omega) * bc * j_on)[..., None] * (
        tau0[..., 0] * mminv_diag
    )  # (..., nmu)
    j1 = j1[..., None]  # (..., nmu, 1)

    count("scatter.ladder_reads")
    upper = min(int(nn.max()), nn_max)
    for k in range(upper):
        rn, tn, jn = _combine(r1, t1, j1, r1, t1, j1, True, thresh=0.1,
                              frob_of_rsq=False)
        do = (k < nn)[..., None, None]
        r1 = torch.where(do, rn, r1)
        t1 = torch.where(do, tn, t1)
        j1 = torch.where(do, jn, j1)
    return r1, t1, j1


def layer_rtj(taut, tauscat, tauray, bc, frac, ppln, pmin, pplr, pmir,
              cc_diag, mminv_diag, j_on, con_fac, nn_max: int = NN_MAX):
    """R/T/J matrices for every layer at once (reference calc_rtj_matrix,
    Multiple_Scattering_Core.py:567-650), batched over leading dims (any
    broadcastable shapes).

    taut/tauscat/tauray/bc: (...,); frac: (..., ncont);
    ppln/pmin: (..., ncont, nmu, nmu); pplr/pmir: (..., nmu, nmu).
    """
    nmu = cc_diag.shape[0]
    e = torch.eye(nmu, dtype=pplr.dtype, device=pplr.device)
    tscat = torch.clamp(tauscat, min=0.0)
    total_scat = tscat + tauray
    safe_taut = torch.where(taut > 0.0, taut, 1.0)
    omega = torch.where(taut > 0.0, total_scat / safe_taut, 0.0)

    safe_ts = torch.where(total_scat > 0.0, total_scat, 1.0)
    wray = (tauray / safe_ts)[..., None, None]
    wsca = (tscat / safe_ts)[..., None, None, None] * frac[..., None, None]
    pplpl = wray * pplr + torch.sum(wsca * ppln, dim=-3)
    pplmi = wray * pmir + torch.sum(wsca * pmin, dim=-3)

    # scattering branch (the floor keeps log2 finite where taut = 0; those
    # elements take the zero-opacity branch below)
    floor = 1e-300 if taut.dtype == torch.float64 else 1e-30
    rs, ts, js = _double_layer(
        pplpl, pplmi, omega, torch.clamp(taut, min=floor), bc, cc_diag,
        mminv_diag, j_on, con_fac, nn_max
    )

    # non-scattering branch: diagonal transmission exp(-taut/mu)
    tex = -mminv_diag * taut[..., None]  # (..., nmu)
    tdiag = torch.where(tex > -200.0, torch.exp(tex), 0.0)
    tn = tdiag[..., None, :] * e  # diag embed
    jn = ((bc * j_on)[..., None] * (1.0 - tdiag))[..., None]

    scat = ((omega > 0.0) & (taut > 0.0))[..., None, None]
    zero = (~(taut > 0.0))[..., None, None]

    def sel(a, b, c):
        return torch.where(zero, c, torch.where(scat, a, b))

    rl = sel(rs, torch.zeros_like(tn), torch.zeros_like(tn))
    tl = sel(ts, tn, e)
    jl = sel(js, jn, torch.zeros_like(jn))
    return rl, tl, jl


def combine_path(rl, tl, jl, j_on, r0=None, t0=None, j0=None):
    """Combine per-layer R/T/J top-down along the path (reference
    scloud11wave_core layer loop :839-875 with addp).

    rl/tl: (nlay, ..., nmu, nmu) ordered so index 0 is combined FIRST: the
    layer FURTHEST from the observer (lookdown: the bottom layer / surface
    side; each subsequent layer is stacked on top of the accumulation).
    r0/t0/j0: optional initial (surface) matrices combined before layer 0.
    """
    if r0 is None:
        rc, tc, jc = rl[0], tl[0], jl[0]
        start = 1
    else:
        rc, tc, jc = r0, t0, j0
        start = 0
    for k in range(start, rl.shape[0]):
        rc, tc, jc = _combine(rl[k], tl[k], jl[k], rc, tc, jc, j_on,
                              thresh=0.01, frob_of_rsq=True)
    return rc, tc, jc


def brdf_fourier_matrix(brdf_fn, quad: ScatterQuadrature, nwave: int):
    """Azimuth-Fourier decomposition of the surface BRDF into the
    (NWAVE, NMU, NMU, NF+1) matrix the doubling method consumes (reference
    calc_brdf_matrix ForwardModel_0.py:5168).

    brdf_fn(sol_ang, emiss_ang, azi_ang) -> (NWAVE, NTHETA) for 1D degree
    arrays (e.g. ``rt.surface.surface_brdf_fn``).
    """
    mu = quad.mu_desc
    nmu, nphi, nf = quad.nmu, quad.nphi, quad.nf
    dphi = 2.0 * np.pi / nphi

    j, i, k = np.meshgrid(
        np.arange(nmu), np.arange(nmu), np.arange(nphi + 1), indexing="ij"
    )
    emiss = np.rad2deg(np.arccos(mu[i])).ravel()
    sol = np.rad2deg(np.arccos(mu[j])).ravel()
    azi = np.rad2deg(k * dphi).ravel()

    brdf = brdf_fn(sol, emiss, azi)  # (NWAVE, NMU*NMU*(NPHI+1))
    brdf = brdf.reshape(nwave, nmu, nmu, nphi + 1)  # [w, j=sol, i=emiss, k]

    phi = np.arange(nphi + 1) * dphi
    wphi = np.full(nphi + 1, dphi)
    wphi[0] = wphi[-1] = 0.5 * dphi
    wphi = wphi / (2.0 * np.pi)
    cosmat = wphi[None, :] * np.cos(
        np.arange(nf + 1)[:, None] * phi[None, :]
    )  # (NF+1, NPHI+1)

    # output[w, i, j, ic] (emission row, solar column, as in the reference)
    return torch.einsum("wjik,ck->wijc", brdf, brdf.new_tensor(cosmat))


# ---------------------------------------------------------------------------
# Geometry interpolation + top-level entry points
# ---------------------------------------------------------------------------


def _angle_bracket(zmu, mu_desc):
    """Index i such that mu[i] >= z > mu[i+1] on the descending quadrature +
    linear weight (reference angle_quadrature:536-560); host float64."""
    mu = np.asarray(mu_desc)
    nmu = mu.shape[0]
    i = np.clip(np.searchsorted(-mu, -zmu, side="right") - 1, 0, nmu - 2)
    # the reference picks the LAST bracket j with mu[j] >= z > mu[j+1]; for
    # z above mu[0] it keeps j=0, below mu[-1] it uses nmu-2
    i = np.where(zmu <= mu[nmu - 1], nmu - 2, i)
    i = np.where(zmu > mu[0], 0, i)
    w = (mu[i] - zmu) / (mu[i] - mu[i + 1])
    return i, w


def _phase_stacks(quad: ScatterQuadrature, phase_fns, iray: bool,
                  nwave: int, dtype, device):
    """Hansen-normalised phase-matrix stacks for every Fourier component.

    Returns ``(ppln, pmin, pplr_b, pmir_b)`` with shapes
    (nc, nwave, ncont, nmu, nmu) / (nc, nwave, nmu, nmu), in ``dtype``.
    These are the only wave-dependent quantities produced from the
    ``phase_fns`` callables, and they are small (nc*nwave*ncont*nmu^2), so
    they are built once, in float64, outside the doubling core, which the
    wave tiles then slice.

    Hansen renormalisation factors are the ic=0 fixed point and scale the
    phase matrices of EVERY Fourier component (reference hansen:201 runs
    only for ic==0 but its fc persists across the ic loop, :771-800).
    """
    mu_d = quad.mu_desc
    wt_d = quad.wtmu_desc
    nmu = quad.nmu
    nc = quad.nf + 1

    def waves(p):
        return p.expand(nwave, nmu, nmu) if p.ndim == 2 else p

    fc_modes = []
    for pf in phase_fns:
        p0, m0 = phase_matrices(pf, mu_d, quad.nphi, 0, device=device)
        _, fc = hansen_normalise(waves(p0), waves(m0), wt_d)
        fc_modes.append(fc)
    if iray:
        p0, m0 = rayleigh_phase_matrices(mu_d, quad.nphi, 0, device=device)
        _, fc_ray = hansen_normalise(waves(p0), waves(m0), wt_d)

    ppln_list, pmin_list = [], []
    for j, pf in enumerate(phase_fns):
        pl, mi = [], []
        for ic in range(nc):
            pplpl, pplmi = phase_matrices(pf, mu_d, quad.nphi, ic,
                                          device=device)
            pl.append(waves(pplpl) * fc_modes[j])
            mi.append(waves(pplmi))
        ppln_list.append(torch.stack(pl, dim=0))
        pmin_list.append(torch.stack(mi, dim=0))
    if ppln_list:
        ppln = torch.stack(ppln_list, dim=2)  # (nc, nwave, ncont, nmu, nmu)
        pmin = torch.stack(pmin_list, dim=2)
    else:
        ppln = torch.zeros((nc, nwave, 0, nmu, nmu), dtype=torch.float64,
                           device=device)
        pmin = torch.zeros_like(ppln)

    if iray:
        pl, mi = [], []
        for ic in range(nc):
            pplr, pmir = rayleigh_phase_matrices(mu_d, quad.nphi, ic,
                                                 device=device)
            pl.append(waves(pplr) * fc_ray)
            mi.append(waves(pmir))
        pplr_b = torch.stack(pl, dim=0)
        pmir_b = torch.stack(mi, dim=0)
    else:
        pplr_b = torch.zeros((nc, nwave, nmu, nmu), dtype=torch.float64,
                             device=device)
        pmir_b = torch.zeros_like(pplr_b)
    return tuple(x.to(dtype) for x in (ppln, pmin, pplr_b, pmir_b))


def _host_angles(x) -> np.ndarray:
    """(npath,) host float64 angles of a float, array or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(x, dtype=np.float64))


def _scloud11wave_core(
    quad: ScatterQuadrature,
    ppln, pmin, pplr_b, pmir_b,  # from _phase_stacks (wave axis = axis 1)
    radg,               # (nwave, nmu) ground/bottom radiance (ascending mu)
    sol_ang, emiss_ang, azi_ang,  # (npath,) host geometry
    solar,              # (nwave,)
    bnu,                # (nwave, nlay) layer Planck
    taus,               # (nwave, ng, nlay) total optical depth
    tauray,             # (nwave, nlay) Rayleigh od
    tauscat,            # (nwave, nlay) aerosol scattering od
    lfrac,              # (nwave, ncont, nlay) per-mode scattering fraction
    brdf_matrix=None,   # (nwave, nmu, nmu, nf+1) surface BRDF Fourier terms
    nn_max: int = NN_MAX,
):
    """Doubling/adding core over an arbitrary wave slab (all phase
    matrices precomputed). Everything here scales with nwave: this is the
    function the wave-tiled loop calls per tile."""
    dtype, device = taus.dtype, taus.device
    mu_d = quad.mu_desc
    wt_d = quad.wtmu_desc
    cc_diag = taus.new_tensor(wt_d)
    mminv_diag = 1.0 / taus.new_tensor(mu_d)
    xfac = 0.5 / np.sum(mu_d * wt_d)

    nwave, ng, nlay = taus.shape
    radg_d = torch.flip(radg, dims=(1,))  # descending mu order

    # aerosol scattering od per (wave, g, lay): the reference clamps omega
    # to [0,1] then tauscat = taut*omega - tauray >= 0 (core :852-860)
    safe_taus = torch.where(taus > 0.0, taus, 1.0)
    omega_in = torch.clamp(
        (tauscat + tauray)[:, None, :] / safe_taus, 0.0, 1.0
    )
    tscat_g = torch.clamp(
        taus * omega_in - tauray[:, None, :], min=0.0
    )  # (nwave, ng, nlay)

    # solar/emission bracketing per path (static quadrature and geometry)
    sol_ang = _host_angles(sol_ang)
    emiss_ang = _host_angles(emiss_ang)
    azi_ang = _host_angles(azi_ang)
    npath = emiss_ang.shape[0]
    zmu0 = np.where(
        sol_ang > 90.0,
        np.cos(np.deg2rad(180.0 - sol_ang)),
        np.cos(np.deg2rad(sol_ang)),
    )
    sol_on = (sol_ang <= 90.0).astype(np.float64)
    zmu = np.cos(np.deg2rad(emiss_ang))
    isol, u = _angle_bracket(zmu0, mu_d)
    iemm, t = _angle_bracket(zmu, mu_d)

    # --- ALL Fourier components in ONE batched R/T/J evaluation ---------
    # The reference loops ic = 0..NF re-running the full doubling ladder
    # per component (Multiple_Scattering_Core.py:790); here the component
    # axis is another leading batch dim (nc, nwave, ng, nlay, ...) so the
    # doubling iterations and the layer loop run once.
    nc = quad.nf + 1

    # component masks: the thermal/ground source J lives only in ic=0, and
    # the phase normalisation factor is (1 + del(0,ic))
    ic_axis = np.arange(nc, dtype=np.float64)
    j_on = taus.new_tensor((ic_axis == 0).astype(np.float64))[
        :, None, None, None]  # (nc, 1, 1, 1)
    con_fac = 1.0 + j_on

    # every per-layer input broadcasts against (nc, nwave, ng, nlay)
    count("scatter.tiles")
    with annotate("nemesis.scatter.doubling"):
        rl, tl, jl = layer_rtj(
            taus[None],
            tscat_g[None],
            tauray[None, :, None, :],
            bnu[None, :, None, :],
            # (1, nwave, 1, nlay, nc')
            torch.movedim(lfrac, 1, 2)[None, :, None],
            ppln[:, :, None, None], pmin[:, :, None, None],
            pplr_b[:, :, None, None], pmir_b[:, :, None, None],
            cc_diag, mminv_diag, j_on, con_fac, nn_max,
        )  # (nc, nwave, ng, nlay, nmu, nmu)
    with annotate("nemesis.scatter.adding"):
        # combine top-down (lookdown): layer index 0 = top is combined LAST in
        # the reference (it iterates l=0..nlay-1 with k=l and the accumulated
        # rsub below); the loop wants the first-combined layer first.
        rl_s = torch.movedim(rl, 3, 0)  # (nlay, nc, nwave, ng, nmu, nmu)
        tl_s = torch.movedim(tl, 3, 0)
        jl_s = torch.movedim(jl, 3, 0)

        j_on_p = j_on[..., None]  # (nc,1,1,1,1) against (..., nmu, 1)
        j_on_mask = j_on_p > 0.0
        if brdf_matrix is not None:
            rs = (
                2.0 * np.pi * torch.movedim(brdf_matrix, 3, 0)
                * taus.new_tensor(mu_d)[None, None, None, :]
                * taus.new_tensor(wt_d)[None, None, None, :]
            ) * xfac  # (nc, nwave, nmu, nmu)
            rs = rs[:, :, None].expand(nc, nwave, ng, quad.nmu, quad.nmu)
            js = radg_d[None, :, None, :, None].expand(
                nc, nwave, ng, quad.nmu, 1) * j_on_p
            ts = torch.zeros_like(rs)
            rcomb, tcomb, jcomb = combine_path(
                rl_s, tl_s, jl_s, j_on_mask, r0=rs, t0=ts, j0=js
            )
        else:
            rcomb, tcomb, jcomb = combine_path(rl_s, tl_s, jl_s, j_on_mask)

        jcomb = jcomb * j_on_p

        # path extraction (reference :886-958), lookdown
        utmi = radg_d[None] * j_on[..., 0]  # (nc, nwave, nmu)
        base = (
            torch.einsum("cwgij,cwj->cwgi", tcomb, utmi) + jcomb[..., 0]
        )  # (nc, nwave, ng, nmu)

        cosfac = np.cos(
            ic_axis[:, None] * np.deg2rad(azi_ang)[None, :]
        ) * np.where(ic_axis[:, None] > 0, 2.0, 1.0)  # (nc, npath)

        def path_rad(ip):
            s = sol_on[ip] * solar / (2.0 * np.pi)  # (nwave,)
            i0 = int(isol[ip])
            ie = int(iemm[ip])
            yx = []
            for d0 in (0, 1):
                col = rcomb[..., i0 + d0]  # (nc, nwave, ng, nmu)
                umi = base + col * (s / wt_d[i0 + d0])[:, None, None]
                for de in (0, 1):
                    yx.append(umi[..., ie + de])
            tt, uu = float(t[ip]), float(u[ip])
            drad = (
                (1 - tt) * (1 - uu) * yx[0]
                + tt * (1 - uu) * yx[1]
                + (1 - tt) * uu * yx[2]
                + tt * uu * yx[3]
            )  # (nc, nwave, ng)
            return torch.einsum("cwg,c->wg", drad,
                                drad.new_tensor(cosfac[:, ip]))

        return torch.stack([path_rad(ip) for ip in range(npath)], dim=-1)


def scloud11wave(
    quad: ScatterQuadrature,
    phase_fns,          # list of callables calpha -> p (one per aerosol mode)
    radg,               # (nwave, nmu) ground/bottom radiance (ascending mu)
    sol_ang, emiss_ang, azi_ang,  # (npath,)
    solar,              # (nwave,)
    bnu,                # (nwave, nlay) layer Planck
    taus,               # (nwave, ng, nlay) total optical depth
    tauray,             # (nwave, nlay) Rayleigh od
    tauscat,            # (nwave, nlay) aerosol scattering od
    lfrac,              # (nwave, ncont, nlay) per-mode scattering fraction
    iray: bool,
    brdf_matrix=None,   # (nwave, nmu, nmu, nf+1) surface BRDF Fourier terms
    nn_max: int = NN_MAX,
):
    """Upward radiance (nwave, ng, npath) by adding-doubling (reference
    scloud11wave_core, Multiple_Scattering_Core.py:652-960), lookdown
    geometry (emission angle < 90).

    All Fourier components 0..nf are evaluated (no data-dependent break).
    ``tauscat`` is the aerosol-only scattering od; the total single
    scattering albedo is (tauscat+tauray)/taus per g (reference wrapper
    ForwardModel_0.py:5121-5128 and core :852-860). Each phase function
    takes a float64 tensor of cos(angle) and returns its values on every
    wave, (nwave, ...) or broadcastable.
    """
    nwave = taus.shape[0]
    with annotate("nemesis.scatter.phase"):
        stacks = _phase_stacks(quad, phase_fns, iray, nwave, taus.dtype,
                               taus.device)
    return _scloud11wave_core(
        quad, *stacks, radg,
        sol_ang, emiss_ang, azi_ang, solar, bnu,
        taus, tauray, tauscat, lfrac, brdf_matrix, nn_max,
    )


def scloud11wave_tiled(
    quad: ScatterQuadrature,
    phase_fns,
    radg, sol_ang, emiss_ang, azi_ang, solar, bnu,
    taus, tauray, tauscat, lfrac,
    iray: bool,
    brdf_matrix=None,
    nn_max: int = NN_MAX,
    wave_tile: int = 256,
):
    """Wave-tiled adding-doubling for production spectral grids.

    The doubling/adding core keeps (nc, nwave, ng, nlay, nmu, nmu) R/T/J
    stacks live; a Python loop over tiles of ``wave_tile`` waves bounds
    them to one tile (the reference loops wave by wave,
    Multiple_Scattering_Core.py:790). The phase-matrix stacks are computed
    once on the full grid and sliced per tile. There is no cross-wave
    mixing anywhere in the core, so each wave's result is the untiled
    one's; the last tile is simply shorter.
    """
    nwave = taus.shape[0]
    if nwave <= wave_tile:
        return scloud11wave(
            quad, phase_fns, radg, sol_ang, emiss_ang, azi_ang, solar,
            bnu, taus, tauray, tauscat, lfrac, iray, brdf_matrix, nn_max,
        )
    with annotate("nemesis.scatter.phase"):
        ppln, pmin, pplr_b, pmir_b = _phase_stacks(
            quad, phase_fns, iray, nwave, taus.dtype, taus.device
        )
    out = []
    for lo in range(0, nwave, wave_tile):
        w = slice(lo, min(lo + wave_tile, nwave))
        out.append(_scloud11wave_core(
            quad, ppln[:, w], pmin[:, w], pplr_b[:, w], pmir_b[:, w],
            radg[w], sol_ang, emiss_ang, azi_ang, solar[w], bnu[w],
            taus[w], tauray[w], tauscat[w], lfrac[w],
            None if brdf_matrix is None else brdf_matrix[w], nn_max,
        ))
    return torch.cat(out, dim=0)
