"""Atmospheric profile parameterisations (the common PreRT models).

Port of the JAX package's ``models/profile_models.py``: 0/-1/50/51
(continuous per-level profiles), 1/4/20 (knee profiles), 45 (Irwin CH4
humidity), 2/3/49 (scaling), 9/32/47 (clouds), 43/62 (exoplanet T
profiles) and 110/111 (Venus clouds). Each model provides:
- ``from_apr(f, varident, ix, ctx)`` (host): parse its .apr block ->
  AprParseResult (reference Models/PreRTModels/model_*.py
  from_apr_to_state_vector); and
- ``apply(entry, atm, x)`` (tensors): map its unlogged state-vector slice
  onto the Atmosphere structure (reference calculate_from_subprofretg).

The two level recurrences the JAX package runs as ``jax.lax.scan``
(``_knee_profile`` and model 9) are closed forms here: a fixed number of
tensor operations whatever NPRO, with no read of a value on the host, so
``torch.func.jacfwd`` goes through them and the card sees no per-level
launches. Model 1002 scales a profile per location of a multi-location
atmosphere (``multiloc.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from archnemesis_tpu_torch.constants import R_GAS
from archnemesis_tpu_torch.models.base import (
    AprParseResult,
    ModelEntry,
    ProfileTarget,
    classify_target,
    register_model,
)
from archnemesis_tpu_torch.rt.atmosphere import calc_grav, set_column
from archnemesis_tpu_torch.utils.interp import interp


def _read_profile_file(path):
    with open(path) as fh:
        toks = fh.read().split()
    nlevel = int(float(toks[0]))
    clen = float(toks[1])
    data = np.array([float(x) for x in toks[2 : 2 + 3 * nlevel]]).reshape(
        nlevel, 3
    )
    return nlevel, clen, data[:, 0], data[:, 1], data[:, 2]


def _corr_block(pref, clen, var_diag, sxminfac=0.001):
    """Inter-level correlation of a continuous profile (reference
    Models/PreRTModels/model_0.py from_apr corr loop)."""
    n = len(pref)
    sx = np.diag(var_diag).astype(float)
    logp = np.log(pref)
    for j in range(n):
        for k in range(n):
            xfac = np.exp(-abs((logp[k] - logp[j]) / clen))
            if xfac >= sxminfac and j != k:
                sx[j, k] = np.sqrt(var_diag[j] * var_diag[k]) * xfac
    return sx


def _set_profile(atm, entry: ModelEntry, prof):
    t = entry.target
    if t == ProfileTarget.TEMPERATURE:
        return atm.replace(t=prof)
    if t == ProfileTarget.GAS_VMR:
        return atm.replace(vmr=set_column(atm.vmr, entry.target_idx, prof))
    if t == ProfileTarget.AEROSOL:
        return atm.replace(dust=set_column(atm.dust, entry.target_idx, prof))
    if t == ProfileTarget.PARAH2:
        return atm.replace(parah2=prof)
    raise NotImplementedError(f"target {t}")


def _get_profile(atm, entry: ModelEntry):
    t = entry.target
    if t == ProfileTarget.TEMPERATURE:
        return atm.t
    if t == ProfileTarget.GAS_VMR:
        return atm.vmr[:, entry.target_idx]
    if t == ProfileTarget.AEROSOL:
        return atm.dust[:, entry.target_idx]
    if t == ProfileTarget.PARAH2:
        return atm.parah2
    raise NotImplementedError(f"target {t}")


@register_model
class Model0:
    """Continuous profile: one state-vector entry per level
    (reference Models/PreRTModels/model_0.py)."""

    id = 0

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        fname = f.readline().split()[0]
        nlevel, clen, pref, ref, eref = _read_profile_file(fname)
        if nlevel != ctx["npro"]:
            raise ValueError("profile in .apr must be on the .ref grid")
        target, tidx = classify_target(
            varident, ctx["gas_id"], ctx["iso_id"], ctx["ndust"]
        )
        if varident[0] == 0:  # temperature: linear
            x0 = ref.copy()
            var = eref**2
            lx = np.zeros(nlevel, dtype=int)
        else:  # gas/aerosol/para-H2: log
            x0 = np.log(ref)
            var = (eref / ref) ** 2
            lx = np.ones(nlevel, dtype=int)
        inum = np.full(nlevel, 1 if varident[1] == -1 and varident[0] == 0 else 0)
        entry = ModelEntry(
            varident=tuple(int(v) for v in varident),
            model_id=0,
            ix=ix,
            nx=nlevel,
            target=target,
            target_idx=tidx,
        )
        return AprParseResult(
            entry=entry,
            x0=x0,
            sx_diag=var,
            lx=lx,
            inum=inum,
            corr=_corr_block(pref, clen, var),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        # x is the unlogged slice (exp applied for lx=1 entries upstream)
        return _set_profile(atm, entry, x)


@register_model
class Model2:
    """Simple scaling of the reference profile
    (reference Models/PreRTModels/model_2.py)."""

    id = 2

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        vals = f.readline().rsplit("!", 1)[0].split()
        x0 = np.array([float(vals[0])])
        var = np.array([float(vals[1]) ** 2])
        target, tidx = classify_target(
            varident, ctx["gas_id"], ctx["iso_id"], ctx["ndust"]
        )
        entry = ModelEntry(
            varident=tuple(int(v) for v in varident),
            model_id=2,
            ix=ix,
            nx=1,
            target=target,
            target_idx=tidx,
        )
        return AprParseResult(
            entry=entry,
            x0=x0,
            sx_diag=var,
            lx=np.zeros(1, dtype=int),
            inum=np.zeros(1, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        prof = _get_profile(atm, entry)
        return _set_profile(atm, entry, prof * x[0])


@register_model
class Model3:
    """Log scaling factor (reference Models/PreRTModels/model_3.py):
    the state carries ln(scale), profile is multiplied by exp-scale."""

    id = 3

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        vals = f.readline().rsplit("!", 1)[0].split()
        xfac, err = float(vals[0]), float(vals[1])
        x0 = np.array([np.log(xfac)])
        var = np.array([(err / xfac) ** 2])
        target, tidx = classify_target(
            varident, ctx["gas_id"], ctx["iso_id"], ctx["ndust"]
        )
        entry = ModelEntry(
            varident=tuple(int(v) for v in varident),
            model_id=3,
            ix=ix,
            nx=1,
            target=target,
            target_idx=tidx,
        )
        return AprParseResult(
            entry=entry,
            x0=x0,
            sx_diag=var,
            lx=np.ones(1, dtype=int),
            inum=np.zeros(1, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        prof = _get_profile(atm, entry)
        return _set_profile(atm, entry, prof * x[0])


def _atm_scale_height(atm):
    """Pressure scale height per level (m): R T / (molwt g) (reference
    models use atm.GRAV from calc_grav)."""
    grav, _ = calc_grav(atm.h, atm.latitude, atm.planet,
                        getattr(atm, "planet_radius", None))
    return R_GAS * atm.t / (atm.molwt * grav)


def _atm_rho(atm):
    """Mass density (kg/m3) (reference Atmosphere_0.calc_rho:809, which
    returns P*MOLWT/(R*T), then models multiply by 1e-3)."""
    return atm.p * atm.molwt / (R_GAS * atm.t) * 1.0e-3


_FLOOR = 1.0e-36  # the profile floor of models 1/4/20/32/47


def _maximum(x, floor):
    """``jnp.maximum(x, floor)`` of a tensor and a constant (its gradient
    at a tie is that of ``jnp.maximum``, which ``clamp`` does not share)."""
    return torch.maximum(x, x.new_full((), floor))


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` = minimum(maximum(x, lo), hi)."""
    return torch.minimum(_maximum(x, lo), x.new_full((), hi))


def _hknee_from_p(atm, p_pa):
    """Altitude of a pressure level by interpolation on the sorted profile
    (reference model_1.py hknee interp)."""
    isort = torch.argsort(atm.p)
    return interp(p_pa, atm.p[isort], atm.h[isort])


def simpson_nonuniform(y, x):
    """Composite Simpson's rule on non-uniform samples, matching
    scipy.integrate.simpson (1.17: Cartwright last-interval correction for
    an even number of samples). Static length."""
    n = y.shape[0]
    h = torch.diff(x)

    def basic(stop):
        # pairs of intervals starting at 0, 2, ... < stop
        h0 = h[0:stop:2]
        h1 = h[1 : stop + 1 : 2]
        y0 = y[0:stop:2]
        y1 = y[1 : stop + 1 : 2]
        y2 = y[2 : stop + 2 : 2]
        hsum = h0 + h1
        hprod = h0 * h1
        h0divh1 = torch.where(h1 != 0, h0 / h1, 0.0)
        tmp = hsum / 6.0 * (
            y0 * (2.0 - torch.where(h0divh1 != 0, 1.0 / h0divh1, 0.0))
            + y1 * torch.where(hprod != 0, hsum * hsum / hprod, 0.0)
            + y2 * (2.0 - h0divh1)
        )
        return torch.sum(tmp)

    if n % 2 == 1:
        return basic(n - 2)
    if n == 2:
        return 0.5 * h[-1] * (y[-1] + y[-2])
    res = basic(n - 3)
    h0, h1 = h[-2], h[-1]
    alpha = (2 * h1**2 + 3 * h0 * h1) / (6 * (h1 + h0))
    beta = (h1**2 + 3.0 * h0 * h1) / (6 * h0)
    eta = h1**3 / (6 * h0 * (h0 + h1))
    return res + alpha * y[-1] + beta * y[-2] - eta * y[-3]


def _before(mask):
    """For each level, whether ``mask`` holds at some level before it in
    the index order."""
    m = mask.to(torch.int64)
    return (torch.cumsum(m, 0) - m) > 0


def _knee_profile(atm, abu_deep, fsh, pknee_atm):
    """Deep-abundance + fractional-scale-height profile above a pressure
    knee (the reference model 1/4/20 recurrence, model_1.py calculate).

    The JAX package scans the levels: a level below the knee (p >= pknee)
    takes ``abu_deep``; a level above it takes max(prev * exp(a_j), 1e-36)
    with a_j = -delh_j * xfac / scale_j, where delh_j runs from the knee
    up to the first level above it and from the level before after that.
    In log space that is L_j = max(L_{j-1} + a_j, log 1e-36), a max-plus
    recurrence solved by L_j = S_j + max_k (c_k - S_k) over the levels k
    of j's run, with S the cumulative sum of a: the run starts at the last
    level below the knee (c_k = log abu_deep; with none, prev = 0 and the
    run starts at the first level), and each level above adds c_k =
    log 1e-36. It is one masked maximum over an (NPRO, NPRO) table, so
    the number of operations does not depend on NPRO; the floor is
    applied last, as in the scan.
    """
    xfac = (1.0 - fsh) / fsh
    pknee_pa = pknee_atm * 101325.0
    hknee = _hknee_from_p(atm, pknee_pa)
    scale = _atm_scale_height(atm)
    h = atm.h
    above = atm.p < pknee_pa
    h_prev = torch.cat([h[:1], h[:-1]])
    delh = torch.where(_before(above), h - h_prev, h - hknee)
    s = torch.cumsum(-delh * xfac / scale, 0)
    idx = torch.arange(h.shape[0], device=h.device)
    # the last level below the knee at or before each level (-1: none)
    start = torch.cummax(torch.where(above, -1, idx), 0).values
    log_deep = torch.where(abu_deep > 0, torch.log(abu_deep), -math.inf)
    cand = torch.where(above, math.log(_FLOOR), log_deep) - s
    run = (idx[None, :] >= start[:, None]) & (idx[None, :] <= idx[:, None])
    best = torch.amax(torch.where(run, cand[None, :], -math.inf), dim=1)
    return torch.where(above, _maximum(torch.exp(s + best), _FLOOR),
                       abu_deep)


def _vals_block(f):
    return [float(v) for v in f.readline().rsplit("!", 1)[0].split()[:2]]


def _mk_entry(varident, model_id, ix, nx, ctx, extra=()):
    target, tidx = classify_target(
        varident, ctx["gas_id"], ctx["iso_id"], ctx["ndust"]
    )
    return ModelEntry(
        varident=tuple(int(v) for v in varident),
        model_id=model_id,
        ix=ix,
        nx=nx,
        target=target,
        target_idx=tidx,
        extra=extra,
    )


def _nan_floor(x):
    """max(nan_to_num(x, nan=1e-36), 1e-36)."""
    return torch.clamp(torch.nan_to_num(x, nan=1.0e-36), min=1.0e-36)


@register_model
class Model47:
    """Gaussian cloud in log-pressure with integrated optical depth
    (reference model_47.py). State: [tau, pref, fwhm], all logged unless
    the target is the temperature. Sets the dust renormalisation flag so the
    layered column integrates to tau."""

    id = 47

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        xdeep, edeep = _vals_block(f)
        pknee, eknee = _vals_block(f)
        xwid, ewid = _vals_block(f)
        if varident[0] == 0:
            x0d, vard, lxd = xdeep, edeep**2, 0
        else:
            x0d, vard, lxd = np.log(xdeep), (edeep / xdeep) ** 2, 1
        entry = _mk_entry(varident, 47, ix, 3, ctx)
        return AprParseResult(
            entry=entry,
            x0=np.array([x0d, np.log(pknee), np.log(xwid)]),
            sx_diag=np.array(
                [vard, (eknee / pknee) ** 2, (ewid / xwid) ** 2]
            ),
            lx=np.array([lxd, 1, 1]),
            inum=np.zeros(3, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        tau, pref, fwhm = x[0], x[1], x[2]
        scale = _atm_scale_height(atm)
        rho = _atm_rho(atm)
        p_atm = atm.p / 101325.0
        y0 = torch.log(pref)
        q = (
            1.0 / (fwhm * np.sqrt(np.pi))
            * torch.exp(-(((torch.log(p_atm) - y0) / fwhm) ** 2))
        )
        nd = q * (rho / 1.0e3)
        od = _nan_floor(nd * scale * 1.0e5)
        q = _nan_floor(q)
        xod = torch.sum(od) * 0.25
        x1 = torch.clamp(q * tau / xod, min=1.0e-36)
        atm = _set_profile(atm, entry, x1)
        return _set_renorm(atm, entry, tau)


@register_model
class Model1:
    """Knee profile: deep abundance below PKNEE, fractional-scale-height
    decay above (reference Models/PreRTModels/model_1.py). State:
    [abu_deep, fsh] (logged unless temperature); PKNEE static."""

    id = 1

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        pknee = float(f.readline().split()[0])
        xdeep, edeep = _vals_block(f)
        fsh, efsh = _vals_block(f)
        if varident[0] == 0:
            x0d, vard, lxd = xdeep, edeep**2, 0
        else:
            x0d, vard, lxd = np.log(xdeep), (edeep / xdeep) ** 2, 1
        entry = _mk_entry(varident, 1, ix, 2, ctx, extra=(float(pknee),))
        return AprParseResult(
            entry=entry,
            x0=np.array([x0d, np.log(fsh)]),
            sx_diag=np.array([vard, (efsh / fsh) ** 2]),
            lx=np.array([lxd, 1]),
            inum=np.array([0, 1]),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        xprof = _knee_profile(atm, x[0], x[1], entry.extra[0])
        return _set_profile(atm, entry, xprof)


@register_model
class Model4:
    """Knee profile with retrieved knee pressure (reference model_4.py).
    State: [abu_deep, fsh, pknee] (all logged unless temperature abu)."""

    id = 4

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        pknee, eknee = _vals_block(f)
        xdeep, edeep = _vals_block(f)
        fsh, efsh = _vals_block(f)
        if varident[0] == 0:
            x0d, vard, lxd = xdeep, edeep**2, 0
        else:
            x0d, vard, lxd = np.log(xdeep), (edeep / xdeep) ** 2, 1
        entry = _mk_entry(varident, 4, ix, 3, ctx)
        return AprParseResult(
            entry=entry,
            x0=np.array([x0d, np.log(fsh), np.log(pknee)]),
            sx_diag=np.array(
                [vard, (efsh / fsh) ** 2, (eknee / pknee) ** 2]
            ),
            lx=np.array([lxd, 1, 1]),
            inum=np.zeros(3, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        xprof = _knee_profile(atm, x[0], x[1], x[2])
        return _set_profile(atm, entry, xprof)


@register_model
class Model20:
    """Knee profile with tropopause cut-off (reference model_20.py). State:
    [abu_deep, fsh]; PKNEE, PTROP static."""

    id = 20

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        s = f.readline().split()
        pknee, ptrop = float(s[0]), float(s[1])
        xdeep, edeep = _vals_block(f)
        fsh, efsh = _vals_block(f)
        if varident[0] == 0:
            x0d, vard, lxd = xdeep, edeep**2, 0
        else:
            x0d, vard, lxd = np.log(xdeep), (edeep / xdeep) ** 2, 1
        entry = _mk_entry(
            varident, 20, ix, 2, ctx, extra=(float(pknee), float(ptrop))
        )
        return AprParseResult(
            entry=entry,
            x0=np.array([x0d, np.log(fsh)]),
            sx_diag=np.array([vard, (efsh / fsh) ** 2]),
            lx=np.array([lxd, 1]),
            inum=np.array([0, 1]),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        xprof = _knee_profile(atm, x[0], x[1], entry.extra[0])
        xprof = torch.where(atm.p < entry.extra[1] * 101325.0, _FLOOR, xprof)
        return _set_profile(atm, entry, xprof)


@register_model
class Model45:
    """Irwin CH4 relative-humidity model (reference model_45.py). State:
    [tropo, humid, strato], all logged."""

    id = 45

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        tropo, etropo = _vals_block(f)
        humid, ehumid = _vals_block(f)
        strato, estrato = _vals_block(f)
        entry = _mk_entry(varident, 45, ix, 3, ctx)
        return AprParseResult(
            entry=entry,
            x0=np.log([tropo, humid, strato]),
            sx_diag=np.array(
                [(etropo / tropo) ** 2, (ehumid / humid) ** 2,
                 (estrato / strato) ** 2]
            ),
            lx=np.ones(3, dtype=int),
            inum=np.zeros(3, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        tropo, humid, strato = x[0], x[1], x[2]
        sch40, sch41 = 10.6815, -1163.83
        pbar = atm.p / 100000.0
        tmp = sch40 + sch41 / atm.t
        psvp = torch.where(tmp < -69.0, 1.0e-30, torch.exp(tmp))
        pch4 = tropo * pbar
        pch4 = torch.where(pch4 / psvp > 1.0, psvp * humid, pch4)
        pch4 = torch.where(
            (pbar < 0.1) & (pch4 / pbar > strato), pbar * strato, pch4
        )
        pch4 = torch.where(
            (pbar > 0.5) & (pch4 / pbar > tropo), pbar * tropo, pch4
        )
        return _set_profile(atm, entry, pch4 / pbar)


def _set_renorm(atm, entry, tau):
    """The dust renormalisation target of the entry's mode set to tau."""
    renorm = (
        atm.p.new_zeros(atm.ndust)
        if atm.dust_renorm is None
        else torch.as_tensor(atm.dust_renorm, dtype=atm.p.dtype,
                             device=atm.p.device)
    )
    hit = torch.arange(atm.ndust, device=atm.p.device) == entry.target_idx
    return atm.replace(dust_renorm=torch.where(hit, tau, renorm))


@register_model
class Model9:
    """Cloud from a base height with fractional scale height, normalised to
    an integrated column (reference model_9.py). State: [tau, fsh, href];
    tau/fsh logged, href (km) linear."""

    id = 9

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        hknee, eknee = _vals_block(f)
        xdeep, edeep = _vals_block(f)
        xfsh, efsh = _vals_block(f)
        entry = _mk_entry(varident, 9, ix, 3, ctx)
        return AprParseResult(
            entry=entry,
            x0=np.array([np.log(xdeep), np.log(xfsh), hknee]),
            sx_diag=np.array(
                [(edeep / xdeep) ** 2, (efsh / xfsh) ** 2, eknee**2]
            ),
            lx=np.array([1, 1, 0]),
            inum=np.zeros(3, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        """The JAX package scans the levels: the first level at or above
        the base takes 1, each later level above it prev * exp(-delh_j /
        (scale_j fsh)), a level below it 0 (and once a level below follows
        the first above, prev stays 0). Here that is the exponential of a
        cumulative sum over the levels after the first above, kept where
        no level below has come between."""
        tau, xfsh, hknee = x[0], x[1], x[2]
        scale = _atm_scale_height(atm)
        h_km = atm.h / 1.0e3
        above = h_km >= hknee
        after_first = _before(above)
        broken = torch.cumsum((after_first & ~above).to(torch.int64), 0) > 0
        delh = torch.cat([atm.h.new_zeros(1), torch.diff(atm.h)])
        log_dec = torch.where(after_first, -delh / (scale * xfsh), 0.0)
        nd = torch.where(above & ~broken, torch.exp(torch.cumsum(log_dec, 0)),
                         0.0)
        # partial bottom level (reference model_9 second loop)
        h_next = torch.cat([h_km[1:], h_km[-1:] + 1.0])
        frac = 1.0 - (hknee - h_km) * 1.0e3 / (
            (h_next - h_km) * 1.0e3
        )
        nd = torch.where(
            h_km < hknee,
            torch.where(h_next >= hknee, nd * frac, 0.0),
            nd,
        )
        totcol = simpson_nonuniform(nd, atm.h)
        return _set_profile(atm, entry, nd / totcol * tau)


@register_model
class Model32:
    """Cloud with base pressure, fractional scale height above and a fixed
    1 km decay below, normalised to integrated opacity (reference
    model_32.py). State: [tau, fsh, pref], all logged."""

    id = 32

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        pknee, eknee = _vals_block(f)
        xdeep, edeep = _vals_block(f)
        xfsh, efsh = _vals_block(f)
        entry = _mk_entry(varident, 32, ix, 3, ctx)
        return AprParseResult(
            entry=entry,
            x0=np.array([np.log(xdeep), np.log(xfsh), np.log(pknee)]),
            sx_diag=np.array(
                [(edeep / xdeep) ** 2, (efsh / xfsh) ** 2,
                 (eknee / pknee) ** 2]
            ),
            lx=np.ones(3, dtype=int),
            inum=np.zeros(3, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        tau, xfsh, pknee = x[0], x[1], x[2]
        np_ = atm.np_
        scale = _atm_scale_height(atm)
        rho = _atm_rho(atm)
        p_atm = atm.p / 101325.0
        isort = torch.argsort(atm.p)
        hknee = interp(pknee, p_atm[isort], atm.h[isort])

        # level just below the knee
        jknee = torch.clamp(
            torch.sum(
                ((p_atm[:-1] >= pknee) & (p_atm[1:] < pknee))
                * torch.arange(np_ - 1, device=atm.p.device)
            ),
            min=0,
        )

        idx = torch.arange(np_, device=atm.p.device)
        xfac_knee = 0.5 * (scale[jknee] + scale[jknee + 1]) * xfsh
        nd_kp1 = torch.exp(-(atm.h[jknee + 1] - hknee) / xfac_knee)
        nd_k = torch.exp(-(hknee - atm.h[jknee]) / 1000.0)

        # above knee+1: recurrence nd[j] = nd[j-1]*exp(-delh/(scale_j fsh))
        log_dec = -torch.diff(atm.h) / (scale[1:] * xfsh)  # step j-1 -> j
        csum = torch.cat([atm.h.new_zeros(1), torch.cumsum(log_dec, 0)])
        nd_above = nd_kp1 * torch.exp(csum - csum[jknee + 1])
        # below knee: exp(-(h[jknee]-h[j])/1km)
        nd_below = torch.exp(-(atm.h[jknee] - atm.h) / 1000.0)
        nd = torch.where(
            idx > jknee + 1, nd_above,
            torch.where(idx == jknee + 1, nd_kp1,
                        torch.where(idx == jknee, nd_k, nd_below)),
        )
        q = nd / rho / 1.0e3

        # integrate optical depth downwards (reference OD loop)
        od_top = nd[np_ - 1] * scale[np_ - 1] * xfsh * 1.0e2
        d_above = (nd[:-1] - nd[1:]) * scale[:-1] * xfsh * 1.0e2  # j > jknee
        d_below = (nd[1:] - nd[:-1]) * 1000.0 * 1.0e2  # j < jknee
        j_arr = torch.arange(np_ - 1, device=atm.p.device)
        d_knee = (
            (1.0 - nd[jknee + 1])
            * (0.5 * (scale[jknee] + scale[jknee + 1]) * xfsh)
            * 1.0e2
            + (1.0 - nd_k) * 1000.0 * 1.0e2
        )
        contrib = torch.where(
            j_arr > jknee, d_above,
            torch.where(j_arr == jknee, d_knee, d_below),
        )
        odx = od_top + torch.sum(contrib)

        x1 = _clip(q * tau / odx, _FLOOR, 1.0e10)
        atm = _set_profile(atm, entry, x1)
        return _set_renorm(atm, entry, tau)


@register_model
class Model49:
    """Scale one gas's VMR to a multiple of another gas's profile
    (reference model_49.py). State: [scale] (logged); reference gas static.
    """

    id = 49

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        s = f.readline().rsplit("!", 1)[0].split()
        ref_gas, ref_iso = int(s[0]), int(s[1])
        scale, escale = _vals_block(f)
        ref_col = None
        for i, (g, iso) in enumerate(zip(ctx["gas_id"], ctx["iso_id"])):
            if g == ref_gas and iso == ref_iso:
                ref_col = i
                break
        if ref_col is None:
            raise ValueError(f"model 49 reference gas {ref_gas}/{ref_iso} not in atmosphere")
        entry = _mk_entry(varident, 49, ix, 1, ctx, extra=(ref_col,))
        return AprParseResult(
            entry=entry,
            x0=np.array([np.log(scale)]),
            sx_diag=np.array([(escale / scale) ** 2]),
            lx=np.ones(1, dtype=int),
            inum=np.zeros(1, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        ref = atm.vmr[:, entry.extra[0]]
        return _set_profile(atm, entry, ref * x[0])


def _continuous_from_apr(model_id, f, varident, ix, ctx, log: bool):
    """Models -1/50/51: one entry per level read from a profile file on the
    .ref grid, with the inter-level correlation of model 0."""
    fname = f.readline().split()[0]
    nlevel, clen, pref, ref, eref = _read_profile_file(fname)
    if nlevel != ctx["npro"]:
        raise ValueError(
            f"model {model_id} profile must be on the .ref grid")
    if log:
        x0, var = np.log(ref), (eref / ref) ** 2
    else:
        x0, var = ref.copy(), eref**2
    entry = _mk_entry(varident, model_id, ix, nlevel, ctx)
    return AprParseResult(
        entry=entry,
        x0=x0,
        sx_diag=var,
        lx=np.full(nlevel, int(log)),
        inum=np.zeros(nlevel, dtype=int),
        corr=_corr_block(pref, clen, var),
    )


@register_model
class Model50:
    """Continuous per-level scaling-factor profile (reference model_50.py).
    State: one linear factor per level with correlation length."""

    id = 50

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        return _continuous_from_apr(50, f, varident, ix, ctx, log=False)

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        prof = _get_profile(atm, entry)
        return _set_profile(atm, entry, prof * x)


@register_model
class Model51:
    """Continuous profile set directly in linear space with correlation
    length (reference model_51.py)."""

    id = 51

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        return _continuous_from_apr(51, f, varident, ix, ctx, log=False)

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        return _set_profile(atm, entry, x)


@register_model
class ModelM1:
    """Continuous aerosol profile in particles per gram (reference
    Models/PreRTModels/model_m1.py): like model 0 with an aerosol target,
    log-space state."""

    id = -1

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        return _continuous_from_apr(-1, f, varident, ix, ctx, log=True)

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        return _set_profile(atm, entry, x)


# E2-like lookup table for the Guillot (2010) T-profile (reference
# Models/PreRTModels/model_43.py e2(): log10 ordinates on z=-10..2, step .12)
_M43_YL = np.array([
    0.00000, 0.00000, 0.00000, 0.00000, 0.00000, 0.00000, 0.00000, 0.00000,
    0.00000, 0.00000, -2.58860e-08, -2.58860e-08, -2.58860e-08, -2.58860e-08,
    -5.17719e-08, -5.17719e-08, -7.76579e-08, -7.76579e-08, -1.03544e-07,
    -1.55316e-07, -2.07088e-07, -2.58860e-07, -3.36518e-07, -4.40062e-07,
    -5.43606e-07, -7.24808e-07, -9.31896e-07, -1.21664e-06, -1.55316e-06,
    -2.01911e-06, -2.61449e-06, -3.39108e-06, -4.40064e-06, -5.66906e-06,
    -7.32579e-06, -9.47437e-06, -1.22442e-05, -1.58166e-05, -2.04245e-05,
    -2.63527e-05, -3.39637e-05, -4.37754e-05, -5.64092e-05, -7.26162e-05,
    -9.34584e-05, -0.000120179, -0.000154463, -0.000198384, -0.000254637,
    -0.000326597, -0.000418571, -0.000536015, -0.000685872, -0.000876814,
    -0.00111995, -0.00142903, -0.00182161, -0.00231951, -0.00295015,
    -0.00374779, -0.00475518, -0.00602551, -0.00762473, -0.00963471,
    -0.0121566, -0.0153151, -0.0192639, -0.0241918, -0.0303303, -0.0379631,
    -0.0474377, -0.0591792, -0.0737073, -0.0916590, -0.113815, -0.141135,
    -0.174802, -0.216279, -0.267385, -0.330392, -0.408156, -0.504287,
    -0.623379, -0.771314, -0.955672, -1.18628, -1.47592, -1.84134, -2.30451,
    -2.89434, -3.64897, -4.61874, -5.87009, -7.49083, -9.59684, -12.3411,
    -15.9257, -20.6167, -26.7657, -34.8358,
])
_M43_X = 10.0 ** (-10.0 + 12.0 * np.arange(100) / 100.0)


def _m43_e2(xin):
    """Tabulated attenuation function of the Guillot profile (reference
    model_43.py e2)."""
    z1 = torch.log10(xin)
    i = torch.clamp(((z1 + 10.0) / 0.12).to(torch.int32), 0, 98).long()
    table_x = torch.as_tensor(_M43_X, dtype=xin.dtype, device=xin.device)
    table_y = torch.as_tensor(_M43_YL, dtype=xin.dtype, device=xin.device)
    x1 = table_x[i]
    x2 = table_x[i + 1]
    fx = (xin - x1) / (x2 - x1)
    ylint = (1.0 - fx) * table_y[i] + fx * table_y[i + 1]
    y = 10.0**ylint
    return torch.where(z1 < -10.0, 1.0, torch.where(z1 > 1.89, 0.0, y))


def _read_lin_log(f, log=True):
    v, e = _vals_block(f)
    if log:
        return np.log(v), (e / v) ** 2, 1
    return v, e**2, 0


@register_model
class Model43:
    """Guillot (2010) radiative-equilibrium T profile for irradiated
    exoplanets (reference model_43.py). State: [alpha, beta, k_ir,
    gamma_v1, gamma_v2] (all logged); stellar params static."""

    id = 43

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        x0, var, lx = [], [], []
        for _ in range(5):
            v, s2, l = _read_lin_log(f, log=True)
            x0.append(v)
            var.append(s2)
            lx.append(l)
        sline = f.readline().split()
        t_star, r_star, sdist, t_int = (
            float(sline[0]), float(sline[1]), float(sline[2]), float(sline[3])
        )
        entry = _mk_entry(
            varident, 43, ix, 5, ctx,
            extra=(t_star, r_star, sdist, t_int),
        )
        return AprParseResult(
            entry=entry, x0=np.asarray(x0), sx_diag=np.asarray(var),
            lx=np.asarray(lx, dtype=int), inum=np.zeros(5, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        alpha, beta, k_ir, g1, g2 = x[0], x[1], x[2], x[3], x[4]
        t_star, r_star, sdist, t_int = entry.extra
        t_eq = t_star * np.sqrt(0.5 * r_star / sdist)
        t_irr = beta * t_eq
        c1 = 0.75 * t_int**4
        cx = 0.75 * t_irr**4
        grav, _ = calc_grav(atm.h, atm.latitude, atm.planet,
                            getattr(atm, "planet_radius", None))
        g0 = grav[0]

        def zeta(gamma, tau):
            c0 = 2.0 / 3.0
            cg = c0 / gamma
            sarg = gamma * tau
            xx = c0 + cg * (1.0 + (0.5 * sarg - 1.0) * torch.exp(-sarg))
            y = _m43_e2(sarg)
            return xx + c0 * gamma * (1.0 - 0.5 * tau**2) * y

        tau = k_ir * atm.p / g0 / 10.0
        xv = c1 * (2.0 / 3.0 + tau) + cx * (
            (1.0 - alpha) * zeta(g1, tau) + alpha * zeta(g2, tau)
        )
        return _set_profile(atm, entry, xv**0.25)


@register_model
class Model62:
    """Madhusudhan & Seager (2009)-style parametric T profile (reference
    model_62.py). State: [P1, P2, P3, T0, alpha1, alpha2]; pressures and
    alphas logged."""

    id = 62

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        specs = [True, True, True, False, True, True]
        x0, var, lx = [], [], []
        for log in specs:
            v, s2, l = _read_lin_log(f, log=log)
            x0.append(v)
            var.append(s2)
            lx.append(l)
        entry = _mk_entry(varident, 62, ix, 6, ctx)
        return AprParseResult(
            entry=entry, x0=np.asarray(x0), sx_diag=np.asarray(var),
            lx=np.asarray(lx, dtype=int), inum=np.ones(6, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        p1, p2, p3 = x[0] * 101325.0, x[1] * 101325.0, x[2] * 101325.0
        t0, a1, a2 = x[3], x[4], x[5]
        p = atm.p
        p0 = torch.min(p)
        t2 = ((1 / a1) * torch.log10(p1 / p0)) ** 2 - (
            (1 / a2) * torch.log10(p1 / p2)
        ) ** 2 + t0
        t3 = ((1 / a2) * torch.log10(p3 / p2)) ** 2 + t2
        tp = torch.where(
            p >= p3, t3,
            torch.where(
                p >= p1,
                ((1 / a2) * torch.log10(p / p2)) ** 2 + t2,
                ((1 / a1) * torch.log10(p / p0)) ** 2 + t0,
            ),
        )
        return _set_profile(atm, entry, _clip(tp, 50.0, 6000.0))


def _venus_cloud_modes(h_km, z_offset):
    """The four Venus cloud/haze number-density profiles of models 110/111
    (reference model_110.py calculate): piecewise exp/flat/exp in altitude.
    Returns (NP, 4) in cm-3."""
    specs = [
        # (zb, zc, h_up, h_lo, n0)
        (49.0, 16.0, 3.5, 1.0, 193.5),
        (65.0, 1.0, 3.5, 3.0, 100.0),
        (49.0, 11.0, 1.0, 0.1, 50.0),
        (49.0, 8.0, 1.0, 0.5, 14.0),
    ]
    cols = []
    for zb0, zc, hup, hlo, n0 in specs:
        zb = zb0 + z_offset
        below = n0 * torch.exp(-(zb - h_km) / hlo)
        flat = torch.full_like(h_km, n0)
        above = n0 * torch.exp(-(h_km - (zb + zc)) / hup)
        cols.append(
            torch.where(h_km < zb, below,
                        torch.where(h_km <= zb + zc, flat, above))
        )
    return torch.stack(cols, dim=1)


def _set_modes(dust, modes, i0: int):
    """``dust`` with the 4 columns from ``i0`` replaced by ``modes``, out of
    place; the start is clamped so the block fits, as
    ``jax.lax.dynamic_update_slice`` clamps it."""
    i0 = max(0, min(int(i0), dust.shape[1] - modes.shape[1]))
    return torch.cat([dust[:, :i0], modes, dust[:, i0 + modes.shape[1]:]],
                     dim=1)


@register_model
class Model110:
    """Venus cloud: 4 fixed modes shifted by a retrieved altitude offset
    (reference model_110.py). State: [z_offset] (km, linear)."""

    id = 110

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        z0, err = _vals_block(f)
        entry = _mk_entry(varident, 110, ix, 1, ctx)
        return AprParseResult(
            entry=entry, x0=np.array([z0]), sx_diag=np.array([err**2]),
            lx=np.zeros(1, dtype=int), inum=np.ones(1, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        h_km = atm.h / 1.0e3
        modes = _venus_cloud_modes(h_km, x[0]) * 1.0e6  # cm-3 -> m-3
        return atm.replace(dust=_set_modes(atm.dust, modes,
                                           entry.target_idx))


@register_model
class Model111:
    """Venus cloud + coupled SO2 profile (reference model_111.py). State:
    [z_offset, so2_deep (log), so2_top (log)]."""

    id = 111

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        z0, zerr = _vals_block(f)
        sd, sde = _vals_block(f)
        st, ste = _vals_block(f)
        so2_col = None
        for i, (g, s) in enumerate(zip(ctx["gas_id"], ctx["iso_id"])):
            if g == 9 and s == 0:
                so2_col = i
                break
        if so2_col is None:
            raise ValueError("model 111 requires SO2 in the atmosphere")
        entry = _mk_entry(varident, 111, ix, 3, ctx, extra=(so2_col,))
        return AprParseResult(
            entry=entry,
            x0=np.array([z0, np.log(sd), np.log(st)]),
            sx_diag=np.array([zerr**2, (sde / sd) ** 2, (ste / st) ** 2]),
            lx=np.array([0, 1, 1]),
            inum=np.ones(3, dtype=int),
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        z_offset, so2_deep, so2_top = x[0], x[1], x[2]
        h_km = atm.h / 1.0e3
        modes = _venus_cloud_modes(h_km, z_offset) * 1.0e6
        dust = _set_modes(atm.dust, modes, entry.target_idx)
        cloud_bottom = 49.0 + z_offset
        cloud_top = cloud_bottom + 20.0
        grad = (torch.log(so2_top) - torch.log(so2_deep)) / (
            cloud_top - cloud_bottom
        )
        so2 = torch.where(
            h_km < cloud_bottom,
            so2_deep,
            torch.where(
                h_km > cloud_top,
                so2_top,
                torch.exp(torch.log(so2_deep) + grad * (h_km - cloud_bottom)),
            ),
        )
        vmr = set_column(atm.vmr, entry.extra[0], so2)
        return atm.replace(dust=dust, vmr=vmr)


@register_model
class Model1002:
    """Per-location scaling of the reference profile at NLOCATIONS planet
    locations (reference Models/PreRTModels/model_1002.py).

    The multi-location Atmosphere carries a leading location axis on its
    profile fields (``core.types.stack_atmospheres``) and the forward is
    vmapped over it (``multiloc.forward_nadir_multiloc``); this model
    scales the target profile by one factor per location. The a-priori
    covariance carries the exponential angular-distance correlation
    between locations (model_1002.py:208-221).
    """

    id = 1002

    @staticmethod
    def from_apr(f, varident, ix, ctx) -> AprParseResult:
        fname = f.readline().split()[0]
        with open(fname) as fh:
            toks = fh.read().split()
        nlocs = int(float(toks[0]))
        clen = float(toks[1])
        dat = np.array([float(x) for x in toks[2:2 + 4 * nlocs]]).reshape(
            nlocs, 4)
        lats, lons, sfactor, efactor = dat.T
        nloc_ctx = ctx.get("nlocations")
        if nloc_ctx is not None and nlocs != nloc_ctx:
            raise ValueError(
                "model 1002: locations must match the Atmosphere's")

        var = efactor**2
        sx = np.diag(var).astype(float)
        # exponential angular-distance correlation (model_1002.py:208-221)
        s = np.sin(np.deg2rad(lats))
        c = np.cos(np.deg2rad(lats))
        for j in range(nlocs):
            c3 = np.cos(np.deg2rad(lons[j] - lons))
            cospsi = np.clip(s[j] * s + c[j] * c * c3, -1.0, 1.0)
            psi = np.rad2deg(np.arccos(cospsi))
            xfac = np.exp(-np.abs(psi / clen))
            for k in range(nlocs):
                if xfac[k] > 0.001 and k != j:
                    sx[j, k] = np.sqrt(var[j] * var[k]) * xfac[k]
                    sx[k, j] = sx[j, k]

        entry = _mk_entry(varident, 1002, ix, nlocs, ctx,
                          extra=(("nlocations", nlocs),))
        return AprParseResult(
            entry=entry,
            x0=sfactor,
            sx_diag=var,
            lx=np.zeros(nlocs, dtype=int),
            inum=np.zeros(nlocs, dtype=int),
            corr=sx,
        )

    @staticmethod
    def apply(entry: ModelEntry, atm, x):
        """The atmosphere's profile fields carry a leading (NLOC,) axis; x
        is the per-location scale vector."""
        t = entry.target
        scf = x.reshape(-1, 1)  # (NLOC, 1), broadcast over the levels
        if t == ProfileTarget.TEMPERATURE:
            return atm.replace(t=atm.t * scf)
        if t in (ProfileTarget.GAS_VMR, ProfileTarget.AEROSOL):
            name = "vmr" if t == ProfileTarget.GAS_VMR else "dust"
            mat, col = getattr(atm, name), entry.target_idx
            return atm.replace(**{name: set_column(mat, col,
                                                   mat[..., col] * scf)})
        if t == ProfileTarget.PARAH2:
            return atm.replace(parah2=atm.parah2 * scf)
        raise NotImplementedError(f"target {t}")
