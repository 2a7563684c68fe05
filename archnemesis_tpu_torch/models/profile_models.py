"""Atmospheric profile parameterisations (the common PreRT models).

Port of models of the JAX package's ``models/profile_models.py``: 0
(continuous profile), 2 (scaling), 3 (log scaling) and 47 (Gaussian cloud
of given optical depth). Each model provides:
- ``from_apr(f, varident, ix, ctx)`` (host): parse its .apr block ->
  AprParseResult (reference Models/PreRTModels/model_*.py
  from_apr_to_state_vector); and
- ``apply(entry, atm, x)`` (tensors): map its unlogged state-vector slice
  onto the Atmosphere structure (reference calculate_from_subprofretg).

Any other model id in an ``.apr`` raises ``NotImplementedError`` in
``retrieval.statevector.read_apr`` until it is ported.
"""

from __future__ import annotations

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
        renorm = (
            atm.p.new_zeros(atm.ndust)
            if atm.dust_renorm is None
            else torch.as_tensor(atm.dust_renorm, dtype=atm.p.dtype,
                                 device=atm.p.device)
        )
        hit = torch.arange(atm.ndust, device=atm.p.device) == entry.target_idx
        return atm.replace(dust_renorm=torch.where(hit, tau, renorm))
