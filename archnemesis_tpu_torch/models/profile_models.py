"""Atmospheric profile parameterisations (the common PreRT models).

Port of the three simplest models of the JAX package's
``models/profile_models.py``: 0 (continuous profile), 2 (scaling) and 3 (log
scaling). Each model provides:
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

from archnemesis_tpu_torch.models.base import (
    AprParseResult,
    ModelEntry,
    ProfileTarget,
    classify_target,
    register_model,
)
from archnemesis_tpu_torch.rt.atmosphere import set_column


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
