"""State vector: .apr parsing, bookkeeping, and pure application to
components (the reference's Variables_0 + subprofretg).

Port of the JAX package's ``retrieval/statevector.py``. ``read_apr`` builds
a static ``StateVector`` (entries, a-priori xa/sa, log flags; host numpy).
``apply_state`` is the pure counterpart of the reference ``subprofretg``
(ForwardModel_0.py:2397): hydrostatic rebalance, model application, VMR
renormalisation + molecular weight, rebalance again, returning an updated
Atmosphere. ``torch.func.jacfwd`` of the forward model through
``apply_state`` yields the full analytic Jacobian K without any xmap
plumbing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from archnemesis_tpu_torch.core.types import Atmosphere
from archnemesis_tpu_torch.enums import AtmosphericProfileFormat
from archnemesis_tpu_torch.models import MODEL_REGISTRY
from archnemesis_tpu_torch.models.base import ModelEntry, ProfileTarget
from archnemesis_tpu_torch.rt.atmosphere import (
    adjust_hydrostat_h,
    adjust_vmr,
    apply_svp_cap,
    calc_molwt,
    gas_molwt_per_column,
)


@dataclass(frozen=True)
class StateVector:
    """Static state-vector description + a-priori."""

    entries: Tuple[ModelEntry, ...]
    nx: int
    xa: np.ndarray  # (NX,) a-priori
    sa: np.ndarray  # (NX, NX) a-priori covariance
    lx: np.ndarray  # (NX,) log flags
    fix: np.ndarray  # (NX,) fixed flags
    inum: np.ndarray  # (NX,) numerical-gradient flags
    jpre: int = -1
    jtan: int = -1
    jsurf: int = -1
    jrad: int = -1

    @property
    def iscale_mask(self) -> np.ndarray:
        """ISCALE for adjust_VMR: gases whose VMR is retrieved are NOT
        rescaled (reference subprofretg ForwardModel_0.py:2517-2526)."""
        return self._iscale

    def with_iscale(self, ngas):
        mask = np.ones(ngas, dtype=int)
        for e in self.entries:
            if e.target == ProfileTarget.GAS_VMR and e.varident[0] > 0:
                mask[e.target_idx] = 0
        object.__setattr__(self, "_iscale", mask)
        return self


def read_apr(path: str, atm: Atmosphere) -> StateVector:
    """Parse a .apr file (reference Variables_0.read_apr:684).

    Auxiliary profile files named inside the .apr are resolved relative to
    the .apr's directory (NEMESIS runs from the deck directory).
    """
    import os

    ctx = dict(
        npro=atm.np_,
        gas_id=atm.gas_id,
        iso_id=atm.iso_id,
        ndust=atm.ndust,
    )
    entries: List[ModelEntry] = []
    x0_parts, lx_parts, inum_parts = [], [], []
    sx_blocks = []

    path = os.path.abspath(path)
    cwd = os.getcwd()
    os.chdir(os.path.dirname(path) or ".")
    try:
        with open(path) as f:
            f.readline()  # header
            nvar = int(f.readline().split()[0])
            ix = 0
            for _ in range(nvar):
                varident = [int(v) for v in f.readline().split()[:3]]
                model_id = varident[2]
                if model_id not in MODEL_REGISTRY:
                    raise NotImplementedError(
                        f"model id {model_id} not implemented (varident={varident})"
                    )
                res = MODEL_REGISTRY[model_id].from_apr(f, varident, ix, ctx)
                entries.append(res.entry)
                x0_parts.append(res.x0)
                lx_parts.append(res.lx)
                inum_parts.append(res.inum)
                sx_blocks.append(
                    res.corr if res.corr is not None else np.diag(res.sx_diag)
                )
                ix += res.entry.nx
    finally:
        os.chdir(cwd)

    nx = ix
    xa = np.concatenate(x0_parts)
    lx = np.concatenate(lx_parts)
    inum = np.concatenate(inum_parts)
    sa = np.zeros((nx, nx))
    off = 0
    for blk in sx_blocks:
        n = blk.shape[0]
        sa[off : off + n, off : off + n] = blk
        off += n

    sv = StateVector(
        entries=tuple(entries),
        nx=nx,
        xa=xa,
        sa=sa,
        lx=lx,
        fix=np.zeros(nx, dtype=int),
        inum=inum,
    )
    return sv.with_iscale(atm.nvmr)


def apply_state(atm: Atmosphere, xn, sv: StateVector, gas_masses=None,
                adjust_hydrostat: bool = True) -> Atmosphere:
    """Pure subprofretg: apply state vector ``xn`` to the atmosphere.

    Order mirrors ForwardModel_0.subprofretg:2397: hydrostatic H rebalance,
    per-model application (with unlogging), VMR renormalisation (AMFORM=1)
    + molwt recalculation, final hydrostatic H rebalance. ``xn`` is a tensor
    on the atmosphere's device (or a host array, which is put there).
    """
    if gas_masses is None:
        gas_masses = gas_molwt_per_column(atm.gas_id, atm.iso_id)

    if adjust_hydrostat:
        atm = adjust_hydrostat_h(atm)

    x_unlogged = _unlog(sv, xn, like=atm.h)

    for e in sv.entries:
        model = MODEL_REGISTRY[e.model_id]
        if getattr(model, "domain", "atmosphere") != "atmosphere":
            continue
        atm = model.apply(e, atm, x_unlogged[e.ix : e.ix + e.nx])

    if atm.amform == AtmosphericProfileFormat.CALC_MOLECULAR_WEIGHT_SCALE_VMR_TO_ONE:
        vmr = adjust_vmr(atm.vmr, sv.iscale_mask)
        atm = atm.replace(vmr=vmr, molwt=calc_molwt(vmr, gas_masses))
    atm = apply_svp_cap(atm)

    if adjust_hydrostat:
        atm = adjust_hydrostat_h(atm)

    return atm


def _unlog(sv: StateVector, xn, like=None):
    """The state vector with its log entries exponentiated; a host ``xn``
    becomes a tensor in the dtype and on the device of ``like``."""
    if not isinstance(xn, torch.Tensor):
        kw = {} if like is None else dict(dtype=like.dtype,
                                          device=like.device)
        xn = torch.as_tensor(np.asarray(xn), **kw)
    lx = torch.as_tensor(np.asarray(sv.lx) == 1, device=xn.device)
    return torch.where(lx, torch.exp(xn), xn)


def apply_domain(sv: StateVector, xn, domain: str, obj, **kw):
    """Apply all models of the given non-atmosphere ``domain`` to ``obj``
    (surface -> SurfaceSpec, scatter -> AerosolOptics, measurement ->
    dict of geometry updates). Counterpart of the reference subprofretg
    dispatch for non-atmospheric targets (ForwardModel_0.py:2507)."""
    x = _unlog(sv, xn)
    for e in sv.entries:
        model = MODEL_REGISTRY[e.model_id]
        if getattr(model, "domain", "atmosphere") != domain:
            continue
        fn = getattr(model, f"apply_{domain}")
        obj = fn(e, obj, x[e.ix : e.ix + e.nx], **kw)
    return obj


def ils_models_present(sv: StateVector) -> bool:
    return any(
        getattr(MODEL_REGISTRY[e.model_id], "domain", "") == "ils"
        for e in sv.entries
    )


def apply_ils_models(sv: StateVector, xn, igeom: int, vconv):
    """Differentiable instrument-lineshape parameterisations (models
    228/229/230): returns (vconv', offset, fwhm, amp) per-channel double-
    Gaussian parameters from the last ils-domain model, or None."""
    x = _unlog(sv, xn)
    out = None
    for e in sv.entries:
        model = MODEL_REGISTRY[e.model_id]
        if getattr(model, "domain", "atmosphere") != "ils":
            continue
        out = model.apply_ils(e, igeom, vconv, x[e.ix : e.ix + e.nx])
    return out


def apply_spectrum_models(sv: StateVector, xn, igeom: int, vconv, spec):
    """PostRT spectral corrections on one geometry's convolved spectrum
    (reference subspecret ForwardModel_0.py:2570)."""
    x = _unlog(sv, xn)
    for e in sv.entries:
        model = MODEL_REGISTRY[e.model_id]
        if getattr(model, "domain", "atmosphere") != "spectrum":
            continue
        spec = model.apply_spectrum(
            e, igeom, vconv, spec, x[e.ix : e.ix + e.nx]
        )
    return spec
