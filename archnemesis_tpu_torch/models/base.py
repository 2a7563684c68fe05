"""Model-parameterisation framework (state vector -> component updates).

Port of the JAX package's ``models/base.py`` (host code, the same in both
packages), the counterpart of the reference ``Models`` registry +
``ModelBase`` (Models/__init__.py:16-67, Models/ModelBase.py:39): each model
is

- a host-side parser ``from_apr(...)`` that consumes its block of the .apr
  file and returns a static ``ModelEntry`` plus its a-priori (x0, sx-diag,
  correlation) contribution; and
- a pure function ``apply(entry, components, x_entry)`` that maps its slice
  of the (already unlogged) state vector onto the component pytrees.

Because components are frozen dataclasses of tensors, 'applying' a model
returns updated copies: this is the whole of the reference's subprofretg
mutation machinery, and ``torch.func.jacfwd`` differentiates through it (no
xmap bookkeeping).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, Optional, Tuple

import numpy as np


class ProfileTarget(Enum):
    TEMPERATURE = "temperature"
    GAS_VMR = "gas_vmr"
    AEROSOL = "aerosol"
    PARAH2 = "parah2"
    FCLOUD = "fcloud"
    NOT_ATMOSPHERIC = "not_atmospheric"


@dataclass(frozen=True)
class ModelEntry:
    """Static description of one parameterisation in the state vector."""

    varident: Tuple[int, int, int]
    model_id: int
    ix: int  # start index in state vector
    nx: int  # number of entries
    target: ProfileTarget
    target_idx: Optional[int] = None  # column (gas or dust index) if applicable
    extra: tuple = ()  # model-specific static parameters (hashable)


@dataclass
class AprParseResult:
    entry: ModelEntry
    x0: np.ndarray  # (nx,)
    sx_diag: np.ndarray  # (nx,) variances
    lx: np.ndarray  # (nx,) log flags
    inum: np.ndarray  # (nx,) numerical-gradient flags
    corr: Optional[np.ndarray] = None  # (nx, nx) full covariance block if set


MODEL_REGISTRY: Dict[int, "type"] = {}


def register_model(cls):
    MODEL_REGISTRY[cls.id] = cls
    return cls


def classify_target(varident, atm_gas_id, atm_iso_id, ndust):
    """Map a VARIDENT triplet to the profile it parameterises (reference
    Variables_0.classify_model_type_from_varident:598 + ForwardModel_0
    _get_ipar:2373)."""
    v0, v1, v2 = varident
    if not (v2 < 100 or 1000 <= v2 <= 1100):
        return ProfileTarget.NOT_ATMOSPHERIC, None
    if v0 == 0:
        return ProfileTarget.TEMPERATURE, None
    if v0 > 0:
        matches = [
            i
            for i, (g, s) in enumerate(zip(atm_gas_id, atm_iso_id))
            if g == v0 and s == v1
        ]
        if len(matches) != 1:
            raise ValueError(f"gas {v0} iso {v1} not uniquely in atmosphere")
        return ProfileTarget.GAS_VMR, matches[0]
    # v0 < 0: aerosol
    jcont = -v0
    if jcont > ndust:
        raise ValueError(f"aerosol {jcont} not in atmosphere (ndust={ndust})")
    return ProfileTarget.AEROSOL, jcont - 1


# ---------------------------------------------------------------------------
# Reconstruction of a ModelEntry from a .pre/.raw (varident, varparam) pair —
# the analog of the reference's per-model ``from_bookmark`` used by
# Files.read_pre:1623 when a previous retrieval is chained (LIN>0,
# Retrievals.py:171-290) and the previous variable is NOT in the current
# state vector.  varparam is what this framework's output writers store
# (entry.extra[:5], retrieval/output.py:_varparam), which mirrors the
# reference's VARPARAM column conventions.
# ---------------------------------------------------------------------------

def _bk(nx, n_extra=0, coerce=()):
    """Bookmark rule: block size nx ("npro" means per-level), how many
    varparam slots hold the model's static extras, and per-slot coercions."""
    return (nx, n_extra, coerce)


_BOOKMARK_RULES = {
    0: _bk("npro"), -1: _bk("npro"), 50: _bk("npro"), 51: _bk("npro"),
    1: _bk(2, 1, (float,)),
    2: _bk(1), 3: _bk(1),
    4: _bk(3), 9: _bk(3), 45: _bk(3), 47: _bk(3), 32: _bk(3),
    20: _bk(2, 2, (float, float)),
    49: _bk(1, 1, (float,)),
    110: _bk(1), 111: _bk(3, 1, (float,)),
    43: _bk(5, 4, (float, float, float, float)),
    62: _bk(6),
    999: _bk(1), 777: _bk(1), 555: _bk(1), 556: _bk(1), 667: _bk(1),
    447: _bk(1),
    666: _bk(1, 1, (float,)),
    228: _bk(8), 229: _bk(7),
}


def entry_from_varparam(varident, varparam, ix, ctx):
    """Build the ModelEntry for one previous-retrieval variable from its
    (varident, varparam) bookmark (reference ModelBase.from_bookmark:619).

    ``ctx`` is the same dict read_apr uses (npro/gas_id/iso_id/ndust).
    Models whose static setup cannot be recovered from varparam alone
    (file-driven ILS/xsc/CIA-basis models 230/887/500/202, multi-location
    1002) raise — the reference's own from_bookmark needs the original
    files for these too.
    """
    model_id = int(varident[2])
    varparam = np.asarray(varparam, dtype=float)

    # PostRT per-geometry blocks: sizes derive from varparam[0] (ngeom)
    if model_id == 231:
        ngeom, ndeg = int(varparam[0]), int(varparam[1])
        return _postrt_entry(varident, 231, ix, ngeom * (ndeg + 1),
                             (ngeom, ndeg))
    if model_id == 232:
        ngeom = int(varparam[0])
        return _postrt_entry(varident, 232, ix, 2 * ngeom,
                             (ngeom, float(varparam[1])))
    if model_id == 233:
        ngeom = int(varparam[0])
        return _postrt_entry(varident, 233, ix, 3 * ngeom, (ngeom,))

    rule = _BOOKMARK_RULES.get(model_id)
    if rule is None:
        raise NotImplementedError(
            f"chaining a previous model id {model_id} (varident="
            f"{tuple(varident)}) needs its original input files; "
            "re-run with the variable in the current .apr instead"
        )
    nx, n_extra, coerce = rule
    if nx == "npro":
        nx = int(ctx["npro"])
    extra = tuple(
        (coerce[i] if i < len(coerce) else float)(varparam[i])
        for i in range(n_extra)
    )
    target, tidx = classify_target(
        varident, ctx["gas_id"], ctx["iso_id"], ctx["ndust"]
    )
    return ModelEntry(
        varident=tuple(int(v) for v in varident),
        model_id=model_id, ix=ix, nx=nx,
        target=target, target_idx=tidx, extra=extra,
    )


def _postrt_entry(varident, model_id, ix, nx, extra):
    return ModelEntry(
        varident=tuple(int(v) for v in varident),
        model_id=model_id, ix=ix, nx=nx,
        target=ProfileTarget.NOT_ATMOSPHERIC, target_idx=None, extra=extra,
    )
