"""Multi-location (NLOCATIONS > 1) forward evaluation.

Port of the JAX package's ``multiloc.py``. The reference can hold
multi-location Atmospheres (``Atmosphere_0`` 2-D (NP, NLOCATIONS) arrays,
model 1002 per-location scaling, ``ForwardModel_0.select_location:2868``)
but its forward models raise on NLOCATIONS > 1 (``nemesisfm``,
ForwardModel_0.py:463-466). Here a multi-location Atmosphere carries a
leading (NLOCATIONS,) axis on its profile fields
(``core.types.stack_atmospheres``), a location is a slice of that axis, and
the multi-location forward is one ``torch.func.vmap`` over it: the combine
kernel's ``vmap`` rule folds the locations into its rows, so a forward
launches it once per gas pair whatever NLOCATIONS is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from archnemesis_tpu_torch.core.types import Atmosphere
from archnemesis_tpu_torch.forward import _structures_to, forward_nadir
from archnemesis_tpu_torch.utils.device import resolve_device
from archnemesis_tpu_torch.utils.pytree import tensor_fields


def select_location(atm_multi: Atmosphere, iloc: int) -> Atmosphere:
    """One location of a multi-location Atmosphere (reference
    select_location, ForwardModel_0.py:2868): every profile field sliced
    at ``iloc`` along its leading axis; host metadata shared."""
    return dataclasses.replace(atm_multi, **{
        name: getattr(atm_multi, name)[iloc]
        for name in tensor_fields(Atmosphere)
        if getattr(atm_multi, name) is not None})


def _per_location(x, default, n_loc, like):
    """(NLOCATIONS,) angles in the run's type: ``default`` where x is
    None, a number or an array broadcast to every location."""
    x = default if x is None else x
    return torch.as_tensor(
        np.broadcast_to(np.asarray(x, dtype=np.float64), (n_loc,)).copy(),
        dtype=like.dtype, device=like.device)


def forward_nadir_multiloc(atm_multi: Atmosphere, laycfg, ktab, cia, aero,
                           surf, cfg, emiss_ang, sol_ang=None, azi_ang=None,
                           device=None):
    """Per-location nadir forward spectra, batched over the location axis.

    ``emiss_ang``, ``sol_ang`` and ``azi_ang`` are per location (a number
    applies to every location; None: 180 and 0, thermal emission only).
    Returns (NWAVE, NLOCATIONS): the reference's ``calc_spectrum_location``
    looped over iLOCATION, as one vmapped forward (tables and settings
    shared; the atmosphere column and the viewing geometry vary). The
    structures are moved to ``device`` first (None = CUDA; raises without
    a card unless ``device="cpu"``).
    """
    device = resolve_device(device)
    atm_multi, ktab, cia, aero, surf = _structures_to(
        device, atm_multi, ktab, cia, aero, surf)
    n_loc = atm_multi.h.shape[0]
    like = atm_multi.t
    angles = (_per_location(emiss_ang, 0.0, n_loc, like),
              _per_location(sol_ang, 180.0, n_loc, like),
              _per_location(azi_ang, 0.0, n_loc, like))
    names = [n for n in tensor_fields(Atmosphere)
             if getattr(atm_multi, n) is not None]

    def one(fields, e, s, a):
        atm = dataclasses.replace(atm_multi, **fields)
        return forward_nadir(atm, laycfg, ktab, cia, aero, surf, cfg,
                             emiss_ang=e, sol_ang=s, azi_ang=a,
                             device=device)[:, 0]

    spec = torch.func.vmap(one)(
        {n: getattr(atm_multi, n) for n in names}, *angles)
    return spec.T  # (NWAVE, NLOCATIONS)


def fov_weighted_spectrum(spec_loc, wgeom):
    """FOV-average of per-location spectra with the measurement weights
    (reference WGEOM application, nemesisfm ForwardModel_0.py:1670-1675):
    one contraction."""
    w = torch.as_tensor(wgeom, dtype=spec_loc.dtype, device=spec_loc.device)
    return spec_loc @ (w / torch.sum(w))
