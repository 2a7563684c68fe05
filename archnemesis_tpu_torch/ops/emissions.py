"""Non-LTE emission rates and per-layer emitted radiance.

Port of the JAX package's ``ops/emissions.py`` (reference
``Emissions_0.calc_rates_hdf5`` ``Emissions_0.py:273`` +
``ForwardModel_0.calculate_layer_emission`` ``ForwardModel_0.py:4018``):
the per-layer/per-emission loops with repeated HDF5 reads become one
temperature interpolation over the preloaded (wave, T, NEM) table block,
contracted with the layer columns. Plain tensor functions with no host
read: they run under ``torch.func.vmap`` and ``jacfwd`` (the reference
raises on ``return_grad=True`` here).
"""

from __future__ import annotations

import numpy as np
import torch

from archnemesis_tpu_torch.constants import C_LIGHT, C_LIGHT_CGS, H_PLANCK
from archnemesis_tpu_torch.core.emissions import EmissionTables
from archnemesis_tpu_torch.enums import EmissionType, WaveUnit
from archnemesis_tpu_torch.utils.interp import interp1d_extrap

SQ_CM_TO_SQ_M = 1.0e-4
FOUR_PI = 4.0 * np.pi


def interp1d_zero(xp, fp, x):
    """Linear interpolation with zero fill outside [xp[0], xp[-1]] (scipy
    interp1d(bounds_error=False, fill_value=0.0) as used at
    ``ForwardModel_0.py:4177``); fp is interpolated along axis 0."""
    y = interp1d_extrap(xp, fp, x)
    inside = (x >= xp[0]) & (x <= xp[-1])
    if fp.ndim > 1:
        inside = inside.reshape(inside.shape + (1,) * (fp.ndim - 1))
    return torch.where(inside, y, torch.zeros_like(y))


def _type_mask(em: EmissionTables, types, like):
    """(NEM,) bool tensor: the emissions whose type is in ``types``."""
    return torch.as_tensor([t in types for t in em.emtype],
                           device=like.device)


def emission_rates(em: EmissionTables, layer_temp, dist=None):
    """Emission rates per (wave, layer, emission) on the table wave grid.

    Reference ``calc_rates_hdf5`` (``Emissions_0.py:273``): clamped linear
    interpolation of K (and RATE_COEFF for chemical/photolysis emissions) in
    temperature, plus the (DIST_REF/dist)^2 stellar-distance rescaling of
    fluorescence/photolysis rates. ``dist`` is the planet-star distance in
    AU (None when no stellar spectrum is attached).

    NT=1 tables are constant in temperature (the reference's NT==1 branch,
    ``Emissions_0.py:305-320``, applied per emission here).

    Returns (NWAVE_EM, NLAY, NEM).
    """
    nem, nlay = em.nem, layer_temp.shape[0]
    if em.nt == 1:
        k_t = em.k[:, 0, :][:, None, :].expand(em.k.shape[0], nlay, nem)
        c_t = em.rate_coeff[0][None, :].expand(nlay, nem)
    else:
        # interpolation along the T axis; clamping makes it pure
        # interpolation
        tcl = torch.clamp(layer_temp, em.temp[0], em.temp[-1])  # (NLAY,)
        k_t = interp1d_extrap(em.temp, em.k.movedim(1, 0), tcl).movedim(0, 1)
        c_t = interp1d_extrap(em.temp, em.rate_coeff, tcl)  # (NLAY, NEM)

    # fluorescence uses c=1 (Emissions_0.py:346-349)
    use_c = _type_mask(em, (EmissionType.CHEMICAL, EmissionType.PHOTOLYSIS),
                       c_t)
    c = torch.where(use_c, c_t, torch.ones_like(c_t))
    rates = k_t * c[None, :, :]

    if dist is not None:
        # stellar-distance rescaling of solar-pumped emissions
        # (Emissions_0.py:355-359)
        scale = (em.dist_ref / dist) ** 2
        pumped = _type_mask(
            em, (EmissionType.FLUORESCENCE, EmissionType.PHOTOLYSIS), scale)
        scale = torch.where(pumped, scale, torch.ones_like(scale))
        rates = rates * scale[None, None, :]
    return rates


def layer_emission(em: EmissionTables, wave_calc, layer_temp, layer_amount,
                   gas_cols, dist=None):
    """Per-layer emitted radiance on the calculation wave grid.

    Reference ``calculate_layer_emission`` (``ForwardModel_0.py:4018``):
    EMI(w, l) = sum_e rate(w, l, e) * N_e(l) / 4pi, converted from photon to
    energy units with the per-wave photon energy, then interpolated from the
    table grid onto the calc grid with zero fill (:4177). The layer->path
    gather happens downstream (``forward.path_spectrum``), which commutes
    with the wave interpolation.

    layer_amount: (NLAY, NVMR) layer column densities [m^-2]; gas_cols:
    host tuple, the atmosphere gas column of each emission
    (``locate_emission_gases``).

    Returns (NWAVE_CALC, NLAY) in W cm-2 sr-1 (cm-1)-1 (or um-1).
    """
    rates = emission_rates(em, layer_temp, dist=dist)  # (NWAVE_EM, NLAY, NEM)
    cols = torch.as_tensor(list(gas_cols), device=layer_amount.device)
    colden = layer_amount[:, cols] * SQ_CM_TO_SQ_M / FOUR_PI  # (NLAY, NEM)
    emi = torch.einsum("wle,le->wl", rates, colden)

    # photon -> energy units (ForwardModel_0.py:4078-4085)
    if em.ispace == WaveUnit.Wavenumber_cm:
        factor = H_PLANCK * C_LIGHT_CGS * em.wave
    else:
        factor = H_PLANCK * C_LIGHT / (em.wave * 1.0e-6)
    emi = emi * factor[:, None]
    return interp1d_zero(em.wave, emi, wave_calc)


def locate_emission_gases(em: EmissionTables, atm_gas_id, atm_iso_id):
    """Host resolution of each emission's gas to an atmosphere VMR column
    (exact (ID, ISO) match, ForwardModel_0.py:4064)."""
    cols = []
    for g, s in zip(em.gas_id, em.iso_id):
        matches = [i for i, (ag, as_) in enumerate(zip(atm_gas_id, atm_iso_id))
                   if ag == g and as_ == s]
        if len(matches) != 1:
            raise ValueError(
                f"emission gas {g} iso {s}: expected exactly one atmosphere "
                f"match, found {len(matches)}")
        cols.append(matches[0])
    return tuple(cols)
