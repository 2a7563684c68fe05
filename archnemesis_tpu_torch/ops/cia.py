"""Collision-induced-absorption optical depth per layer.

Port of the JAX package's ``ops/cia.py`` (reference ``ForwardModel_0.py:4516``
calc_tau_cia): temperature/para-H2 bracketing over all layers at once; the
pair sum is an einsum over a static pair->gas mapping.

tau_cia[w, l] = XFAC[l] * sum_pairs k_pair(w, T_l, f_l) * q1[l] * q2[l]
with XFAC = (TOTAM cm-2)^2 / (DELH cm)  [molec^2 cm^-5].

The analytic CO2-CO2 / N2-N2 / N2-H2 band add-ons (CIA_0.py:631,710,775) are
applied when those gases are present.
"""

from functools import lru_cache

import numpy as np
import torch

from archnemesis_tpu_torch.core.spectra import CIATables
from archnemesis_tpu_torch.enums import WaveUnit
from archnemesis_tpu_torch.utils.datafiles import data_file
from archnemesis_tpu_torch.utils.interp import (
    interp,
    interp1d_extrap_with_weights,
)

AMAGAT = 2.68675e19  # molecule cm-3 (CIA_0.py:703)


@lru_cache(maxsize=1)
def _band_tables():
    with np.load(data_file("assets", "cia_bands.npz")) as d:
        return {k: d[k] for k in d.files}


def analytic_cia_curves(waven, prescale: float = 1.0):
    """Wavenumber-only k curves [cm5 molecule-2] for the analytic NIR CIA
    bands (reference CIA_0.py co2cia:631, n2n2cia:710, n2h2cia:775),
    each (NWAVE,) in the dtype of ``waven``: (k_co2, k_n2n2, k_n2h2).

    prescale multiplies the tables on the host in float64 before they
    become tensors: the raw ~1e-45 cm5 values are subnormal in float32.
    """
    t = _band_tables()

    def tab(key):
        xp = torch.as_tensor(t[key + "_knots"], dtype=waven.dtype,
                             device=waven.device)
        fp = torch.as_tensor(t[key + "_k"] * prescale, dtype=waven.dtype,
                             device=waven.device)
        return interp(waven, xp, fp, left=0.0, right=0.0)

    k_co2 = tab("co2")
    wavel = 1.0e4 / waven
    for lo, hi, a in (
        (1.70, 1.76, 6.0e-9),
        (1.25, 1.35, 1.5e-9),
        (1.125, 1.225, 0.5 * (0.31 + 0.79) * 1e-9),
        (1.06, 1.125, 0.5 * (0.29 + 0.67) * 1e-9),
    ):
        k_co2 = torch.where(
            (wavel >= lo) & (wavel <= hi), a / AMAGAT**2 * prescale, k_co2
        )
    return k_co2, tab("n2n2"), tab("n2h2")


def _bracket_clamped(grid, x):
    hi = torch.searchsorted(grid, x.contiguous(), right=False)
    hi = hi.clamp(1, grid.shape[0] - 1)
    lo = hi - 1
    f = ((x - grid[lo]) / (grid[hi] - grid[lo])).clamp(0.0, 1.0)
    return lo, hi, f


def cia_tau(
    cia: CIATables,
    wavec,
    temp_lay,
    frac_lay,
    q_lay,
    totam,
    delh,
    pair_q1_idx,
    pair_q2_idx,
    pair_active,
    ispace=WaveUnit.Wavenumber_cm,
    ico2: int = -1,
    in2: int = -1,
    ih2: int = -1,
):
    """CIA optical depth (NWAVE, NLAY).

    Parameters
    ----------
    wavec : (NWAVE,) calculation grid (cm-1 or um per ispace)
    temp_lay, frac_lay : (NLAY,) layer temperature / para-H2 fraction
    q_lay : (NLAY, NVMR) layer volume mixing ratios (PP/PRESS)
    totam : (NLAY,) layer column density [m-2]
    delh : (NLAY,) layer thickness [m]
    pair_q1_idx, pair_q2_idx : static (NPAIR,) indices into q_lay columns
        for each CIA pair's two gases (0 for inactive pairs)
    pair_active : static (NPAIR,) 0/1 mask
    ico2, in2, ih2 : static atmosphere columns of CO2/N2/H2 (-1 = absent);
        enable the analytic NIR band add-ons (ForwardModel_0.py:4752-4770)
    """
    dev = wavec.device
    if ispace == WaveUnit.Wavenumber_cm:
        waven = wavec
    else:
        waven = torch.sort(1.0e4 / wavec).values

    # --- temperature / para-H2 interpolation of the table, per layer
    itl, ithi, ut = _bracket_clamped(cia.temp, temp_lay)  # (NLAY,)
    k = cia.k_cia  # (NPAIR, NPARA1, NT, NWAVE_CIA)
    if cia.npara == 0:
        # NPARA=0: the para-fraction blend acts on identical slices, so it
        # reduces to plain T interpolation
        ktlo = k[:, 0, itl, :]  # (NPAIR, NLAY, NWAVE_CIA)
        kthi = k[:, 0, ithi, :]
        kt = ktlo * (1 - ut[None, :, None]) + kthi * ut[None, :, None]
    else:
        ipl, iphi, uf = _bracket_clamped(cia.frac, frac_lay)
        k_t_lo = k[:, :, itl, :]  # (NPAIR, NPARA, NLAY, NWAVE_CIA)
        k_t_hi = k[:, :, ithi, :]
        kT = (k_t_lo * (1 - ut[None, None, :, None])
              + k_t_hi * ut[None, None, :, None])
        lay = torch.arange(temp_lay.shape[0], device=dev)
        klo = kT[:, ipl, lay, :]
        khi = kT[:, iphi, lay, :]
        kt = klo * (1 - uf[None, :, None]) + khi * uf[None, :, None]

    # --- interpolate to calculation wavenumbers (zero outside table range)
    j, f = interp1d_extrap_with_weights(cia.waven, waven)
    in_range = (waven >= cia.waven[0]) & (waven <= cia.waven[-1])
    k_w = kt[..., j - 1] * (1 - f) + kt[..., j] * f  # (NPAIR, NLAY, NWAVE)
    k_w = torch.where(in_range[None, None, :], k_w, 0.0)

    # --- pair mixing-ratio products
    q1 = q_lay[:, torch.as_tensor(pair_q1_idx, dtype=torch.long, device=dev)]
    q2 = q_lay[:, torch.as_tensor(pair_q2_idx, dtype=torch.long, device=dev)]
    active = torch.as_tensor(pair_active, dtype=q_lay.dtype, device=dev)
    qq = (q1 * q2) * active[None, :]  # (NLAY, NPAIR)

    sum_pairs = torch.einsum("plw,lp->wl", k_w, qq)

    # XFAC = (TOTAM cm-2)^2 / (DELH cm): TOTAM^2 ~ 1e50 overflows float32
    # and k_cia ~ 1e-45 underflows it. Balance with an exact power-of-2
    # scale (2^134, sqrt = 2^67): bit-identical in float64, in range in
    # float32. The table may already carry part of the factor (cia.k_scale,
    # set by CIATables.prescale(), required for float32 decks); apply only
    # the residual, in 2^67 steps alternated between the two factors so no
    # constant exceeds the float32 range.
    scale = 2.0**134
    half_scale = 2.0**67
    residual = scale / cia.k_scale
    totam_cm2 = totam * 1.0e-4
    xlen_cm = delh * 1.0e2
    xfac_scaled = (totam_cm2 / half_scale) ** 2 / xlen_cm
    steps = []
    while residual > 1.0:
        step = min(residual, half_scale)
        steps.append(step)
        residual /= step
    xfac_pairs = xfac_scaled  # band add-ons below must not see the steps
    for i, step in enumerate(steps):
        if i % 2 == 0:
            sum_pairs = sum_pairs * step
        else:
            xfac_pairs = xfac_pairs * step
    tau = sum_pairs * xfac_pairs[None, :]

    # --- analytic NIR band add-ons (T-independent); curves enter
    # pre-scaled by 2**134 so they survive float32
    if ico2 >= 0 or in2 >= 0:
        k_co2, k_n2n2, k_n2h2 = analytic_cia_curves(waven, prescale=scale)
        band = 0.0
        if ico2 >= 0:
            band = band + k_co2[:, None] * (q_lay[:, ico2] ** 2)[None, :]
        if in2 >= 0:
            band = band + k_n2n2[:, None] * (q_lay[:, in2] ** 2)[None, :]
        if in2 >= 0 and ih2 >= 0:
            band = band + k_n2h2[:, None] * (
                q_lay[:, in2] * q_lay[:, ih2]
            )[None, :]
        tau = tau + band * xfac_scaled[None, :]

    if ispace != WaveUnit.Wavenumber_cm:
        # undo the wavenumber sort back to the wavelength ordering
        tau = tau.flip(0)
    return tau
