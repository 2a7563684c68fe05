"""Correlated-k / LBL table interpolation to layer (P, T) points.

Port of the JAX package's ``ops/ktab.py`` (reference ``Spectroscopy_0.py:2147``
calc_kg): a searchsorted bracket over all layers at once and one
log-bilinear blend over the (gas, wave, g, layer) block.

Reference semantics preserved exactly:
- bilinear in (ln P, T) of ln k where all 4 surrounding table values are > 0;
- bilinear of raw k where all 4 are <= 0 (all-zero regions);
- zero where the 4 corners are mixed sign;
- out-of-range P/T clamp to the table edges (v,u in [0,1]).
"""

import numpy as np
import torch

LOG_POS_THRESH = -8.0e8  # sentinel cut: host logk stores -1e9 where k <= 0


def _bracket(grid, x):
    """Indices (lo, hi) and clamped fraction for linear interpolation with
    edge clamping (the reference's argmin-based bracketing)."""
    hi = torch.searchsorted(grid, x.contiguous(), right=False)
    hi = hi.clamp(1, grid.shape[0] - 1)
    lo = hi - 1
    f = (x - grid[lo]) / (grid[hi] - grid[lo])
    return lo, hi, f.clamp(0.0, 1.0)


def host_log_ktable(k64):
    """Host-side float64 log of a k-table for the float32 path (numpy in,
    float32 numpy out).

    The table is static, so its logs are taken once on the host in float64
    and stored: no float32 device ``log`` of table values is needed. k <= 0
    entries get a -1e9 sentinel (the positivity mask survives the encoding);
    0 < k < float32-tiny clamps to log(tiny).
    """
    k64 = np.asarray(k64, np.float64)
    tiny = float(np.finfo(np.float32).tiny)
    out = np.where(k64 > 0.0, np.log(np.maximum(k64, tiny)), -1.0e9)
    return out.astype(np.float32)


def interp_ktables(k, press_grid, temp_grid, press, temp, logk=None):
    """Interpolate k-tables to layer pressure/temperature points.

    Parameters
    ----------
    k : (NGAS, NWAVE, NG, NP, NT) table k-coefficients [cm^2]
    press_grid : (NP,) table pressures [atm]
    temp_grid : (NT,) table temperatures [K]
    press : (NLAY,) layer pressures [atm]
    temp : (NLAY,) layer temperatures [K]
    logk : optional (NGAS, NWAVE, NG, NP, NT) ``host_log_ktable`` values.
        When given, the corner gathers read the log table and no device
        ``log`` is evaluated; regions where all 4 corners are <= 0 then
        return exactly 0 instead of the raw bilinear value.

    Returns
    -------
    kgood : (NWAVE, NG, NLAY, NGAS) (a view of a gas-major tensor)
    """
    lgrid = torch.log(press_grid)
    ipl, iphi, v = _bracket(lgrid, torch.log(press))  # (NLAY,)
    itl, ithi, u = _bracket(temp_grid, temp)  # (NLAY,)

    w11 = (1.0 - v) * (1.0 - u)
    w21 = v * (1.0 - u)
    w22 = v * u
    w12 = (1.0 - v) * u

    if logk is not None:
        l11 = logk[:, :, :, ipl, itl]
        l12 = logk[:, :, :, ipl, ithi]
        l21 = logk[:, :, :, iphi, itl]
        l22 = logk[:, :, :, iphi, ithi]
        loglin = w11 * l11 + w21 * l21 + w22 * l22 + w12 * l12
        all_pos = (
            (l11 > LOG_POS_THRESH) & (l12 > LOG_POS_THRESH)
            & (l21 > LOG_POS_THRESH) & (l22 > LOG_POS_THRESH)
        )
        out = torch.where(all_pos, torch.exp(loglin), 0.0)
        return out.movedim(0, -1)

    # corner gathers -> (NGAS, NWAVE, NG, NLAY)
    klo1 = k[:, :, :, ipl, itl]
    klo2 = k[:, :, :, ipl, ithi]
    khi1 = k[:, :, :, iphi, itl]
    khi2 = k[:, :, :, iphi, ithi]

    tiny = torch.finfo(k.dtype).tiny
    loglin = (
        w11 * torch.log(klo1.clamp_min(tiny))
        + w21 * torch.log(khi1.clamp_min(tiny))
        + w22 * torch.log(khi2.clamp_min(tiny))
        + w12 * torch.log(klo2.clamp_min(tiny))
    )
    lin = w11 * klo1 + w21 * khi1 + w22 * khi2 + w12 * klo2

    all_pos = (klo1 > 0.0) & (klo2 > 0.0) & (khi1 > 0.0) & (khi2 > 0.0)
    all_nonpos = (
        (klo1 <= 0.0) & (klo2 <= 0.0) & (khi1 <= 0.0) & (khi2 <= 0.0)
    )
    out = torch.where(
        all_pos, torch.exp(loglin), torch.where(all_nonpos, lin, 0.0)
    )
    return out.movedim(0, -1)
