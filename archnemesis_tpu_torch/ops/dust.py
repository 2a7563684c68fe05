"""Aerosol (dust) extinction/scattering optical depth per layer.

Port of the JAX package's ``ops/dust.py`` (reference ``calc_tau_dust``
ForwardModel_0.py:4790): interpolate the per-population extinction and
scattering cross sections to the calculation grid (linear for <=2-point
tables, not-a-knot cubic spline otherwise) and multiply by the layer dust
column densities.
"""

import torch

from archnemesis_tpu_torch.utils.interp import interp1d_extrap


def _cubic_spline_eval(xs, ys, xq):
    """Not-a-knot cubic spline (scipy.interpolate.CubicSpline defaults),
    solved densely on the (n x n) system for c (second derivatives / 2).
    The system is assembled in a fixed number of tensor operations, however
    many points the table has. ys may have trailing dims."""
    n = xs.shape[0]
    h = xs[1:] - xs[:-1]
    a = torch.zeros((n, n), dtype=xs.dtype, device=xs.device)
    rows = torch.arange(1, n - 1, device=xs.device)
    a[rows, rows - 1] = h[:-1]
    a[rows, rows] = 2.0 * (h[:-1] + h[1:])
    a[rows, rows + 1] = h[1:]
    hr = h.reshape((-1,) + (1,) * (ys.ndim - 1))
    inner = 3.0 * (
        (ys[2:] - ys[1:-1]) / hr[1:] - (ys[1:-1] - ys[:-2]) / hr[:-1]
    )
    edge = torch.zeros_like(ys[:1])
    rhs = torch.cat([edge, inner, edge])
    # not-a-knot end conditions
    a[0, 0] = h[1]
    a[0, 1] = -(h[0] + h[1])
    a[0, 2] = h[0]
    a[n - 1, n - 3] = h[-1]
    a[n - 1, n - 2] = -(h[-2] + h[-1])
    a[n - 1, n - 1] = h[-2]
    c = torch.linalg.solve(a, rhs.reshape(n, -1)).reshape(rhs.shape)

    hb = h.reshape((-1,) + (1,) * (ys.ndim - 1))
    b = (ys[1:] - ys[:-1]) / hb - hb * (2.0 * c[:-1] + c[1:]) / 3.0
    d = (c[1:] - c[:-1]) / (3.0 * hb)

    j = torch.searchsorted(xs, xq.contiguous(), right=True) - 1
    j = j.clamp(0, n - 2)
    dx = (xq - xs[j]).reshape((-1,) + (1,) * (ys.ndim - 1))
    return ys[j] + b[j] * dx + c[j] * dx**2 + d[j] * dx**3


def dust_tau(xsc_wave, kext, ksca, wavec, cont):
    """Aerosol optical depths.

    Parameters
    ----------
    xsc_wave : (NWX,) cross-section wave grid
    kext, ksca : (NWX, NDUST) cross sections [cm^2 particle^-1]
    wavec : (NWAVE,) calculation grid
    cont : (NLAY, NDUST) dust column densities [particles m^-2]

    Returns
    -------
    taudust : (NWAVE, NLAY) extinction optical depth (summed over dust)
    tauscat : (NWAVE, NLAY) scattering optical depth
    tauclscat : (NWAVE, NLAY, NDUST) per-population scattering
    """
    if xsc_wave.shape[0] > 2:
        kext_c = _cubic_spline_eval(xsc_wave, kext, wavec)
        ksca_c = _cubic_spline_eval(xsc_wave, ksca, wavec)
    else:
        kext_c = interp1d_extrap(xsc_wave, kext, wavec)
        ksca_c = interp1d_extrap(xsc_wave, ksca, wavec)

    sq_cm_to_sq_m = 1.0e-4
    taudust_i = kext_c[:, None, :] * sq_cm_to_sq_m * cont[None, :, :]
    tauclscat = ksca_c[:, None, :] * sq_cm_to_sq_m * cont[None, :, :]
    taudust_i = torch.nan_to_num(taudust_i).clamp(0.0, 1e20)
    return (
        torch.sum(taudust_i, dim=2),
        torch.sum(tauclscat, dim=2),
        tauclscat,
    )
