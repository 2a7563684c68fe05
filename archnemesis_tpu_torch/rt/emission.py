"""Thermal-emission radiative transfer along line-of-sight paths.

Port of the JAX package's ``rt/emission.py`` (reference
``ForwardModel_0.py:6288`` calc_thermal_emission_spectrum): the running
transmission is a cumulative sum over the path axis, one
cumsum+exp+weighted-reduction over the (wave, g, layer, path) block.

spec = sum_j (T_{j-1} - T_j) * B(T_emission_j) + T_N * radground
with T_j = exp(-cumsum(tau)_j) along the path (observer -> far end).
"""

import torch

from archnemesis_tpu_torch.ops.planck import planck


def thermal_emission_spectrum(
    wave,
    tau_path,
    emtemp,
    mask,
    tsurf,
    emissivity,
    surface_visible: bool,
    gasgiant: bool,
    ispace=0,
):
    """Thermal-emission spectra for all paths at once.

    Parameters
    ----------
    wave : (NWAVE,)
    tau_path : (NWAVE, NG, NLAYIN, NPATH) LOS optical depth per layer
    emtemp : (NLAYIN, NPATH) emission temperatures along each path
    mask : (NLAYIN, NPATH) 1 where the layer participates
    tsurf : scalar surface temperature (<=0 -> bottom-layer Planck)
    emissivity : (NWAVE,) surface emissivity on the calc grid
    surface_visible : False for limb paths (no ground term)
    gasgiant : True -> radground = Planck(bottom layer T)

    Returns
    -------
    spec : (NWAVE, NG, NPATH)
    """
    taud = torch.cumsum(tau_path * mask[None, None, :, :], dim=2)
    tr = torch.exp(-taud)
    trold = torch.cat([torch.ones_like(tr[:, :, :1, :]), tr[:, :, :-1, :]],
                      dim=2)
    bb = planck(wave[:, None, None], emtemp[None, :, :], ispace)
    spec = torch.einsum("wgjp,wjp->wgp", trold - tr, bb * mask[None, :, :])

    if surface_visible:
        tr_tot = tr[:, :, -1, :]  # transmission after full path
        if gasgiant:
            radground = planck(wave[:, None], emtemp[-1, :][None, :], ispace)
        else:
            radground = (
                planck(wave, tsurf, ispace)[:, None] * emissivity[:, None]
            )
        spec = spec + tr_tot * radground[:, None, :]
    return spec


def transmission_spectrum(tau_total_path):
    """Pure transmission: exp(-tau) (reference
    calculate_transmission_spectrum)."""
    return torch.exp(-tau_total_path)


def absorption_spectrum(tau_total_path):
    """1 - exp(-tau) (reference calculate_absorption_spectrum)."""
    return 1.0 - torch.exp(-tau_total_path)
