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
    solflux=None,
    reflectance=None,
    sol_ang=None,
    emiss_ang=None,
    emission_path=None,
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
    solflux, reflectance : optional (NWAVE,) solar flux and surface
        reflectance; with both given, a visible surface adds the
        plane-parallel reflection of the attenuated solar beam
    sol_ang, emiss_ang : (NPATH,) solar and emission angles (degrees) of
        each path for that term, which is zero on a path where either is
        90 or more
    emission_path : optional (NWAVE, NLAYIN, NPATH) non-LTE emission of
        each path layer, weighted by the transmission after the layer
        (the JAX package's ``rt/emission.py:60-63``)

    Returns
    -------
    spec : (NWAVE, NG, NPATH)
    """
    tau_l = tau_path * mask[None, None, :, :]
    taud = torch.cumsum(tau_l, dim=2)
    tr = torch.exp(-taud)
    trold = torch.cat([torch.ones_like(tr[:, :, :1, :]), tr[:, :, :-1, :]],
                      dim=2)
    bb = planck(wave[:, None, None], emtemp[None, :, :], ispace)
    # T_{j-1} - T_j = T_{j-1} (1 - exp(-tau_j)), with expm1: the plain
    # difference of two transmissions near 1 loses every layer with
    # tau < 6e-8 in float32, and with it the whole temperature Jacobian of
    # the levels above the weighting functions
    dtr = trold * (-torch.expm1(-tau_l))
    spec = torch.einsum("wgjp,wjp->wgp", dtr, bb * mask[None, :, :])
    if emission_path is not None:
        spec = spec + torch.einsum("wgjp,wjp->wgp", tr,
                                   emission_path * mask[None, :, :])

    if surface_visible:
        tr_tot = tr[:, :, -1, :]  # transmission after full path
        if gasgiant:
            radground = planck(wave[:, None], emtemp[-1, :][None, :], ispace)
        else:
            radground = (
                planck(wave, tsurf, ispace)[:, None] * emissivity[:, None]
            )
        spec = spec + tr_tot * radground[:, None, :]

        if solflux is not None and reflectance is not None:
            # plane-parallel surface reflection (ForwardModel_0.py:
            # 6368-6374), active only where both angles are < 90; off those
            # paths the cosines are replaced before the division, so the
            # term (and its derivatives) stays finite where it is zeroed
            def angle(a):
                return torch.as_tensor(a, dtype=spec.dtype,
                                       device=spec.device)

            emiss_ang, sol_ang = angle(emiss_ang), angle(sol_ang)
            active = (emiss_ang < 90.0) & (sol_ang < 90.0)
            mu = torch.where(active, torch.cos(torch.deg2rad(emiss_ang)), 0.0)
            mu0 = torch.where(active, torch.cos(torch.deg2rad(sol_ang)), 1.0)
            refl = (tr_tot * torch.exp(-taud[:, :, -1, :] * mu / mu0)
                    * (solflux * reflectance)[:, None, None])
            spec = spec + refl * active.to(spec.dtype)
    return spec


def transmission_spectrum(tau_total_path):
    """Pure transmission: exp(-tau) (reference
    calculate_transmission_spectrum)."""
    return torch.exp(-tau_total_path)


def absorption_spectrum(tau_total_path):
    """1 - exp(-tau) (reference calculate_absorption_spectrum)."""
    return 1.0 - torch.exp(-tau_total_path)
