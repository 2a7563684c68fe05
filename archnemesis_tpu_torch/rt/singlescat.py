"""Single-scattering plane-parallel RT.

Port of the JAX package's ``rt/singlescat.py`` (reference numba kernel
``calc_singlescatt_plane_spectrum`` ForwardModel_0.py:6509-6607 and its
caller ``calculate_single_scattering_plane_parallel_spectrum`` :4251): the
per-(wave, g) loops are a cumulative-transmission expression over the
path-layer axis.
"""

from __future__ import annotations

import numpy as np
import torch

from archnemesis_tpu_torch.ops.planck import planck


def scattering_cos_angle(sol_ang, emiss_ang, azi_ang):
    """cos(alpha) of the single-scattering angle (reference :4265-4266);
    angles in degrees, as tensors."""
    sol = torch.deg2rad(sol_ang)
    emi = torch.deg2rad(emiss_ang)
    azi = torch.deg2rad(azi_ang)
    return torch.sin(sol) * torch.sin(emi) * torch.cos(azi - np.pi) - (
        torch.cos(emi) * torch.cos(sol))


def layer_mean_phase(phase_modes, phase_ray, tauclscat, tauray, tauscat):
    """Scattering-weighted mean phase function per layer (reference
    :4317-4322).

    phase_modes: (NWAVE, NDUST) phase of each aerosol at the path's
    scattering angle; phase_ray: (NWAVE,); tauclscat: (NWAVE, NLAY, NDUST);
    tauray/tauscat: (NWAVE, NLAY). Returns (NWAVE, NLAY).
    """
    num = torch.einsum("wd,wld->wl", phase_modes, tauclscat)
    num = num + phase_ray[:, None] * tauray
    den = tauray + tauscat
    return torch.where(den > 0.0, num / torch.where(den > 0.0, den, 1.0), 0.0)


def single_scatter_plane_spectrum(
    wave,
    tau_layinc,     # (NWAVE, NG, NLAYIN) LOS optical depth per path layer
    emtemp,         # (NLAYIN,) layer temperatures along the path
    emomega,        # (NWAVE, NG, NLAYIN) single-scattering albedo
    emphase,        # (NWAVE, NLAYIN) mean phase function along the path
    mask,           # (NLAYIN,) 1.0 where the layer participates (host)
    tsurf,
    emissivity,     # (NWAVE,)
    brdf,           # (NWAVE,) surface BRDF at the path geometry
    solar,          # (NWAVE,)
    sol_ang,
    emiss_ang,
    ispace: int = 0,
):
    """One path's single-scatter spectrum (NWAVE, NG) (reference
    calc_singlescatt_plane_spectrum ForwardModel_0.py:6509).

    ``mask`` is static path geometry: the bottom of the path is read off it
    on the host. ``tsurf`` <= 0 puts the bottom layer's Planck function at
    the ground.
    """
    mask_np = np.asarray(mask, dtype=np.float64)
    mask = tau_layinc.new_tensor(mask_np)
    mu = np.cos(np.deg2rad(float(emiss_ang)))
    mu0 = np.cos(np.deg2rad(float(sol_ang)))
    ssfac = mu0 / (mu0 + mu)

    taud = torch.cumsum(tau_layinc * mask[None, None, :], dim=2)
    tr = torch.exp(-taud)  # (NWAVE, NG, NLAYIN)
    trold = torch.cat([torch.ones_like(tr[:, :, :1]), tr[:, :, :-1]], dim=2)
    dtr = (trold - tr) * mask[None, None, :]

    bb = planck(wave[:, None], emtemp[None, :], ispace=ispace)
    scat = ssfac * emomega * emphase[:, None, :] * solar[:, None, None] / (
        4.0 * np.pi
    )
    specg = torch.sum(dtr * (scat + bb[:, None, :]), dim=2)

    # transmission to the bottom of the path (last active layer)
    n_active = int(mask_np.sum())
    tr_bottom = tr[:, :, n_active - 1]  # (NWAVE, NG)

    t_bottom = emtemp[n_active - 1]
    tsurf = torch.as_tensor(tsurf, dtype=wave.dtype, device=wave.device)
    radground = torch.where(
        tsurf <= 0.0,
        planck(wave, t_bottom, ispace=ispace),
        planck(wave, tsurf, ispace=ispace) * emissivity,
    )  # (NWAVE,)
    specg = specg + tr_bottom * radground[:, None]
    specg = specg + tr_bottom * (solar * mu0 * brdf)[:, None]
    return specg
