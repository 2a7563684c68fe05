"""Surface reflectance models: Lambert, Hapke (2012), Oren-Nayar (1994).

Port of the JAX package's ``rt/surface.py`` (reference ``Surface_0`` BRDF
machinery, Surface_0.py: calc_BRDF:916, calc_Hapke_BRDFx:1334,
calc_OrenNayar_BRDFx:1777, E/nu/H helpers :1633-1735): broadcasting
expressions over (NWAVE,) spectral parameters x (NTHETA,) angles, with
``torch.where`` for the angle-ordering branches, so they differentiate for
surface-parameter retrievals.
"""

from __future__ import annotations

import numpy as np
import torch

from archnemesis_tpu_torch.utils.interp import interp


def hg_phase2(theta_deg, g1, g2, f):
    """Double Henyey-Greenstein phase function, 4pi-normalised (reference
    calc_Hapke_hgphase Surface_0.py:1715 / Scatter calc_hgphase without the
    1/4pi)."""
    c = torch.cos(torch.deg2rad(theta_deg))
    t1 = (1.0 - g1**2) / (1.0 - 2.0 * g1 * c + g1**2) ** 1.5
    t2 = (1.0 - g2**2) / (1.0 - 2.0 * g2 * c + g2**2) ** 1.5
    return f * t1 + (1.0 - f) * t2


def lambert_brdf(albedo, ntheta: int):
    """(NWAVE,) albedo -> (NWAVE, NTHETA) BRDF = A/pi (reference
    calc_BRDF Lambertian branch :941-948)."""
    return (albedo[:, None] / np.pi).expand(albedo.shape[0], ntheta)


def _tan_nonzero(x):
    return torch.tan(torch.where(x == 0.0, 1.0, x))


def _hapke_e1(x_deg, theta_bar_deg):
    tb = torch.deg2rad(theta_bar_deg)
    x = torch.deg2rad(x_deg)
    val = torch.exp(-2.0 / np.pi / torch.tan(tb) / _tan_nonzero(x))
    return torch.where((theta_bar_deg == 0.0) | (x_deg == 0.0), 0.0, val)


def _hapke_e2(x_deg, theta_bar_deg):
    tb = torch.deg2rad(theta_bar_deg)
    x = torch.deg2rad(x_deg)
    val = torch.exp(-1.0 / np.pi / torch.tan(tb) ** 2 / _tan_nonzero(x) ** 2)
    return torch.where((theta_bar_deg == 0.0) | (x_deg == 0.0), 0.0, val)


def _hapke_h(w, x, r0):
    """Ambartsumian-Chandrasekhar H function (Surface_0.py:1449)."""
    return 1.0 / (
        1.0 - w * x * (r0 + (1.0 - 2.0 * r0 * x) / 2.0
                       * torch.log((1.0 + x) / x))
    )


def hapke_brdf(w, k, bs0, hs, bc0, hc, roughness, g1, g2, f,
               sol_ang, emiss_ang, azi_ang):
    """Hapke (2012, ch. 12.3.1) BRDF (reference calc_Hapke_BRDFx
    Surface_0.py:1334-1445).

    Spectral params: (NWAVE,) tensors; angles (deg): (NTHETA,) tensors.
    Returns (NWAVE, NTHETA). The NEMESIS azimuth convention (phi=0 forward
    scattering) is converted internally.
    """
    w, k, bs0, hs, bc0, hc, roughness, g1, g2, f = (
        p[:, None] for p in (w, k, bs0, hs, bc0, hc, roughness, g1, g2, f))
    i = sol_ang[None, :]
    e = emiss_ang[None, :]
    phi = 180.0 - azi_ang[None, :]
    phix = torch.where(phi > 180.0, 360.0 - phi, torch.abs(phi))

    mu = torch.cos(torch.deg2rad(e))
    mu0 = torch.cos(torch.deg2rad(i))
    cg = torch.clamp(
        mu * mu0
        + torch.sqrt(1.0 - mu**2) * torch.sqrt(1.0 - mu0**2)
        * torch.cos(torch.deg2rad(phix)),
        0.0, 1.0,
    )
    g = torch.rad2deg(torch.arccos(cg))

    gamma = torch.sqrt(1.0 - w)
    r0 = (1.0 - gamma) / (1.0 + gamma)
    theta_bar = roughness * (1.0 - r0)
    chi = 1.0 / torch.sqrt(
        1.0 + np.pi * torch.tan(torch.deg2rad(theta_bar)) ** 2)
    fphi = torch.where(
        torch.abs(phix) == 180.0,
        0.0,
        torch.exp(-2.0 * torch.abs(torch.tan(torch.deg2rad(phix) / 2.0))),
    )

    e1e = _hapke_e1(e, theta_bar)
    e2e = _hapke_e2(e, theta_bar)
    e1i = _hapke_e1(i, theta_bar)
    e2i = _hapke_e2(i, theta_bar)

    tbrad = torch.deg2rad(theta_bar)
    xr_e = torch.deg2rad(e)
    xr_i = torch.deg2rad(i)
    phirad = torch.deg2rad(phix)

    nue = chi * (
        torch.cos(xr_e)
        + torch.sin(xr_e) * torch.tan(tbrad) * e2e / (2.0 - e1e)
    )
    nui = chi * (
        torch.cos(xr_i)
        + torch.sin(xr_i) * torch.tan(tbrad) * e2i / (2.0 - e1i)
    )

    s2 = torch.sin(phirad / 2.0) ** 2
    # i <= e branch
    den_le = 2.0 - e1e - phirad / np.pi * e1i
    mu0eff_le = chi * (
        torch.cos(xr_i) + torch.sin(xr_i) * torch.tan(tbrad)
        * (torch.cos(phirad) * e2e + s2 * e2i) / den_le
    )
    mueff_le = chi * (
        torch.cos(xr_e) + torch.sin(xr_e) * torch.tan(tbrad)
        * (e2e - s2 * e2i) / den_le
    )
    # i > e branch
    den_gt = 2.0 - e1i - phirad / np.pi * e1e
    mu0eff_gt = chi * (
        torch.cos(xr_i) + torch.sin(xr_i) * torch.tan(tbrad)
        * (e2i - s2 * e2e) / den_gt
    )
    mueff_gt = chi * (
        torch.cos(xr_e) + torch.sin(xr_e) * torch.tan(tbrad)
        * (torch.cos(phirad) * e2i + s2 * e2e) / den_gt
    )
    le = i <= e
    mu0eff = torch.where(le, mu0eff_le, mu0eff_gt)
    mueff = torch.where(le, mueff_le, mueff_gt)

    s_le = mueff / nue * mu0 / nui * chi / (
        1.0 - fphi + fphi * chi * mu0 / nui)
    s_gt = mueff / nue * mu0 / nui * chi / (
        1.0 - fphi + fphi * chi * mu / nue)
    s = torch.where(le, s_le, s_gt)

    tg2 = torch.tan(torch.deg2rad(g) / 2.0)
    bs = bs0 / (1.0 + (1.0 / hs) * tg2)
    bc = bc0 / (1.0 + (1.3 + k) * (tg2 / hc + (tg2 / hc) ** 2))

    h0e = _hapke_h(w, mu0eff / k, r0)
    he = _hapke_h(w, mueff / k, r0)

    phase = hg_phase2(g, g1, g2, f)

    r = (
        k * w / (4.0 * np.pi) * mu0eff / (mu0eff + mueff)
        * (phase * (1.0 + bs) + (h0e * he - 1.0)) * (1.0 + bc) * s
    )
    brdf = r / mu0
    return torch.where((e >= 90.0) | (i >= 90.0), 0.0, brdf)


def oren_nayar_brdf(albedo, roughness, sol_ang, emiss_ang, azi_ang):
    """Oren & Nayar (1994) rough-Lambert BRDF (reference
    calc_OrenNayar_BRDFx Surface_0.py:1777-1824). (NWAVE,) x (NTHETA,) ->
    (NWAVE, NTHETA)."""
    a = albedo[:, None]
    sigma = torch.deg2rad(roughness)[:, None]
    irad = torch.deg2rad(sol_ang)[None, :]
    erad = torch.deg2rad(emiss_ang)[None, :]
    phirad = torch.deg2rad(azi_ang)[None, :]

    alpha = torch.maximum(irad, erad)
    beta = torch.minimum(irad, erad)
    cphi = torch.cos(phirad)

    c1 = 1.0 - 0.5 * sigma**2 / (sigma**2 + 0.33)
    c2 = 0.45 * sigma**2 / (sigma**2 + 0.09)
    c2 = c2 * torch.where(
        cphi >= 0, torch.sin(alpha),
        torch.sin(alpha) - (2.0 * beta / np.pi) ** 3
    )
    c3 = (
        0.125 * sigma**2 / (sigma**2 + 0.09)
        * (4.0 * alpha * beta / np.pi**2) ** 2
    )
    brdf1 = a / np.pi * (
        c1
        + cphi * c2 * torch.tan(beta)
        + (1.0 - torch.abs(cphi)) * c3 * torch.tan((alpha + beta) / 2.0)
    )
    brdf2 = (
        0.17 * a**2 / np.pi * sigma**2 / (sigma**2 + 0.13)
        * (1.0 - cphi * (2.0 * beta / np.pi) ** 2)
    )
    return brdf1 + brdf2


def surface_brdf_fn(surf, wave):
    """Closure ``fn(sol_ang, emiss_ang, azi_ang) -> (NWAVE, NTHETA)`` for a
    SurfaceSpec at the calc wave grid: the reference Surface_0.calc_BRDF
    dispatch (Surface_0.py:916: Lambert :941, Hapke :949, Oren-Nayar :969),
    with the parameter spectra interpolated to ``wave`` up front. The
    angles (degrees) may be host arrays or tensors: they are put on
    ``wave``'s device in its type.

    Feed to ``rt.scattering.brdf_fourier_matrix`` for the doubling method,
    or call directly with one geometry for single scattering.
    """

    def angles(*a):
        return tuple(torch.as_tensor(x, dtype=wave.dtype,
                                     device=wave.device).reshape(-1)
                     for x in a)

    lowbc = int(surf.lowbc)
    if lowbc == 1:  # Lambertian (calc_albedo: GALB<0 -> 1-emissivity)
        emis = interp(wave, surf.vem, surf.emissivity)
        albedo = torch.where(surf.galb >= 0.0, surf.galb * torch.ones_like(wave),
                             1.0 - emis)

        def fn(sol_ang, emiss_ang, azi_ang):
            return lambert_brdf(albedo, angles(emiss_ang)[0].numel())

        return fn
    if lowbc == 2:  # Hapke
        h = surf.hapke
        if h is None:
            raise ValueError("LOWBC=2 (Hapke) needs SurfaceSpec.hapke "
                             "(.hap file or HDF5 Surface Hapke block)")
        p = [interp(wave, h.vem, getattr(h, name))
             for name in ("sglalb", "k", "bs0", "hs", "bc0", "hc",
                          "roughness", "g1", "g2", "f")]

        def fn(sol_ang, emiss_ang, azi_ang):
            return hapke_brdf(*p, *angles(sol_ang, emiss_ang, azi_ang))

        return fn
    if lowbc == 3:  # Oren-Nayar
        if surf.on_albedo is None:
            raise ValueError("LOWBC=3 (Oren-Nayar) needs SurfaceSpec."
                             "on_albedo/on_roughness")
        alb = interp(wave, surf.vem, surf.on_albedo)
        rough = interp(wave, surf.vem, surf.on_roughness)

        def fn(sol_ang, emiss_ang, azi_ang):
            return oren_nayar_brdf(alb, rough,
                                   *angles(sol_ang, emiss_ang, azi_ang))

        return fn
    raise ValueError(f"no BRDF for LOWBC={lowbc}")
