"""Atmosphere physics: molecular weight, gravity, hydrostatic balancing, VMR
renormalisation.

Port of the JAX package's ``rt/atmosphere.py`` (reference ``Atmosphere_0``
methods: calc_molwt :768, calc_grav :858, adjust_hydrostatH :1027,
adjust_hydrostatP :930, adjust_VMR :703): the per-level loops are cumulative
sums anchored at a reference level. The hydrostatic convergence loop runs on
the host and reads one scalar per iteration (the primal of the depth change,
which all tangents share under ``torch.func.jacfwd``), so it iterates
exactly as often as the JAX ``lax.while_loop`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from archnemesis_tpu_torch.constants import G_GRAV, R_GAS
from archnemesis_tpu_torch.core.types import Atmosphere
from archnemesis_tpu_torch.utils import datafiles
from archnemesis_tpu_torch.utils.host import host_values


def gas_molwt_per_column(gas_id, iso_id) -> np.ndarray:
    """Static per-gas molar masses (g/mol): terrestrial-abundance mean for
    iso 0, isotope mass otherwise (reference calc_molwt Atmosphere_0.py:768)."""
    out = np.zeros(len(gas_id))
    for i, (g, s) in enumerate(zip(gas_id, iso_id)):
        out[i] = datafiles.molecular_weight(int(g), int(s))
    return out


def calc_molwt(vmr, gas_masses):
    """Mean molecular weight profile (kg/mol). vmr: (NP, NVMR) tensor."""
    gm = torch.as_tensor(np.asarray(gas_masses), dtype=vmr.dtype,
                         device=vmr.device)
    vmrtot = torch.sum(vmr, dim=1)
    molwt = torch.sum(vmr * gm[None, :], dim=1) / vmrtot
    return molwt / 1000.0


# Legendre polynomials P1..P6 (closed form; reference uses scipy legendre)
def _legendre_all(x):
    p1 = x
    p2 = 0.5 * (3 * x**2 - 1)
    p3 = 0.5 * (5 * x**3 - 3 * x)
    p4 = 0.125 * (35 * x**4 - 30 * x**2 + 3)
    p5 = 0.125 * (63 * x**5 - 70 * x**3 + 15 * x)
    p6 = 0.0625 * (231 * x**6 - 315 * x**4 + 105 * x**2 - 5)
    return [p1, p2, p3, p4, p5, p6]


def calc_grav(h, latitude, planet: int, radius_override=None):
    """Gravity profile (m/s^2) and planetocentric radius (m) following
    Lindal et al. 1986 (reference calc_grav Atmosphere_0.py:858).

    h: (NP,) tensor in metres; latitude in degrees (planetographic; 0-d
    tensor or float). planet is the static NEMESIS planet id used to look
    up mass/rotation/flattening/J coeffs. radius_override (m, tensor)
    replaces the catalogue equatorial radius (retrieved-radius models).
    """
    info = datafiles.planet_info()[str(int(planet))]
    mass, rotation = info["mass"], info["rotation"]
    flatten, jcoeff = info["flatten"], info["Jcoeff"]
    radius_km = info["radius"]
    if radius_override is not None:
        radius_km = radius_override / 1.0e3

    xgm = mass * G_GRAV * 1.0e6
    xomega = 2.0 * np.pi / (rotation * 24.0 * 3600.0)
    xellip = 1.0 / (1.0 - flatten)
    xcoeff = np.array([jcoeff[0] / 1e3, jcoeff[1] / 1e6, jcoeff[2] / 1e8])
    xradius = radius_km * 1.0e5  # cm

    lat = torch.deg2rad(torch.as_tensor(latitude, dtype=h.dtype,
                                        device=h.device))
    latc = torch.arctan(torch.tan(lat) / xellip**2)
    slatc, clatc = torch.sin(latc), torch.cos(latc)
    rr = torch.sqrt(clatc**2 + xellip**2 * slatc**2)
    r = (xradius + h * 1.0e2) / rr  # cm
    radius_m = (xradius / rr) * 1.0e-5 * 1.0e3

    pol = _legendre_all(slatc)

    g = 1.0
    for i in range(3):
        ix = i + 1
        g = g - (2 * ix + 1) * rr ** (2 * ix) * xcoeff[ix - 1] * pol[2 * ix - 1]
    gradial = g * xgm / r**2 - r * xomega**2 * clatc**2

    gtheta1 = 0.0
    for i in range(3):
        ix = i + 1
        gtheta1 = gtheta1 - (
            4.0 * ix**2 * rr ** (2 * ix) * xcoeff[ix - 1]
            * (pol[2 * ix - 2] - slatc * pol[2 * ix - 1]) / clatc
        )
    gtheta = gtheta1 * xgm / r**2 + r * xomega**2 * clatc * slatc

    gtot = torch.sqrt(gradial**2 + gtheta**2) * 0.01  # m/s^2
    return gtot, radius_m


def _hydrostat_h_once(h, p, t, molwt, latitude, planet, ialt: int,
                      radius_override=None):
    grav, _ = calc_grav(h, latitude, planet, radius_override)
    scale = R_GAS * t / (molwt * grav)  # m
    n = h.shape[0]
    # sh between consecutive levels
    sh = 0.5 * (scale[:-1] + scale[1:])
    dlogp = torch.log(p[1:] / p[:-1])
    step = -sh * dlogp  # h[i+1] - h[i]
    # anchor at level ialt with value h[ialt] (0 if interior, reference
    # :1062-1063 forces the anchor to 0 when 0<ialt<NP-1)
    anchor = 0.0 if 0 < ialt < n - 1 else h[ialt]
    cum = torch.cat([h.new_zeros(1), torch.cumsum(step, dim=0)])
    return anchor + cum - cum[ialt]


def adjust_hydrostat_h(atm: Atmosphere, ialt: int | None = None) -> Atmosphere:
    """Iteratively rebalance heights hydrostatically (reference
    adjust_hydrostatH Atmosphere_0.py:1027): repeat until the total
    atmospheric depth changes by < 1 %.

    The stopping test reads the depth change on the host (one
    device-to-host copy per iteration, two or three iterations in
    practice); the anchor level is read once from the input heights, which
    the loop keeps at that level. Under ``vmap`` over states the loop runs
    until every row has stopped, each row frozen once it has, as the JAX
    package's batched ``while_loop`` does; the rows must share the anchor
    level.
    """
    if ialt is None:
        levels = host_values(torch.argmin(torch.abs(atm.h)))
        ialt = int(levels.reshape(-1)[0])
        if not bool((levels == ialt).all()):
            raise ValueError("adjust_hydrostat_h: batched states anchor at "
                             f"different levels {sorted(set(levels.tolist()))}")
    planet_radius = getattr(atm, "planet_radius", None)

    h = atm.h
    xdepth = torch.full_like(h[0], 100.0)
    while bool(host_values(xdepth > 1.0).any()):
        active = xdepth > 1.0
        atdepth = h[-1] - h[0]
        h_new = _hydrostat_h_once(h, atm.p, atm.t, atm.molwt, atm.latitude,
                                  atm.planet, ialt, planet_radius)
        atdepth1 = h_new[-1] - h_new[0]
        xdepth = torch.where(
            active, 100.0 * torch.abs((atdepth1 - atdepth) / atdepth), xdepth)
        h = torch.where(active, h_new, h)
    _, radius = calc_grav(h, atm.latitude, atm.planet, planet_radius)
    return atm.replace(h=h, radius=radius)


def adjust_hydrostat_p(atm: Atmosphere, htan, ptan,
                       ialt: int | None = None) -> Atmosphere:
    """Rescale pressures hydrostatically so p(htan) = ptan (reference
    adjust_hydrostatP Atmosphere_0.py:930)."""
    h = atm.h
    htan = torch.as_tensor(htan, dtype=h.dtype, device=h.device)
    ptan = torch.as_tensor(ptan, dtype=h.dtype, device=h.device)
    if ialt is None:
        i = int(torch.argmin(torch.abs(h - htan)))
        ialt = i - int(bool(h[i] > htan) and i > 0)

    grav, _ = calc_grav(h, atm.latitude, atm.planet,
                        getattr(atm, "planet_radius", None))
    scale = R_GAS * atm.t / (atm.molwt * grav)

    sh_tan = 0.5 * (scale[ialt] + scale[ialt + 1])
    p_ialt = ptan * torch.exp(-(h[ialt] - htan) / sh_tan)

    sh = 0.5 * (scale[:-1] + scale[1:])
    dh = h[1:] - h[:-1]
    step = -dh / sh  # log p[i+1] - log p[i]
    cum = torch.cat([h.new_zeros(1), torch.cumsum(step, dim=0)])
    logp = torch.log(p_ialt) + cum - cum[ialt]
    # level ialt+1 uses sh_tan from htan, not the generic step (reference
    # :966-969); rebuild it and propagate upward
    p_ialt1 = ptan * torch.exp(-(h[ialt + 1] - htan) / sh_tan)
    corr = torch.log(p_ialt1) - logp[ialt + 1]
    upper = torch.arange(h.shape[0], device=h.device) >= ialt + 1
    logp = torch.where(upper, logp + corr, logp)
    return atm.replace(p=torch.exp(logp))


def adjust_vmr(vmr, iscale):
    """Renormalise VMRs to sum to 1, scaling only gases with iscale=1
    (reference adjust_VMR Atmosphere_0.py:703; SVP capping not included:
    applied separately when a .vpf is present)."""
    iscale = np.asarray(iscale)
    scalable = torch.as_tensor(iscale == 1, dtype=vmr.dtype,
                               device=vmr.device)[None, :]
    sumtot = torch.sum(vmr, dim=1, keepdim=True)
    sum_fixed = torch.sum(vmr * (1 - scalable), dim=1, keepdim=True)
    xfac = (1.0 - sum_fixed) / (sumtot - sum_fixed)
    return torch.where(scalable > 0, vmr * xfac, vmr)


def apply_svp_cap(atm: Atmosphere) -> Atmosphere:
    """Cap gas VMRs at their saturation vapour pressure where a .vpf entry
    exists (reference adjust_VMR Atmosphere_0.py:753-765:
    svp = vp exp(a + b/T + c T + d T^2) [atm])."""
    if not atm.svp:
        return atm
    coeffs = datafiles.svp_coefficients()
    vmr = atm.vmr
    p_atm = atm.p / 101325.0
    for gas_id, iso_id, vp, _flag in atm.svp:
        col = None
        for i, (g, s) in enumerate(zip(atm.gas_id, atm.iso_id)):
            if g == gas_id and s == iso_id:
                col = i
                break
        if col is None:
            continue
        a, b, c, d = coeffs[str(int(gas_id))]
        svp = vp * torch.exp(a + b / atm.t + c * atm.t + d * atm.t**2)
        pp = vmr[:, col] * p_atm
        capped = torch.where(pp > svp, svp / p_atm, vmr[:, col])
        vmr = set_column(vmr, col, capped)
    return atm.replace(vmr=vmr)


def set_column(mat, col: int, values):
    """``mat`` (..., N, M) with column ``col`` replaced by ``values``
    (..., N), out of place (a dual or batched ``values`` cannot be written
    into a plain buffer)."""
    return torch.cat([mat[..., :col], values[..., None], mat[..., col + 1:]],
                     dim=-1)
