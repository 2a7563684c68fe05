"""Atmosphere layering: split profiles into layers and average properties.

Port of the JAX package's ``rt/layer.py`` (reference ``Layer_0.py``:
layer_split:1402, layer_average:755): every layer integrates NINT samples
with static composite-Simpson weights, as one batched (NLAY, NINT)
computation.

All angles in degrees; LAYANG=0 for nadir splitting, 90 for limb.
"""

from __future__ import annotations

import numpy as np
import torch

from archnemesis_tpu_torch.constants import AVOGAD
from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig, Layers
from archnemesis_tpu_torch.enums import LayerIntegrationScheme, LayerType
from archnemesis_tpu_torch.utils.interp import (
    interp1d_extrap,
    linspace,
    simpson_weights,
)

# The reference layer_average uses a locally rounded Boltzmann constant
# (Layer_0.py:829 ``k_B = 1.38065e-23``); mirror it for exact golden parity.
K_B = 1.38065e-23


def _scalar(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# Straight rays through a spherical atmosphere of radius ``radius`` that
# leave altitude ``base`` at zenith angle ``ang`` (radians), z0 = radius +
# base. The reference's forms (Layer_0.py:847-870, AtmCalc_0.py:380-400)
# subtract numbers of the planet's size, of which float32 keeps ~8 m on
# Jupiter: every profile interpolated along the path moves by that much,
# and a cloud a few km thick loses 3e-3 of its Jacobian. Here no two
# numbers of the planet's size are subtracted, at any angle up to 90
# degrees: the root's argument r^2 - (z0 sin)^2 is the product (r - z0 sin)
# (r + z0 sin) with r - z0 sin = (alt - base) + z0 (1 - sin), and the root
# minus z0 cos is (r^2 - z0^2) / (root + z0 cos) = (alt - base) (r + z0) /
# (root + z0 cos). The angle's complement pi/2 - ang is taken against
# deg2rad(90) in the run's type, so that at 90 degrees (given in degrees)
# cos = sin(complement) and 1 - sin = 2 sin^2(complement / 2) are exactly
# 0 and the length at the tangent point is exactly 0. At nadir the lengths
# are alt - base and the altitudes base + s, to the bit.


def _ray_terms(base, radius, ang):
    """z0, cos ang, 1 - sin ang and the impact parameter z0 sin ang."""
    z0 = radius + base
    # no Python number meets z0: under torch.func a 0-d tensor with a
    # tangent and a Python float promote to float64
    comp = torch.deg2rad(torch.full_like(ang, 90.0)) - ang
    return (z0, torch.sin(comp), 2.0 * torch.sin(0.5 * comp) ** 2,
            z0 * torch.sin(ang))


def _ray_root(alt, base, radius, ang):
    """(under, sqrt(under) where under > 0 else 1, r, z0, cos): under =
    (radius + alt)^2 - (z0 sin)^2 in product form."""
    z0, cos, one_minus_sin, impact = _ray_terms(base, radius, ang)
    r = radius + alt
    under = ((alt - base) + z0 * one_minus_sin) * (r + impact)
    root = torch.sqrt(torch.where(under > 0, under, torch.ones_like(under)))
    return under, root, r, z0, cos


def ray_length(alt, base, radius, ang):
    """Length along the ray from ``base`` up to altitude ``alt``:
    sqrt((radius + alt)^2 - (z0 sin)^2) - z0 cos, with the root taken as 0
    below the ray's tangent point."""
    under, root, r, z0, cos = _ray_root(alt, base, radius, ang)
    # root - z0 cos as a quotient while cos >= 0 (the two terms are alike
    # near the ray's start); beyond 90 degrees they add
    den = root + z0 * cos
    quot = (alt - base) * (r + z0) / torch.where(den > 0, den,
                                                 torch.ones_like(den))
    length = torch.where(cos >= 0, quot, root - z0 * cos)
    length = torch.where(under > 0, length, -z0 * cos)
    return torch.where(ang == 0, alt - base, length)


def ray_segment(alt0, alt1, base, radius, ang):
    """ray_length(alt1) - ray_length(alt0) without the difference of two
    lengths (each up to thousands of km on a limb path): the difference of
    the roots is (r1^2 - r0^2) / (root1 + root0) = (alt1 - alt0) (r1 + r0)
    / (root1 + root0) wherever neither altitude lies below the tangent
    point. The difference itself at nadir (exact there) and below the
    tangent point."""
    diff = (ray_length(alt1, base, radius, ang)
            - ray_length(alt0, base, radius, ang))
    under0, root0, r0, _, _ = _ray_root(alt0, base, radius, ang)
    under1, root1, r1, _, _ = _ray_root(alt1, base, radius, ang)
    root0 = torch.where(under0 > 0, root0, torch.zeros_like(root0))
    root1 = torch.where(under1 > 0, root1, torch.zeros_like(root1))
    den = root1 + root0
    ok = (under0 >= 0) & (under1 >= 0) & (den > 0)
    quot = (alt1 - alt0) * (r1 + r0) / torch.where(ok, den,
                                                   torch.ones_like(den))
    return torch.where((ang == 0) | ~ok, diff, quot)


def ray_altitude(s, base, radius, ang):
    """Altitude at length ``s`` along the ray: sqrt(s^2 + z0^2 + 2 s z0
    cos) - radius, written base + x / (sqrt(z0^2 + x) + z0) with x = s (s +
    2 z0 cos)."""
    z0, cos, _, _ = _ray_terms(base, radius, ang)
    x = s * (s + z0 * (2.0 * cos))
    alt = base + x / (torch.sqrt(z0 * z0 + x) + z0)
    return torch.where(ang == 0, base + s, alt)


def split_layers(atm: Atmosphere, cfg: LayerConfig, layang=0.0,
                 layht_override=None):
    """Layer base altitudes/pressures for the configured scheme (reference
    ``layer_split`` Layer_0.py:1402). Returns (baseh (NLAY,), basep (NLAY,)).
    ``layht_override`` (metres) replaces cfg.layht."""
    h, p = atm.h, atm.p
    nlay = cfg.nlay
    # reference resets LAYHT to H(0) when below the profile base
    base = cfg.layht if layht_override is None else layht_override
    layht = torch.maximum(_scalar(base, h), h[0])

    if cfg.laytyp == LayerType.EQUAL_PRESSURE:
        pbot = interp1d_extrap(h, p, layht)
        basep = linspace(pbot, p[-1], nlay + 1)[:-1]
        baseh = interp1d_extrap(p.flip(0), h.flip(0), basep)
    elif cfg.laytyp == LayerType.EQUAL_LOG_PRESSURE:
        pbot = interp1d_extrap(h, p, layht)
        basep = torch.exp(
            linspace(torch.log(pbot), torch.log(p[-1]), nlay + 1)[:-1]
        )
        baseh = interp1d_extrap(p.flip(0), h.flip(0), basep)
    elif cfg.laytyp == LayerType.EQUAL_HEIGHT:
        baseh = linspace(layht, h[-1], nlay + 1)[:-1]
        basep = interp1d_extrap(h, p, baseh)
    elif cfg.laytyp == LayerType.EQUAL_PATH_LENGTH:
        ang = torch.deg2rad(_scalar(layang, h))
        smax = ray_length(h[-1], layht, atm.radius, ang)
        bases = linspace(_scalar(0.0, h), smax, nlay + 1)[:-1]
        baseh = ray_altitude(bases, layht, atm.radius, ang)
        basep = torch.exp(interp1d_extrap(h, torch.log(p), baseh))
    elif cfg.laytyp == LayerType.BASE_PRESSURE:
        basep = _scalar(np.asarray(cfg.p_base), h)
        baseh = interp1d_extrap(p.flip(0), h.flip(0), basep)
    elif cfg.laytyp == LayerType.BASE_HEIGHT:
        baseh = _scalar(np.asarray(cfg.h_base), h)
        basep = torch.exp(interp1d_extrap(h, torch.log(p), baseh))
    else:
        raise ValueError(f"unknown layer type {cfg.laytyp}")
    return baseh, basep


def average_layers(atm: Atmosphere, cfg: LayerConfig, baseh, basep,
                   layang=0.0):
    """Curtis-Godson absorber-weighted (or mid-path) layer averages
    (reference ``layer_average`` Layer_0.py:755). The topmost layer extends
    to the top of the profile."""
    h, p, t = atm.h, atm.p, atm.t
    vmr, dust, parah2 = atm.vmr, atm.dust, atm.parah2
    radius = atm.radius
    nlay = cfg.nlay
    nint = cfg.nint

    delh = torch.cat([baseh[1:] - baseh[:-1], (h[-1] - baseh[-1])[None]])

    ang = torch.deg2rad(_scalar(layang, h))
    # slant geometry is anchored at the base of the lowest layer
    smax = ray_length(h[-1], baseh[0], radius, ang)
    bases = ray_length(baseh, baseh[0], radius, ang)
    # each layer's path length without the difference of two lengths
    # (equal to bases[i + 1] - bases[i] at nadir, to the bit)
    dels = ray_segment(baseh, torch.cat([baseh[1:], h[-1:]]), baseh[0],
                       radius, ang)
    laysf = dels / delh
    baset = interp1d_extrap(h, t, baseh)

    # molecular-weight profile only feeds dust in particles-per-gram units
    xmolwt = atm.molwt * 1000.0  # kg/mol -> g/mol as in reference :879

    if cfg.layint == LayerIntegrationScheme.ABSORBER_WEIGHTED_AVERAGE:
        # (NLAY, NINT) path-length samples in each layer
        frac_lin = _scalar(np.linspace(0.0, 1.0, nint), h)
        s = bases[:, None] + dels[:, None] * frac_lin[None, :]
        hgt = ray_altitude(s, baseh[0], radius, ang)

        p_s = interp1d_extrap(h, p, hgt)
        t_s = interp1d_extrap(h, t, hgt)
        fr_s = interp1d_extrap(h, parah2, hgt)
        mw_s = interp1d_extrap(h, xmolwt, hgt)
        # (p/t) * (1/K_B): keeps every intermediate in float32 range
        duds = (p_s / t_s) * (1.0 / K_B)  # molecules m^-3

        w = _scalar(simpson_weights(nint), h)
        ds = dels / (nint - 1)  # per-layer sample spacing

        # 2^-97-scaled number density (exact power of two: float64 results
        # are bit-identical) keeps the TOTAM divisor O(1)
        duds_scale = 2.0**97
        duds_s = duds * (2.0**-97)

        def integ_s(y):
            # scaled path integral per layer: (NLAY, NINT) -> (NLAY,)
            return torch.sum(y * w[None, :], dim=1) * ds

        totam_s = integ_s(duds_s)
        totam = totam_s * duds_scale
        height = integ_s(hgt * duds_s) / totam_s
        press = integ_s(p_s * duds_s) / totam_s
        temp = integ_s(t_s * duds_s) / totam_s
        frac = integ_s(fr_s * duds_s) / totam_s

        vmr_s = interp1d_extrap(h, vmr, hgt.reshape(-1)).reshape(
            nlay, nint, -1
        )
        amount = (
            torch.einsum("lik,i->lk", vmr_s * duds_s[:, :, None], w)
            * ds[:, None]
            * duds_scale
        )
        pp = (
            torch.einsum("lik,i->lk", vmr_s * (p_s * duds_s)[:, :, None], w)
            * ds[:, None]
            / totam_s[:, None]
        )

        if atm.ndust > 0:
            dust_s = interp1d_extrap(h, dust, hgt.reshape(-1)).reshape(
                nlay, nint, -1
            )
            if atm.dust_units_flag is not None:
                cont_cols = []
                for j in range(atm.ndust):
                    if atm.dust_units_flag[j] == -1:
                        # particles per gram of atmosphere (reference :997)
                        cont_j = torch.einsum(
                            "li,i->l",
                            dust_s[:, :, j] * duds * mw_s / AVOGAD,
                            w,
                        ) * ds
                    else:
                        cont_j = torch.einsum("li,i->l", dust_s[:, :, j], w) * ds
                    cont_cols.append(cont_j)
                cont = torch.stack(cont_cols, dim=1)
            else:
                cont = torch.einsum("lik,i->lk", dust_s, w) * ds[:, None]
        else:
            cont = h.new_zeros((nlay, 0))

    elif cfg.layint == LayerIntegrationScheme.MID_PATH:
        s_upper = torch.cat([bases[1:], smax[None]])
        s_mid = 0.5 * (bases + s_upper)
        height = ray_altitude(s_mid, baseh[0], radius, ang)
        press = interp1d_extrap(h, p, height)
        temp = interp1d_extrap(h, t, height)
        frac = interp1d_extrap(h, parah2, height)
        mw_l = interp1d_extrap(h, xmolwt, height)
        duds = (press / temp) * (1.0 / K_B)
        totam = duds * dels
        vmr_l = interp1d_extrap(h, vmr, height)
        pp = vmr_l * press[:, None]
        amount = vmr_l * totam[:, None]
        if atm.ndust > 0:
            dust_l = interp1d_extrap(h, dust, height)
            if atm.dust_units_flag is not None:
                cont_cols = []
                for j in range(atm.ndust):
                    if atm.dust_units_flag[j] == -1:
                        cont_j = dust_l[:, j] * totam * mw_l / AVOGAD
                    else:
                        cont_j = dust_l[:, j] * dels
                    cont_cols.append(cont_j)
                cont = torch.stack(cont_cols, dim=1)
            else:
                cont = dust_l * dels[:, None]
        else:
            cont = h.new_zeros((nlay, 0))
    else:
        raise ValueError(f"unknown layer integration scheme {cfg.layint}")

    # scale slant columns back to vertical (reference :1012-1025)
    totam = totam / laysf
    amount = amount / laysf[:, None]
    cont = cont / laysf[:, None] if atm.ndust > 0 else cont

    return Layers(
        baseh=baseh,
        basep=basep,
        baset=baset,
        delh=delh,
        height=height,
        press=press,
        temp=temp,
        totam=totam,
        amount=amount,
        pp=pp,
        cont=cont,
        frac=frac,
        laysf=laysf,
    )


def build_layers(atm: Atmosphere, cfg: LayerConfig, layang=0.0,
                 layht_override=None) -> Layers:
    """split + average in one call (reference ``calc_layering``
    Layer_0.py:386)."""
    baseh, basep = split_layers(atm, cfg, layang, layht_override)
    return average_layers(atm, cfg, baseh, basep, layang)
