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
        sin, cos = torch.sin(ang), torch.cos(ang)
        z0 = atm.radius + layht
        zmax = atm.radius + h[-1]
        smax = torch.sqrt(zmax**2 - (z0 * sin) ** 2) - z0 * cos
        bases = linspace(_scalar(0.0, h), smax, nlay + 1)[:-1]
        baseh = (torch.sqrt(bases**2 + z0**2 + 2 * bases * z0 * cos)
                 - atm.radius)
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
    sin, cos = torch.sin(ang), torch.cos(ang)
    # slant geometry is anchored at the base of the lowest layer
    z0 = radius + baseh[0]
    zmax = radius + h[-1]
    smax = torch.sqrt(zmax**2 - (z0 * sin) ** 2) - z0 * cos
    bases = torch.sqrt((radius + baseh) ** 2 - (z0 * sin) ** 2) - z0 * cos
    dels = torch.cat([bases[1:] - bases[:-1], (smax - bases[-1])[None]])
    laysf = dels / delh
    baset = interp1d_extrap(h, t, baseh)

    # molecular-weight profile only feeds dust in particles-per-gram units
    xmolwt = atm.molwt * 1000.0  # kg/mol -> g/mol as in reference :879

    if cfg.layint == LayerIntegrationScheme.ABSORBER_WEIGHTED_AVERAGE:
        # (NLAY, NINT) path-length samples in each layer
        s_upper = torch.cat([bases[1:], smax[None]])
        frac_lin = _scalar(np.linspace(0.0, 1.0, nint), h)
        s = bases[:, None] + (s_upper - bases)[:, None] * frac_lin[None, :]
        hgt = torch.sqrt(s**2 + z0**2 + 2 * s * z0 * cos) - radius

        p_s = interp1d_extrap(h, p, hgt)
        t_s = interp1d_extrap(h, t, hgt)
        fr_s = interp1d_extrap(h, parah2, hgt)
        mw_s = interp1d_extrap(h, xmolwt, hgt)
        # (p/t) * (1/K_B): keeps every intermediate in float32 range
        duds = (p_s / t_s) * (1.0 / K_B)  # molecules m^-3

        w = _scalar(simpson_weights(nint), h)
        ds = (s_upper - bases) / (nint - 1)  # per-layer sample spacing

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
        height = torch.sqrt(s_mid**2 + z0**2 + 2 * s_mid * z0 * cos) - radius
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
