"""Nadir thermal emission of a layered atmosphere (archNEMESIS semantics).

The layering of ``Layer_0.layer_split``/``layer_average`` at nadir (equal
log-pressure bases, Curtis-Godson averages by composite Simpson over NINT
samples of each layer), the nadir path from the top layer down, thermal
emission with a gas-giant lower boundary (Planck of the bottom layer), the
gas-giant Rayleigh of Allen (1976) and the g-integration, in plain tensor
operations of the type of the inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ATM_PA = 101325.0
SQ_CM_PER_SQ_M = 1.0e-4
# NEMESIS's rounded constants (ForwardModel_0.py:6215, Layer_0.py:829)
PLANCK_C1 = 1.1911e-12
PLANCK_C2 = 1.439
K_B_LAYER = 1.38065e-23


def interp_extrap(xp, fp, x):
    """Linear interpolation of fp(xp) along axis 0 at x, extended linearly
    beyond both ends; xp strictly increasing."""
    j = torch.searchsorted(xp, x.reshape(-1).contiguous(), right=True)
    j = j.clamp(1, xp.shape[0] - 1).reshape(x.shape)
    f = (x - xp[j - 1]) / (xp[j] - xp[j - 1])
    if fp.ndim > 1:
        f = f.reshape(f.shape + (1,) * (fp.ndim - 1))
    return (1.0 - f) * fp[j - 1] + f * fp[j]


def simpson_weights(n: int) -> np.ndarray:
    """Composite Simpson weights for n evenly spaced samples of unit
    spacing (Simpson on n - 1 points plus a trapezoid when n is even)."""
    if n % 2 == 1:
        w = np.ones(n)
        w[1:-1:2], w[2:-1:2] = 4.0, 2.0
        return w / 3.0
    w = np.zeros(n)
    w[:n - 1] = simpson_weights(n - 1)
    w[-2:] += 0.5
    return w


def layers(h, p, t, vmr, nlay: int, nint: int, layht: float):
    """(press [Pa], temp, totam [m-2], amount (NLAY, NVMR) [m-2], pp [Pa])
    of ``nlay`` layers with equal log-pressure bases from ``layht`` (or
    the profile's base) to the top level, averaged along the vertical."""
    base = torch.maximum(h.new_tensor(layht), h[0])
    pbot = interp_extrap(h, p, base)
    frac = torch.arange(nlay, dtype=h.dtype, device=h.device) / nlay
    basep = torch.exp(torch.log(pbot) * (1 - frac) + torch.log(p[-1]) * frac)
    baseh = interp_extrap(p.flip(0), h.flip(0), basep)
    delh = torch.cat([baseh[1:] - baseh[:-1], (h[-1] - baseh[-1])[None]])
    s = torch.linspace(0.0, 1.0, nint, dtype=h.dtype, device=h.device)
    hgt = baseh[:, None] + delh[:, None] * s[None, :]  # (NLAY, NINT)
    p_s = interp_extrap(h, p, hgt)
    t_s = interp_extrap(h, t, hgt)
    vmr_s = interp_extrap(h, vmr, hgt.reshape(-1)).reshape(nlay, nint, -1)
    duds = (p_s / t_s) / K_B_LAYER  # molecules m-3
    w = h.new_tensor(simpson_weights(nint))
    ds = delh / (nint - 1)

    def integral(y):  # (NLAY, NINT, ...) -> (NLAY, ...)
        return torch.einsum("li...,i->l...", y, w) * ds.reshape(
            (-1,) + (1,) * (y.ndim - 2))

    totam = integral(duds)
    press = integral(p_s * duds) / totam
    temp = integral(t_s * duds) / totam
    amount = integral(vmr_s * duds[..., None])
    pp = integral(vmr_s * (p_s * duds)[..., None]) / totam[:, None]
    return press, temp, totam, amount, pp


def planck(wave, temp):
    """Radiance [W cm-2 sr-1 (cm-1)-1] at wavenumbers ``wave`` [cm-1]."""
    return PLANCK_C1 * wave**3 / (torch.exp(PLANCK_C2 * wave / temp) - 1.0)


def rayleigh_gas_giant(wave, totam):
    """(NWAVE, NLAY) Rayleigh optical depth of an H2/He atmosphere (Allen
    1976; ForwardModel_0.py:5546-5553), ``totam`` in m-2."""
    ah2, bh2, ahe, bhe, fh2 = 13.58e-5, 7.52e-3, 3.48e-5, 2.30e-3, 0.864
    lam = 1.0e-2 / wave  # m
    x = 1.0e-6 / lam  # 1 / lambda[um]
    n_air = (fh2 * ah2 * (1.0 + bh2 * x * x)
             + (1.0 - fh2) * ahe * (1.0 + bhe * x * x))
    n0 = 1.01325e5 / (1.37971e-23 * 273.15)
    xl = n0 * lam * lam
    k = (torch.sqrt(32.0 * math.pi**3 * n_air**2 / 3.0) / xl) ** 2  # m2
    return k[:, None] * totam[None, :]


def emission(wave, tau, temp, del_g):
    """Nadir spectrum (NWAVE,) at zero emission angle: ``tau`` (NWAVE, NG,
    NLAY) vertical optical depths with layer 0 at the bottom, ``temp``
    (NLAY,) layer temperatures; each layer emits at its own temperature
    and the ground at the bottom layer's (a gas giant)."""
    tau_top_down = tau.flip(-1)
    temp_top_down = temp.flip(0)
    trans = torch.exp(-torch.cumsum(tau_top_down, dim=-1))
    before = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                       dim=-1)
    b = planck(wave[:, None], temp_top_down[None, :])  # (NWAVE, NLAY)
    spec = torch.sum(before * (-torch.expm1(-tau_top_down)) * b[:, None, :],
                     dim=-1)
    spec = spec + trans[..., -1] * b[:, None, -1]
    return spec @ del_g
