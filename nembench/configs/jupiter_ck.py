"""jupiter_ck: Jupiter thermal nadir on correlated-k tables, float32.

The program's side builds the port's structures (``Atmosphere``,
``LayerConfig``, ``KTables`` with its float32 log table, ``SurfaceSpec``,
``ForwardConfig``) and calls ``forward.forward_nadir``; the reference's
side recomputes the same spectrum from the same numbers with
``nembench.reference``. The k-table is made on the device from the seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nembench.harness import traffic
from nembench.reference import ktables, nadir


def profiles(spec) -> dict:
    """Heights [m], pressures [Pa], temperatures [K] and VMRs of the levels,
    float64 numpy."""
    pr, n = spec["profile"], spec["nlevel"]
    h = np.linspace(pr["h_bottom_m"], pr["h_top_m"], n)
    depth = h - h[0]
    return dict(
        h=h,
        p=pr["p_bottom_pa"] * np.exp(-depth / pr["p_scale_height_m"]),
        t=pr["t_top"] + pr["t_excess"] * np.exp(-depth / pr["t_scale_height_m"]),
        vmr=np.tile(np.asarray(pr["vmr"], np.float64), (n, 1)),
    )


def grids(spec) -> dict:
    """Wave, g and (p, T) grids of the tables, float64 numpy."""
    kt = spec["ktable"]
    x, w = np.polynomial.legendre.leggauss(spec["ng"])
    return dict(
        wave=np.linspace(spec["wave_min"], spec["wave_max"], spec["nwave"]),
        g_ord=0.5 * (x + 1.0), del_g=0.5 * w,
        press=np.logspace(np.log10(kt["press_min_atm"]),
                          np.log10(kt["press_max_atm"]), kt["npress"]),
        temp=np.linspace(kt["temp_min"], kt["temp_max"], kt["ntemp"]),
    )


def band_centres(spec, seed: int) -> np.ndarray:
    kt = spec["ktable"]
    return np.random.default_rng(seed).uniform(kt["band_min"], kt["band_max"],
                                               kt["nband"])


def ktable(spec, seed: int, wave_idx, device, dtype=torch.float64):
    """(NGAS, len(wave_idx), NG, NP, NT) k [cm2] at the waves ``wave_idx``
    of the grid, made on ``device`` in float64 and returned in ``dtype``
    (the same table for every gas)."""
    kt, g = spec["ktable"], grids(spec)

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    wave = t64(g["wave"][wave_idx])
    centres = t64(band_centres(spec, seed))
    band = kt["floor"] + torch.exp(
        -0.5 * ((wave[:, None] - centres[None, :]) / kt["band_width"]) ** 2
    ).sum(1)
    k = (kt["scale"] * band[:, None, None, None]
         * torch.exp(kt["g_slope"] * (t64(g["g_ord"]) - kt["g_mid"]))[
             None, :, None, None]
         * (t64(g["press"]) / kt["press_max_atm"])[None, None, :, None]
         ** kt["p_exponent"]
         * (t64(g["temp"]) / kt["t_ref"])[None, None, None, :]
         ** kt["t_exponent"])
    return k.to(dtype)[None].expand(len(spec["gas_id"]), -1, -1, -1, -1)


class Program:
    """The port on this configuration: ``forward(t, mult)`` is one
    ``forward_nadir`` call on the levels' temperatures ``t`` (NLEVEL,) and
    the multipliers ``mult`` (NLEVEL, NSCALED) of the scaled gases' VMRs,
    returning the (NWAVE,) spectrum on the device."""

    def __init__(self, spec, seed: int, device):
        from archnemesis_tpu_torch.core.spectra import KTables, SurfaceSpec
        from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
        from archnemesis_tpu_torch.enums import (
            RayleighScatteringMode,
            WaveUnit,
        )
        from archnemesis_tpu_torch.forward import (
            forward_nadir,
            make_forward_config,
        )

        self._forward_nadir = forward_nadir
        dtype = getattr(torch, spec["dtype"])
        pr, prof, g = spec["profile"], profiles(spec), grids(spec)

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=device
                                   ).to(dtype)

        self.atm = Atmosphere(
            h=dev(prof["h"]), p=dev(prof["p"]), t=dev(prof["t"]),
            vmr=dev(prof["vmr"]), dust=dev(np.zeros((spec["nlevel"], 0))),
            parah2=dev(np.zeros(spec["nlevel"])),
            molwt=dev(np.full(spec["nlevel"], pr["molwt_kg"])),
            radius=dev(pr["radius_m"]), latitude=dev(pr["latitude"]),
            gas_id=tuple(spec["gas_id"]), iso_id=tuple(spec["iso_id"]),
            planet=spec["planet"])
        self.laycfg = LayerConfig(nlay=spec["nlay"], laytyp=1, layint=1,
                                  nint=spec["nint"], layht=float(prof["h"][0]))
        k64 = ktable(spec, seed, slice(None), device)[0]
        # the float32 path reads the table's logs, taken in float64
        # (ops/ktab.py:host_log_ktable: -1e9 where k <= 0)
        tiny = torch.finfo(torch.float32).tiny
        logk = torch.where(k64 > 0, torch.log(k64.clamp_min(tiny)), -1.0e9)
        ngas = len(spec["gas_id"])
        self.ktab = KTables(
            wave=dev(g["wave"]), g_ord=dev(g["g_ord"]), del_g=dev(g["del_g"]),
            press=dev(g["press"]), temp=dev(g["temp"]),
            k=k64.to(dtype)[None].repeat(ngas, 1, 1, 1, 1),
            logk=(logk.to(torch.float32)[None].repeat(ngas, 1, 1, 1, 1)
                  if dtype != torch.float64 else None),
            gas_id=tuple(spec["gas_id"]), iso_id=tuple(spec["iso_id"]))
        del k64, logk
        self.surf = SurfaceSpec(tsurf=dev(0.0), vem=dev([0.0, 1e5]),
                                emissivity=dev(np.zeros(2)), galb=dev(0.0),
                                gasgiant=True)
        self.cfg = make_forward_config(
            self.atm, self.ktab, None,
            iray=RayleighScatteringMode.GAS_GIANT_ATM,
            ispace=WaveUnit.Wavenumber_cm, gasgiant=True)
        self.scaled = list(spec["scaled_gases"])
        self.dtype, self.device = dtype, device

    def forward(self, t, mult):
        full = traffic.vmr_multiplier(mult, self.scaled, self.atm.vmr.shape[1])
        atm = dataclasses.replace(self.atm, t=t, vmr=self.atm.vmr * full)
        spec = self._forward_nadir(atm, self.laycfg, self.ktab, None, None,
                                   self.surf, self.cfg, emiss_ang=0.0,
                                   device=self.device)
        return spec[:, 0]


class Reference:
    """The plain reference on this configuration, on ``device`` in
    ``dtype``: ``forward(t, mult, wave_idx)`` is the spectrum at the waves
    ``wave_idx`` (a host integer array) of the grid."""

    def __init__(self, spec, seed: int, device, dtype=torch.float64):
        self.spec, self.seed, self.device, self.dtype = spec, seed, device, dtype
        prof, g = profiles(spec), grids(spec)

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=device
                                   ).to(dtype)

        self.h, self.p, self.vmr = dev(prof["h"]), dev(prof["p"]), dev(prof["vmr"])
        self.layht = float(prof["h"][0])
        self.g = g
        self.del_g, self.press, self.temp = (dev(g["del_g"]), dev(g["press"]),
                                             dev(g["temp"]))
        self.scaled = list(spec["scaled_gases"])

    def layers(self, t, mult):
        full = traffic.vmr_multiplier(mult.to(self.dtype), self.scaled,
                                      self.vmr.shape[1])
        return nadir.layers(self.h, self.p, t.to(self.dtype), self.vmr * full,
                            self.spec["nlay"], self.spec["nint"],
                            self.layht)

    def forward(self, t, mult, wave_idx):
        press, temp, totam, amount, _ = self.layers(t, mult)
        k = ktable(self.spec, self.seed, wave_idx, self.device, self.dtype)
        k_lay = ktables.interpolate(k, self.press, self.temp,
                                    press / nadir.ATM_PA, temp)
        tau = ktables.mix(k_lay, amount.T * nadir.SQ_CM_PER_SQ_M,
                          self.g["del_g"])
        wave = torch.as_tensor(self.g["wave"][wave_idx],
                               device=self.device).to(self.dtype)
        tau = tau + nadir.rayleigh_gas_giant(wave, totam)[:, None, :]
        return nadir.emission(wave, tau, temp, self.del_g)
