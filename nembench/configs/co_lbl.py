"""co_lbl: line-by-line synthesis at run time (ILBL = 1), float32.

The program's side builds the port's ``LineList`` from the benchmark's
copy of the line file (``io/linedata.read_ans_linedata``), tiles it as
``tile`` does, wraps it in a ``RuntimeLBL`` windowed to the lines' range
and calls ``forward.forward_nadir``; the reference's side reads the same
file with ``nembench.reference.lbl`` and recomputes every step.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from nembench.harness import traffic
from nembench.reference import lbl, nadir

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiles(spec) -> dict:
    pr, n = spec["profile"], spec["nlevel"]
    h = np.linspace(0.0, pr["h_top_m"], n)
    return dict(
        h=h, p=pr["p_bottom_pa"] * np.exp(-h / pr["p_scale_height_m"]),
        t=pr["t_bottom"] - pr["t_drop"] * h / pr["h_top_m"],
        vmr=np.tile(np.asarray(pr["vmr"], np.float64), (n, 1)))


def wave_grid(spec) -> np.ndarray:
    return (spec["wave_start"]
            + spec["wave_step"] * np.arange(spec["nwave"], dtype=np.float64))


def tile_order(nu, copies: int, spread: float, seed: int):
    """(centres, order) of the tiled list: ``copies`` copies each shifted by
    one uniform draw in [-spread, spread] from ``default_rng(seed)``; the
    order sorts them by centre."""
    rng = np.random.default_rng(seed)
    tiled = np.concatenate([nu + rng.uniform(-spread, spread)
                            for _ in range(copies)])
    return tiled, np.argsort(tiled)


class Program:
    """The port on this configuration (see ``jupiter_ck.Program``)."""

    def __init__(self, spec, seed: int, device):
        from archnemesis_tpu_torch.core.spectra import SurfaceSpec
        from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
        from archnemesis_tpu_torch.enums import (
            RayleighScatteringMode,
            WaveUnit,
        )
        from archnemesis_tpu_torch.forward import (
            forward_nadir,
            make_forward_config,
        )
        from archnemesis_tpu_torch.io.linedata import (
            RuntimeLBL,
            read_ans_linedata,
        )

        self._forward_nadir = forward_nadir
        dtype = getattr(torch, spec["dtype"])
        pr, prof, ln = spec["profile"], profiles(spec), spec["lines"]
        ll = read_ans_linedata(os.path.join(HERE, ln["file"]), ln["gas_id"],
                               ln["iso_id"], ambient=ln["ambient"])
        nu, order = tile_order(ll.nu, ln["copies"], ln["spread"],
                               ln["tile_seed"])

        def rep(a):
            return np.concatenate([a] * ln["copies"], axis=-1)[..., order]

        ll = dataclasses.replace(
            ll, nu=nu[order], sw=rep(ll.sw) / ln["copies"],
            elower=rep(ll.elower), stim_ref=rep(ll.stim_ref),
            broad=rep(ll.broad))
        self.rt = RuntimeLBL(
            wave=wave_grid(spec), gas_id=(ln["gas_id"],),
            iso_id=(ln["iso_id"],), line_lists=(ll,),
            lineshape=(ln["lineshape"],), wn_calc_window=(ln["wn_calc"],),
            wn_approx_window=(ln["wn_approx"],), s_floor=(ln["s_floor"],),
            include_pressure_shift=(ln["pressure_shift"],),
            include_continuum=(False,),
        ).windowed(ln["window_min"], ln["window_max"])

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
                                  nint=spec["nint"], layht=0.0)
        self.surf = SurfaceSpec(tsurf=dev(0.0), vem=dev([0.0, 1e5]),
                                emissivity=dev(np.zeros(2)), galb=dev(0.0),
                                gasgiant=True)
        self.cfg = make_forward_config(
            self.atm, self.rt, None, iray=RayleighScatteringMode.NOT_INCLUDED,
            ispace=WaveUnit.Wavenumber_cm, gasgiant=True)
        self.scaled = list(spec["scaled_gases"])
        self.dtype, self.device = dtype, device

    def forward(self, t, mult):
        full = traffic.vmr_multiplier(mult, self.scaled, self.atm.vmr.shape[1])
        atm = dataclasses.replace(self.atm, t=t, vmr=self.atm.vmr * full)
        spec = self._forward_nadir(atm, self.laycfg, self.rt, None, None,
                                   self.surf, self.cfg, emiss_ang=0.0,
                                   device=self.device)
        return spec[:, 0]


class Reference:
    """The plain reference on this configuration (see
    ``jupiter_ck.Reference``)."""

    def __init__(self, spec, seed: int, device, dtype=torch.float64):
        self.spec, self.device, self.dtype = spec, device, dtype
        ln, prof = spec["lines"], profiles(spec)
        lines = lbl.read_lines(os.path.join(HERE, ln["file"]), ln["prefix"],
                               ln["ambient"], ln["mass_g_mol"])
        lines = lbl.tile(lines, ln["copies"], ln["spread"], ln["tile_seed"])
        self.lines = lbl.select(lines, ln["window_min"], ln["window_max"])
        self.wave = wave_grid(spec)

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=device
                                   ).to(dtype)

        self.h, self.p, self.vmr = dev(prof["h"]), dev(prof["p"]), dev(prof["vmr"])
        self.scaled = list(spec["scaled_gases"])
        # atmosphere columns of the line gas: its own share of the
        # broadening (ForwardModel_0.py:3819-3848)
        self.self_cols = [i for i, g in enumerate(spec["gas_id"])
                          if g == ln["gas_id"]]
        self.line_col = spec["gas_id"].index(ln["gas_id"])

    def layers(self, t, mult):
        full = traffic.vmr_multiplier(mult.to(self.dtype), self.scaled,
                                      self.vmr.shape[1])
        return nadir.layers(self.h, self.p, t.to(self.dtype), self.vmr * full,
                            self.spec["nlay"], self.spec["nint"], 0.0)

    def ambient(self, press, pp):
        """(NLAY,) ambient fraction of the line gas's broadening: one less
        the layer-mean VMR of its own columns."""
        self_frac = (pp / press[:, None]).mean(0)[self.self_cols].sum()
        return (1.0 - self_frac).expand(press.shape[0])

    def line_parameters(self, t, mult):
        """The lines' (strength, alpha_d, gamma_l, shift) in the layers."""
        press, temp, _, _, pp = self.layers(t, mult)
        return lbl.line_parameters(self.lines, temp, press / nadir.ATM_PA,
                                   self.ambient(press, pp))

    def forward(self, t, mult, wave_idx):
        press, temp, _, amount, pp = self.layers(t, mult)
        ln = self.spec["lines"]
        k = lbl.cross_section(self.lines, self.wave[wave_idx], temp,
                              press / nadir.ATM_PA, self.ambient(press, pp),
                              ln["wn_calc"], ln["wn_approx"])
        tau = (k * (amount[:, self.line_col] * nadir.SQ_CM_PER_SQ_M)[None, :])
        wave = torch.as_tensor(self.wave[wave_idx], device=self.device
                               ).to(self.dtype)
        return nadir.emission(wave, tau[:, None, :], temp,
                              torch.ones(1, dtype=self.dtype,
                                         device=self.device))
