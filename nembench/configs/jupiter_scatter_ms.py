"""jupiter_scatter_ms: Jupiter's nadir spectrum of reflected sunlight at
0.8-1.0 um by multiple scattering (adding-doubling) on correlated-k
tables, float32.

The program's side builds the port's structures (``Atmosphere`` with two
dust modes, ``LayerConfig``, ``KTables`` with its float32 log table,
``AerosolOptics``, ``StellarSpec``, ``SurfaceSpec``, ``ForwardConfig``,
``ScatterQuadrature``) and calls ``forward.forward_scattering_nadir``;
the reference's side recomputes the same spectrum from the same numbers
with ``nembench.reference`` (the layering and the combined k of
``nadir`` and ``ktables``, the adding-doubling of ``scattering``). The
k-table is made on the device; the seed draws the states (the harness's
traffic), not the table.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from nembench.harness import traffic
from nembench.reference import ktables, nadir, scattering

AU_CM = 1.49598e13


def profiles(spec) -> dict:
    """Heights [m], pressures [Pa], temperatures [K], VMRs and dust
    [particles m-3] of the levels, float64 numpy."""
    pr, ae, n = spec["profile"], spec["aerosol"], spec["nlevel"]
    h = np.linspace(pr["h_bottom_m"], pr["h_top_m"], n)
    depth = h - h[0]
    bump = np.exp(-0.5 * ((np.linspace(0.0, 1.0, n) - ae["centre"])
                          / ae["width"]) ** 2)
    return dict(
        h=h,
        p=pr["p_bottom_pa"] * np.exp(-depth / pr["p_scale_height_m"]),
        t=pr["t_top"] + pr["t_excess"] * np.exp(-depth / pr["t_scale_height_m"]),
        vmr=np.tile(np.asarray(pr["vmr"], np.float64), (n, 1)),
        dust=np.stack([s * bump for s in ae["mode_scale"]], axis=1),
    )


def grids(spec) -> dict:
    """Wave, g and (p, T) grids of the tables, float64 numpy: the first
    ``nwave`` waves of the ``grid_nwave`` grid; the table's g-ordinates
    are the first ``ng`` of a ``table_ng``-point Gauss-Legendre rule, its
    weights the ``ng``-point rule's."""
    kt = spec["ktable"]
    x_table, _ = np.polynomial.legendre.leggauss(spec["table_ng"])
    x, w = np.polynomial.legendre.leggauss(spec["ng"])
    return dict(
        wave=np.linspace(spec["wave_min"], spec["wave_max"],
                         spec["grid_nwave"])[:spec["nwave"]],
        g_table=0.5 * (x_table[:spec["ng"]] + 1.0),
        g_ord=0.5 * (x + 1.0), del_g=0.5 * w,
        press=np.logspace(np.log10(kt["press_min_atm"]),
                          np.log10(kt["press_max_atm"]), kt["npress"]),
        temp=np.linspace(kt["temp_min"], kt["temp_max"], kt["ntemp"]),
    )


def ktable(spec, wave_idx, device, dtype=torch.float64):
    """(NGAS, len(wave_idx), NG, NP, NT) k [cm2] at the waves ``wave_idx``
    of the grid, made on ``device`` in float64 and returned in ``dtype``
    (the same table for every gas; its bands' centres drawn from the
    table's own ``band_seed``)."""
    kt, g = spec["ktable"], grids(spec)

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    wave = t64(g["wave"][wave_idx])
    centres = t64(np.random.default_rng(kt["band_seed"]).uniform(
        kt["band_min"], kt["band_max"], kt["nband"]))
    band = kt["floor"] + torch.exp(
        -0.5 * ((wave[:, None] - centres[None, :]) / kt["band_width"]) ** 2
    ).sum(1)
    k = (kt["scale"] * band[:, None, None, None]
         * torch.exp(kt["g_slope"] * (t64(g["g_table"]) - kt["g_mid"]))[
             None, :, None, None]
         * (t64(g["press"]) / kt["press_max_atm"])[None, None, :, None]
         ** kt["p_exponent"]
         * (t64(g["temp"]) / kt["t_ref"])[None, None, None, :]
         ** kt["t_exponent"])
    return k.to(dtype)[None].expand(len(spec["gas_id"]), -1, -1, -1, -1)


def aerosol_xsc(spec, wave):
    """(kext, ksca), each (NWAVE, NMODE) [cm2], at the waves ``wave``
    (float64 numpy or tensor of the grid's waves)."""
    ae = spec["aerosol"]
    rel = wave / spec["wave_min"]

    def modes(key):
        cols = [c * rel ** e for c, e in zip(ae[key], ae["exponent"])]
        return (torch.stack(cols, 1) if isinstance(wave, torch.Tensor)
                else np.stack(cols, 1))

    return modes("kext_cm2"), modes("ksca_cm2")


def solar_power(spec, wave):
    """The Sun's power spectrum [W (cm-1)-1] at the waves ``wave`` (a
    float64 tensor): a blackbody of ``t_eff_k`` over a sphere of
    ``radius_m``, 4 pi R^2 x pi B(nu, T)."""
    so = spec["solar"]
    radius_cm = 100.0 * so["radius_m"]
    return (4.0 * math.pi * radius_cm**2 * math.pi
            * nadir.planck(wave, wave.new_tensor(so["t_eff_k"])))


def quadrature(spec):
    """(mu, wtmu): the positive half of a 2 NMU-point Gauss-Legendre rule,
    ascending."""
    mu, wt = np.polynomial.legendre.leggauss(2 * spec["scattering"]["nmu"])
    return mu[mu > 0], wt[mu > 0]


class Program:
    """The port on this configuration: ``forward(t, mult)`` is one
    ``forward_scattering_nadir`` call on the levels' temperatures ``t``
    (NLEVEL,) and the multipliers ``mult`` (NLEVEL, NSCALED) of the scaled
    gases' VMRs, returning the (NWAVE,) spectrum on the device."""

    def __init__(self, spec, seed: int, device):
        from archnemesis_tpu_torch.core.spectra import (
            AerosolOptics,
            KTables,
            StellarSpec,
            SurfaceSpec,
        )
        from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
        from archnemesis_tpu_torch.enums import (
            RayleighScatteringMode,
            WaveUnit,
        )
        from archnemesis_tpu_torch.forward import (
            forward_scattering_nadir,
            make_forward_config,
        )
        from archnemesis_tpu_torch.rt.scattering import ScatterQuadrature

        self._forward = forward_scattering_nadir
        dtype = getattr(torch, spec["dtype"])
        pr, prof, g = spec["profile"], profiles(spec), grids(spec)
        ae, sc, so = spec["aerosol"], spec["scattering"], spec["solar"]
        nwave = spec["nwave"]

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=device
                                   ).to(dtype)

        self.atm = Atmosphere(
            h=dev(prof["h"]), p=dev(prof["p"]), t=dev(prof["t"]),
            vmr=dev(prof["vmr"]), dust=dev(prof["dust"]),
            parah2=dev(np.zeros(spec["nlevel"])),
            molwt=dev(np.full(spec["nlevel"], pr["molwt_kg"])),
            radius=dev(pr["radius_m"]), latitude=dev(pr["latitude"]),
            gas_id=tuple(spec["gas_id"]), iso_id=tuple(spec["iso_id"]),
            planet=spec["planet"])
        self.laycfg = LayerConfig(nlay=spec["nlay"], laytyp=1, layint=1,
                                  nint=spec["nint"], layht=float(prof["h"][0]))
        k64 = ktable(spec, slice(None), device)[0]
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
        kext, ksca = aerosol_xsc(spec, g["wave"])
        self.aero = AerosolOptics(wave=dev(g["wave"]), kext=dev(kext),
                                  ksca=dev(ksca))
        nmode = len(ae["mode_scale"])
        self.hgphase = (g["wave"], np.full((nwave, nmode), ae["hg_f"]),
                        np.full((nwave, nmode), ae["hg_g1"]),
                        np.full((nwave, nmode), ae["hg_g2"]))
        self.stellar = StellarSpec(
            wave=dev(g["wave"]),
            solspec=dev(solar_power(spec, torch.as_tensor(g["wave"]))),
            dist=dev(so["dist_au"]), radius=dev(so["radius_m"]),
            solexist=True, ispace=0)
        self.surf = SurfaceSpec(tsurf=dev(0.0), vem=dev([0.0, 1e5]),
                                emissivity=dev(np.zeros(2)), galb=dev(0.0),
                                gasgiant=True)
        cfg = make_forward_config(
            self.atm, self.ktab, None,
            iray=RayleighScatteringMode.GAS_GIANT_ATM,
            ispace=WaveUnit.Wavenumber_cm, gasgiant=True)
        self.cfg = dataclasses.replace(cfg, scat_wave_tile=sc["wave_tile"])
        mu, wt = quadrature(spec)
        self.quad = ScatterQuadrature(mu=tuple(mu), wtmu=tuple(wt),
                                      nf=sc["nf"], nphi=sc["nphi"])
        self.geometry = spec["geometry"]
        self.scaled = list(spec["scaled_gases"])
        self.dtype, self.device = dtype, device

    def forward(self, t, mult):
        full = traffic.vmr_multiplier(mult, self.scaled, self.atm.vmr.shape[1])
        atm = dataclasses.replace(self.atm, t=t, vmr=self.atm.vmr * full)
        spec = self._forward(atm, self.laycfg, self.ktab, None, self.aero,
                             self.surf, self.stellar, self.cfg, self.quad,
                             self.hgphase, iray_phase=True,
                             device=self.device, **self.geometry)
        return spec[:, 0]


class Reference:
    """The plain reference on this configuration, on ``device`` in
    ``dtype``: ``forward(t, mult, wave_idx)`` is the spectrum at the waves
    ``wave_idx`` (a host integer array) of the grid."""

    def __init__(self, spec, seed: int, device, dtype=torch.float64):
        self.spec, self.device, self.dtype = spec, device, dtype
        prof, g = profiles(spec), grids(spec)

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=device
                                   ).to(dtype)

        self.h, self.p, self.vmr = dev(prof["h"]), dev(prof["p"]), dev(prof["vmr"])
        self.dust = dev(prof["dust"])
        self.layht = float(prof["h"][0])
        self.g = g
        self.del_g, self.press, self.temp = (dev(g["del_g"]), dev(g["press"]),
                                             dev(g["temp"]))
        self.mu, self.wt = quadrature(spec)
        self.scaled = list(spec["scaled_gases"])

    def opacities(self, t, mult, wave_idx) -> dict:
        """The layers' temperatures and optical depths at the waves
        ``wave_idx``: ``temp`` (NLAY,), ``taut`` (NWAVE, NG, NLAY),
        ``tauray``, ``tauscat`` (NWAVE, NLAY) and ``frac`` (NWAVE, NMODE,
        NLAY), each mode's share of ``tauscat``."""
        spec = self.spec
        full = traffic.vmr_multiplier(mult.to(self.dtype), self.scaled,
                                      self.vmr.shape[1])
        press, temp, totam, amount, _ = nadir.layers(
            self.h, self.p, t.to(self.dtype), self.vmr * full, spec["nlay"],
            spec["nint"], self.layht)
        cont = scattering.dust_columns(self.h, self.p, self.dust,
                                       spec["nlay"], spec["nint"], self.layht)
        k = ktable(spec, wave_idx, self.device, self.dtype)
        k_lay = ktables.interpolate(k, self.press, self.temp,
                                    press / nadir.ATM_PA, temp)
        taugas = ktables.mix(k_lay, amount.T * nadir.SQ_CM_PER_SQ_M,
                             self.g["del_g"])
        wave = self.wave(wave_idx)
        tauray = nadir.rayleigh_gas_giant(wave, totam)
        kext, ksca = aerosol_xsc(spec, wave)
        tauext = (kext * nadir.SQ_CM_PER_SQ_M)[:, None, :] * cont[None]
        taucl = (ksca * nadir.SQ_CM_PER_SQ_M)[:, None, :] * cont[None]
        tauscat = taucl.sum(-1)
        safe = torch.where(tauscat > 0, tauscat, 1.0)[..., None]
        frac = torch.where(tauscat[..., None] > 0, taucl / safe, 0.0)
        return dict(temp=temp, tauray=tauray, tauscat=tauscat,
                    frac=frac.transpose(1, 2),
                    taut=taugas + (tauray + tauext.sum(-1))[:, None, :])

    def wave(self, wave_idx):
        return torch.as_tensor(self.g["wave"][wave_idx],
                               device=self.device).to(self.dtype)

    def forward(self, t, mult, wave_idx):
        ae, sc, so = (self.spec["aerosol"], self.spec["scattering"],
                      self.spec["solar"])
        od = self.opacities(t, mult, wave_idx)
        wave = self.wave(wave_idx)
        bnu = nadir.planck(wave[:, None], od["temp"][None, :])
        solar = solar_power(self.spec, wave) / (
            4.0 * math.pi * (so["dist_au"] * AU_CM) ** 2)
        geo = self.spec["geometry"]

        def hg(c):
            return scattering.henyey_greenstein2(c, ae["hg_f"], ae["hg_g1"],
                                                 ae["hg_g2"])

        # the ground of a gas giant: the bottom layer's Planck radiance
        rad = scattering.radiance(
            self.mu, self.wt, sc["nf"], sc["nphi"],
            [hg] * len(ae["mode_scale"]), bnu, od["taut"], od["tauray"],
            od["tauscat"], od["frac"], bnu[:, :1].expand(-1, len(self.mu)),
            solar, [geo["sol_ang"]],
            [geo["emiss_ang"]], [geo["azi_ang"]])
        return rad[..., 0] @ self.del_g

    def base_optical_depth(self):
        """(NWAVE, NG, NLAY) total optical depth of the configuration's own
        profiles on the whole grid."""
        t = torch.as_tensor(profiles(self.spec)["t"], device=self.device)
        mult = torch.ones((t.shape[0], len(self.scaled)), dtype=t.dtype,
                          device=self.device)
        return self.opacities(t, mult, np.arange(self.spec["nwave"]))["taut"]
