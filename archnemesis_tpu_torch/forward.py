"""Forward model: components -> synthetic nadir spectrum.

Port of the nadir path of the JAX package's ``forward.py``, with
correlated-k, line-by-line table and runtime line-by-line gas opacity
(reference ``ForwardModel_0`` nemesisfm :437 + CIRSrad :4376): a static
``ForwardConfig`` is built once on the host (gas index mappings, enums,
quadrature constants), and ``forward_nadir`` is a plain function of the
component structures.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from archnemesis_tpu_torch.core.spectra import (
    AerosolOptics,
    CIATables,
    KTables,
    SurfaceSpec,
)
from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
from archnemesis_tpu_torch.enums import (
    PathCalc,
    RayleighScatteringMode,
    SpectralCalculationMode,
    WaveUnit,
)
from archnemesis_tpu_torch.io.linedata import RuntimeLBL
from archnemesis_tpu_torch.ops.cia import cia_tau
from archnemesis_tpu_torch.ops.dust import dust_tau
from archnemesis_tpu_torch.ops.ktab import interp_ktables
from archnemesis_tpu_torch.ops.lbl import lbl_cross_section
from archnemesis_tpu_torch.ops.overlap import mix_gas_k
from archnemesis_tpu_torch.ops.pseudo_continuum import pseudo_continuum_k
from archnemesis_tpu_torch.ops.rayleigh import rayleigh_tau
from archnemesis_tpu_torch.rt.emission import (
    absorption_spectrum,
    thermal_emission_spectrum,
    transmission_spectrum,
)
from archnemesis_tpu_torch.rt.layer import build_layers
from archnemesis_tpu_torch.rt.path import Paths, nadir_path
from archnemesis_tpu_torch.utils.device import resolve_device
from archnemesis_tpu_torch.utils.interp import interp1d_extrap

ATM_TO_PA = 101325.0
SQ_CM_TO_SQ_M = 1.0e-4


@dataclass(frozen=True)
class ForwardConfig:
    """Static forward-model configuration, built once on the host by
    ``make_forward_config``."""

    ispace: WaveUnit
    iray: RayleighScatteringMode
    spec_gas_idx: Tuple[int, ...]  # spectroscopy gas -> atmosphere column
    pair_q1: Tuple[int, ...]  # CIA pair -> atmosphere column of gas 1
    pair_q2: Tuple[int, ...]
    pair_active: Tuple[int, ...]
    ray_gas_idx: Tuple[Tuple[str, int], ...]  # for IRAY=4 (h2/he/ch4/nh3)
    del_g: Tuple[float, ...]  # host copy of the g-bin widths
    gasgiant: bool = True
    # per spectroscopy gas: atmosphere columns sharing its gas id (self-
    # broadening fraction for runtime LBL, ForwardModel_0.py:3822-3828)
    amb_self_cols: Tuple[Tuple[int, ...], ...] = ()
    # atmosphere columns of CO2/N2/H2 for the analytic NIR CIA bands
    # (reference species scan, ForwardModel_0.py:4560-4584); -1 = absent
    ico2: int = -1
    in2: int = -1
    ih2: int = -1


def _locate_gas(gas_id, iso_id, atm_ids, atm_isos):
    for i, (g, s) in enumerate(zip(atm_ids, atm_isos)):
        if g == gas_id and s == iso_id:
            return i
    return None


def _pair_is_inormal_dependent(cia: CIATables, p: int) -> bool:
    """A pair is INORMAL-dependent if the same (gas1,gas2) appears more than
    once in the table (reference locate_INORMAL_pairs CIA_0.py:380)."""
    count = sum(
        1
        for q in range(len(cia.pair_gas1))
        if cia.pair_gas1[q] == cia.pair_gas1[p]
        and cia.pair_gas2[q] == cia.pair_gas2[p]
    )
    return count > 1


def make_forward_config(
    atm: Atmosphere,
    ktab: KTables,
    cia: Optional[CIATables],
    iray: RayleighScatteringMode,
    ispace: WaveUnit = WaveUnit.Wavenumber_cm,
    gasgiant: bool = True,
) -> ForwardConfig:
    """Resolve static gas mappings (reference locate_gas
    Atmosphere_0.py:1152 and the CIA pair resolution
    ForwardModel_0.py:4700-4716)."""
    spec_idx = []
    for g, s in zip(ktab.gas_id, ktab.iso_id):
        i = _locate_gas(g, s, atm.gas_id, atm.iso_id)
        if i is None:
            raise ValueError(f"spectroscopy gas {g} iso {s} not in atmosphere")
        spec_idx.append(i)

    # gas-coverage note (reference check_gas_spec_atm
    # ForwardModel_0.py:296-348): atmosphere gases without spectroscopy
    # data contribute no opacity
    uncovered = [
        (g, s)
        for g, s in zip(atm.gas_id, atm.iso_id)
        if not any(
            kg == g and (ks == s or ks == 0 or s == 0)
            for kg, ks in zip(ktab.gas_id, ktab.iso_id)
        )
    ]
    if uncovered:
        logging.getLogger(__name__).info(
            "atmosphere gases without spectroscopy data (no line/band "
            "opacity contribution): %s", uncovered)

    pair_q1, pair_q2, pair_active = [], [], []
    if cia is not None:
        for p in range(len(cia.pair_gas1)):
            g1, g2 = cia.pair_gas1[p], cia.pair_gas2[p]

            def find(g):
                cols = [i for i, x in enumerate(atm.gas_id) if x == g]
                if len(cols) > 1:
                    cols = [i for i in cols if atm.iso_id[i] == 1]
                return cols[0] if len(cols) == 1 else None

            i1, i2 = find(g1), find(g2)
            active = i1 is not None and i2 is not None
            if active and cia.inormalt[p] is not None:
                # INORMAL-dependent pairs participate only when their flag
                # matches the run INORMAL (ForwardModel_0.py:4732-4749)
                if (_pair_is_inormal_dependent(cia, p)
                        and cia.inormalt[p] != cia.inormal):
                    active = False
            pair_q1.append(i1 if i1 is not None else 0)
            pair_q2.append(i2 if i2 is not None else 0)
            pair_active.append(1 if active else 0)

    amb_self_cols = tuple(
        tuple(i for i, ag in enumerate(atm.gas_id) if ag == g)
        for g in ktab.gas_id
    )

    ray_idx = []
    names = {39: "h2", 40: "he", 6: "ch4", 11: "nh3"}
    for i, (g, s) in enumerate(zip(atm.gas_id, atm.iso_id)):
        if g in names and s in (0, 1) and names[g] not in dict(ray_idx):
            ray_idx.append((names[g], i))

    # species columns for the analytic NIR CIA bands (reference scan keeps
    # the LAST match, ForwardModel_0.py:4560-4584)
    ico2 = in2 = ih2 = -1
    for i, (g, s) in enumerate(zip(atm.gas_id, atm.iso_id)):
        if g == 39 and s in (0, 1):
            ih2 = i
        elif g == 22:
            in2 = i
        elif g == 2 and s in (0, 1):
            ico2 = i

    del_g = torch.as_tensor(ktab.del_g).detach().cpu().numpy()
    return ForwardConfig(
        ispace=WaveUnit(ispace),
        iray=RayleighScatteringMode(iray),
        spec_gas_idx=tuple(spec_idx),
        pair_q1=tuple(pair_q1),
        pair_q2=tuple(pair_q2),
        pair_active=tuple(pair_active),
        ray_gas_idx=tuple(ray_idx),
        del_g=tuple(float(x) for x in del_g),
        gasgiant=gasgiant,
        amb_self_cols=amb_self_cols,
        ico2=ico2,
        in2=in2,
        ih2=ih2,
    )


def apply_dust_renorm(layers, atm: Atmosphere):
    """Rescale layered dust columns so each flagged mode integrates to the
    model-specified optical depth (reference ForwardModel_0.py:4833-4834:
    CONT[:, i] / sum * 1e4 * DUST_RENORMALISATION[i])."""
    if atm.dust_renorm is None:
        return layers
    renorm = atm.dust_renorm
    cont = layers.cont  # (NLAY, NDUST)
    tot = torch.sum(cont, dim=0)
    scaled = cont / torch.where(tot > 0.0, tot, 1.0) * 1.0e4 * renorm
    new = torch.where((renorm > 0.0)[None, :], scaled, cont)
    return layers.replace(cont=new)


def runtime_ambient_fraction(cfg: ForwardConfig, layers, gas: int):
    """(NLAY,) ambient-gas fraction of one runtime-LBL gas: one minus its
    self fraction, the summed layer-mean VMRs of the atmosphere columns of
    its gas id (reference ForwardModel_0.py:3819-3848)."""
    ave_vmr = torch.mean(layers.pp / layers.press[:, None], dim=0)
    self_frac = torch.sum(ave_vmr[list(cfg.amb_self_cols[gas])])
    return (1.0 - self_frac).expand(layers.nlay)


def runtime_lbl_tau(cfg: ForwardConfig, layers, rt: RuntimeLBL, press_atm,
                    amounts):
    """Gas optical depths (NWAVE, 1, NLAY) of a runtime line-by-line deck:
    per gas the on-the-fly line synthesis (reference calc_klbl_online
    Spectroscopy_0.py:2046) plus its weak-line pseudo-continuum, times the
    gas's layer amounts; NG = 1. A wave-sharded deck (``rt.shard_data``)
    synthesises this rank's waves only, shard by shard
    (``parallel/sharded.py``)."""
    if not isinstance(rt, RuntimeLBL):
        raise TypeError(f"ILBL=1 (runtime line-by-line) needs a RuntimeLBL, "
                        f"got {type(rt).__name__}")
    dev = layers.temp.device
    wave = runtime_wave(rt)
    taugas = layers.temp.new_zeros((wave.shape[0], layers.nlay))
    for i in range(rt.ngas):
        amb = runtime_ambient_fraction(cfg, layers, i)
        opts = dict(
            lineshape=rt.lineshape[i], s_floor=rt.s_floor[i],
            wn_calc_window=rt.wn_calc_window[i],
            wn_approx_window=rt.wn_approx_window[i],
            include_pressure_shift=rt.include_pressure_shift[i])
        k_i = 0.0
        if rt.include_lines[i] and rt.shard_data:
            from archnemesis_tpu_torch.parallel.sharded import (
                sharded_lbl_cross_section,
            )

            k_i = sharded_lbl_cross_section(
                rt.line_lists[i], rt.shard_data[i], rt.wave_slice.mesh,
                layers.temp, press_atm, amb, **opts)  # (NWAVE_rank, NLAY)
        elif rt.include_lines[i]:
            # the kernel's static inputs, packed once per deck on the card
            k_i = lbl_cross_section(
                rt.line_lists[i], rt.blocks[i], layers.temp, press_atm, amb,
                device=dev, packed=rt.packed_inputs(i),
                **opts)  # (NWAVE, NLAY)
        if rt.include_continuum[i] and rt.pseudo_continuum[i] is not None:
            # weak-line pseudo-continuum (reference
            # add_monochromatic_absorption LineData_0.py:2436-2460)
            k_i = k_i + pseudo_continuum_k(
                rt.pseudo_continuum[i], wave, layers.temp, press_atm, amb,
                lineshape=rt.lineshape[i])
        taugas = taugas + k_i * amounts[i][None, :]
    return taugas[:, None, :]


def runtime_wave(rt: RuntimeLBL):
    """The host calc grid a runtime deck synthesises on this rank: the
    whole grid, or the rank's part of a wave-sharded one."""
    if rt.wave_slice is None:
        return rt.wave
    lo, hi = rt.wave_slice.bounds()
    return rt.wave[lo:hi]


def layer_optical_depths(
    cfg: ForwardConfig,
    layers,
    wave,
    ktab: KTables,
    cia: Optional[CIATables],
    aero: Optional[AerosolOptics],
):
    """Per-layer vertical optical depths (reference calculate_layer_opacity
    ForwardModel_0.py:3905): gas (correlated-k mixed, line-by-line tables,
    or runtime line-by-line synthesis), CIA, Rayleigh, dust.

    Returns dict with taugas (NWAVE,NG,NLAY), taucia/tauray/taudust/tauscat
    (NWAVE,NLAY), tauclscat (NWAVE,NLAY,NDUST), tautot (NWAVE,NG,NLAY).
    """
    dev = wave.device
    press_atm = layers.press / ATM_TO_PA

    # --- gas opacity
    spec_idx = torch.as_tensor(cfg.spec_gas_idx, device=dev)
    amounts = layers.amount[:, spec_idx].T * SQ_CM_TO_SQ_M  # (NGAS, NLAY)
    if ktab.ilbl == SpectralCalculationMode.LINE_BY_LINE_RUNTIME:
        taugas = runtime_lbl_tau(cfg, layers, ktab, press_atm, amounts)
    elif ktab.ilbl == SpectralCalculationMode.LINE_BY_LINE_TABLES:
        k_gas = interp_ktables(ktab.k, ktab.press, ktab.temp, press_atm,
                               layers.temp, logk=ktab.logk)
        # monochromatic: plain sum over gases, NG=1
        # (reference ForwardModel_0.py:3796-3818)
        taugas = torch.einsum("wglr,rl->wgl", k_gas, amounts)
    else:
        # correlated-k random overlap (ForwardModel_0.py:3853-3885)
        k_gas = interp_ktables(ktab.k, ktab.press, ktab.temp, press_atm,
                               layers.temp, logk=ktab.logk)
        taugas = mix_gas_k(cfg.del_g, k_gas, amounts)

    q_lay = layers.pp / layers.press[:, None]

    # --- CIA
    if cia is not None:
        taucia = cia_tau(
            cia,
            wave,
            layers.temp,
            layers.frac,
            q_lay,
            layers.totam,
            layers.delh,
            cfg.pair_q1,
            cfg.pair_q2,
            cfg.pair_active,
            ispace=cfg.ispace,
            ico2=cfg.ico2,
            in2=cfg.in2,
            ih2=cfg.ih2,
        )
    else:
        taucia = layers.temp.new_zeros((wave.shape[0], layers.nlay))

    # --- Rayleigh
    tauray = rayleigh_tau(
        cfg.iray,
        wave,
        layers.totam,
        vmr_lay=q_lay,
        gas_idx=dict(cfg.ray_gas_idx),
        ispace=cfg.ispace,
    )

    # --- dust
    if aero is not None and aero.ndust > 0:
        taudust, tauscat, tauclscat = dust_tau(
            aero.wave, aero.kext, aero.ksca, wave, layers.cont
        )
    else:
        z = layers.temp.new_zeros((wave.shape[0], layers.nlay))
        taudust, tauscat, tauclscat = z, z, z[:, :, None] * 0

    tautot = taugas + (taucia + taudust + tauray)[:, None, :]
    return {
        "taugas": taugas,
        "taucia": taucia,
        "tauray": tauray,
        "taudust": taudust,
        "tauscat": tauscat,
        "tauclscat": tauclscat,
        "tautot": tautot,
    }


def path_spectrum(
    cfg: ForwardConfig,
    wave,
    tautot,
    path: Paths,
    surf: Optional[SurfaceSpec],
    del_g,
):
    """LOS accumulation + IMOD dispatch + g integration (reference CIRSrad
    ForwardModel_0.py:4376-4508). Returns (NWAVE, NPATH)."""
    tau_layinc = (
        tautot[:, :, path.layinc] * path.scale[None, None, :, :]
    )  # (NWAVE, NG, NLAYIN, NPATH)

    if PathCalc.THERMAL_EMISSION in path.imod:
        if surf is not None and not cfg.gasgiant:
            emissivity = interp1d_extrap(surf.vem, surf.emissivity, wave)
            tsurf = surf.tsurf
        else:
            emissivity = torch.zeros_like(wave)
            tsurf = wave.new_tensor(-1.0)
        spec = thermal_emission_spectrum(
            wave,
            tau_layinc,
            path.emtemp,
            path.mask,
            tsurf,
            emissivity,
            path.surface_visible,
            cfg.gasgiant,
            ispace=cfg.ispace,
        )
    elif PathCalc.ABSORBTION in path.imod:
        # 1 - transmission, useful for small transmissions (reference
        # calculate_absorption_spectrum ForwardModel_0.py:4127-4136)
        tau_total = torch.sum(tau_layinc * path.mask[None, None, :, :], dim=2)
        spec = absorption_spectrum(tau_total)
    elif not (
        (PathCalc.MULTIPLE_SCATTERING
         | PathCalc.SINGLE_SCATTERING_PLANE_PARALLEL) & path.imod
    ):
        tau_total = torch.sum(tau_layinc * path.mask[None, None, :, :], dim=2)
        spec = transmission_spectrum(tau_total)
    else:
        raise NotImplementedError(f"IMOD {path.imod} not yet implemented")

    return torch.einsum("wgp,g->wp", spec, del_g)


def forward_nadir(
    atm: Atmosphere,
    laycfg: LayerConfig,
    ktab: KTables,
    cia: Optional[CIATables],
    aero: Optional[AerosolOptics],
    surf: Optional[SurfaceSpec],
    cfg: ForwardConfig,
    emiss_ang,
    sol_ang=180.0,
    azi_ang=0.0,
    return_diagnostics: bool = False,
    device=None,
):
    """One nadir-geometry thermal-emission forward evaluation on the
    k-table (or runtime line-by-line) wave grid (reference nemesisfm for a
    single (IGEOM, IAV) + CIRSrad). Returns the (NWAVE, 1) spectrum.

    Wave-sharded tables (``parallel/mesh.py:shard_ktables_by_wave``,
    ``parallel/sharded.py:shard_runtime_lbl``) run every per-wave stage on
    this rank's waves and gather the whole spectrum on every rank; the
    diagnostics stay the rank's.

    The structures are moved to ``device`` first (None = CUDA; raises
    without a card unless ``device="cpu"``); a ``RuntimeLBL`` stays on the
    host and its synthesis runs on ``device``.
    """
    device = resolve_device(device)
    atm = atm.to(device)
    if not isinstance(ktab, RuntimeLBL):
        ktab = ktab.to(device)
    cia = cia.to(device) if cia is not None else None
    aero = aero.to(device) if aero is not None else None
    surf = surf.to(device) if surf is not None else None

    layers = apply_dust_renorm(build_layers(atm, laycfg, layang=0.0), atm)
    path = nadir_path(
        layers,
        atm.radius,
        atm.h[-1],
        emiss_ang,
        sol_ang=sol_ang,
        azi_ang=azi_ang,
        imod=PathCalc.THERMAL_EMISSION,
    )
    if isinstance(ktab, RuntimeLBL):
        # the host grid in the run's type (the synthesis reads its own
        # float64 copy)
        wave = layers.temp.new_tensor(runtime_wave(ktab))
        del_g = layers.temp.new_tensor(ktab.del_g)
    else:
        wave, del_g = ktab.wave, ktab.del_g
    taus = layer_optical_depths(cfg, layers, wave, ktab, cia, aero)
    spec = path_spectrum(cfg, wave, taus["tautot"], path, surf, del_g)
    if ktab.wave_slice is not None:
        # wave-sharded tables: every stage above ran on this rank's waves;
        # the spectrum is gathered once, before the instrument function
        spec = ktab.wave_slice.gather(spec, dim=0)
    if return_diagnostics:
        return spec, {"layers": layers, "path": path, **taus}
    return spec
