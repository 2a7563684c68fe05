"""Forward model: components -> synthetic spectra.

Port of the JAX package's ``forward.py`` for the nadir, limb,
disc-averaged, solar-occultation (with AOTF orders) and primary-transit
geometries, with correlated-k, line-by-line table and runtime line-by-line
gas opacity (reference ``ForwardModel_0`` nemesisfm :437, nemesisSOfm
:783, nemesisLfm :1254, nemesisdiscfm :1609, nemesisPTfm :1838 + CIRSrad
:4376): a static ``ForwardConfig`` is built once on the host (gas index
mappings, enums, quadrature constants), and every forward is a plain
function of the component structures.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from archnemesis_tpu_torch.core.spectra import (
    AerosolOptics,
    CIATables,
    KTables,
    StellarSpec,
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
from archnemesis_tpu_torch.ops.ktab import (
    interp_ktables,
    interp_ktables_factored,
)
from archnemesis_tpu_torch.ops.lbl import lbl_cross_section
from archnemesis_tpu_torch.ops.overlap import mix_gas_k
from archnemesis_tpu_torch.ops.pseudo_continuum import pseudo_continuum_k
from archnemesis_tpu_torch.ops.rayleigh import rayleigh_tau
from archnemesis_tpu_torch.rt.emission import (
    absorption_spectrum,
    ground_radiance,
    path_emission_spectrum,
    thermal_emission_spectrum,
    transmission_spectrum,
)
from archnemesis_tpu_torch.rt.layer import build_layers
from archnemesis_tpu_torch.rt.layer_graph import layering_and_path
from archnemesis_tpu_torch.rt.path import (
    Paths,
    limb_paths,
    nadir_path,
)
from archnemesis_tpu_torch.utils.device import resolve_device
from archnemesis_tpu_torch.utils.host import has_tangent
from archnemesis_tpu_torch.utils.interp import interp, interp1d_extrap
from archnemesis_tpu_torch.utils.profiling import FORWARD_SPAN, annotate

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
    # multiple-scattering wave tile: the adding-doubling core runs over
    # tiles of this many waves (live memory bounded by the tile; the
    # reference's analog is its per-wave loop, Multiple_Scattering_Core.py:
    # 790). 128 is the JAX package's default; grids <= the tile run
    # untiled.
    scat_wave_tile: int = 128


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

    # .tolist(): a host read that also works inside torch.func transforms
    # (the telluric transmission builds its configuration there)
    del_g = torch.as_tensor(ktab.del_g).detach().cpu().tolist()
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

            with annotate("nemesis.lbl.synth"):
                k_i = sharded_lbl_cross_section(
                    rt.line_lists[i], rt.shard_data[i], rt.wave_slice.mesh,
                    layers.temp, press_atm, amb,
                    **opts)  # (NWAVE_rank, NLAY)
        elif rt.include_lines[i]:
            # the kernel's static inputs, packed once per deck on the card
            with annotate("nemesis.lbl.pack"):
                blocks, packed = rt.blocks[i], rt.packed_inputs(i)
            with annotate("nemesis.lbl.synth"):
                k_i = lbl_cross_section(
                    rt.line_lists[i], blocks, layers.temp, press_atm, amb,
                    device=dev, packed=packed, **opts)  # (NWAVE, NLAY)
        if rt.include_continuum[i] and rt.pseudo_continuum[i] is not None:
            # weak-line pseudo-continuum (reference
            # add_monochromatic_absorption LineData_0.py:2436-2460)
            with annotate("nemesis.lbl.continuum"):
                k_i = k_i + pseudo_continuum_k(
                    rt.pseudo_continuum[i], wave, layers.temp, press_atm,
                    amb, lineshape=rt.lineshape[i])
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
        with annotate("nemesis.kinterp"):
            k_gas = interp_ktables(ktab.k, ktab.press, ktab.temp, press_atm,
                                   layers.temp, logk=ktab.logk)
        # monochromatic: plain sum over gases, NG=1
        # (reference ForwardModel_0.py:3796-3818)
        taugas = torch.einsum("wglr,rl->wgl", k_gas, amounts)
    else:
        # correlated-k random overlap (ForwardModel_0.py:3853-3885); under
        # forward-mode derivatives k comes in factored form, so that each
        # gas's tangent exists only while its combine runs
        interp_k = (interp_ktables_factored
                    if has_tangent(press_atm, layers.temp) else interp_ktables)
        with annotate("nemesis.kinterp"):
            k_gas = interp_k(ktab.k, ktab.press, ktab.temp, press_atm,
                             layers.temp, logk=ktab.logk)
        with annotate("nemesis.overlap"):
            taugas = mix_gas_k(cfg.del_g, k_gas, amounts)

    q_lay = layers.pp / layers.press[:, None]

    # --- CIA
    if cia is not None:
        with annotate("nemesis.cia"):
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
    with annotate("nemesis.rayleigh"):
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
        with annotate("nemesis.dust"):
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


def _emission_tangents(tautot, path, tsurf, emissivity, wave,
                       del_g) -> bool:
    """Whether the thermal emission runs under forward-mode tangents that
    ``rt/emission.py:path_emission_spectrum`` takes: a tangent on the
    optical depths, the path's scale or temperatures, or the surface, and
    none on the mask, the wave grid or the g weights."""
    def tensors(*xs):
        return [x for x in xs if isinstance(x, torch.Tensor)]

    return (has_tangent(*tensors(tautot, path.scale, path.emtemp, tsurf,
                                 emissivity))
            and not has_tangent(*tensors(path.mask, wave, del_g)))


def path_spectrum(
    cfg: ForwardConfig,
    wave,
    tautot,
    path: Paths,
    surf: Optional[SurfaceSpec],
    del_g,
    emission_layer=None,
):
    """LOS accumulation + IMOD dispatch + g integration (reference CIRSrad
    ForwardModel_0.py:4376-4508). Returns (NWAVE, NPATH).

    ``emission_layer``: optional (NWAVE, NLAY) non-LTE per-layer emitted
    radiance (``ops.emissions.layer_emission``), gathered onto the path as
    tau is (reference EMITOT_LAYINC ForwardModel_0.py:4095).

    The thermal emission under forward-mode tangents (``jvp``, ``jacfwd``,
    with or without a ``vmap`` over locations) and without
    ``emission_layer`` goes through ``rt/emission.py:
    path_emission_spectrum``: the same primal, and one tangent kernel for
    all tangents (``_emission_tangents`` says when)."""
    with annotate("nemesis.spectrum"):
        if PathCalc.THERMAL_EMISSION in path.imod:
            if surf is not None and not cfg.gasgiant:
                emissivity = interp1d_extrap(surf.vem, surf.emissivity, wave)
                tsurf = surf.tsurf
            else:
                emissivity = torch.zeros_like(wave)
                tsurf = wave.new_tensor(-1.0)
            if emission_layer is None and _emission_tangents(
                    tautot, path, tsurf, emissivity, wave, del_g):
                radground = None
                if path.surface_visible:
                    radground = ground_radiance(
                        wave, path.emtemp, tsurf, emissivity, cfg.gasgiant,
                        cfg.ispace).expand(wave.shape[0], path.npath)
                return path_emission_spectrum(
                    wave, tautot, path.layinc, path.scale, path.mask,
                    path.emtemp, radground, del_g, cfg.ispace)
        tau_layinc = (
            tautot[:, :, path.layinc] * path.scale[None, None, :, :]
        )  # (NWAVE, NG, NLAYIN, NPATH)

        if PathCalc.THERMAL_EMISSION in path.imod:
            emission_path = None
            if emission_layer is not None:
                # (NWAVE, NLAYIN, NPATH)
                emission_path = (emission_layer[:, path.layinc]
                                 * path.scale[None, :, :])
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
                emission_path=emission_path,
            )
        elif PathCalc.ABSORBTION in path.imod:
            # 1 - transmission, useful for small transmissions (reference
            # calculate_absorption_spectrum ForwardModel_0.py:4127-4136)
            tau_total = torch.sum(tau_layinc * path.mask[None, None, :, :],
                                  dim=2)
            spec = absorption_spectrum(tau_total)
        elif not (
            (PathCalc.MULTIPLE_SCATTERING
             | PathCalc.SINGLE_SCATTERING_PLANE_PARALLEL) & path.imod
        ):
            tau_total = torch.sum(tau_layinc * path.mask[None, None, :, :],
                                  dim=2)
            spec = transmission_spectrum(tau_total)
        else:
            raise NotImplementedError(f"IMOD {path.imod} not yet implemented")

        return torch.einsum("wgp,g->wp", spec, del_g)


def _calc_grid(ktab, layers):
    """(wave, del_g) of the calc grid in the run's type: the tables' own,
    or a runtime deck's host grid (its synthesis reads its own float64
    copy)."""
    if isinstance(ktab, RuntimeLBL):
        return (layers.temp.new_tensor(runtime_wave(ktab)),
                layers.temp.new_tensor(ktab.del_g))
    return ktab.wave, ktab.del_g


def _structures_to(device, atm, ktab, *rest):
    """The component structures on ``device``; a ``RuntimeLBL`` stays on
    the host."""
    if not isinstance(ktab, RuntimeLBL):
        ktab = ktab.to(device)
    return (atm.to(device), ktab) + _to_device(device, *rest)


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
    emis=None,
    emis_gas_cols=(),
    emis_dist=None,
    return_diagnostics: bool = False,
    device=None,
):
    """One nadir-geometry thermal-emission forward evaluation on the
    k-table (or runtime line-by-line) wave grid (reference nemesisfm for a
    single (IGEOM, IAV) + CIRSrad). Returns the (NWAVE, 1) spectrum.

    ``emis``/``emis_gas_cols``/``emis_dist``: optional non-LTE emission
    tables (``core.emissions.EmissionTables``), the atmosphere column of
    each emission's gas (``ops.emissions.locate_emission_gases``) and the
    planet-star distance in AU (None without a stellar spectrum).

    Wave-sharded tables (``parallel/mesh.py:shard_ktables_by_wave``,
    ``parallel/sharded.py:shard_runtime_lbl``) run every per-wave stage on
    this rank's waves and gather the whole spectrum on every rank; the
    diagnostics stay the rank's.

    The structures are moved to ``device`` first (None = CUDA; raises
    without a card unless ``device="cpu"``); a ``RuntimeLBL`` stays on the
    host and its synthesis runs on ``device``. On the card, with plain
    inputs and host-number angles, the layering and the path replay CUDA
    graphs (``rt/layer_graph.py``).
    """
    with annotate(FORWARD_SPAN):
        device = resolve_device(device)
        atm, ktab, cia, aero, surf, emis = _structures_to(
            device, atm, ktab, cia, aero, surf, emis)

        layers, path = layering_and_path(
            atm, laycfg, emiss_ang, sol_ang, azi_ang,
            others=(ktab, cia, aero, surf, emis), own=return_diagnostics)
        wave, del_g = _calc_grid(ktab, layers)
        taus = layer_optical_depths(cfg, layers, wave, ktab, cia, aero)
        emission_layer = None
        if emis is not None:
            from archnemesis_tpu_torch.ops.emissions import layer_emission

            emission_layer = layer_emission(emis, wave, layers.temp,
                                            layers.amount, emis_gas_cols,
                                            dist=emis_dist)
        spec = path_spectrum(cfg, wave, taus["tautot"], path, surf, del_g,
                             emission_layer=emission_layer)
        if ktab.wave_slice is not None:
            # wave-sharded tables: every stage above ran on this rank's
            # waves; the spectrum is gathered once, before the instrument
            # function
            spec = ktab.wave_slice.gather(spec, dim=0)
        if return_diagnostics:
            return spec, {"layers": layers, "path": path, **taus}
        return spec


def so_tangent_layers(baseh_m: np.ndarray, tanhe_km: np.ndarray):
    """Unique tangent (bottom) layers bracketing each measured tangent
    height (reference calc_path_SO ForwardModel_0.py:3240-3258). Host-side
    static."""
    nlay = baseh_m.shape[0]
    baseh_km = np.asarray(baseh_m) / 1.0e3
    itanhe = []
    for th in np.atleast_1d(tanhe_km):
        ibase = int(np.argmin(np.abs(baseh_km - th)))
        if baseh_km[ibase] <= th:
            ibasel, ibaseh = ibase, min(ibase + 1, nlay - 1)
        else:
            ibasel, ibaseh = ibase - 1, ibase
        itanhe += [ibasel, ibaseh]
    return np.unique(itanhe)


def so_geometry(atm: Atmosphere, laycfg: LayerConfig, tanhe_km,
                lfm_bracket: bool = False):
    """Host-side static limb geometry: the tangent layers and the linear
    tangent-height interpolation stencil (reference calc_path_SO
    ForwardModel_0.py:3240-3258 and nemesisSOfm :943-961), from the
    unperturbed layering at 90 degrees (the reference freezes layer
    heights, adjust_hydrostat=False, ForwardModel_0.py:855).

    ``lfm_bracket=True`` keeps nemesisLfm's bracket choice
    (ForwardModel_0.py:1322-1329) verbatim: there ``base0 =
    BASEH_TANHE[ibase]/1e3`` divides the tangent baseline, already in km,
    by 1e3 again, so the bracket is almost always [ibase, ibase+1], with
    weights that may extrapolate; a bracket past the last path takes the
    last path alone."""
    layers = build_layers(atm, laycfg, layang=90.0)
    baseh = layers.baseh.detach().cpu().double().numpy()
    itanhe = so_tangent_layers(baseh, tanhe_km)
    baseh_tan = baseh[itanhe] / 1.0e3  # (NPATH,) km
    npath = len(itanhe)

    tanhe = np.atleast_1d(np.asarray(tanhe_km, dtype=np.float64))
    lo, hi, wlo, whi = [], [], [], []
    for th in tanhe:
        ibase = int(np.argmin(np.abs(baseh_tan - th)))
        base0 = baseh_tan[ibase] / 1.0e3 if lfm_bracket else baseh_tan[ibase]
        if base0 <= th:
            ibasel, ibaseh = ibase, ibase + 1
        else:
            ibasel, ibaseh = ibase - 1, ibase
        if ibaseh > npath - 1:
            lo.append(ibasel)
            hi.append(ibasel)
            wlo.append(1.0)
            whi.append(0.0)
        else:
            span = baseh_tan[ibaseh] - baseh_tan[ibasel]
            lo.append(ibasel)
            hi.append(ibaseh)
            wlo.append(1.0 - (th - baseh_tan[ibasel]) / span)
            whi.append(1.0 - (baseh_tan[ibaseh] - th) / span)
    return dict(
        itanhe=itanhe,
        lo=np.asarray(lo), hi=np.asarray(hi),
        wlo=np.asarray(wlo), whi=np.asarray(whi),
        baseh_tan=baseh_tan, tanhe_km=tanhe,
    )


def forward_limb(
    atm: Atmosphere,
    laycfg: LayerConfig,
    ktab: KTables,
    cia: Optional[CIATables],
    aero: Optional[AerosolOptics],
    cfg: ForwardConfig,
    tanhe_km,
    return_diagnostics: bool = False,
    device=None,
):
    """Limb thermal-emission forward evaluation at one tangent height (km,
    a host number): the reference nemesisfm path for EMISS_ANG < 0
    (ForwardModel_0.py:505-508 + calc_path :2996-2998). The layering is
    re-based at the tangent height (LAYHT = tanhe, LAYANG = 90) and one
    mirrored limb path through every layer feeds the thermal-emission
    integral (no surface). Returns (NWAVE, 1), gathered over the ranks of
    wave-sharded tables as ``forward_nadir``'s; ``device`` as in
    ``forward_nadir``."""
    device = resolve_device(device)
    atm, ktab, cia, aero = _structures_to(device, atm, ktab, cia, aero)
    layers = apply_dust_renorm(
        build_layers(atm, laycfg, layang=90.0,
                     layht_override=float(tanhe_km) * 1.0e3),
        atm,
    )
    paths = limb_paths(layers, atm.radius, atm.h[-1], [0],
                       imod=PathCalc.THERMAL_EMISSION)
    wave, del_g = _calc_grid(ktab, layers)
    taus = layer_optical_depths(cfg, layers, wave, ktab, cia, aero)
    spec = path_spectrum(cfg, wave, taus["tautot"], paths, None, del_g)
    if ktab.wave_slice is not None:
        # wave-sharded tables, as in forward_nadir
        spec = ktab.wave_slice.gather(spec, dim=0)
    if return_diagnostics:
        return spec, {"layers": layers, "paths": paths, **taus}
    return spec


def tangent_stencil(spec, geo: dict, tanhe_shift=None):
    """(NWAVE, NPATH) tangent-path spectra -> (NWAVE, NGEOM) at the
    measured tangent heights: the static ``so_geometry`` stencil, or with
    ``tanhe_shift`` (km, a tensor that model 777 retrieves) a
    differentiable search over the paths' tangent heights."""
    if tanhe_shift is None:
        def host(x):
            return torch.as_tensor(x, device=spec.device)

        return (spec[:, host(geo["lo"])] * host(geo["wlo"]).to(spec.dtype)
                + spec[:, host(geo["hi"])] * host(geo["whi"]).to(spec.dtype))
    bt = spec.new_tensor(geo["baseh_tan"])  # (NPATH,) km, ascending
    th = spec.new_tensor(geo["tanhe_km"]) + tanhe_shift  # (NGEOM,)
    idx = torch.clamp(torch.searchsorted(bt, th.detach()) - 1, 0,
                      bt.shape[0] - 2)
    w = torch.clamp((th - bt[idx]) / (bt[idx + 1] - bt[idx]), 0.0, 1.0)
    return spec[:, idx] * (1.0 - w)[None, :] + spec[:, idx + 1] * w[None, :]


def forward_limb_batch(
    atm: Atmosphere,
    laycfg: LayerConfig,
    ktab: KTables,
    cia: Optional[CIATables],
    aero: Optional[AerosolOptics],
    cfg: ForwardConfig,
    geo: dict,
    tanhe_shift=None,
    return_diagnostics: bool = False,
    device=None,
):
    """Limb thermal-emission forward model over every measured tangent
    height at once (reference nemesisLfm ForwardModel_0.py:1254 +
    calc_path_L :3375): ONE layering at 90 degrees and one
    ``layer_optical_depths`` feed every tangent path of ``geo`` (from
    ``so_geometry``), then ``tangent_stencil`` to the measured tangent
    heights. Returns (NWAVE, NGEOM); ``device`` as in ``forward_nadir``."""
    device = resolve_device(device)
    atm, ktab, cia, aero = _structures_to(device, atm, ktab, cia, aero)
    layers = apply_dust_renorm(build_layers(atm, laycfg, layang=90.0), atm)
    paths = limb_paths(layers, atm.radius, atm.h[-1], geo["itanhe"],
                       imod=PathCalc.THERMAL_EMISSION)
    wave, del_g = _calc_grid(ktab, layers)
    taus = layer_optical_depths(cfg, layers, wave, ktab, cia, aero)
    spec = path_spectrum(cfg, wave, taus["tautot"], paths, None,
                         del_g)  # (NWAVE, NPATH) radiance
    specmod = tangent_stencil(spec, geo, tanhe_shift)
    if return_diagnostics:
        return specmod, {"layers": layers, "paths": paths, **taus,
                         "spec_paths": spec}
    return specmod


def forward_so(
    atm: Atmosphere,
    laycfg: LayerConfig,
    ktab: KTables,
    cia: Optional[CIATables],
    aero: Optional[AerosolOptics],
    cfg: ForwardConfig,
    geo: dict,
    return_diagnostics: bool = False,
    tanhe_shift=None,
    solflux=None,
    device=None,
):
    """Solar-occultation forward model: one transmission spectrum per
    measured tangent height (reference nemesisSOfm ForwardModel_0.py:783 +
    calc_path_SO :3181). Returns (NWAVE, NGEOM).

    ONE layering at 90 degrees and one ``layer_optical_depths`` feed every
    tangent path of ``geo`` (``so_geometry``); the path transmissions go
    through ``tangent_stencil`` to the measured tangent heights (with
    ``tanhe_shift``, km, a tensor that model 777 retrieves: the
    differentiable search). ``solflux`` (NWAVE,) multiplies the
    transmission for IFORM=Atmospheric_transmission (reference
    calculate_transmission_spectrum ForwardModel_0.py:4114-4122).
    ``device`` as in ``forward_nadir``."""
    device = resolve_device(device)
    atm, ktab, cia, aero = _structures_to(device, atm, ktab, cia, aero)
    layers = apply_dust_renorm(build_layers(atm, laycfg, layang=90.0), atm)
    paths = limb_paths(layers, atm.radius, atm.h[-1], geo["itanhe"],
                       imod=PathCalc.PLANCK_FUNCTION_AT_BIN_CENTRE)
    wave, del_g = _calc_grid(ktab, layers)
    taus = layer_optical_depths(cfg, layers, wave, ktab, cia, aero)
    spec = path_spectrum(cfg, wave, taus["tautot"], paths, None,
                         del_g)  # (NWAVE, NPATH) transmission
    specmod = tangent_stencil(spec, geo, tanhe_shift)
    if solflux is not None:
        specmod = specmod * solflux[:, None]
    if return_diagnostics:
        return specmod, {"layers": layers, "paths": paths, **taus,
                         "spec_paths": spec}
    return specmod


def forward_so_aotf(
    atm: Atmosphere,
    laycfg: LayerConfig,
    ktab_orders,
    cia: Optional[CIATables],
    aero: Optional[AerosolOptics],
    cfg_orders,
    geo: dict,
    conv_orders,
    trans_aotf,
    device=None,
):
    """AOTF multi-diffraction-order solar occultation (reference nemesisSOfm
    AOTF branch, ForwardModel_0.py:825-907): the TRANS_AOTF-weighted sum of
    per-order ``forward_so`` spectra, each on its own windowed tables
    (``ktab_orders``, ``cfg_orders``) and through its own instrument
    function (``conv_orders``: callables ``(wave, specmod) -> (NCONV,
    NGEOM)``), normalised by the summed weights (:901-907).
    ``trans_aotf``: (NCONV, NGEOM, NORDERS). The tangent geometry ``geo``
    does not depend on the wave range and serves every order.

    As in the JAX package, one frozen atmosphere feeds every order: the
    reference's loop re-applies its profile scalings to one mutable
    atmosphere in every order (ForwardModel_0.py:835, model_2.py:133),
    compounding them across orders; the port does not."""
    device = resolve_device(device)
    atm, cia, aero = _to_device(device, atm, cia, aero)
    weights = torch.as_tensor(np.asarray(trans_aotf), dtype=atm.t.dtype,
                              device=device)
    combined = 0.0
    for o, (kt, cfg_o, conv) in enumerate(zip(ktab_orders, cfg_orders,
                                              conv_orders)):
        kt = kt.to(device)
        specmod = forward_so(atm, laycfg, kt, cia, aero, cfg_o, geo,
                             device=device)
        combined = combined + conv(kt.wave, specmod) * weights[:, :, o]
    return combined / torch.sum(weights, dim=2)


def forward_transit(
    atm: Atmosphere,
    laycfg: LayerConfig,
    ktab: KTables,
    cia: Optional[CIATables],
    aero: Optional[AerosolOptics],
    cfg: ForwardConfig,
    stellar_radius_km,
    return_diagnostics: bool = False,
    device=None,
):
    """Primary-transit depth spectrum (NWAVE,) in percent (reference
    nemesisPTfm ForwardModel_0.py:1838 + calc_path_PT :3697): limb
    transmission paths through the NLAY - 1 layer bases (90 degrees) in
    ONE ``layer_optical_depths``; the absorbing area is the trapezoid
    integral of (1 - T) 2 pi (R + h) over the tangent heights, and the
    depth 100 (A_abs + A_disk) / A_star. ``device`` as in
    ``forward_nadir``."""
    device = resolve_device(device)
    atm, ktab, cia, aero = _structures_to(device, atm, ktab, cia, aero)
    layers = apply_dust_renorm(build_layers(atm, laycfg, layang=90.0), atm)
    nlay = laycfg.nlay
    paths = limb_paths(layers, atm.radius, atm.h[-1], list(range(nlay - 1)),
                       imod=PathCalc.PLANCK_FUNCTION_AT_BIN_CENTRE)
    wave, del_g = _calc_grid(ktab, layers)
    taus = layer_optical_depths(cfg, layers, wave, ktab, cia, aero)
    trans = path_spectrum(cfg, wave, taus["tautot"], paths, None,
                          del_g)  # (NWAVE, NLAY - 1) per tangent layer base
    baseh = layers.baseh[: nlay - 1]
    ann = (1.0 - trans) * (2.0 * np.pi) * (baseh + atm.radius)[None, :]
    dh = baseh[1:] - baseh[:-1]
    area_abs = 0.5 * torch.sum((ann[:, :-1] + ann[:, 1:]) * dh[None, :],
                               dim=1)
    area_disk = np.pi * (atm.radius + baseh[0]) ** 2
    area_star = np.pi * (float(stellar_radius_km) * 1.0e3) ** 2
    depth = (area_abs + area_disk) / area_star * 100.0
    if return_diagnostics:
        return depth, {"layers": layers, "paths": paths, **taus,
                       "trans": trans}
    return depth


def forward_disc(
    atm: Atmosphere,
    laycfg: LayerConfig,
    ktab: KTables,
    cia: Optional[CIATables],
    aero: Optional[AerosolOptics],
    surf: Optional[SurfaceSpec],
    cfg: ForwardConfig,
    quad: dict,
    point_fn=None,
    ray_chunk: Optional[int] = None,
    device=None,
):
    """Disc-averaged spectrum (NWAVE,) over a static quadrature
    (``rt.disc.disc_quadrature``): the reference nemesisdiscfm's fan-out
    over averaging rays (ForwardModel_0.py:1609). The layering and the
    layer optical depths do not depend on the rays' angles, so they are
    computed ONCE; the rays' nadir paths then go through the emission in
    chunks of ``ray_chunk`` rays (None = all at once; under ``jacfwd``
    every tangent holds a (NWAVE, NG, NLAY, chunk) block), and the
    ``wgeom``-weighted sum adds the chunks up.

    ``point_fn(emiss, sol, azi) -> (NWAVE,)`` replaces the per-ray nadir
    forward (called once per ray, with host angles). ``device`` as in
    ``forward_nadir``."""
    angles = [np.asarray(quad[k], dtype=np.float64).reshape(-1)
              for k in ("emiss_ang", "sol_ang", "azi_ang")]
    wgeom = np.asarray(quad["wgeom"], dtype=np.float64).reshape(-1)
    if point_fn is not None:
        out = 0.0
        for i in range(wgeom.shape[0]):
            out = out + float(wgeom[i]) * point_fn(
                *(float(a[i]) for a in angles))
        return out
    device = resolve_device(device)
    atm, ktab, cia, aero, surf = _structures_to(device, atm, ktab, cia, aero,
                                                surf)
    layers = apply_dust_renorm(build_layers(atm, laycfg, layang=0.0), atm)
    wave, del_g = _calc_grid(ktab, layers)
    taus = layer_optical_depths(cfg, layers, wave, ktab, cia, aero)
    nav = wgeom.shape[0]
    chunk = nav if ray_chunk is None else max(1, int(ray_chunk))
    out = 0.0
    for c in range(0, nav, chunk):
        sel = slice(c, c + chunk)
        paths = nadir_path(layers, atm.radius, atm.h[-1],
                           *(a[sel] for a in angles),
                           imod=PathCalc.THERMAL_EMISSION)
        spec = path_spectrum(cfg, wave, taus["tautot"], paths, surf,
                             del_g)  # (NWAVE, chunk)
        out = out + spec @ spec.new_tensor(wgeom[sel])
    return out


# The largest (NWAVE, NG, NLAY, rays) block of ``forward_disc``, the
# primal and every tangent of a Jacobian together. It bounds one block, not
# the peak: the emission stage holds several at once. On an H100 with
# jupiter_nadir (599 waves, 20 g, 71 layers, 81 tangents, float64) the
# chunk is 7 rays, a 3.63 GiB block, and the peak read 36.26 GiB at
# nmu 3 and 5 alike: 10 such blocks.
DISC_BLOCK_BYTES = 4 * 2**30


def disc_ray_chunk(nwave: int, ng: int, nlay: int, n_tangents: int,
                   itemsize: int) -> int:
    """Rays per chunk of ``forward_disc`` whose (NWAVE, NG, NLAY, chunk)
    block of the primal and ``n_tangents`` tangents fits
    ``DISC_BLOCK_BYTES``."""
    per_ray = nwave * ng * nlay * (n_tangents + 1) * itemsize
    return max(1, DISC_BLOCK_BYTES // per_ray)


def solar_flux(stellar: Optional[StellarSpec], wave):
    """Stellar flux at the planet's distance interpolated to the calc grid
    (reference Stellar_0.calc_solar_flux:429 + ForwardModel_0.py:4353-4358).
    """
    if stellar is None or not stellar.solexist:
        return torch.zeros_like(wave)
    au_cm = 1.49598e11 * 100.0
    area = 4.0 * np.pi * (stellar.dist * au_cm) ** 2
    flux = stellar.solspec / area
    return interp(wave, stellar.wave, flux)


def _hg_mode_params(hgphase, wave64):
    """Per-mode (f, g1, g2) of the deck's double Henyey-Greenstein table
    (host arrays (wave, f, g1, g2)), interpolated in float64 to the calc
    grid."""
    hg_wave, hg_f, hg_g1, hg_g2 = (np.asarray(a, dtype=np.float64)
                                   for a in hgphase)
    xp = wave64.new_tensor(hg_wave)
    out = []
    for j in range(hg_f.shape[1]):
        out.append(tuple(interp(wave64, xp, wave64.new_tensor(col[:, j]))
                         for col in (hg_f, hg_g1, hg_g2)))
    return out


def _to_device(device, *objs):
    return tuple(None if o is None else o.to(device) for o in objs)


def _ground(surf, cfg: ForwardConfig):
    """Whether the lower boundary is a surface with its own temperature."""
    return surf is not None and not cfg.gasgiant and float(surf.tsurf) > 0.0


def forward_scattering_nadir(
    atm: Atmosphere,
    laycfg: LayerConfig,
    ktab: KTables,
    cia: Optional[CIATables],
    aero: Optional[AerosolOptics],
    surf: Optional[SurfaceSpec],
    stellar: Optional[StellarSpec],
    cfg: ForwardConfig,
    quad,                # rt.scattering.ScatterQuadrature
    hgphase,             # host (wave, f, g1, g2) per-mode HG params
    emiss_ang, sol_ang, azi_ang,
    iray_phase: bool,
    return_diagnostics: bool = False,
    device=None,
):
    """Nadir multiple-scattering forward evaluation (reference
    calculate_multiple_scattering_spectrum ForwardModel_0.py:4343 +
    scloud11wave wrapper :5018): vertical layer opacities feed the
    adding-doubling core directly (no LOS scaling). Returns (NWAVE, NPATH)
    with one path per (sol, emiss, azi) angle; the structures are moved to
    ``device`` first (None = CUDA; raises without a card unless
    ``device="cpu"``). Spans as ``forward_nadir``'s (``nemesis.forward``
    around the body, ``nemesis.layering``, the layer opacities'), and the
    scattering core's (``rt/scattering.py``)."""
    from archnemesis_tpu_torch.ops.planck import planck
    from archnemesis_tpu_torch.rt.scattering import (
        brdf_fourier_matrix,
        henyey_greenstein2,
        scloud11wave_tiled,
    )
    from archnemesis_tpu_torch.rt.surface import surface_brdf_fn

    with annotate(FORWARD_SPAN):
        device = resolve_device(device)
        atm, ktab, cia, aero, surf, stellar = _to_device(
            device, atm, ktab, cia, aero, surf, stellar)

        with annotate("nemesis.layering"):
            layers = apply_dust_renorm(build_layers(atm, laycfg, layang=0.0),
                                       atm)
        wave = ktab.wave
        taus = layer_optical_depths(cfg, layers, wave, ktab, cia, aero)

        bnu = planck(wave[:, None], layers.temp[None, :],
                     ispace=int(cfg.ispace))
        nmu = quad.nmu
        if _ground(surf, cfg):
            emiss = interp1d_extrap(surf.vem, surf.emissivity, wave)
            radg = (planck(wave, surf.tsurf, ispace=int(cfg.ispace))
                    * emiss)[:, None] * wave.new_ones((1, nmu))
        else:
            radg = bnu[:, 0:1] * wave.new_ones((1, nmu))
        # reflective lower boundary: BRDF Fourier matrix enters the doubling
        # ladder as the bottom layer (reference scloud11wave:5099-5103
        # calc_brdf_matrix for LOWBC != THERMAL; Lambert AND Hapke/Oren-Nayar)
        brdf_matrix = None
        if surf is not None and not cfg.gasgiant and int(surf.lowbc) != 0:
            with annotate("nemesis.scatter.phase"):
                brdf_matrix = brdf_fourier_matrix(
                    surface_brdf_fn(surf, wave), quad, wave.shape[0]
                )

        sol = solar_flux(stellar, wave)

        phase_fns = [
            (lambda c, f=f, g1=g1, g2=g2: henyey_greenstein2(
                c[None], f[:, None, None, None], g1[:, None, None, None],
                g2[:, None, None, None]))
            for f, g1, g2 in _hg_mode_params(hgphase, wave.double())
        ]

        # per-mode scattering fraction (reference wrapper FRAC :5109-5118)
        tauscat = taus["tauscat"]
        tauclscat = taus["tauclscat"]  # (NWAVE, NLAY, NDUST)
        safe = torch.where(tauscat > 0.0, tauscat, 1.0)
        lfrac = torch.where(
            (tauscat > 0.0)[:, :, None], tauclscat / safe[:, :, None], 0.0
        )
        lfrac = lfrac.permute(0, 2, 1)  # (NWAVE, NCONT, NLAY)

        rad = scloud11wave_tiled(
            quad, phase_fns,
            radg=radg,
            brdf_matrix=brdf_matrix,
            sol_ang=sol_ang,
            emiss_ang=emiss_ang,
            azi_ang=azi_ang,
            solar=sol,
            bnu=bnu,
            taus=taus["tautot"],
            tauray=taus["tauray"],
            tauscat=tauscat,
            lfrac=lfrac,
            iray=iray_phase,
            wave_tile=cfg.scat_wave_tile,
        )  # (NWAVE, NG, NPATH)
        spec = torch.einsum("wgp,g->wp", rad, ktab.del_g)
        if return_diagnostics:
            return spec, {"layers": layers, **taus, "rad_g": rad}
        return spec


def forward_singlescat_nadir(
    atm: Atmosphere,
    laycfg: LayerConfig,
    ktab: KTables,
    cia: Optional[CIATables],
    aero: Optional[AerosolOptics],
    surf: Optional[SurfaceSpec],
    stellar: Optional[StellarSpec],
    cfg: ForwardConfig,
    hgphase,            # host (wave, f, g1, g2) per-mode HG params
    emiss_ang, sol_ang, azi_ang,
    iray_phase: bool,
    return_diagnostics: bool = False,
    device=None,
):
    """Nadir single-scattering forward evaluation (reference
    calculate_single_scattering_plane_parallel_spectrum
    ForwardModel_0.py:4251; the path angle is reset to 0 for scattering
    calculations, calc_path :2972-2975, so LOS taus equal vertical taus
    ordered top->bottom). Returns (NWAVE, 1); ``device`` as in
    ``forward_scattering_nadir``."""
    from archnemesis_tpu_torch.rt.singlescat import (
        layer_mean_phase,
        scattering_cos_angle,
        single_scatter_plane_spectrum,
    )
    from archnemesis_tpu_torch.rt.surface import hg_phase2, surface_brdf_fn

    device = resolve_device(device)
    atm, ktab, cia, aero, surf, stellar = _to_device(
        device, atm, ktab, cia, aero, surf, stellar)

    layers = apply_dust_renorm(build_layers(atm, laycfg, layang=0.0), atm)
    wave = ktab.wave
    taus = layer_optical_depths(cfg, layers, wave, ktab, cia, aero)

    def ang(x):
        return wave.new_tensor(float(np.asarray(x).reshape(-1)[0]))

    sol_a, emi_a, azi_a = ang(sol_ang), ang(emiss_ang), ang(azi_ang)
    calpha = scattering_cos_angle(sol_a, emi_a, azi_a)
    theta = torch.rad2deg(torch.arccos(torch.clamp(calpha, -1.0, 1.0)))

    pm = [hg_phase2(theta, g1.to(wave.dtype), g2.to(wave.dtype),
                    f.to(wave.dtype)) / (4.0 * np.pi)
          for f, g1, g2 in _hg_mode_params(hgphase, wave.double())]
    phase_modes = (torch.stack(pm, dim=1) if pm
                   else wave.new_zeros((wave.shape[0], 0)))
    phase_ray = (
        0.75 * (1.0 + calpha**2) / (4.0 * np.pi) * torch.ones_like(wave)
        if iray_phase
        else torch.zeros_like(wave)
    )

    phase_lay = layer_mean_phase(
        phase_modes, phase_ray, taus["tauclscat"], taus["tauray"],
        taus["tauscat"],
    )  # (NWAVE, NLAY)

    tautot = taus["tautot"]
    safe_tau = torch.where(tautot > 0.0, tautot, 1.0)
    omega = torch.where(
        tautot > 0.0,
        (taus["tauray"] + taus["tauscat"])[:, None, :] / safe_tau,
        0.0,
    )  # (NWAVE, NG, NLAY)

    sol = solar_flux(stellar, wave)

    if _ground(surf, cfg):
        emissivity = interp1d_extrap(surf.vem, surf.emissivity, wave)
        tsurf = surf.tsurf
    else:
        emissivity = torch.zeros_like(wave)
        tsurf = -1.0

    if surf is not None and not cfg.gasgiant and int(surf.lowbc) != 0:
        # reference calc_BRDF at the single path geometry (Lambert/Hapke/
        # Oren-Nayar dispatch, Surface_0.py:916)
        brdf = surface_brdf_fn(surf, wave)(sol_a, emi_a, azi_a)[:, 0]
    else:
        brdf = torch.zeros_like(wave)

    # path: vertical taus top->bottom (angle reset to 0)
    spec = single_scatter_plane_spectrum(
        wave, torch.flip(tautot, dims=(2,)), torch.flip(layers.temp, (0,)),
        torch.flip(omega, dims=(2,)), torch.flip(phase_lay, dims=(1,)),
        np.ones(layers.nlay), tsurf, emissivity, brdf, sol,
        float(sol_a), float(emi_a), ispace=int(cfg.ispace),
    )  # (NWAVE, NG)
    out = torch.einsum("wg,g->w", spec, ktab.del_g)[:, None]
    if return_diagnostics:
        return out, {"layers": layers, **taus, "phase_lay": phase_lay}
    return out
