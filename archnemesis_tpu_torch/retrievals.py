"""Top-level retrieval entry points (the reference's ``Retrievals.py``
retrieval_nemesis equivalent for the nadir thermal-emission family).

Port of the JAX package's ``retrievals.py``: builds a pure forward function
spectrum(xn) from a loaded deck (state-vector application, layering,
opacities, RT, ILS convolution, FOV averaging) and runs optimal estimation
with ``torch.func.jacfwd`` Jacobians. Every entry point takes ``device``
(None = the CUDA card; raises without one unless ``device="cpu"``) and
``dtype`` (float64, as the goldens are; ``torch.float32`` is the
counterpart of the JAX package's ``cast_dtype``).

Ported: ISCAT = thermal emission, multiple scattering and plane-parallel
single scattering with nadir and limb FOV points, every instrument function
of the nadir set-up (channel interpolation, the static ILS and filter
weights, the double-Gaussian ILS of models 228-230, filter integration with
a retrieved Doppler shift), the limb (``make_retrieval_setup_limb``),
solar-occultation (``make_retrieval_setup_so``), primary-transit
(``make_retrieval_setup_transit``), combined multi-angle
(``make_retrieval_setup_c``) and disc-averaged
(``make_retrieval_setup_disc``) set-ups, HDF5 run files (or their ``.npz``
export) for the set-ups that read them, with the telluric transmission of
a ground-based run (model 202), LIN 0-3 chaining, resume, nested sampling
(``retrieval_method=1``) and the ``/Retrieval`` output group of an HDF5
run.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from archnemesis_tpu_torch.core.spectra import KTables, cast_deck
from archnemesis_tpu_torch.enums import (
    InstrumentLineshape,
    ScatteringCalculationMode,
    SpectralCalculationMode,
    SpectraUnit,
)
from archnemesis_tpu_torch.forward import (
    disc_ray_chunk,
    forward_disc,
    forward_limb,
    forward_limb_batch,
    forward_nadir,
    forward_scattering_nadir,
    forward_singlescat_nadir,
    forward_so,
    forward_transit,
    make_forward_config,
    so_geometry,
    solar_flux,
)
from archnemesis_tpu_torch.io.hdf5 import load_deck_hdf5
from archnemesis_tpu_torch.io.legacy import Deck, load_deck
from archnemesis_tpu_torch.io.linedata import RuntimeLBL
from archnemesis_tpu_torch.ops.convolution import (
    apply_ils,
    conv_channel_interp,
    conv_quad_weights,
    doppler_corrected_wave,
    double_gauss_ils_weights,
    ils_weights_filter,
    ils_weights_lbl,
    integrate_filter_apply,
    integrate_filter_weights,
    invert_doppler_shift,
)
from archnemesis_tpu_torch.ops.ktab import host_log_ktable
from archnemesis_tpu_torch.retrieval import output as out_mod
from archnemesis_tpu_torch.retrieval.oe import OEResult, coreret_oe
from archnemesis_tpu_torch.rt.scattering import ScatterQuadrature
from archnemesis_tpu_torch.rt.telluric import apply_telluric
from archnemesis_tpu_torch.retrieval.statevector import (
    StateVector,
    apply_domain,
    apply_ils_models,
    apply_spectrum_models,
    apply_state,
    ils_models_present,
    read_apr,
)
from archnemesis_tpu_torch.utils.device import resolve_device
from archnemesis_tpu_torch.utils.interp import interp

_DECK_COMPONENTS = ("atmosphere", "ktables", "cia", "aerosol", "surface",
                    "stellar")


@dataclass
class RetrievalSetup:
    deck: Deck
    sv: StateVector
    forward_fn: Callable  # xn -> concatenated convolved spectrum y(xn)
    y: np.ndarray  # measurement vector
    se: np.ndarray  # measurement covariance (diagonal)
    vconv_list: list
    device: torch.device  # where forward_fn computes (required: no default)
    dtype: torch.dtype = torch.float64


def _windowed_ktab(deck: Deck, wavemin, wavemax, pad_multiple: int = 1) -> KTables:
    """Re-window the deck's tables for a geometry's wave range (the
    reference re-reads tables per geometry, ForwardModel_0.py:479-483;
    here we slice the already-loaded tensors). The bracket is inclusive of
    one grid point beyond each end (Spectroscopy_0.read_tables:1495-1501).

    ``pad_multiple``: widen the window with extra REAL grid points so the
    sliced NWAVE is divisible by it (wave-axis sharding needs equal shards;
    the extra points carry zero ILS weight).
    """
    kt = deck.ktables
    wave = kt.wave.detach().cpu().numpy()
    iwl = max(int(np.searchsorted(wave, wavemin, side="right")) - 1, 0)
    iwh = min(int(np.searchsorted(wave, wavemax, side="left")),
              wave.size - 1)
    if pad_multiple > 1:
        n = iwh - iwl + 1
        extra = (-n) % pad_multiple
        iwh = min(iwh + extra, wave.size - 1)
        n = iwh - iwl + 1
        extra = (-n) % pad_multiple
        iwl = max(iwl - extra, 0)
        if (iwh - iwl + 1) % pad_multiple:
            raise ValueError(
                f"k-table grid too small to pad window to a multiple of "
                f"{pad_multiple}")
    sel = slice(iwl, iwh + 1)
    extra = {}
    if kt.logk is not None:
        extra["logk"] = kt.logk[:, sel]
    return kt.replace(wave=kt.wave[sel], k=kt.k[:, sel], **extra)


def cast_deck_components(deck: Deck, dtype) -> Deck:
    """Cast a loaded deck's floating component structures to ``dtype`` (the
    float32 path): ``core.spectra.cast_deck`` per component, which also
    prescales CIA tables out of the float32 subnormal range and attaches
    the host log-k table before k is truncated. A ``RuntimeLBL`` is not
    cast: its line lists stay float64 on the host, so the float32
    synthesis can split the line centres into two floats."""
    casted = {}
    for name in _DECK_COMPONENTS:
        v = getattr(deck, name)
        if v is None or isinstance(v, RuntimeLBL):
            continue
        casted[name] = cast_deck(v, dtype)
    if deck.telluric is not None:
        tel = deck.telluric
        casted["telluric"] = tel.replace(atm=cast_deck(tel.atm, dtype),
                                         ktables=cast_deck(tel.ktables, dtype))
    return dataclasses.replace(deck, **casted)


def _attach_logk(deck: Deck, dtype) -> Deck:
    """Host-float64 preparation of table data for a float32 run.

    Whenever the run's dtype is float32, two table fixes must have happened
    before anything is truncated:

    - the host-computed log-k table is attached, so the float32 device path
      never takes a log of table values (``ops.ktab.host_log_ktable``);
    - the CIA table is prescaled by its 2**134 balance factor: the raw
      ~1e-45 cm^5 values are SUBNORMAL in float32, and without the prescale
      all CIA opacity is silently lost.
    """
    if torch.finfo(dtype).bits >= 64:
        return deck
    if isinstance(deck.ktables, KTables) and deck.ktables.logk is None:
        logk = host_log_ktable(deck.ktables.k.detach().cpu().numpy())
        deck = dataclasses.replace(
            deck,
            ktables=deck.ktables.replace(
                logk=torch.as_tensor(logk, device=deck.ktables.k.device)),
        )
    if deck.cia is not None:
        deck = dataclasses.replace(deck, cia=deck.cia.prescale())
    return deck


def _deck_to(deck: Deck, device) -> Deck:
    """The deck's tensor structures on ``device``; a ``RuntimeLBL`` stays a
    host structure (its synthesis puts what it needs on the device)."""
    moved = {name: getattr(deck, name).to(device)
             for name in _DECK_COMPONENTS
             if getattr(deck, name) is not None
             and not isinstance(getattr(deck, name), RuntimeLBL)}
    if deck.telluric is not None:
        moved["telluric"] = deck.telluric.to(device)
    return dataclasses.replace(deck, **moved)


def _host_wave(kt) -> np.ndarray:
    """The calc grid of k-tables or of a ``RuntimeLBL`` as host float64."""
    if isinstance(kt, RuntimeLBL):
        return np.asarray(kt.wave, dtype=np.float64)
    return kt.wave.detach().cpu().double().numpy()


def _iform_xfac(iform, atm, stellar, wave):
    """Spectral unit conversion of disc-averaged outputs (reference
    ForwardModel_0.py:4359-4367) on the host grid ``wave``: FluxRatio
    divides the 4*pi*pi*R^2-scaled radiance by the stellar power spectrum;
    Integrated_spectral_power just scales. Returns a float64 array
    (NWAVE,) or a float."""
    radius_cm = float(atm.radius) * 1.0e2
    xfac = np.pi * 4.0 * np.pi * radius_cm**2
    if iform == SpectraUnit.FluxRatio:
        if stellar is None:
            raise ValueError("IFORM=FluxRatio requires a stellar spectrum")
        solpspec = np.interp(
            wave, stellar.wave.detach().cpu().double().numpy(),
            stellar.solspec.detach().cpu().double().numpy())
        return xfac / solpspec
    if iform == SpectraUnit.Integrated_spectral_power:
        return xfac
    return 1.0


def _load_setup_deck(deck_dir: str, runname: str, atm_override, dtype,
                     hdf5: bool = False, deck_file=None) -> Deck:
    """The deck of a set-up in the run's type, on the host:
    ``atm_override`` in place of its atmosphere, the float32 table fixes
    (``_attach_logk``) and the cast.

    ``hdf5``: a set-up whose JAX counterpart reads an HDF5 run file when
    there is one reads ``deck_file`` (None = ``<deck_dir>/<runname>.h5``;
    its ``.npz`` export where h5py is missing), its relative table paths
    resolved against ``deck_dir``, with the ``.apr`` beside the deck;
    where that file is absent, the legacy deck."""
    import os

    if deck_file is None:
        deck_file = os.path.join(deck_dir, runname + ".h5")
    if hdf5 and os.path.exists(deck_file):
        deck = load_deck_hdf5(deck_file, base_dir=deck_dir)
        apr = os.path.join(deck_dir, runname + ".apr")
        if os.path.exists(apr):
            deck = dataclasses.replace(deck, apr_path=os.path.abspath(apr))
    else:
        deck = load_deck(deck_dir, runname)
    if atm_override is not None:
        deck = dataclasses.replace(deck, atmosphere=atm_override)
    return _typed_deck(deck, dtype)


def _typed_deck(deck: Deck, dtype) -> Deck:
    """The float32 table fixes (``_attach_logk``), then the cast."""
    return cast_deck_components(_attach_logk(deck, dtype), dtype)


def _measurement(geom):
    """The measurement vector and its diagonal covariance (reference
    calc_MeasurementVector Measurement_0.py:1423), host float64."""
    y_parts, se_parts = [], []
    for ig in range(geom.ngeom):
        nc = geom.nconv[ig]
        y_parts.append(geom.meas[:nc, ig])
        se_parts.append(geom.errmeas[:nc, ig] ** 2)
    return np.concatenate(y_parts), np.diag(np.concatenate(se_parts))


def _ils_halfwidth(fwhm: float, ishape: InstrumentLineshape) -> float:
    """Half the calc range an ILS of ``fwhm`` needs beyond the channels
    (reference calc_wave_range Measurement_0.py:2044)."""
    if ishape == InstrumentLineshape.Square:
        return 0.5 * fwhm
    if ishape == InstrumentLineshape.Triangular:
        return fwhm
    return 3.0 * 0.5 * fwhm / np.sqrt(np.log(2.0))


def _channel_range(geom):
    """(min, max) channel centre over every geometry."""
    vmin = min(float(geom.vconv[: geom.nconv[ig], ig].min())
               for ig in range(geom.ngeom))
    vmax = max(float(geom.vconv[: geom.nconv[ig], ig].max())
               for ig in range(geom.ngeom))
    return vmin, vmax


def _as_state(xn, dev):
    """``forward_fn``'s state as a tensor: a host array is put on the
    set-up's device in its type."""
    return xn if isinstance(xn, torch.Tensor) else dev(xn)


def _vconv_list(geom):
    return [geom.vconv[: geom.nconv[ig], ig] for ig in range(geom.ngeom)]


def _to_run(dtype, device) -> Callable:
    """A host array as a tensor of the run's type on its device."""
    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return dev


def _shared_window(deck: Deck, geom, st, widen_doppler: bool):
    """One windowed table set over every geometry's channels, widened by
    the ILS support and, where ``widen_doppler``, by the Doppler shift
    (reference calc_wave_range Measurement_0.py:2044, :2113-2115)."""
    vmin, vmax = _channel_range(geom)
    if geom.fwhm > 0.0:
        dv = _ils_halfwidth(geom.fwhm, InstrumentLineshape(st.ishape))
        vmin, vmax = vmin - dv, vmax + dv
    if widen_doppler and st.v_doppler != 0.0:
        lo = invert_doppler_shift(vmin, st.v_doppler, st.ispace)
        hi = invert_doppler_shift(vmax, st.v_doppler, st.ispace)
        vmin, vmax = min(vmin, lo), max(vmax, hi)
    if isinstance(deck.ktables, RuntimeLBL):
        return deck.ktables.windowed(vmin, vmax)
    return _windowed_ktab(deck, vmin, vmax)


def _typed_window(deck: Deck, geom, st, dtype, device, widen_doppler: bool):
    """(the float64 host deck in the run's type on ``device``, its tables
    windowed by ``_shared_window``; the window's host float64 calc grid).
    The window is taken on the float64 grid before the cast, so that both
    types compute on the same waves and the instrument function's weights
    come from the exact grid (a float32 grid near 4,000 cm-1 keeps 0.5e-3
    cm-1, and a 0.16 cm-1 Gaussian ILS sampled there is 3e-4 off)."""
    ktw = _shared_window(deck, geom, st, widen_doppler=widen_doppler)
    wave_host = _host_wave(ktw)
    deck = dataclasses.replace(deck, ktables=ktw)
    return _deck_to(_typed_deck(deck, dtype), device), wave_host


def _ils_weights(geom, st, wave, vconv, intfilter: bool, ktab_quad: bool,
                 fwh=None):
    """One geometry's static instrument function on the host calc grid
    ``wave`` (observer frame) as a host float64 (NCONV, NWAVE) matrix, or
    None for channel interpolation (FWHM=0). ``intfilter``: IFORM=
    Integrated_radiance integrates the .fil filters (reference nemesisfm
    ForwardModel_0.py:556-559). ``ktab_quad``: FWHM>0 in k-table mode is
    the conv() spline quadrature, with the per-channel FWHM of the .fwh
    table ``fwh``; otherwise FWHM>0 takes the lineshape weights. FWHM<0
    takes the .fil filters."""
    vconv = np.asarray(vconv)
    if intfilter and st.iform == SpectraUnit.Integrated_radiance:
        if geom.nfil is None:
            raise ValueError("IFORM=Integrated_radiance requires a .fil "
                             "filter file")
        return integrate_filter_weights(wave, vconv, geom.nfil, geom.vfil,
                                        geom.afil)
    if geom.fwhm > 0.0:
        if ktab_quad and st.ilbl == SpectralCalculationMode.K_TABLES:
            vf, xf = fwh if fwh is not None else (None, None)
            return conv_quad_weights(wave, vconv, geom.fwhm, vfwhm=vf,
                                     xfwhm=xf)
        return ils_weights_lbl(wave, vconv, geom.fwhm,
                               InstrumentLineshape(st.ishape))
    if geom.fwhm < 0.0 and geom.nfil is not None:
        return ils_weights_filter(wave, vconv, geom.nfil, geom.vfil,
                                  geom.afil)
    return None


def _convolve(wave, spec, ils_w, vconv):
    """One geometry's spectrum on the calc grid ``wave`` through its
    static instrument function: the weight matrix ``ils_w``, or channel
    interpolation at ``vconv`` where it is None."""
    if ils_w is None:
        return conv_channel_interp(wave, spec, vconv)
    return apply_ils(ils_w, spec)


def _convolve_geoms(sv, xn, spec, ils, vconvs, wave):
    """Column ig of ``spec`` (NWAVE, NGEOM) through geometry ig's static
    instrument function (``ils[ig]``, channel centres ``vconvs[ig]`` on
    the device) and the spectrum-domain models, concatenated."""
    return torch.cat([
        apply_spectrum_models(sv, xn, ig, vconv,
                              _convolve(wave, spec[:, ig], ils[ig], vconv))
        for ig, vconv in enumerate(vconvs)])


def _setup(deck: Deck, sv, geom, forward_fn, device, dtype
           ) -> RetrievalSetup:
    y, se = _measurement(geom)
    return RetrievalSetup(
        deck=deck, sv=sv, forward_fn=forward_fn, y=y, se=se,
        vconv_list=_vconv_list(geom), device=device, dtype=dtype,
    )


def make_retrieval_setup(
    deck_dir: str, runname: str, atm_override=None, sv_override=None,
    wave_pad_multiple: int = 1, ktab_transform=None,
    device=None, dtype=torch.float64, deck_file=None,
) -> RetrievalSetup:
    """Build the retrieval setup for a nadir deck: thermal emission
    (ISCAT=0), multiple scattering (1) or plane-parallel single scattering
    (3).

    ``deck_file``: an HDF5 run file (or its ``.npz`` export) to read in
    place of the legacy deck, its relative table locations resolved
    against ``deck_dir`` and the ``.apr`` beside the deck; None reads the
    legacy deck. A run file's ``Telluric`` group multiplies each
    geometry's FOV-averaged calc-grid spectrum by the Earth's transmission
    (``rt/telluric.py``), with model 202 retrieving its profiles.

    ``atm_override`` replaces the deck's reference atmosphere (LIN=1/3
    chaining bakes the previous retrieval's state into the base profiles,
    reference Retrievals.py:190-196). ``sv_override`` swaps the state
    vector the forward function applies (used to linearise around a
    previous retrieval's variables, the reference's FM_prev).

    ``wave_pad_multiple`` / ``ktab_transform``: hooks of the wave-sharded
    path: pad each geometry's windowed calc grid to a shardable length and
    apply a placement transform to the windowed tables before the forward
    closure captures them (``parallel.mesh.shard_ktables_by_wave`` for
    k-tables, ``parallel.sharded.shard_runtime_lbl`` for a runtime
    line-by-line deck; the forward then gathers each spectrum before the
    instrument function).

    ``device`` (None = the CUDA card; raises without one) is where the
    deck's tensors live and ``forward_fn`` computes; ``dtype`` is the run's
    floating type (float32 goes through ``cast_deck_components`` and the
    table fixes of ``_attach_logk``). ``forward_fn`` takes ``xn`` as a
    tensor there, or a host array that is put there."""
    device = resolve_device(device)
    deck = _load_setup_deck(deck_dir, runname, atm_override, dtype,
                            hdf5=deck_file is not None, deck_file=deck_file)
    st = deck.settings
    iscat = ScatteringCalculationMode(deck.settings.iscat)
    multiple = iscat == ScatteringCalculationMode.MULTIPLE_SCATTERING
    single = (iscat
              == ScatteringCalculationMode.SINGLE_SCATTERING_PLANE_PARALLEL)
    if iscat != ScatteringCalculationMode.THERMAL_EMISSION and not (
            multiple or single):
        raise NotImplementedError(
            f"ISCAT={iscat!r}: only thermal emission, multiple scattering "
            "and plane-parallel single scattering are retrieval modes "
            "(the reference's other modes are diagnostic flux "
            "calculations, ForwardModel_0.py:4338-4341)")
    flux_units = (SpectraUnit.FluxRatio,
                  SpectraUnit.Integrated_spectral_power)
    if deck.settings.iform not in (
        SpectraUnit.Radiance,
        SpectraUnit.Normalised_radiance,
        SpectraUnit.Integrated_radiance,
    ) and not (multiple and deck.settings.iform in flux_units):
        # FluxRatio / Integrated_spectral_power of multiple scattering:
        # DELIBERATE DEVIATION (PARITY.md), as in the JAX package: the
        # reference's calculate_multiple_scattering_spectrum computes the
        # 4*pi^2*R^2 (/ stellar power) xfac but never multiplies SPECOUT by
        # it (dead code, ForwardModel_0.py:4360-4373); the physically
        # intended scaling is applied below on the calc grid. The units of
        # the disc set-up, TransitDepth (transit set-up) and
        # Atmospheric_transmission (SO set-up) come with the other
        # geometries
        raise NotImplementedError(
            f"IFORM={deck.settings.iform!r} is not a nadir radiance unit: "
            "Atmospheric_transmission is make_retrieval_setup_so's, "
            "TransitDepth make_retrieval_setup_transit's"
        )
    if (deck.settings.iform == SpectraUnit.Normalised_radiance
            and deck.settings.vnorm is None):
        raise ValueError("IFORM=Normalised_radiance requires VNORM "
                         "(reference Measurement_0.assess:344)")
    sv = (
        sv_override
        if sv_override is not None
        else read_apr(deck.apr_path, deck.atmosphere)
    )
    geom = deck.geometry
    if (float(np.min(geom.emiss_ang)) < 0.0
            and iscat != ScatteringCalculationMode.THERMAL_EMISSION):
        raise NotImplementedError(
            "limb geometries with scattering are not wired (the reference "
            "nemesisfm computes limb paths in thermal emission only)")

    deck = _deck_to(deck, device)
    dev = _to_run(dtype, device)

    # per-geometry static setup; model 447 retrieves the Doppler velocity,
    # so the observer-frame grid becomes a function of the state
    has_447 = any(e.model_id == 447 for e in sv.entries)
    geoms = []
    for ig in range(geom.ngeom):
        nc = geom.nconv[ig]
        vconv = geom.vconv[:nc, ig]
        if st.iform == SpectraUnit.Integrated_radiance:
            # filter integration replaces ILS convolution entirely
            # (reference nemesisfm ForwardModel_0.py:556-559)
            if geom.nfil is None:
                raise ValueError("IFORM=Integrated_radiance requires a .fil "
                                 "filter file (FWHM<0)")
            wavemin = geom.vfil[0, :].min()
            wavemax = max(geom.vfil[geom.nfil[j] - 1, j]
                          for j in range(geom.nfil.shape[0]))
            ils_w = "intfilter"
        elif geom.fwhm == 0.0:
            wavemin, wavemax = vconv[0], vconv[-1]
            ils_w = None
        elif geom.fwhm > 0.0:
            # ILS support (reference calc_wave_range Measurement_0.py:2044)
            dv = _ils_halfwidth(geom.fwhm, InstrumentLineshape(st.ishape))
            wavemin, wavemax = vconv[0] - dv, vconv[-1] + dv
            ils_w = True
        else:
            # FWHM<0: per-channel filters, tabulated (.fil) or the
            # differentiable double-Gaussian ILS models 228/229/230
            # (reference calc_wave_range Measurement_0.py:2090-2105)
            if ils_models_present(sv):
                vc_a, off_a, fw_a, _ = (
                    v.numpy() for v in apply_ils_models(
                        sv, sv.xa, ig, torch.as_tensor(vconv),
                        vconv_host=vconv)
                )
                half = 2.5 * fw_a.max() + np.abs(off_a).max()
                wavemin = vc_a.min() - 1.5 * half
                wavemax = vc_a.max() + 1.5 * half
                ils_w = "dynamic"
            elif geom.nfil is not None:
                wavemin = geom.vfil[0, :].min()
                wavemax = max(
                    geom.vfil[geom.nfil[j] - 1, j]
                    for j in range(geom.nfil.shape[0])
                )
                ils_w = "filter"
            else:
                raise ValueError("FWHM<0 requires a .fil file or an ILS model")
        if has_447 and ils_w not in (None, "dynamic", "intfilter"):
            raise NotImplementedError(
                "model 447 (retrieved Doppler) needs a differentiable "
                "convolution path: FWHM=0, ILS models 228/229/230, or "
                "IFORM=Integrated_radiance")
        # a Doppler shift widens the needed rest-frame calc range
        # (reference calc_wave_range Measurement_0.py:2113-2115)
        if st.v_doppler != 0.0:
            lo = invert_doppler_shift(wavemin, st.v_doppler, st.ispace)
            hi = invert_doppler_shift(wavemax, st.v_doppler, st.ispace)
            wavemin, wavemax = min(wavemin, lo), max(wavemax, hi)
        if isinstance(deck.ktables, RuntimeLBL):
            # the lines inside the geometry's range, blocked on the full
            # calc grid (reference Spectroscopy_0.py:1468-1485)
            ktw = deck.ktables.windowed(wavemin, wavemax)
        else:
            ktw = _windowed_ktab(deck, wavemin, wavemax,
                                 pad_multiple=wave_pad_multiple)
        # ILS weight matrices live on the observer-frame (Doppler-corrected)
        # calc grid (reference conv/lblconv correct Wave first,
        # Measurement_0.py:2149): the whole grid, taken before a sharding
        # transform cuts the tables to this rank's waves (the forward
        # gathers the whole spectrum)
        wave_host = _host_wave(ktw)
        if ktab_transform is not None:
            ktw = ktab_transform(ktw)
        wavecorr = doppler_corrected_wave(wave_host, st.v_doppler, st.ispace)
        if ils_w is True or ils_w == "filter" or (ils_w == "intfilter"
                                                   and not has_447):
            ils_w = dev(_ils_weights(geom, st, wavecorr, vconv,
                                     intfilter=True, ktab_quad=True,
                                     fwh=deck.fwh))
        # multiple scattering's FluxRatio / Integrated_spectral_power unit
        # conversion on the calc grid (ForwardModel_0.py:4360-4373)
        xfac_g = (dev(_iform_xfac(st.iform, deck.atmosphere, deck.stellar,
                                  wave_host))
                  if st.iform in flux_units else 1.0)
        # the rest-frame calc grid of the telluric transmission
        wave_rest = dev(wave_host) if deck.telluric is not None else None
        # the channel centres and the calc grid on the device once: the
        # observer-frame grid where the state does not move it, else the
        # rest-frame grid, corrected per evaluation (model 447)
        geoms.append((ig, vconv, dev(vconv), ktw, wave_host,
                      dev(wave_host if has_447 else wavecorr), ils_w,
                      xfac_g, wave_rest))

    cfg = make_forward_config(
        deck.atmosphere,
        deck.ktables,
        deck.cia,
        iray=deck.settings.iray,
        ispace=deck.settings.ispace,
        gasgiant=deck.surface.gasgiant,
    )

    quad = (ScatterQuadrature(mu=st.mu, wtmu=st.wtmu, nf=st.nf,
                              nphi=st.nphi) if multiple else None)

    def nadir_spectrum(atm, ktw, cia_x, aero, surf, ig, iav):
        angles = dict(emiss_ang=geom.emiss_ang[ig, iav],
                      sol_ang=geom.sol_ang[ig, iav],
                      azi_ang=geom.azi_ang[ig, iav])
        if multiple:
            spec = forward_scattering_nadir(
                atm, deck.layer_config, ktw, cia_x, aero, surf,
                deck.stellar, cfg, quad, deck.hgphase,
                iray_phase=st.iray > 0, device=device, **angles)
        elif single:
            spec = forward_singlescat_nadir(
                atm, deck.layer_config, ktw, cia_x, aero, surf,
                deck.stellar, cfg, deck.hgphase,
                iray_phase=st.iray > 0, device=device, **angles)
        else:
            spec = forward_nadir(atm, deck.layer_config, ktw, cia_x, aero,
                                 surf, cfg, device=device, **angles)
        return spec[:, 0]

    # the aerosol grid on the host, for the scatter-domain models
    aero_wave = (None if deck.aerosol is None
                 else deck.aerosol.wave.detach().cpu().double().numpy())
    cia = deck.cia
    cia_range = cia_waven = None
    if cia is not None:
        cia_waven = cia.waven.detach().cpu().double().numpy()
        # spectroscopy wave range in cm-1 for CIA-domain models
        # (reference model_500 hook, model_500.py:185-196)
        tw = _host_wave(deck.ktables)
        cia_range = (
            (float(tw.min()), float(tw.max()))
            if int(st.ispace) == 0
            else (1.0e4 / float(tw.max()), 1.0e4 / float(tw.min()))
        )

    def forward_fn(xn):
        xn = _as_state(xn, dev)
        atm = apply_state(deck.atmosphere, xn, sv)
        surf = apply_domain(sv, xn, "surface", deck.surface)
        aero = (
            apply_domain(sv, xn, "scatter", deck.aerosol,
                         ispace=int(st.ispace), wave_host=aero_wave)
            if deck.aerosol is not None
            else None
        )
        cia_x = (apply_domain(sv, xn, "cia", cia, wave_range=cia_range,
                              waven_host=cia_waven)
                 if cia is not None else None)
        # measurement-domain models (447: retrieved Doppler velocity)
        v_dop = (apply_domain(sv, xn, "measurement",
                              {"v_doppler": st.v_doppler})["v_doppler"]
                 if has_447 else st.v_doppler)
        # the Earth's atmosphere of a ground-based run, with its models
        # (202) applied inside the differentiated map
        telluric = (apply_domain(sv, xn, "telluric", deck.telluric)
                    if deck.telluric is not None else None)
        out = []
        for (ig, vconv, vconv_dev, ktw, wave_host, wave_dev, ils_w,
             xfac_g, wave_rest) in geoms:
            spec_sum = 0.0
            iavs = range(geom.nav[ig])
            for iav in iavs:
                if geom.emiss_ang[ig, iav] >= 0.0:
                    spec = nadir_spectrum(atm, ktw, cia_x, aero, surf, ig,
                                          iav)
                    spec_sum = spec_sum + geom.wgeom[ig, iav] * spec
            # limb FOV points (EMISS_ANG < 0) after the nadir ones, each
            # re-layered at its tangent height SOL_ANG (km)
            for iav in iavs:
                if geom.emiss_ang[ig, iav] < 0.0:
                    spec = forward_limb(
                        atm, deck.layer_config, ktw, cia_x, aero, cfg,
                        tanhe_km=geom.sol_ang[ig, iav], device=device)[:, 0]
                    spec_sum = spec_sum + geom.wgeom[ig, iav] * spec
            # NOTE: the reference accumulates WGEOM-weighted spectra
            # WITHOUT dividing by the weight total (nemesisfm
            # ForwardModel_0.py:530-535; FOV weights are pre-normalised)
            spec_sum = spec_sum * xfac_g
            if telluric is not None:
                # on the rest-frame calc grid, corrected for the target's
                # Doppler shift inside (ForwardModel_0.py:538-552)
                spec_sum = apply_telluric(
                    telluric, wave_rest, spec_sum,
                    v_doppler=st.v_doppler, ispace=st.ispace)
            vconv_out = vconv_dev
            # observer-frame calc grid (reference corrects Wave by the
            # Doppler shift inside conv/lblconv, Measurement_0.py:2149);
            # differentiable in v_dop when model 447 retrieves it
            wave_obs = (doppler_corrected_wave(wave_dev, v_dop, st.ispace)
                        if has_447 else wave_dev)
            if ils_w is None or isinstance(ils_w, torch.Tensor):
                conv = _convolve(wave_obs, spec_sum, ils_w, vconv_dev)
            elif ils_w == "dynamic":
                vconv_out, off, fw, amp = apply_ils_models(
                    sv, xn, ig, vconv_dev, vconv_host=vconv)
                conv = apply_ils(double_gauss_ils_weights(
                    wave_obs, vconv_out, off, fw, amp), spec_sum)
            else:  # "intfilter" with a retrieved Doppler shift
                conv = integrate_filter_apply(
                    wave_host, spec_sum, geom.nfil, geom.vfil, geom.afil,
                    v_doppler=v_dop, ispace=st.ispace,
                    v_doppler_nominal=st.v_doppler)
            if st.iform == SpectraUnit.Normalised_radiance:
                # normalise to the radiance at VNORM (reference nemesisfm
                # ForwardModel_0.py:581-583)
                vnorm = dev(st.vnorm)
                conv = conv / interp(vnorm, vconv_out, conv, left=conv[0],
                                     right=conv[-1])
            out.append(apply_spectrum_models(sv, xn, ig, vconv_out, conv))
        return torch.cat(out)

    return _setup(deck, sv, geom, forward_fn, device, dtype)


def make_retrieval_setup_limb(
    deck_dir: str, runname: str, atm_override=None, sv_override=None,
    device=None, dtype=torch.float64, deck_file=None,
) -> RetrievalSetup:
    """Limb thermal-emission retrieval set-up (reference nemesisLfm,
    ForwardModel_0.py:1254 + calc_path_L :3375): one layering for every
    tangent height, every tangent emission path through one
    ``layer_optical_depths`` (``forward_limb_batch``), the tangent-height
    stencil to the measured TANHE, then each geometry's ILS (or filter
    integration for IFORM=Integrated_radiance) on one shared calc grid.
    ``device`` and ``dtype`` as in ``make_retrieval_setup``; an HDF5 run
    file is read as ``_load_setup_deck`` says (``deck_file``)."""
    return _tangent_setup(deck_dir, runname, atm_override, sv_override,
                          device, dtype, deck_file, occultation=False)


def make_retrieval_setup_so(
    deck_dir: str, runname: str, atm_override=None, sv_override=None,
    device=None, dtype=torch.float64, deck_file=None,
) -> RetrievalSetup:
    """Solar-occultation (limb transmission) retrieval set-up (reference
    nemesisSOfm, ForwardModel_0.py:783): one layering for every tangent
    height with the layer heights frozen (``adjust_hydrostat=False``,
    ForwardModel_0.py:855), every tangent path through one
    ``layer_optical_depths`` (``forward_so``), the tangent-height stencil
    (model 777 through ``apply_domain``), the solar flux for
    IFORM=Atmospheric_transmission, then each geometry's ILS on one shared
    calc grid. ``device``, ``dtype`` and ``deck_file`` as in
    ``make_retrieval_setup_limb``."""
    return _tangent_setup(deck_dir, runname, atm_override, sv_override,
                          device, dtype, deck_file, occultation=True)


def _tangent_setup(deck_dir, runname, atm_override, sv_override, device,
                   dtype, deck_file, occultation: bool) -> RetrievalSetup:
    """The limb (thermal emission) and solar-occultation (transmission)
    set-ups: they differ in the path physics, the stencil's bracket
    (nemesisLfm's, ``so_geometry(lfm_bracket=True)``), the solar flux and
    the filter integration, which only the limb takes."""
    what = "SO" if occultation else "limb"
    device = resolve_device(device)
    deck = _load_setup_deck(deck_dir, runname, atm_override, torch.float64,
                            hdf5=True, deck_file=deck_file)
    st = deck.settings
    geom = deck.geometry
    if geom.tanhe is None:
        raise ValueError(f"{what} retrieval needs tangent heights (TANHE, "
                         "i.e. EMISS_ANG<0 in the .spx)")
    tanhe = np.asarray(geom.tanhe)
    if tanhe.ndim == 2:  # (NGEOM, NAV) -> one tangent height per geometry
        tanhe = tanhe[:, 0]

    sv = (sv_override if sv_override is not None
          else read_apr(deck.apr_path, deck.atmosphere))
    # the stencil from the unperturbed layering in float64, whatever the
    # run's type, so that both types take the same tangent paths
    geo = so_geometry(deck.atmosphere, deck.layer_config, tanhe,
                      lfm_bracket=not occultation)
    # one calc range over every geometry (nemesisSOfm and nemesisLfm build
    # the ILS and the wave range once, ForwardModel_0.py:918-923,
    # :1282-1288)
    deck, wave_host = _typed_window(deck, geom, st, dtype, device,
                                    widen_doppler=True)
    ktw = deck.ktables
    has_447 = any(e.model_id == 447 for e in sv.entries)
    has_777 = any(e.model_id == 777 for e in sv.entries)
    dev = _to_run(dtype, device)
    wavecorr = doppler_corrected_wave(wave_host, st.v_doppler, st.ispace)
    ils = [_ils_weights(geom, st, wavecorr, vc, intfilter=not occultation,
                        ktab_quad=False) for vc in _vconv_list(geom)]
    ils = [None if w is None else dev(w) for w in ils]
    if has_447 and any(w is not None for w in ils):
        # static weights freeze the Doppler correction at st.v_doppler; a
        # retrieved 447 velocity would be a silent no-op (reference
        # conv/lblconv re-correct Wave per call, Measurement_0.py:2149)
        raise NotImplementedError(
            f"model 447 (retrieved Doppler) in an {what} run needs the "
            "differentiable convolution path (FWHM=0 channel "
            "interpolation); FWHM>0 / .fil / filter-integration weights "
            "are static")

    cfg = make_forward_config(deck.atmosphere, ktw, deck.cia, iray=st.iray,
                              ispace=st.ispace, gasgiant=True)
    solflux = None
    if occultation and st.iform == SpectraUnit.Atmospheric_transmission:
        if deck.stellar is None:
            raise ValueError("IFORM=Atmospheric_transmission requires a "
                             "stellar spectrum")
        solflux = solar_flux(deck.stellar, ktw.wave)
    wave_dev = dev(wave_host if has_447 else wavecorr)
    vconvs = [dev(vc) for vc in _vconv_list(geom)]

    def forward_fn(xn):
        xn = _as_state(xn, dev)
        atm = apply_state(deck.atmosphere, xn, sv, adjust_hydrostat=False)
        meas = apply_domain(sv, xn, "measurement",
                            {"v_doppler": st.v_doppler, "tanhe_shift": 0.0})
        shift = meas["tanhe_shift"] if has_777 else None
        if occultation:
            spec = forward_so(
                atm, deck.layer_config, ktw, deck.cia, deck.aerosol, cfg,
                geo, tanhe_shift=shift, solflux=solflux, device=device)
        else:
            spec = forward_limb_batch(
                atm, deck.layer_config, ktw, deck.cia, deck.aerosol, cfg,
                geo, tanhe_shift=shift, device=device)  # (NWAVE, NGEOM)
        # observer-frame grid, differentiable in the velocity for model
        # 447 (reference lblconv corrects Wave first, Measurement_0.py:2149)
        wave_obs = (doppler_corrected_wave(wave_dev, meas["v_doppler"],
                                           st.ispace)
                    if has_447 else wave_dev)
        return _convolve_geoms(sv, xn, spec, ils, vconvs, wave_obs)

    return _setup(deck, sv, geom, forward_fn, device, dtype)


def make_retrieval_setup_transit(
    deck_dir: str, runname: str, atm_override=None, sv_override=None,
    device=None, dtype=torch.float64, deck_file=None,
) -> RetrievalSetup:
    """Primary-transit retrieval set-up (reference nemesisPTfm,
    ForwardModel_0.py:1838): IFORM=TransitDepth, limb transmission over
    every layer base in one ``layer_optical_depths`` (``forward_transit``),
    the annulus trapezoid integral, then each geometry's ILS. The
    hydrostatic rebalance stays ON inside the differentiated state map
    (ForwardModel_0.py:1899). ``device``, ``dtype`` and ``deck_file`` as in
    ``make_retrieval_setup_limb``."""
    device = resolve_device(device)
    deck = _load_setup_deck(deck_dir, runname, atm_override, torch.float64,
                            hdf5=True, deck_file=deck_file)
    st = deck.settings
    if st.iform != SpectraUnit.TransitDepth:
        raise ValueError(
            "transit retrievals need IFORM=TransitDepth "
            "(reference nemesisPTfm check, ForwardModel_0.py:1882)")
    if deck.stellar is None or float(deck.stellar.radius) <= 0:
        raise ValueError("transit retrievals need a stellar radius")
    geom = deck.geometry
    sv = (sv_override if sv_override is not None
          else read_apr(deck.apr_path, deck.atmosphere))
    deck, wave_host = _typed_window(deck, geom, st, dtype, device,
                                    widen_doppler=True)
    ktw = deck.ktables
    cfg = make_forward_config(deck.atmosphere, ktw, deck.cia, iray=st.iray,
                              ispace=st.ispace, gasgiant=True)
    dev = _to_run(dtype, device)
    # the lineshape weights for FWHM > 0 on the rest-frame grid, else
    # channel interpolation, as the JAX package's transit set-up takes them
    ils = [dev(ils_weights_lbl(wave_host, vc, geom.fwhm,
                               InstrumentLineshape(st.ishape)))
           if geom.fwhm > 0.0 else None for vc in _vconv_list(geom)]
    # StellarSpec.radius is in km (reference Stellar_0: "Radius of the
    # star (km)")
    r_star_km = float(deck.stellar.radius)
    wave_dev = dev(wave_host)
    vconvs = [dev(vc) for vc in _vconv_list(geom)]

    def forward_fn(xn):
        xn = _as_state(xn, dev)
        atm = apply_state(deck.atmosphere, xn, sv, adjust_hydrostat=True)
        depth = forward_transit(atm, deck.layer_config, ktw, deck.cia,
                                deck.aerosol, cfg, stellar_radius_km=r_star_km,
                                device=device)
        # the one depth spectrum serves every geometry
        return _convolve_geoms(sv, xn, depth[:, None].expand(-1, len(ils)),
                               ils, vconvs, wave_dev)

    return _setup(deck, sv, geom, forward_fn, device, dtype)


def make_retrieval_setup_c(
    deck_dir: str, runname: str, atm_override=None, sv_override=None,
    device=None, dtype=torch.float64, deck_file=None,
) -> RetrievalSetup:
    """Combined multi-angle scattering set-up (reference nemesisCfm
    ForwardModel_0.py:1526 + calc_path_C :3571): an up- or down-looking
    instrument observing one atmosphere and surface at NGEOM viewing
    angles. One layering and one adding-doubling evaluation serve every
    geometry: the geometries' (emiss, sol, azi) angles are one path batch
    of ``forward_scattering_nadir``. ``device``, ``dtype`` and
    ``deck_file`` as in ``make_retrieval_setup_limb``."""
    device = resolve_device(device)
    deck = _load_setup_deck(deck_dir, runname, atm_override, dtype,
                            hdf5=True, deck_file=deck_file)
    st = deck.settings
    geom = deck.geometry
    if ScatteringCalculationMode(st.iscat) != (
            ScatteringCalculationMode.MULTIPLE_SCATTERING):
        raise ValueError(
            "nemesisC requires ISCAT=MULTIPLE_SCATTERING "
            "(reference calc_path_C check, ForwardModel_0.py:3628)")
    emi = np.asarray(geom.emiss_ang[:, 0])
    if not (np.all(emi > 90.0) or np.all((emi >= 0.0) & (emi < 90.0))):
        raise ValueError(
            "nemesisC geometries must all be upward-looking (>90) or all "
            "downward-looking (<90) (ForwardModel_0.py:3619-3624)")
    if np.any(np.asarray(geom.nav) > 1):
        raise ValueError("nemesisC allows one FOV point per geometry "
                         "(ForwardModel_0.py:3633-3635)")

    sv = (sv_override if sv_override is not None
          else read_apr(deck.apr_path, deck.atmosphere))
    deck = _deck_to(deck, device)

    # one calc range and one windowed table set over every geometry
    # (nemesisCfm takes no Doppler shift)
    ktw = _shared_window(deck, geom, st, widen_doppler=False)
    dev = _to_run(dtype, device)
    wave_host = _host_wave(ktw)
    ils = [_ils_weights(geom, st, wave_host, vc, intfilter=False,
                        ktab_quad=True) for vc in _vconv_list(geom)]
    ils = [None if w is None else dev(w) for w in ils]

    cfg = make_forward_config(deck.atmosphere, ktw, deck.cia, iray=st.iray,
                              ispace=st.ispace,
                              gasgiant=deck.surface.gasgiant)
    quad = ScatterQuadrature(mu=st.mu, wtmu=st.wtmu, nf=st.nf, nphi=st.nphi)
    angles = {k: np.asarray(getattr(geom, k)[:, 0], dtype=np.float64)
              for k in ("emiss_ang", "sol_ang", "azi_ang")}
    aero_wave = (None if deck.aerosol is None
                 else deck.aerosol.wave.detach().cpu().double().numpy())
    wave_dev = dev(wave_host)
    vconvs = [dev(vc) for vc in _vconv_list(geom)]

    def forward_fn(xn):
        xn = _as_state(xn, dev)
        atm = apply_state(deck.atmosphere, xn, sv)
        surf = apply_domain(sv, xn, "surface", deck.surface)
        aero = (apply_domain(sv, xn, "scatter", deck.aerosol,
                             ispace=int(st.ispace), wave_host=aero_wave)
                if deck.aerosol is not None else None)
        spec = forward_scattering_nadir(
            atm, deck.layer_config, ktw, deck.cia, aero, surf,
            deck.stellar, cfg, quad, deck.hgphase,
            iray_phase=st.iray > 0, device=device,
            **angles)  # (NWAVE, NGEOM)
        return _convolve_geoms(sv, xn, spec, ils, vconvs, wave_dev)

    return _setup(deck, sv, geom, forward_fn, device, dtype)


def make_retrieval_setup_disc(
    deck_dir: str, runname: str, nmu: int = 5, phase: float = 0.0,
    atm_override=None, sv_override=None, device=None, dtype=torch.float64,
) -> RetrievalSetup:
    """Disc-averaged retrieval set-up (reference nemesisdiscfm,
    ForwardModel_0.py:1609 + calc_avepoints_exoplanet
    Measurement_0.py:1680): the quadrature's rays as batches of nadir
    paths over one layering and one set of layer optical depths
    (``forward_disc``), the IFORM FluxRatio / Integrated_spectral_power
    unit conversion on the calc grid. The rays go in batches that keep
    each (NWAVE, NG, NLAY, rays) block of a Jacobian's tangents within
    ``forward.DISC_BLOCK_BYTES`` (``forward.disc_ray_chunk``). ``device``
    and ``dtype`` as in ``make_retrieval_setup``."""
    from archnemesis_tpu_torch.rt.disc import disc_quadrature

    device = resolve_device(device)
    deck = _load_setup_deck(deck_dir, runname, atm_override, dtype)
    st = deck.settings
    geom = deck.geometry
    sv = (sv_override if sv_override is not None
          else read_apr(deck.apr_path, deck.atmosphere))
    deck = _deck_to(deck, device)

    vmin, vmax = _channel_range(geom)
    ktw = _windowed_ktab(deck, vmin, vmax)
    wave_host = _host_wave(ktw)
    quad = disc_quadrature(nmu=nmu, phase=phase)
    ray_chunk = disc_ray_chunk(ktw.k.shape[1], len(ktw.del_g),
                               deck.layer_config.nlay, sv.nx,
                               torch.finfo(dtype).bits // 8)
    dev = _to_run(dtype, device)
    xfac = dev(_iform_xfac(st.iform, deck.atmosphere, deck.stellar,
                           wave_host))
    cfg = make_forward_config(deck.atmosphere, ktw, deck.cia, iray=st.iray,
                              ispace=st.ispace,
                              gasgiant=deck.surface.gasgiant)
    wave_dev = dev(wave_host)
    vconvs = [dev(vc) for vc in _vconv_list(geom)]
    ils = [None] * len(vconvs)  # channel interpolation

    def forward_fn(xn):
        xn = _as_state(xn, dev)
        atm = apply_state(deck.atmosphere, xn, sv)
        surf = apply_domain(sv, xn, "surface", deck.surface)
        spec = forward_disc(
            atm, deck.layer_config, ktw, deck.cia, deck.aerosol, surf,
            cfg, quad, ray_chunk=ray_chunk, device=device) * xfac
        # the one disc spectrum serves every geometry
        return _convolve_geoms(sv, xn, spec[:, None].expand(-1, len(ils)),
                               ils, vconvs, wave_dev)

    return _setup(deck, sv, geom, forward_fn, device, dtype)


def run_retrieval(
    deck_dir: str,
    runname: str,
    niter: Optional[int] = None,
    philimit: Optional[float] = None,
    verbose: bool = False,
    device=None,
    dtype=torch.float64,
) -> tuple[RetrievalSetup, OEResult]:
    """Full OE retrieval on a legacy deck (reference retrieval_nemesis,
    Retrievals.py:31)."""
    setup = make_retrieval_setup(deck_dir, runname, device=device,
                                 dtype=dtype)
    st = setup.deck.settings
    res = coreret_oe(
        setup.forward_fn,
        setup.sv.xa,
        setup.sv.sa,
        setup.y,
        setup.se,
        setup.sv.lx,
        niter=niter if niter is not None else max(st.niter, 0),
        philimit=philimit if philimit is not None else st.philimit,
        verbose=verbose,
        device=setup.device,
        dtype=dtype,
    )
    return setup, res


def _match_prev_entries(sv, prev, atm):
    """Match .pre varidents against the current state vector's entries.

    Returns [(pre_entry, current_entry_or_None, prev_offset)] in .pre
    order.  A previous variable with a current counterpart reuses that
    entry (re-offset to the .pre layout); an UNMATCHED one is
    reconstructed from its (varident, varparam) bookmark exactly as the
    reference rebuilds Variables_prev in Files.read_pre:1623 via each
    model's from_bookmark (Retrievals.py:171-290 then chains it).
    """
    from archnemesis_tpu_torch.models.base import entry_from_varparam

    by_vid = {e.varident: e for e in sv.entries}
    ctx = dict(npro=atm.np_, gas_id=atm.gas_id, iso_id=atm.iso_id,
               ndust=atm.ndust)
    matched, ix2 = [], 0
    for i, vid in enumerate(prev["varidents"]):
        cur = by_vid.get(tuple(vid))
        if cur is not None:
            pe = dataclasses.replace(cur, ix=ix2)
        else:
            pe = entry_from_varparam(vid, prev["varparams"][i], ix2, ctx)
        matched.append((pe, cur, ix2))
        ix2 += pe.nx
    if ix2 != prev["nx"]:
        raise ValueError(
            f".pre state length {prev['nx']} != matched layout {ix2}"
        )
    return matched


def _prev_subset_sv(matched, prev, atm):
    """A StateVector holding the previous retrieval's variables in the
    .pre layout, used to bake the previous state into the base atmosphere
    and form K_prev (LIN=1/3, reference Retrievals.py:182-196).  Log flags
    come from the .pre itself (read_pre keeps the stored LX)."""
    entries = tuple(pe for pe, _, _ in matched)
    nx = prev["nx"]
    sub = StateVector(
        entries=entries, nx=nx,
        xa=np.zeros(nx), sa=np.eye(nx),
        lx=np.asarray(prev["lx"], dtype=int),
        fix=np.zeros(nx, dtype=int), inum=np.zeros(nx, dtype=int),
    )
    return sub.with_iscale(atm.nvmr)


def retrieval_nemesis(
    deck_dir: str,
    runname: str,
    lin: int = 0,
    niter: Optional[int] = None,
    philimit: Optional[float] = None,
    write_outputs: bool = True,
    verbose: bool = False,
    resume: bool = False,
    nemesis_so: bool = False,
    nemesis_l: bool = False,
    nemesis_pt: bool = False,
    nemesis_disc: bool = False,
    nemesis_c: bool = False,
    retrieval_method: int = 0,
    ncores: int = 1,
    ns_kwargs: Optional[dict] = None,
    device=None,
    dtype=torch.float64,
    deck_file=None,
):
    """Full retrieval (reference retrieval_nemesis Retrievals.py:31):
    load deck, optional LIN chaining from <runname>.pre, OE retrieval, and
    legacy output files (.mre/.cov/.raw/.itr).

    LIN semantics (Retrievals.py:171-290):
      1 - bake the previous retrieval's state into the base atmosphere and
          fold its posterior through the Jacobian into SE as forward-model
          error
      2 - substitute the previous posterior state/covariance as the new
          a-priori for matching VARIDENTs
      3 - both, with the re-retrieved variables' columns excluded from the
          forward-model-error projection (Retrievals.py:262-275)

    resume=True restarts the OE loop from the last .itr checkpoint record
    (reference OptimalEstimation_0.from_itr:55).

    The ``nemesis_so``, ``nemesis_l``, ``nemesis_pt``, ``nemesis_disc`` and
    ``nemesis_c`` flags pick the solar-occultation, limb, primary-transit,
    disc-averaged and combined multi-angle set-ups (reference dispatch
    Retrievals.py:298-307). Where ``<runname>.h5`` sits in the deck
    directory, ``write_outputs=True`` also writes the OE results into its
    ``/Retrieval`` group (``retrieval.output.write_output_hdf5``, which
    needs h5py).

    retrieval_method: 0 = optimal estimation (coreretOE), 1 = nested
    sampling (reference dispatch Retrievals.py:298-307;
    ``retrieval/nested.py``). ``ns_kwargs`` are passed to it. Returns an
    OEResult (method 0) or an NSResult (method 1).

    ncores is accepted for API parity with the reference's joblib fan-out
    (Retrievals.py:35); analytic jacfwd Jacobians make it a no-op here: the
    Jacobian is one batched forward evaluation on the card.

    device: None = the CUDA card (raises without one); "cpu" runs on the
    CPU. dtype: the run's floating type. deck_file: the HDF5 run file (or
    its ``.npz`` export) the set-up reads, as ``make_retrieval_setup``
    and ``make_retrieval_setup_limb`` take it.
    """
    import os

    del ncores  # parity-only (see docstring)

    if retrieval_method not in (0, 1):
        raise ValueError(f"unknown retrieval_method {retrieval_method}")
    make_setup = (
        make_retrieval_setup_so if nemesis_so
        else make_retrieval_setup_limb if nemesis_l
        else make_retrieval_setup_transit if nemesis_pt
        else make_retrieval_setup_disc if nemesis_disc
        else make_retrieval_setup_c if nemesis_c
        else make_retrieval_setup
    )

    if deck_file is not None:
        make_setup = functools.partial(make_setup, deck_file=deck_file)

    def _setup_fn(**kw):
        return make_setup(deck_dir, runname, device=device, dtype=dtype,
                          **kw)

    setup = _setup_fn()
    st = setup.deck.settings
    sv = setup.sv
    xa = np.array(sv.xa)
    sa = np.array(sv.sa)
    se = np.array(setup.se)

    if lin > 0:
        prev = out_mod.read_raw(os.path.join(deck_dir, runname + ".pre"))
        matched = _match_prev_entries(sv, prev, setup.deck.atmosphere)
        if lin in (2, 3):
            # substitute matching-varident blocks (Retrievals.py:205-226);
            # unmatched previous variables are not substituted (they are
            # not in the current state vector): they enter via LIN=1/3
            # baking + forward-model error below.
            for pe, cur, i2 in matched:
                if cur is None:
                    continue
                i1, n = cur.ix, cur.nx
                xa[i1 : i1 + n] = prev["xn"][i2 : i2 + n]
                sa[i1 : i1 + n, i1 : i1 + n] = prev["st"][
                    i2 : i2 + n, i2 : i2 + n
                ]
        if lin in (1, 3):
            sub_sv = _prev_subset_sv(matched, prev, setup.deck.atmosphere)
            xn_prev = torch.as_tensor(prev["xn"], dtype=dtype,
                                      device=setup.device)

            # forward-model error SE += K_prev ST K_prev^T, with K_prev the
            # Jacobian of the forward model over ONLY the previous
            # retrieval's variables around the previous state on the
            # pristine reference atmosphere (the reference's FM_prev,
            # Retrievals.py:182-188). For LIN=3 the columns of re-retrieved
            # (matched) variables are zeroed (:262-275), so SF only carries
            # the unmatched variables' uncertainty.
            any_sf_cols = lin == 1 or any(cur is None for _, cur, _ in matched)
            if any_sf_cols:
                setup_prev = _setup_fn(sv_override=sub_sv)
                kk_prev = (
                    torch.func.jacfwd(setup_prev.forward_fn)(xn_prev)
                    .detach().cpu().double().numpy()
                )
                if lin == 3:
                    for pe, cur, i2 in matched:
                        if cur is not None:
                            kk_prev[:, i2 : i2 + pe.nx] = 0.0
                se = se + kk_prev @ prev["st"] @ kk_prev.T

            # bake the previous state into the base atmosphere
            # (Retrievals.py:190-196: the reference keeps FM_prev's
            # AtmosphereX) and rebuild the setup over it
            atm_baked = apply_state(
                setup.deck.atmosphere, xn_prev, sub_sv
            )
            setup = _setup_fn(atm_override=atm_baked.to("cpu"))

    if retrieval_method == 1:
        from archnemesis_tpu_torch.retrieval.nested import run_setup_ns

        if lin > 0:
            raise NotImplementedError(
                "LIN chaining + nested sampling is not wired (the reference "
                "also only folds LIN into the OE path, Retrievals.py:171)")
        return run_setup_ns(setup, verbose=verbose, **(ns_kwargs or {}))

    x0 = None
    if resume:
        itr_path = os.path.join(deck_dir, runname + ".itr")
        if os.path.exists(itr_path):
            x0 = out_mod.read_itr(itr_path)["xn1"]

    res = coreret_oe(
        setup.forward_fn, xa, sa, setup.y, se, sv.lx,
        niter=niter if niter is not None else max(st.niter, 0),
        philimit=philimit if philimit is not None else st.philimit,
        verbose=verbose, record_itr=write_outputs, x0=x0,
        progress_dir=deck_dir if write_outputs else None,
        device=setup.device, dtype=dtype,
    )

    if write_outputs:
        base = os.path.join(deck_dir, runname)
        out_mod.write_mre(base + ".mre", setup, res)
        out_mod.write_cov(base + ".cov", setup, res)
        out_mod.write_raw(base + ".raw", setup, res, setup.deck.atmosphere)
        if res.itr_records:
            out_mod.write_itr(base + ".itr", setup, res.itr_records)
        if os.path.exists(base + ".h5"):
            # the HDF5 run's /Retrieval group (reference
            # write_output_hdf5, OptimalEstimation_0.py:288)
            out_mod.write_output_hdf5(base + ".h5", setup, res)
    return res
