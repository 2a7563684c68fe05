"""Top-level retrieval entry points (the reference's ``Retrievals.py``
retrieval_nemesis equivalent for the nadir thermal-emission family).

Port of the JAX package's ``retrievals.py``: builds a pure forward function
spectrum(xn) from a loaded deck (state-vector application, layering,
opacities, RT, ILS convolution, FOV averaging) and runs optimal estimation
with ``torch.func.jacfwd`` Jacobians. Every entry point takes ``device``
(None = the CUDA card; raises without one unless ``device="cpu"``) and
``dtype`` (float64, as the goldens are; ``torch.float32`` is the
counterpart of the JAX package's ``cast_dtype``).

Ported: ISCAT = thermal emission with nadir FOV points, LIN 0-3 chaining,
resume. The scattering modes, limb FOV points, telluric transmission, the
other set-ups (SO, limb, transit, disc, combined) and nested sampling raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings them.
"""

from __future__ import annotations

import dataclasses
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
from archnemesis_tpu_torch.forward import forward_nadir, make_forward_config
from archnemesis_tpu_torch.io.legacy import Deck, load_deck
from archnemesis_tpu_torch.io.linedata import RuntimeLBL
from archnemesis_tpu_torch.ops.convolution import (
    apply_ils,
    conv_channel_interp,
    conv_quad_weights,
    doppler_corrected_wave,
    ils_weights_filter,
    ils_weights_lbl,
    integrate_filter_weights,
    invert_doppler_shift,
)
from archnemesis_tpu_torch.ops.ktab import host_log_ktable
from archnemesis_tpu_torch.retrieval import output as out_mod
from archnemesis_tpu_torch.retrieval.oe import OEResult, coreret_oe
from archnemesis_tpu_torch.retrieval.statevector import (
    StateVector,
    apply_domain,
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
    return dataclasses.replace(deck, **moved)


def _host_wave(kt) -> np.ndarray:
    """The calc grid of k-tables or of a ``RuntimeLBL`` as host float64."""
    if isinstance(kt, RuntimeLBL):
        return np.asarray(kt.wave, dtype=np.float64)
    return kt.wave.detach().cpu().double().numpy()


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what}: not ported yet ({item})")


def make_retrieval_setup(
    deck_dir: str, runname: str, atm_override=None, sv_override=None,
    wave_pad_multiple: int = 1, ktab_transform=None,
    device=None, dtype=torch.float64,
) -> RetrievalSetup:
    """Build the retrieval setup for a nadir thermal-emission deck.

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
    deck = load_deck(deck_dir, runname)
    if atm_override is not None:
        deck = dataclasses.replace(deck, atmosphere=atm_override)
    deck = _attach_logk(deck, dtype)
    deck = cast_deck_components(deck, dtype)
    st = deck.settings
    iscat = ScatteringCalculationMode(deck.settings.iscat)
    if iscat in (
        ScatteringCalculationMode.MULTIPLE_SCATTERING,
        ScatteringCalculationMode.SINGLE_SCATTERING_PLANE_PARALLEL,
    ):
        _not_ported(f"ISCAT={iscat!r}",
                    "the scattering slice, ROADMAP Queue 1 item 11")
    if iscat != ScatteringCalculationMode.THERMAL_EMISSION:
        raise NotImplementedError(
            f"ISCAT={iscat!r}: only thermal emission, multiple scattering "
            "and plane-parallel single scattering are retrieval modes "
            "(the reference's other modes are diagnostic flux "
            "calculations, ForwardModel_0.py:4338-4341)")
    if deck.settings.iform not in (
        SpectraUnit.Radiance,
        SpectraUnit.Normalised_radiance,
        SpectraUnit.Integrated_radiance,
    ):
        # FluxRatio / Integrated_spectral_power belong to multiple
        # scattering and the disc set-up; TransitDepth to the transit
        # set-up; Atmospheric_transmission to the SO set-up
        raise NotImplementedError(
            f"IFORM={deck.settings.iform!r} is not a nadir thermal-emission "
            "radiance unit (other set-ups: ROADMAP Queue 1 items 10-11)"
        )
    if (deck.settings.iform == SpectraUnit.Normalised_radiance
            and deck.settings.vnorm is None):
        raise ValueError("IFORM=Normalised_radiance requires VNORM "
                         "(reference Measurement_0.assess:344)")
    if deck.telluric is not None:
        _not_ported("telluric transmission",
                    "rt/telluric.py, ROADMAP Queue 1 item 13")

    sv = (
        sv_override
        if sv_override is not None
        else read_apr(deck.apr_path, deck.atmosphere)
    )
    geom = deck.geometry
    if float(np.min(geom.emiss_ang)) < 0.0:
        _not_ported("limb FOV points (EMISS_ANG < 0)",
                    "forward_limb, ROADMAP Queue 1 item 10")

    # measurement vector (reference calc_MeasurementVector Measurement_0.py:1423)
    y_parts, se_parts = [], []
    for ig in range(geom.ngeom):
        nc = geom.nconv[ig]
        y_parts.append(geom.meas[:nc, ig])
        se_parts.append(geom.errmeas[:nc, ig] ** 2)
    y = np.concatenate(y_parts)
    se = np.diag(np.concatenate(se_parts))

    deck = _deck_to(deck, device)

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    # per-geometry static setup
    if any(e.model_id == 447 for e in sv.entries):
        _not_ported("model 447 (retrieved Doppler)",
                    "ROADMAP Queue 1 item 12")
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
            ishape = InstrumentLineshape(st.ishape)
            if ishape == InstrumentLineshape.Square:
                dv = 0.5 * geom.fwhm
            elif ishape == InstrumentLineshape.Triangular:
                dv = geom.fwhm
            else:
                dv = 3.0 * 0.5 * geom.fwhm / np.sqrt(np.log(2.0))
            wavemin, wavemax = vconv[0] - dv, vconv[-1] + dv
            ils_w = True
        else:
            # FWHM<0: per-channel filters, tabulated (.fil) or the
            # differentiable double-Gaussian ILS models 228/229/230
            # (reference calc_wave_range Measurement_0.py:2090-2105)
            if ils_models_present(sv):
                _not_ported("ILS models 228/229/230",
                            "ROADMAP Queue 1 item 12")
            elif geom.nfil is not None:
                wavemin = geom.vfil[0, :].min()
                wavemax = max(
                    geom.vfil[geom.nfil[j] - 1, j]
                    for j in range(geom.nfil.shape[0])
                )
                ils_w = "filter"
            else:
                raise ValueError("FWHM<0 requires a .fil file or an ILS model")
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
        if ils_w is True:
            if st.ilbl == SpectralCalculationMode.K_TABLES:
                # k-table mode convolves via the conv() spline quadrature,
                # with optional per-channel FWHM from a .fwh table
                vf, xf = deck.fwh if deck.fwh is not None else (None, None)
                ils_w = dev(conv_quad_weights(
                    wavecorr, np.asarray(vconv), geom.fwhm,
                    vfwhm=vf, xfwhm=xf,
                ))
            else:
                ils_w = dev(ils_weights_lbl(
                    wavecorr, np.asarray(vconv), geom.fwhm,
                    InstrumentLineshape(st.ishape),
                ))
        elif isinstance(ils_w, str) and ils_w == "filter":
            ils_w = dev(ils_weights_filter(
                wavecorr, np.asarray(vconv),
                geom.nfil, geom.vfil, geom.afil,
            ))
        elif isinstance(ils_w, str) and ils_w == "intfilter":
            ils_w = dev(integrate_filter_weights(
                wavecorr, np.asarray(vconv),
                geom.nfil, geom.vfil, geom.afil,
            ))
        # the observer-frame calc grid and the channel centres, on the
        # device once (the state does not move them: model 447 is not
        # ported)
        geoms.append((ig, vconv, dev(vconv), ktw, dev(wavecorr), ils_w))

    cfg = make_forward_config(
        deck.atmosphere,
        deck.ktables,
        deck.cia,
        iray=deck.settings.iray,
        ispace=deck.settings.ispace,
        gasgiant=deck.surface.gasgiant,
    )

    cia = deck.cia
    cia_range = None
    if cia is not None:
        # spectroscopy wave range in cm-1 for CIA-domain models
        # (reference model_500 hook, model_500.py:185-196)
        tw = _host_wave(deck.ktables)
        cia_range = (
            (float(tw.min()), float(tw.max()))
            if int(st.ispace) == 0
            else (1.0e4 / float(tw.max()), 1.0e4 / float(tw.min()))
        )

    def forward_fn(xn):
        if not isinstance(xn, torch.Tensor):
            xn = dev(xn)
        atm = apply_state(deck.atmosphere, xn, sv)
        surf = apply_domain(sv, xn, "surface", deck.surface)
        aero = (
            apply_domain(sv, xn, "scatter", deck.aerosol,
                         ispace=int(st.ispace))
            if deck.aerosol is not None
            else None
        )
        cia_x = (apply_domain(sv, xn, "cia", cia, wave_range=cia_range)
                 if cia is not None else None)
        out = []
        for ig, vconv, vconv_dev, ktw, wave_obs, ils_w in geoms:
            spec_sum = 0.0
            for iav in range(geom.nav[ig]):
                spec = forward_nadir(
                    atm,
                    deck.layer_config,
                    ktw,
                    cia_x,
                    aero,
                    surf,
                    cfg,
                    emiss_ang=geom.emiss_ang[ig, iav],
                    sol_ang=geom.sol_ang[ig, iav],
                    azi_ang=geom.azi_ang[ig, iav],
                    device=device,
                )[:, 0]
                spec_sum = spec_sum + geom.wgeom[ig, iav] * spec
            # NOTE: the reference accumulates WGEOM-weighted spectra
            # WITHOUT dividing by the weight total (nemesisfm
            # ForwardModel_0.py:530-535; FOV weights are pre-normalised)
            if ils_w is None:
                conv = conv_channel_interp(wave_obs, spec_sum, vconv_dev)
            else:
                conv = apply_ils(ils_w, spec_sum)
            if st.iform == SpectraUnit.Normalised_radiance:
                # normalise to the radiance at VNORM (reference nemesisfm
                # ForwardModel_0.py:581-583)
                vnorm = dev(st.vnorm)
                conv = conv / interp(vnorm, vconv_dev, conv, left=conv[0],
                                     right=conv[-1])
            out.append(apply_spectrum_models(sv, xn, ig, vconv_dev, conv))
        return torch.cat(out)

    return RetrievalSetup(
        deck=deck, sv=sv, forward_fn=forward_fn, y=y, se=se,
        vconv_list=[g[1] for g in geoms], device=device, dtype=dtype,
    )


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

    retrieval_method: 0 = optimal estimation (coreretOE); 1 (nested
    sampling) and the ``nemesis_so/_l/_pt/_disc/_c`` set-ups are not ported
    yet and raise. ``ns_kwargs`` belongs to method 1.

    ncores is accepted for API parity with the reference's joblib fan-out
    (Retrievals.py:35); analytic jacfwd Jacobians make it a no-op here: the
    Jacobian is one batched forward evaluation on the card.

    device: None = the CUDA card (raises without one); "cpu" runs on the
    CPU. dtype: the run's floating type.
    """
    import os

    del ncores, ns_kwargs  # parity-only (see docstring)

    for flag, name in ((nemesis_so, "nemesis_so"), (nemesis_l, "nemesis_l"),
                       (nemesis_pt, "nemesis_pt"),
                       (nemesis_disc, "nemesis_disc"),
                       (nemesis_c, "nemesis_c")):
        if flag:
            _not_ported(f"{name}=True",
                        "the other geometries, ROADMAP Queue 1 item 10")
    if retrieval_method == 1:
        _not_ported("retrieval_method=1 (nested sampling)",
                    "retrieval/nested.py, ROADMAP Queue 1 item 13")
    if retrieval_method != 0:
        raise ValueError(f"unknown retrieval_method {retrieval_method}")

    def _setup_fn(**kw):
        return make_retrieval_setup(deck_dir, runname, device=device,
                                    dtype=dtype, **kw)

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
            _not_ported("the /Retrieval group of an HDF5 run",
                        "io/hdf5.py, ROADMAP Queue 1 item 13")
    return res
