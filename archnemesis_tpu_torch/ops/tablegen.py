"""Look-up-table generation: .lta (monochromatic) and .kta (correlated-k)
tables from line lists.

Port of the JAX package's ``ops/tablegen.py`` (the reference's offline
pipeline, Spectroscopy_0.py: calc_lbltable:3124, calc_ktable:3338,
calc_ktable_chunk:3558). The synthesis goes through
``ops.lbl.lbl_cross_section``: on the card that is kernel 2
(``csrc/lbl_cross_section.cu``) with the (P, T) pairs of the table grid as
its layer axis, one launch per table or per wave chunk; on the CPU its
plain version. The host builds the adaptive fine grid and the g-ordinate
bins; each bin's sort, cumulative distribution and interpolation at the
Gauss-Legendre ordinates are tensor operations on the synthesis's device.

Everything runs in float64, as the JAX package's tables do. The tables come
back as float64 tensors on ``device`` (None = the CUDA card; raises without
one unless ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from archnemesis_tpu_torch.io.linedata import LineList, _slice_lines
from archnemesis_tpu_torch.ops.lbl import (
    DOPPLER_CONST,
    build_blocks,
    lbl_cross_section,
)
from archnemesis_tpu_torch.utils.device import resolve_device


def gauss_legendre_g(ng: int):
    """g-ordinates and weights on [0, 1] (reference calc_ktable
    :3444-3447)."""
    x, w = np.polynomial.legendre.leggauss(ng)
    return 0.5 * (x + 1.0), 0.5 * w


def _pt_columns(press_atm, temp):
    """The table's (P, T) pairs as the synthesis's layer axis, P-major:
    (pressures, temperatures), each (NP * NT,)."""
    pp, tt = np.meshgrid(np.asarray(press_atm, dtype=np.float64),
                         np.asarray(temp, dtype=np.float64), indexing="ij")
    return pp.ravel(), tt.ravel()


def _synthesise(ll, wave, pcol, tcol, amb_frac, device, **kw):
    """k (NWAVE, len(pcol)) float64 on ``device``: one synthesis with the
    (P, T) pairs as layers (one kernel launch on the card)."""
    blocks = build_blocks(wave, ll.nu,
                          wn_approx_window=kw["wn_approx_window"])
    return lbl_cross_section(
        ll, blocks, torch.as_tensor(tcol, device=device),
        torch.as_tensor(pcol, device=device),
        torch.full((pcol.size,), float(amb_frac), dtype=torch.float64,
                   device=device),
        device=device, **kw)


def _min_hwhm(ll: LineList, p, t, amb_frac) -> float:
    """The smallest Voigt HWHM of the lines at (p atm, t K) (reference
    :3617-3624)."""
    alpha_d = DOPPLER_CONST * ll.nu * np.sqrt(t / ll.mass)
    t_ratio = ll.t_ref / t
    gam = (t_ratio ** ll.broad[1] * ll.broad[0] * (1.0 - amb_frac)
           + t_ratio ** ll.broad[4] * ll.broad[3] * amb_frac) * (p / ll.p_ref)
    hwhm = 0.5346 * gam + np.sqrt(0.2166 * gam**2 + alpha_d**2)
    return float(np.min(hwhm))


def generate_lbltable(
    ll: LineList,
    press_atm: np.ndarray,
    temp: np.ndarray,
    wave: np.ndarray,
    amb_frac: float = 1.0,
    lineshape: str = "voigt",
    wn_calc_window: float = 25.0,
    wn_approx_window: float = 75.0,
    include_pressure_shift: bool = True,
    restrict_lines: bool = True,
    device=None,
) -> torch.Tensor:
    """Monochromatic cross-sections k(NWAVE, NP, NT) [cm^2] on the table
    grid (reference calc_lbltable Spectroscopy_0.py:3124; its chunked
    loop restricts the lines to the table's wave range, :3249): every
    (P, T) pair in one synthesis."""
    device = resolve_device(device)
    wave = np.asarray(wave, dtype=np.float64)
    if restrict_lines:
        ll = _slice_lines(ll, wave.min(), wave.max())
    pcol, tcol = _pt_columns(press_atm, temp)
    k = _synthesise(ll, wave, pcol, tcol, amb_frac, device,
                    lineshape=lineshape, wn_calc_window=wn_calc_window,
                    wn_approx_window=wn_approx_window,
                    include_pressure_shift=include_pressure_shift)
    return k.reshape(wave.size, len(press_atm), len(temp))


def _bin_stencil(n: int, dfine: float, g_ord: np.ndarray):
    """Host (lower knot, upper knot, weight) of the linear interpolation of
    a bin's cumulative g at ``g_ord``: the bin's ``n`` sorted fine points
    sit at g = cumsum(dfine) / sum, clamped at both ends as ``np.interp``
    clamps."""
    g_sorted = np.cumsum(np.full(n, dfine))
    g_sorted /= g_sorted[-1]
    idx = np.clip(np.searchsorted(g_sorted, g_ord), 1, n - 1)
    x0, x1 = g_sorted[idx - 1], g_sorted[idx]
    w = np.clip((g_ord - x0) / (x1 - x0), 0.0, 1.0)
    return idx - 1, idx, w


def _rebin(kabs, lo: int, hi: int, dfine: float, g_ord: np.ndarray):
    """(NG, NCOL) k at the g ordinates of the fine points [lo, hi) of
    ``kabs`` (NCALC, NCOL): sorted per column, interpolated in the
    cumulative distribution."""
    ksel = torch.sort(kabs[lo:hi], dim=0).values
    if hi - lo == 1:
        return ksel.expand(g_ord.size, -1)
    i0, i1, w = _bin_stencil(hi - lo, dfine, g_ord)
    dev = kabs.device
    w = torch.as_tensor(w, device=dev)[:, None]
    return ((1.0 - w) * ksel[torch.as_tensor(i0, device=dev)]
            + w * ksel[torch.as_tensor(i1, device=dev)])


def generate_ktable(
    ll: LineList,
    press_atm: np.ndarray,
    temp: np.ndarray,
    wave: np.ndarray,          # bin centres (uniform)
    ng: int,
    amb_frac: float = 1.0,
    lineshape: str = "voigt",
    wn_calc_window: float = 25.0,
    wn_approx_window: float = 75.0,
    include_pressure_shift: bool = True,
    fine_points_cap: int = 2_000_000,
    device=None,
):
    """Correlated-k coefficients k_g(NWAVE, NG, NP, NT) for square bins of
    width delv centred on ``wave`` (reference calc_ktable_chunk
    Spectroscopy_0.py:3558): per (P, T) an adaptive fine grid at the
    smallest Voigt HWHM / 5, the cross-sections sorted per bin into a
    cumulative distribution and interpolated at the Gauss-Legendre g
    ordinates. One synthesis per (P, T) pair, as the reference's.

    Returns (k_g tensor on ``device``, g_ord, del_g)."""
    device = resolve_device(device)
    wave = np.asarray(wave, dtype=np.float64)
    g_ord, del_g = gauss_legendre_g(ng)
    delwave = wave[1] - wave[0]
    vmin = wave[0] - delwave / 2.0
    vmax = wave[-1] + delwave / 2.0
    # lines fetched with a doubled approx-window pad (reference :3590-3596)
    ll_win = _slice_lines(ll, vmin - 2.0 * wn_approx_window,
                          vmax + 2.0 * wn_approx_window)
    kw = dict(lineshape=lineshape, wn_calc_window=wn_calc_window,
              wn_approx_window=wn_approx_window,
              include_pressure_shift=include_pressure_shift)

    npress, ntemp = len(press_atm), len(temp)
    k_g = torch.zeros((wave.size, ng, npress, ntemp), dtype=torch.float64,
                      device=device)
    for ip, p in enumerate(press_atm):
        for it, t in enumerate(temp):
            ncalc = min(int((vmax - vmin)
                            / (_min_hwhm(ll_win, p, t, amb_frac) / 5.0)),
                        fine_points_cap)
            wavecalc = np.linspace(vmin, vmax, ncalc)
            kabs = _synthesise(ll_win, wavecalc, np.array([float(p)]),
                               np.array([float(t)]), amb_frac, device, **kw)
            dfine = wavecalc[1] - wavecalc[0]
            for iw, wc in enumerate(wave):
                lo = int(np.searchsorted(wavecalc, wc - delwave / 2.0,
                                         side="left"))
                hi = int(np.searchsorted(wavecalc, wc + delwave / 2.0,
                                         side="right"))
                k_g[iw, :, ip, it] = _rebin(kabs, lo, hi, dfine, g_ord)[:, 0]
    return k_g, g_ord, del_g


def chunk_grid(ll_win, press_atm, temp, wave, amb_frac, wn_approx_window,
               fine_points_cap):
    """Host set-up of one wavenumber chunk's synthesis: (its lines, with
    the 2x approx-window pad of the reference, :3590-3596; the fine grid;
    the (P, T) columns; the bin width; the chunk's edges)."""
    delwave = wave[1] - wave[0] if wave.size > 1 else wave[0] * 0 + 1.0
    vmin = wave[0] - delwave / 2.0
    vmax = wave[-1] + delwave / 2.0
    ll_c = _slice_lines(ll_win, vmin - 2.0 * wn_approx_window,
                        vmax + 2.0 * wn_approx_window)
    pcol, tcol = _pt_columns(press_atm, temp)
    # one shared fine grid: the finest adaptive resolution over the whole
    # (P, T) grid (min Voigt HWHM / 5, reference :3617-3624), at least as
    # fine as the reference's per-point grids
    delv_calc = min(_min_hwhm(ll_c, p, t, amb_frac) / 5.0
                    for p, t in zip(pcol, tcol))
    ncalc = min(int((vmax - vmin) / delv_calc), fine_points_cap)
    # empty-bin guard: the cap (or a min-HWHM/5 coarser than delwave on
    # sparse high-pressure decks) can otherwise leave a bin with no fine
    # point
    ncalc = max(ncalc, 2 * len(wave) + 2)
    wavecalc = np.linspace(vmin, vmax, ncalc)
    return ll_c, wavecalc, pcol, tcol, delwave, vmin, vmax


def _chunk_launch(ll_win, press_atm, temp, wave, amb_frac, lineshape,
                  wn_calc_window, wn_approx_window, include_pressure_shift,
                  fine_points_cap, device):
    """Device phase of one wavenumber chunk: the fine-grid cross-sections
    of the WHOLE (P, T) grid in one synthesis (one kernel launch on the
    card, which returns before the card has finished). Returns the
    (NCALC, NP * NT) tensor and the rebin's host metadata."""
    ll_c, wavecalc, pcol, tcol, delwave, vmin, vmax = chunk_grid(
        ll_win, press_atm, temp, wave, amb_frac, wn_approx_window,
        fine_points_cap)
    kabs = _synthesise(ll_c, wavecalc, pcol, tcol, amb_frac, device,
                       lineshape=lineshape, wn_calc_window=wn_calc_window,
                       wn_approx_window=wn_approx_window,
                       include_pressure_shift=include_pressure_shift)
    return (kabs, wavecalc, wavecalc[1] - wavecalc[0], delwave, vmin, vmax,
            len(press_atm), len(temp))


def _chunk_rebin(kabs, wavecalc, dfine, delwave, vmin, vmax, npress, ntemp,
                 wave, ng, g_ord):
    """Rebin of one chunk, on ``kabs``'s device: each bin's fine points
    sorted per (P, T) column into g space and interpolated at the g
    ordinates, every column of a bin at once."""
    bins = []
    for iw, wc in enumerate(wave):
        lo = int(np.searchsorted(wavecalc, wc - delwave / 2.0, side="left"))
        hi = int(np.searchsorted(wavecalc, wc + delwave / 2.0, side="right"))
        if hi - lo < 1:
            raise ValueError(
                f"k-table bin {iw} ({wc:.6g} cm-1, chunk "
                f"[{vmin:.6g},{vmax:.6g}]) contains no fine-grid points; "
                "raise fine_points_cap")
        bins.append(_rebin(kabs, lo, hi, dfine, g_ord))
    return torch.stack(bins).reshape(len(wave), ng, npress, ntemp)


def generate_ktable_chunked(
    ll: LineList,
    press_atm: np.ndarray,
    temp: np.ndarray,
    wave: np.ndarray,
    ng: int,
    n_chunks: int = 1,
    amb_frac: float = 1.0,
    lineshape: str = "voigt",
    wn_calc_window: float = 25.0,
    wn_approx_window: float = 75.0,
    include_pressure_shift: bool = True,
    fine_points_cap: int = 2_000_000,
    device=None,
):
    """Wavenumber-chunked, (P, T)-batched k-table pipeline: the
    production-scale counterpart of ``generate_ktable`` and of the
    reference's threaded chunking (calc_ktable n_chunks,
    Spectroscopy_0.py:3355, :3528-3534). Each chunk fetches its own line
    window (2x approx pad, :3590-3596) and synthesises the WHOLE (P, T)
    grid in one launch.

    The launches are asynchronous: chunk k+1 is dispatched before chunk k
    is rebinned, so the card synthesises one chunk while the host issues
    the previous chunk's rebin, and at most two chunks' fine grids are
    held at once. (The JAX package's ``devices=`` round-robin over a mesh
    becomes ``device``: one card.)

    Returns (k_g tensor (NWAVE, NG, NP, NT) on ``device``, g_ord, del_g).
    """
    device = resolve_device(device)
    wave = np.asarray(wave, dtype=np.float64)
    g_ord, del_g = gauss_legendre_g(ng)
    chunks = [idx for idx in np.array_split(np.arange(wave.size), n_chunks)
              if idx.size]

    def launch(idx):
        return _chunk_launch(ll, press_atm, temp, wave[idx], amb_frac,
                             lineshape, wn_calc_window, wn_approx_window,
                             include_pressure_shift, fine_points_cap, device)

    parts = []
    pending = launch(chunks[0])
    for i, idx in enumerate(chunks):
        current = pending
        pending = launch(chunks[i + 1]) if i + 1 < len(chunks) else None
        parts.append(_chunk_rebin(*current, wave[idx], ng, g_ord))
        del current
    return torch.cat(parts, dim=0), g_ord, del_g
