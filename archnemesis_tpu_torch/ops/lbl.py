"""Runtime line-by-line opacity synthesis.

Port of the JAX package's ``ops/lbl.py`` (the reference's LBL accumulation,
``LineData_0.py:229`` add_line_set_monochromatic_spectrum — the lines x
wavegrid double loop): the wavenumber grid is tiled into static blocks; for
each block, the host-precomputed range of lines within the 75 cm^-1
approximation window is gathered and their contributions evaluated as one
dense (lines_per_block, block_width) lineshape panel with window masks.

Physics identical to the reference kernels (LineData_0.py:124-226):
- line strength: S(T) = sw * (stim(T)/stim(Tref)) * exp(c2 E" (T-Tref)/(T Tref)) * Q(Tref)/Q(T)
- Doppler HWHM alpha_d ~ nu sqrt(T/m); Lorentz HWHM from self+ambient
  broadening with T exponents; pressure shift from ambient delta;
- |dv| < 25 cm^-1: full lineshape; 25..75 cm^-1: f(25) * 25^2/dv^2 wing.

``lbl_cross_section`` is the entry every caller uses: a CPU tensor goes to
the plain version below (``lbl_cross_section_plain``), a CUDA tensor to the
hand-written kernel of ``ops/lbl_cuda.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from archnemesis_tpu_torch.constants import (
    C2_CGS,
    C_LIGHT_CGS,
    K_B_CGS,
    N_AVOGADRO,
)
from archnemesis_tpu_torch.io.linedata import LineList
from archnemesis_tpu_torch.ops import voigt as voigt_mod
from archnemesis_tpu_torch.utils.device import resolve_device
from archnemesis_tpu_torch.utils.interp import interp

DOPPLER_CONST = (1.0 / C_LIGHT_CGS) * np.sqrt(
    2.0 * np.log(2.0) * N_AVOGADRO * K_B_CGS
)
# (line, wave) pairs of one panel of the plain version: the lineshape keeps
# ~15 temporaries of this size alive (~8 GB in float64)
PANEL_ELEMENTS = 2**26


@dataclass(frozen=True)
class LblBlocks:
    """Static blocking of a wavenumber grid against a line list (the JAX
    package's fields, then each block's exact line range)."""

    block_width: int
    n_blocks: int
    max_lines_per_block: int
    line_idx: np.ndarray  # (n_blocks, max_lines_per_block) gather indices
    line_mask: np.ndarray  # (n_blocks, max_lines_per_block) 1=valid
    wn_pad: np.ndarray  # (n_blocks * block_width,) padded grid
    n_wave: int  # true grid length
    starts: np.ndarray  # (n_blocks,) first line of each block
    counts: np.ndarray  # (n_blocks,) number of lines of each block


def build_blocks(
    wn_grid: np.ndarray,
    nu: np.ndarray,
    wn_approx_window: float = 75.0,
    block_width: int = 128,
    shift_margin: float = 2.0,
) -> LblBlocks:
    """Host-side: for each wave block, the index range of lines whose
    (shift-padded) window overlaps it. Lines must be sorted by nu."""
    n = wn_grid.shape[0]
    n_blocks = -(-n // block_width)
    npad = n_blocks * block_width
    wn_pad = np.full(npad, wn_grid[-1], dtype=wn_grid.dtype)
    wn_pad[:n] = wn_grid

    lo = wn_pad[::block_width] - wn_approx_window - shift_margin
    hi = wn_pad[block_width - 1::block_width] + wn_approx_window + shift_margin
    starts = np.searchsorted(nu, lo, side="left").astype(np.int64)
    counts = np.searchsorted(nu, hi, side="right") - starts
    maxl = max(int(counts.max()), 1)
    cols = np.arange(maxl)
    mask = cols[None, :] < counts[:, None]
    idx = np.where(mask, starts[:, None] + cols[None, :], 0).astype(np.int32)
    return LblBlocks(
        block_width=block_width,
        n_blocks=n_blocks,
        max_lines_per_block=maxl,
        line_idx=idx,
        line_mask=mask.astype(np.float64),
        wn_pad=wn_pad,
        n_wave=n,
        starts=starts,
        counts=counts,
    )


def default_factor(ll: LineList) -> float:
    """The isotope factor folded into every line: the abundance when the
    list stands for all isotopes (iso_id 0), else 1."""
    return 1.0 if ll.iso_id != 0 else ll.abundance


def partition_ratio(ll: LineList, t_calc):
    """Q(t_ref) / Q(T) per layer, in ``t_calc``'s type (the arithmetic of
    ``jnp.interp``, clamped at the table's ends)."""
    pf_t = t_calc.new_tensor(ll.pf_temp)
    pf_q = t_calc.new_tensor(ll.pf_q)

    def q(t):
        return interp(t, pf_t, pf_q, left=pf_q[0], right=pf_q[-1])

    return q(t_calc.new_tensor(ll.t_ref)) / q(t_calc)


def line_column(x, like):
    """A host line array as a tensor of ``like``'s type and device."""
    return like.new_tensor(np.asarray(x, dtype=np.float64))


def layer_line_params(ll: LineList, t_calc, p_calc, amb_frac):
    """Per-layer per-line strength, Doppler width, Lorentz width, shift.

    t_calc, p_calc (atm), amb_frac: (NLAY,) tensors. Returns (NLAY, NLINE)
    tensors in ``t_calc``'s type: the line arrays are cast to it first, so
    float32 runs compute in float32 throughout.
    """
    t = t_calc[:, None]
    nu = line_column(ll.nu, t_calc)[None, :]
    elower = line_column(ll.elower, t_calc)[None, :]
    q_ratio = partition_ratio(ll, t_calc)  # (NLAY,)

    boltz = torch.exp(C2_CGS * (t - ll.t_ref) / (t * ll.t_ref) * elower)
    stim = 1.0 - torch.exp(-C2_CGS * nu / t)
    strength = (
        line_column(ll.sw, t_calc)[None, :]
        * (stim / line_column(ll.stim_ref, t_calc)[None, :])
        * boltz
        * q_ratio[:, None]
    )

    alpha_d = DOPPLER_CONST * nu * torch.sqrt(t / ll.mass)

    t_ratio = ll.t_ref / t  # (NLAY, 1)
    p_ratio = (p_calc / ll.p_ref)[:, None]
    frac = torch.stack([1.0 - amb_frac, amb_frac], dim=1)  # (NLAY, 2)
    g_self, n_self, _, g_amb, n_amb, d_amb = (
        line_column(b, t_calc)[None, :] for b in ll.broad)
    gamma_l = (
        t_ratio**n_self * g_self * frac[:, 0:1]
        + t_ratio**n_amb * g_amb * frac[:, 1:2]
    ) * p_ratio
    shift = p_ratio * d_amb * frac[:, 1:2]  # delta_self = 0 (reference)
    return strength, alpha_d, gamma_l, shift


def two_float(x: np.ndarray):
    """(hi, lo) float32 parts of a float64 array: hi = float32(x),
    lo = float32(x - hi)."""
    hi = np.asarray(x, dtype=np.float64).astype(np.float32)
    return hi, (np.asarray(x, dtype=np.float64) - hi).astype(np.float32)


def uses_two_float(ll: LineList, dtype) -> bool:
    """Whether a synthesis in ``dtype`` takes the two-float delta: float32
    with float64 host line centres."""
    return (dtype == torch.float32 and isinstance(ll.nu, np.ndarray)
            and ll.nu.dtype == np.float64)


def lbl_cross_section_plain(
    ll: LineList,
    blocks: LblBlocks,
    t_calc,
    p_calc,
    amb_frac,
    lineshape: str = "voigt",
    s_floor: float = 0.0,
    wn_calc_window: float = 25.0,
    wn_approx_window: float = 75.0,
    include_pressure_shift: bool = True,
    factor: float | None = None,
):
    """Plain PyTorch version: k(NWAVE, NLAY) [cm^2 molecule^-1] from
    (NLAY,) tensors t_calc (K), p_calc (atm), amb_frac.

    Dense (blocks, lines, waves) panels of about ``PANEL_ELEMENTS`` pairs,
    layer by layer (one layer of the full-width configuration is ~4e8
    pairs). Differentiable in t_calc, p_calc and amb_frac
    (``torch.func.jvp``/``jacfwd``)."""
    fn = voigt_mod.LINESHAPES[lineshape]
    if factor is None:
        factor = default_factor(ll)

    strength, alpha_d, gamma_l, shift = layer_line_params(
        ll, t_calc, p_calc, amb_frac)
    if not include_pressure_shift:
        shift = torch.zeros_like(shift)

    dev = t_calc.device
    idx = torch.as_tensor(blocks.line_idx, dtype=torch.long, device=dev)
    lmask = t_calc.new_tensor(blocks.line_mask)
    nb, w = blocks.n_blocks, blocks.block_width

    # delta = wn - nu cancels catastrophically in f32 (both ~1e3 cm^-1,
    # difference ~1e-3 at a line core -> ~4% delta error -> ~20% k error).
    # Two-float split: hi parts subtract EXACTLY (Sterbenz: operands within
    # a factor 2 whenever delta is small), lo parts restore the f64 ulps.
    twofloat = uses_two_float(ll, t_calc.dtype)
    if twofloat:
        nu_hi, nu_lo = (torch.as_tensor(x, device=dev) for x in two_float(ll.nu))
        wn_hi, wn_lo = (torch.as_tensor(x, device=dev).reshape(nb, w)
                        for x in two_float(blocks.wn_pad))
    else:
        nu_hi = line_column(ll.nu, t_calc)
        wn_hi = t_calc.new_tensor(blocks.wn_pad).reshape(nb, w)
    # blocks per panel: about PANEL_ELEMENTS (line, wave) pairs at a time
    chunk = max(1, PANEL_ELEMENTS // (blocks.max_lines_per_block * w))

    def panel(sl, lay):
        """k of the blocks ``sl`` of one layer, (len(sl), W)."""
        ib = idx[sl]
        s = strength[lay][ib]  # (B, M)
        a = alpha_d[lay][ib]
        g = gamma_l[lay][ib]
        sh = shift[lay][ib]
        if twofloat:
            delta = (
                (wn_hi[sl, None, :] - nu_hi[ib][:, :, None])
                + (wn_lo[sl, None, :] - nu_lo[ib][:, :, None])
                - sh[:, :, None]
            )  # (B, M, W)
        else:
            # f64: keep the reference's association wn - (nu + shift)
            # bit-compatibly (test_lbl asserts rtol 1e-12)
            delta = wn_hi[sl, None, :] - (nu_hi[ib] + sh)[:, :, None]
        in_win = (delta >= -wn_approx_window) & (delta < wn_approx_window)
        in_calc = (delta >= -wn_calc_window) & (delta < wn_calc_window)

        core = fn(delta, a[:, :, None], g[:, :, None])
        wing = (fn(torch.full_like(a, wn_calc_window), a, g)[:, :, None]
                * (wn_calc_window**2) / (delta * delta))
        contrib = torch.where(in_calc, core, wing) * in_win
        keep = (s >= s_floor) * lmask[sl]  # (B, M)
        return torch.einsum("bmw,bm->bw", contrib, s * keep) * factor

    out = []
    for lay in range(t_calc.shape[0]):
        k = torch.cat([panel(slice(b0, b0 + chunk), lay)
                       for b0 in range(0, nb, chunk)])
        out.append(k.reshape(-1)[: blocks.n_wave])
    return torch.stack(out, dim=1)


def lbl_cross_section(
    ll: LineList,
    blocks: LblBlocks,
    t_calc,
    p_calc,
    amb_frac,
    lineshape: str = "voigt",
    s_floor: float = 0.0,
    wn_calc_window: float = 25.0,
    wn_approx_window: float = 75.0,
    include_pressure_shift: bool = True,
    factor: float | None = None,
    device=None,
    packed: dict | None = None,
):
    """Absorption cross-section k(NWAVE, NLAY) [cm^2 molecule^-1].

    t_calc (K), p_calc (atm), amb_frac: (NLAY,) tensors or host arrays,
    put on ``device`` (None = the CUDA card; raises without one). There a
    CUDA tensor launches the kernel of ``csrc/lbl_cross_section.cu``
    (``ops/lbl_cuda.py``; ``packed``: a dict that keeps its static inputs
    across calls, or None to pack them for this launch) and a CPU tensor
    runs the plain version. Forward-mode differentiable: the tangent is
    the plain version's.
    """
    from archnemesis_tpu_torch.ops import lbl_cuda

    device = resolve_device(device)
    t, p, amb = (torch.as_tensor(x, device=device)
                 for x in (t_calc, p_calc, amb_frac))
    return lbl_cuda.lbl_cross_section(
        ll, blocks, t, p, amb, lineshape=lineshape, s_floor=s_floor,
        wn_calc_window=wn_calc_window, wn_approx_window=wn_approx_window,
        include_pressure_shift=include_pressure_shift, factor=factor,
        packed=packed)
