"""Pseudo-continuum absorption from pre-binned weak lines (Irwin+19).

Port of the JAX package's ``ops/pseudo_continuum.py`` (reference kernels
``LineData_0.add_pseudo_continuum_monochromatic_absorption`` (:486) and
``add_pseudo_continuum_monochromatic_spectrum`` (:361)): weak lines excluded
from the explicit LBL sum are pre-binned into (strength sum,
strength-weighted width/energy) coarse bins; at runtime each bin's strength
is re-scaled to the layer (T, P) like a single effective line, spread over
+-K neighbouring bins with a normalised lineshape stencil, divided by the
bin width, and tent-interpolated onto the fine wave grid.

The stencil geometry is host numpy; the per-layer physics is plain tensor
code over all layers at once (no kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from archnemesis_tpu_torch.constants import C2_CGS
from archnemesis_tpu_torch.ops import voigt as voigt_mod
from archnemesis_tpu_torch.ops.lbl import DOPPLER_CONST
from archnemesis_tpu_torch.utils.interp import interp


@dataclass
class PseudoContinuum:
    """Pre-binned weak-line data for one isotopologue (reference
    PseudoContinuumData, database/datatypes/pseudo_continuum_data.py:9)."""

    t_ref: float  # tabulation temperature (K)
    p_ref: float  # tabulation pressure (atm)
    mass: float  # isotopic molar mass (g/mol)
    abundance: float  # isotopic abundance factor applied to the result

    wn_bin_center: np.ndarray  # (N,) cm-1, ascending
    wn_bin_width: np.ndarray  # (N,)
    strength_sum: np.ndarray  # (N,) sum of weak-line strengths at t_ref
    lsw_e_lower: np.ndarray  # (N,) strength-weighted lower-state energy
    lsw_gamma_self: np.ndarray  # (N,)
    lsw_n_self: np.ndarray  # (N,)
    lsw_gamma_amb: np.ndarray  # (N,)
    lsw_n_amb: np.ndarray  # (N,)

    pf_temp: np.ndarray
    pf_q: np.ndarray


def _stencil(pc: PseudoContinuum, wave: np.ndarray, kk: int) -> dict:
    """Host geometry of the spread and of the grid interpolation."""
    nb = pc.wn_bin_center.shape[0]
    # bin-to-bin deltas and validity masks
    idx = np.arange(nb)
    nbr = idx[:, None] + np.arange(-kk, kk + 1)[None, :]  # (N, 2K+1)
    valid = (nbr >= 0) & (nbr < nb)
    nbr_c = np.clip(nbr, 0, nb - 1)
    delta = pc.wn_bin_center[nbr_c] - pc.wn_bin_center[:, None]

    # source-bin range (reference :399-417): bins entirely above the grid
    # do not spread (first index whose upper edge exceeds the grid end)
    bin_max = pc.wn_bin_center + pc.wn_bin_width / 2.0
    above = np.nonzero(bin_max > wave[-1])[0]
    last_idx = int(above[0]) if above.size else nb
    # the reference's first-index scan (:399-417) only ever matches bin 0
    # (ascending bin mins), so a bin set starting above the grid start
    # spreads nothing at all — replicated
    first_idx = 0 if (pc.wn_bin_center[0] - pc.wn_bin_width[0] / 2.0
                      <= wave[0]) else nb
    src_ok = (idx >= first_idx) & (idx < last_idx)

    # grid interpolation stencil: 3 candidate bins per grid point
    pos = np.searchsorted(pc.wn_bin_center, wave)
    cand = np.clip(pos[:, None] + np.array([-1, 0, 1])[None, :], 0, nb - 1)
    d_cand = (wave[:, None] - pc.wn_bin_center[cand]) / pc.wn_bin_width[cand]
    inside = (d_cand >= -0.5) & (d_cand < 0.5)
    # drop duplicate candidate indices (edge clipping)
    dup = np.zeros_like(inside)
    dup[:, 1] = cand[:, 1] == cand[:, 0]
    dup[:, 2] = (cand[:, 2] == cand[:, 1]) | (cand[:, 2] == cand[:, 0])
    inside &= ~dup
    counts = inside.sum(axis=1)
    covered = counts > 0
    # the reference's final division loop runs j in [j_min, j_max)
    # EXCLUSIVE of j_max (LineData_0.py:478), so the last covered grid
    # point is dropped — replicated for bit-parity
    out_mask = covered.copy()
    if covered.any():
        out_mask[int(np.nonzero(covered)[0][-1])] = False
    side = np.sign(d_cand)  # -1: take i-1 as secondary, +1: take i+1
    sec = np.clip(cand + side.astype(int), 0, nb - 1)
    # secondary contribution only when the neighbour exists (reference
    # :454-457: i>0 / i<N-1 guards)
    sec_ok = inside & (
        ((side < 0) & (cand > 0)) | ((side > 0) & (cand < nb - 1))
    )
    return dict(valid=valid, nbr_c=nbr_c, delta=delta, src_ok=src_ok,
                cand=cand, tent=1.0 - np.abs(d_cand), inside=inside,
                sec=sec, sec_ok=sec_ok, counts=counts, out_mask=out_mask)


def pseudo_continuum_k(
    pc: PseudoContinuum,
    wave,
    t_calc,
    p_calc,
    amb_frac,
    lineshape: str = "voigt",
    n_neighbour_bins: int = 3,
):
    """Pseudo-continuum cross-section k(NWAVE, NLAY) [cm^2 molecule^-1].

    t_calc/p_calc/amb_frac: (NLAY,) tensors of layer temperature [K],
    pressure [atm] and ambient-gas fraction; the result is in their type
    and on their device. ``wave`` is the (static) host calc grid in cm-1.
    """
    fn = voigt_mod.LINESHAPES[lineshape]
    g = _stencil(pc, np.asarray(wave), n_neighbour_bins)
    nb = pc.wn_bin_center.shape[0]

    def dev(x):
        return t_calc.new_tensor(np.asarray(x, dtype=np.float64))

    def idx(x):
        return torch.as_tensor(x, dtype=torch.long, device=t_calc.device)

    ctr = dev(pc.wn_bin_center)[None, :]
    q_t_ref = float(np.interp(pc.t_ref, pc.pf_temp, pc.pf_q))
    stim_ref = 1.0 - np.exp(-C2_CGS * pc.wn_bin_center / pc.t_ref)

    # per-layer bin physics, (NLAY, N)
    t = t_calc[:, None]
    p = p_calc[:, None]
    amb = amb_frac[:, None]
    pf_t, pf_q = dev(pc.pf_temp), dev(pc.pf_q)
    q_t = interp(t_calc, pf_t, pf_q, left=pf_q[0], right=pf_q[-1])
    q_ratio = (q_t_ref / q_t)[:, None]
    boltz = torch.exp(
        C2_CGS * (t - pc.t_ref) / (t * pc.t_ref) * dev(pc.lsw_e_lower)[None, :]
    )
    stim = 1.0 - torch.exp(-C2_CGS * ctr / t)
    s = dev(pc.strength_sum)[None, :] * (stim / dev(stim_ref)[None, :]) \
        * boltz * q_ratio
    alpha_d = DOPPLER_CONST * ctr * torch.sqrt(t / pc.mass)
    t_ratio = pc.t_ref / t
    p_ratio = p / pc.p_ref
    gamma_l = (
        t_ratio ** dev(pc.lsw_n_self)[None, :]
        * dev(pc.lsw_gamma_self)[None, :] * (1.0 - amb)
        + t_ratio ** dev(pc.lsw_n_amb)[None, :]
        * dev(pc.lsw_gamma_amb)[None, :] * amb
    ) * p_ratio

    # neighbour-spread stencil (reference :421-432): per-bin lineshape over
    # the (2K+1) neighbour deltas, normalised per SOURCE bin
    valid = dev(g["valid"])
    y = fn(dev(g["delta"])[None], alpha_d[:, :, None], gamma_l[:, :, None])
    y = y * valid
    ysum = torch.sum(y, dim=2, keepdim=True)
    w = torch.where(ysum > 0, y / ysum, 0.0)
    contrib = s[:, :, None] * w * dev(g["src_ok"])[None, :, None]
    # scatter-add to neighbour positions: x[l, i+dk] += contrib[l, i, k]
    nlay = t_calc.shape[0]
    x = t_calc.new_zeros((nlay, nb)).index_add(
        1, idx(g["nbr_c"]).reshape(-1), (contrib * valid).reshape(nlay, -1))
    x = x / dev(pc.wn_bin_width)  # per-bin continuum density (:434-435)

    # tent interpolation onto the grid with count normalisation
    tent = dev(g["tent"])
    prim = tent * x[:, idx(g["cand"])]
    secd = (1.0 - tent) * x[:, idx(g["sec"])]
    z0 = torch.sum(
        (prim * dev(g["inside"]) + secd * dev(g["sec_ok"])) * pc.abundance,
        dim=2,
    )
    z1 = dev(g["counts"])
    out_mask = torch.as_tensor(g["out_mask"], device=t_calc.device)
    k = torch.where(out_mask, z0 / torch.clamp(z1, min=1.0), 0.0)
    return k.T  # (NWAVE, NLAY)
