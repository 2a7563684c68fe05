"""Least times of the kernels' work on an H100, from the cell's inputs.

Frozen copies of the counts the port's card script gives
(``chip_smoke.py:combine_ops_per_row``, ``combine_bound_ms``,
``lbl_pair_counts``, ``lbl_bound_ms``): what the algorithm needs for these
inputs, not what a kernel happens to do, so that a bound reads the same
work whatever implements the layer. Peaks are NVIDIA's data sheet for the
H100 SXM at 700 W (dense, outside the tensor cores); the run prints the
card's power limit beside every share.
"""

from __future__ import annotations

import math

import numpy as np

PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_F64_OPS_S = 34e12


def combine_ops_per_row(ng: int, presorted: bool) -> int:
    """One row of a random-overlap combine: the NG^2 pair sums; the sort
    of the n = NG^2 keys, one comparison each (a merge of NG presorted runs,
    n ceil(log2 NG), when both inputs are sorted along g, else n ceil(log2
    n)); the n-step prefix sum; 7 operations per (element, bin) overlap, at
    most n + NG - 1 of them; NG divisions."""
    n = ng * ng
    sort = n * math.ceil(math.log2(ng if presorted else n))
    return n + sort + n + 7 * (n + ng - 1) + ng


def combine_bound_ms(rows: int, ng: int, itemsize: int,
                     presorted: bool = True) -> float:
    """Least time of one combine: the larger of its bytes (two inputs read,
    one output written) over HBM bandwidth and its operations over the
    float32 peak."""
    bytes_ms = 3 * rows * ng * itemsize / PEAK_BYTES_S * 1e3
    ops_ms = rows * combine_ops_per_row(ng, presorted) / PEAK_F32_OPS_S * 1e3
    return max(bytes_ms, ops_ms)


# Operations of the line-by-line synthesis, counting an exp, a pow, a sqrt
# and a division as one each. Re w(z) by Weideman's 24-term expansion: 188;
# by the 6-convergent continued fraction in its ratio form (|z|^2 > 49 in
# float32): 57. Every (line, wave) pair inside the window: 10 in float32
# (two-float delta, window tests, weighted add), 7 in float64; a core pair
# beyond Re w: 8 / 4; a wing pair: 2; per (layer, line): 25 plus the wing
# value's Re w.
LBL_OPS_WEIDEMAN, LBL_OPS_CF = 188, 57
LBL_OPS_PAIR = {4: 10, 8: 7}
LBL_OPS_CORE = {4: 8, 8: 4}
LBL_OPS_WING, LBL_OPS_LINE = 2, 25
# the wave blocks' width in the line ranges the synthesis reads
LBL_BLOCK = 128


def lbl_pair_counts(nu, strength, alpha_d, gamma_l, shift, wave,
                    wn_calc: float, wn_approx: float):
    """(core_cf, core_weideman, wing, lines) of one synthesis: for each
    (layer, line) of non-zero strength the waves within wn_calc of the
    shifted centre (split at |z|^2 = 49) and those from wn_calc to
    wn_approx. Line parameters (NLAY, NLINE) float64 numpy, ``nu`` and the
    grid ``wave`` host float64."""
    ctr = nu[None, :] + shift
    live = strength > 0

    def within(half):
        lo = np.searchsorted(wave, ctr - half, side="left")
        hi = np.searchsorted(wave, ctr + half, side="left")
        return np.where(live, hi - lo, 0)

    core, full = within(wn_calc), within(wn_approx)
    scale = math.sqrt(math.log(2.0)) / alpha_d
    y = gamma_l * scale
    half = np.where(y < 7.0, np.sqrt(np.maximum(49.0 - y * y, 0.0)) / scale,
                    0.0)
    weid = np.minimum(within(half), core)
    return (int((core - weid).sum()), int(weid.sum()),
            int((full - core).sum()), int(live.sum()))


def lbl_bound_ms(nu, strength, alpha_d, gamma_l, shift, wave,
                 wn_calc: float, wn_approx: float, itemsize: int) -> float:
    """Least time of one synthesis: the larger of its bytes (ten line
    columns, the grid's two parts, the block ranges and the layer scalars
    read once, k written once) over HBM bandwidth and its operations over
    the peak of its type (float32: the continued fraction where |z|^2 >
    49, float64: the expansion everywhere)."""
    cf, weid, wing, lines = lbl_pair_counts(nu, strength, alpha_d, gamma_l,
                                            shift, wave, wn_calc, wn_approx)
    nlay, nwave = strength.shape[0], wave.shape[0]
    pair, core = LBL_OPS_PAIR[itemsize], LBL_OPS_CORE[itemsize]
    if itemsize == 4:
        ops = (cf * (pair + core + LBL_OPS_CF)
               + weid * (pair + core + LBL_OPS_WEIDEMAN))
        line_w, peak = LBL_OPS_CF, PEAK_F32_OPS_S
    else:
        ops = (cf + weid) * (pair + core + LBL_OPS_WEIDEMAN)
        line_w, peak = LBL_OPS_WEIDEMAN, PEAK_F64_OPS_S
    ops += wing * (pair + LBL_OPS_WING) + lines * (LBL_OPS_LINE + line_w)
    nblock = -(-nwave // LBL_BLOCK)
    nbytes = (itemsize * (10 * nu.shape[0] + 2 * nblock * LBL_BLOCK
                          + 4 * nlay + nwave * nlay) + 8 * nblock)
    return max(nbytes / PEAK_BYTES_S * 1e3, ops / peak * 1e3)
