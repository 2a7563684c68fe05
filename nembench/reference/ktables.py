"""Correlated-k opacity (archNEMESIS semantics): k-tables interpolated to
the layers, then the gases combined by random overlap.

Interpolation (Spectroscopy_0.py:2147 calc_kg): bilinear in (ln p, T) of
ln k where the four corners are positive, of k where all four are zero or
less, zero otherwise; pressures and temperatures outside the table take
its edge. Random overlap (ForwardModel_0.py:5843 k_overlapg, :5960 rankg):
for each added gas, the NG x NG sums of the two distributions with weights
del_g[i] del_g[j], sorted, laid end to end on [0, 1] and averaged over each
output g-bin, an element that straddles a bin edge split in proportion; a
gas with no opacity at its largest g in a layer adds nothing there.
"""

from __future__ import annotations

import numpy as np
import torch

# rows of one combine panel: bounds its (rows, NG*NG, NG) overlap tensor
PANEL_ELEMENTS = 2**25


def _bracket(grid, x):
    hi = torch.searchsorted(grid, x.contiguous()).clamp(1, grid.shape[0] - 1)
    lo = hi - 1
    return lo, hi, ((x - grid[lo]) / (grid[hi] - grid[lo])).clamp(0.0, 1.0)


def interpolate(k, press_grid, temp_grid, press_atm, temp):
    """(NWAVE, NG, NLAY, NGAS) k at the layers from a (NGAS, NWAVE, NG,
    NP, NT) table; ``press_atm``, ``temp``: (NLAY,)."""
    pl, ph, v = _bracket(torch.log(press_grid), torch.log(press_atm))
    tl, th, u = _bracket(temp_grid, temp)
    corners = [(pl, tl, (1 - v) * (1 - u)), (ph, tl, v * (1 - u)),
               (ph, th, v * u), (pl, th, (1 - v) * u)]
    vals = [k[:, :, :, i, j] for i, j, _ in corners]
    pos = vals[0] > 0
    nonpos = vals[0] <= 0
    for c in vals[1:]:
        pos = pos & (c > 0)
        nonpos = nonpos & (c <= 0)
    tiny = torch.finfo(k.dtype).tiny
    logk = sum(w * torch.log(c.clamp_min(tiny))
               for (_, _, w), c in zip(corners, vals))
    lin = sum(w * c for (_, _, w), c in zip(corners, vals))
    out = torch.where(pos, torch.exp(logk), torch.where(nonpos, lin, 0.0))
    return out.movedim(0, -1)


def combine(tau_a, tau_b, del_g):
    """Random-overlap combine of two (ROWS, NG) distributions."""
    ng = tau_a.shape[-1]
    dg = torch.as_tensor(np.asarray(del_g, np.float64), dtype=tau_a.dtype,
                         device=tau_a.device)
    w2 = (dg[:, None] * dg[None, :]).reshape(-1)
    edges = torch.cat([torch.zeros_like(dg[:1]), torch.cumsum(dg, 0)])
    edges[-1] = 1.0
    lo_e, hi_e = edges[:-1], edges[1:]
    step = max(1, PANEL_ELEMENTS // ng**3)
    out = []
    for r in range(0, tau_a.shape[0], step):
        a, b = tau_a[r:r + step], tau_b[r:r + step]
        tau, order = torch.sort((a[:, :, None] + b[:, None, :]).reshape(
            -1, ng * ng), dim=-1)
        w = w2[order]
        ghi = torch.cumsum(w, dim=-1)
        glo = ghi - w
        share = (torch.minimum(ghi[..., None], hi_e)
                 - torch.maximum(glo[..., None], lo_e)).clamp_min(0.0)
        out.append(torch.einsum("rn,rnj->rj", tau, share)
                   / share.sum(dim=-2).clamp_min(torch.finfo(tau.dtype).tiny))
    return torch.cat(out)


def mix(k_gas, amounts, del_g):
    """(NWAVE, NG, NLAY) optical depth of the gases mixed by random
    overlap, in the order of the table; ``amounts``: (NGAS, NLAY) [cm-2]."""
    nwave, ng, nlay, ngas = k_gas.shape
    k = k_gas.permute(0, 2, 1, 3)  # (NWAVE, NLAY, NG, NGAS)
    tau = k[..., 0] * amounts[0][None, :, None]
    for i in range(1, ngas):
        tau_b = k[..., i] * amounts[i][None, :, None]
        mixed = combine(tau.reshape(-1, ng), tau_b.reshape(-1, ng),
                        del_g).reshape(nwave, nlay, ng)
        tau = torch.where((tau_b[..., -1] <= 0)[..., None], tau,
                          torch.where((tau[..., -1] <= 0)[..., None], tau_b,
                                      mixed))
    return tau.permute(0, 2, 1)
