"""Random-overlap mixing of correlated-k distributions.

Port of the JAX package's ``ops/overlap.py`` (reference resort-rebin
``ForwardModel_0.py:5843`` k_overlapg / ``:5960`` rankg).

Algorithm: for each gas pair, form the NG x NG random-overlap sums
``tau_ij = tau_a[i] + tau_b[j]`` with weights ``w_ij = del_g[i]*del_g[j]``,
sort by tau, lay the sorted elements end-to-end on [0,1] (cumulative
weight), and average tau over each output g-bin, splitting elements that
straddle a bin edge proportionally.

``_combine_pair`` here is the plain PyTorch version of the combine. On a
CUDA tensor ``mix_gas_k`` goes through ``ops.overlap_cuda.combine_pair``,
which launches the hand-written kernel (``csrc/overlap_combine.cu``).
"""

import numpy as np
import torch

# rows per chunk of the plain combine: bounds its (rows, NG*NG, NG)
# interval-overlap tensor to about 2**26 elements (512 MiB in float64)
_PLAIN_CHUNK_ELEMS = 2**26


def overlap_nstraddle(del_g: np.ndarray) -> int:
    """Max number of output bins a sorted element can intersect (static)."""
    del_g = np.asarray(del_g)
    max_elem = float(del_g.max()) ** 2
    min_bin = float(del_g.min())
    return int(np.floor(max_elem / min_bin)) + 2


def g_bin_edges(del_g: np.ndarray) -> np.ndarray:
    """Output g-bin edges: cumsum of del_g with the top edge forced to 1
    (mirrors rankg's g_ord construction)."""
    del_g = np.asarray(del_g, dtype=np.float64)
    edges = np.zeros(del_g.shape[0] + 1)
    edges[1:] = np.cumsum(del_g)
    edges[-1] = 1.0
    return edges


def pair_weights(del_g: np.ndarray) -> np.ndarray:
    """(NG*NG,) float64 pair weights del_g[i]*del_g[j], i-major."""
    del_g = np.asarray(del_g, dtype=np.float64)
    return (del_g[:, None] * del_g[None, :]).reshape(-1)


def _combine_rows(w2, lo_e, hi_e, tau_a, tau_b):
    ng = tau_a.shape[-1]
    tau = (tau_a[:, :, None] + tau_b[:, None, :]).reshape(-1, ng * ng)
    tau_s, order = torch.sort(tau, dim=-1)
    w_s = w2[order]
    ghi = torch.cumsum(w_s, dim=-1)
    glo = ghi - w_s
    # interval overlap of each sorted element [glo, ghi) with each output
    # g-bin [e_j, e_{j+1}), contracted over elements
    inter = (
        torch.minimum(ghi[..., None], hi_e)
        - torch.maximum(glo[..., None], lo_e)
    ).clamp_min_(0.0)
    num = torch.einsum("rn,rnj->rj", tau_s, inter)
    den = inter.sum(dim=-2)
    return num / den.clamp_min(torch.finfo(tau.dtype).tiny)


def _combine_pair(w2, g_edges, tau_a, tau_b):
    """Random-overlap combine of two k-distributions (plain version).

    tau_a, tau_b: (..., NG) optical-depth distributions.
    w2: (NG*NG,) pair weights; g_edges: (NG+1,) output bin edges.
    Returns (..., NG) in the dtype of tau_a.
    """
    ng = tau_a.shape[-1]
    batch = tau_a.shape[:-1]
    w2 = torch.as_tensor(w2, dtype=tau_a.dtype, device=tau_a.device)
    g_edges = torch.as_tensor(g_edges, dtype=tau_a.dtype, device=tau_a.device)
    lo_e, hi_e = g_edges[:-1], g_edges[1:]
    a = tau_a.reshape(-1, ng)
    b = tau_b.reshape(-1, ng)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // ng**3)
    out = torch.cat([
        _combine_rows(w2, lo_e, hi_e, a[r:r + chunk], b[r:r + chunk])
        for r in range(0, a.shape[0], chunk)
    ]) if a.shape[0] else a.clone()
    return out.reshape(*batch, ng)


def mix_gas_k(del_g, k_gas, amounts):
    """Sequentially mix per-gas k-distributions into layer optical depths.

    Parameters
    ----------
    del_g : (NG,) host g-bin widths (numpy or tuple)
    k_gas : (NWAVE, NG, NLAY, NGAS) per-gas k at layer (P,T) [cm^2]
    amounts : (NGAS, NLAY) per-gas column densities [cm^-2]

    Returns
    -------
    tau : (NWAVE, NG, NLAY) mixed gas optical depth.

    Skip semantics match the reference (k_overlapg cutoff=0): a gas whose
    largest-g optical depth is <= 0 in a layer contributes nothing there,
    and mixing with an empty accumulated distribution is a copy. Each pair
    goes through ``overlap_cuda.combine_pair``: the kernel on a CUDA tensor,
    the plain version on a CPU one.
    """
    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair

    del_g = tuple(float(x) for x in np.asarray(del_g))
    nwave, ng, nlay, ngas = k_gas.shape

    # (NWAVE, NG, NLAY, NGAS) -> (NWAVE, NLAY, NG, NGAS): g fast axis
    k_wlg = k_gas.permute(0, 2, 1, 3)

    tau = (k_wlg[..., 0] * amounts[0][None, :, None]).contiguous()
    for i in range(1, ngas):
        tau_b = (k_wlg[..., i] * amounts[i][None, :, None]).contiguous()
        mixed = combine_pair(
            tau.view(-1, ng), tau_b.view(-1, ng), del_g
        ).view(nwave, nlay, ng)
        skip_b = (tau_b[..., -1] <= 0.0)[..., None]
        skip_a = (tau[..., -1] <= 0.0)[..., None]
        tau = torch.where(skip_b, tau, torch.where(skip_a, tau_b, mixed))
    return tau.permute(0, 2, 1)
