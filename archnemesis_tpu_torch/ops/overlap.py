"""Random-overlap mixing of correlated-k distributions.

Port of the JAX package's ``ops/overlap.py`` (reference resort-rebin
``ForwardModel_0.py:5843`` k_overlapg / ``:5960`` rankg).

Algorithm: for each gas pair, form the NG x NG random-overlap sums
``tau_ij = tau_a[i] + tau_b[j]`` with weights ``w_ij = del_g[i]*del_g[j]``,
sort by tau, lay the sorted elements end-to-end on [0,1] (cumulative
weight), and average tau over each output g-bin, splitting elements that
straddle a bin edge proportionally.

``_combine_pair`` here is the plain PyTorch version of the combine. On a
CUDA tensor ``mix_gas_k`` goes through ``ops.overlap_cuda.mix_pair``,
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


def _combine_rows(w2, lo_e, hi_e, tau_a, tau_b, dta=None, dtb=None):
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
    den = inter.sum(dim=-2).clamp_min(torch.finfo(tau.dtype).tiny)
    if dta is None:
        return num / den
    # tangents of the pair sums, carried through the primal's permutation
    # and rebinned with its overlaps and denominators
    dtau = (dta[:, :, :, None] + dtb[:, :, None, :]).reshape(
        dta.shape[0], -1, ng * ng)
    dtau_s = torch.gather(dtau, -1, order.expand(dtau.shape))
    dnum = torch.einsum("trn,rnj->trj", dtau_s, inter)
    return num / den, dnum / den


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


def _combine_pair_with_tangents(w2, g_edges, tau_a, tau_b, dta, dtb):
    """Fused primal + tangent combine (plain version): (R, NG) x2 and
    (T, R, NG) x2 -> (out (R, NG), dout (T, R, NG)), chunked over rows."""
    rows, ng = tau_a.shape
    n_tan = dta.shape[0]
    w2 = torch.as_tensor(w2, dtype=tau_a.dtype, device=tau_a.device)
    g_edges = torch.as_tensor(g_edges, dtype=tau_a.dtype, device=tau_a.device)
    lo_e, hi_e = g_edges[:-1], g_edges[1:]
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (ng**2 * max(ng, n_tan)))
    outs, douts = [], []
    for r in range(0, rows, chunk):
        o, d = _combine_rows(w2, lo_e, hi_e, tau_a[r:r + chunk],
                             tau_b[r:r + chunk], dta[:, r:r + chunk],
                             dtb[:, r:r + chunk])
        outs.append(o)
        douts.append(d)
    if not outs:
        return tau_a.clone(), dta.clone()
    return torch.cat(outs), torch.cat(douts, dim=1)


def mix_gas_k(del_g, k_gas, amounts):
    """Sequentially mix per-gas k-distributions into layer optical depths.

    Parameters
    ----------
    del_g : (NG,) host g-bin widths (numpy or tuple)
    k_gas : (NWAVE, NG, NLAY, NGAS) per-gas k at layer (P,T) [cm^2], or the
        same in factored form (``ops.ktab.LayerK``, forward-mode
        derivatives), which forms each gas's tangent only when its combine
        takes it
    amounts : (NGAS, NLAY) per-gas column densities [cm^-2]

    Returns
    -------
    tau : (NWAVE, NG, NLAY) mixed gas optical depth.

    Skip semantics match the reference (k_overlapg cutoff=0): a gas whose
    largest-g optical depth is <= 0 in a layer contributes nothing there,
    and mixing with an empty accumulated distribution is a copy. Each pair
    goes through ``overlap_cuda.mix_pair`` (the combine and the skip rule):
    the kernel on a CUDA tensor, the plain version on a CPU one.
    """
    from archnemesis_tpu_torch.ops.ktab import LayerK
    from archnemesis_tpu_torch.ops.overlap_cuda import mix_pair

    del_g = tuple(float(x) for x in np.asarray(del_g))
    if isinstance(k_gas, LayerK):
        ngas = k_gas.ngas
        _, nwave, nlay, ng = k_gas.k.shape

        def gas_tau(i):
            return k_gas.tau(i, amounts[i])
    else:
        nwave, ng, nlay, ngas = k_gas.shape
        # (NWAVE, NG, NLAY, NGAS) -> (NWAVE, NLAY, NG, NGAS): g fast axis
        k_wlg = k_gas.permute(0, 2, 1, 3)

        def gas_tau(i):
            return (k_wlg[..., i] * amounts[i][None, :, None]).contiguous()

    tau = gas_tau(0)
    for i in range(1, ngas):
        tau = mix_pair(tau.reshape(-1, ng), gas_tau(i).reshape(-1, ng),
                       del_g).reshape(nwave, nlay, ng)
    return tau.permute(0, 2, 1)
