"""A/B variants of the random-overlap combine: the Hopper kernel and its
plain versions.

The variants of the TPU tool ``combine_lean``
(``tools/bench_overlap_variants.py:131``), the lower bounds a redesign of
the combine kernel is measured against:

- ``full``: the combine with static pair weights, min/max compare-exchange
  and a weight that moves only where its key changed;
- ``edges``: the same sort, rebinned through cumulative edge sums (NG + 1
  edge sums instead of NG bins of two clipped ends);
- ``sortonly``: the compare-exchange stages on the keys alone (the NG
  smallest pair sums, ascending);
- ``rollonly``: the stages' data movement alone (the padded pair-sum row
  rotated by the sum of the network's strides, its first NG columns).

``combine_lean`` launches the kernel of ``csrc/overlap_variants.cu`` on a
CUDA tensor, in the layout of the combine kernel (``csrc/overlap_combine.cu``),
and runs the plain version ``combine_lean_plain`` on a CPU one. float32
only, as the TPU tool is.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from archnemesis_tpu_torch.ops import cuda_build
from archnemesis_tpu_torch.ops.overlap import g_bin_edges, pair_weights

MODES = ("full", "edges", "sortonly", "rollonly")
ROW_TILE = 256  # rows per block: the TPU tool's default row tile
# the full mode's row-tile sweep of the TPU tool (lean8 .. lean128)
ROW_TILES = (8, 16, 32, 64, 128, ROW_TILE)
MAX_NG = 22  # the kernel's rows hold at most 512 pair sums
DEN_FLOOR = 1e-37  # the rebins' denominator floor (the TPU tool's)
# rows per chunk of the plain version: bounds its (rows, NG*NG, NG + 1)
# overlap tensor to about 2**26 elements
_PLAIN_CHUNK_ELEMS = 2**26


def ref_pad(ng: int) -> int:
    """The TPU kernel's padded row length: next power of two of NG*NG."""
    return 1 << (ng * ng - 1).bit_length()


def e_pad(ng: int) -> int:
    """This kernel's row length: the TPU one's, at least one per lane."""
    return max(32, ref_pad(ng))


def roll_shift(ng: int) -> int:
    """Sum of the strides of the bitonic network over ``ref_pad(ng)``
    elements (sizes 2^s, s = 1..log2, each with strides 2^(s-1) .. 1), the
    rotation of ``rollonly`` modulo the padded length."""
    log_e = ref_pad(ng).bit_length() - 1
    return sum((1 << s) - 1 for s in range(1, log_e + 1)) % ref_pad(ng)


def build() -> dict:
    """Compile the kernel library (once per source content) and return
    ``{"path", "seconds", "ptxas"}`` (``ops.cuda_build.build``)."""
    return cuda_build.build("overlap_variants")


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(build()["path"])
    lib.overlap_variant_f32.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
    lib.overlap_variant_f32.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _tables(del_g: tuple, device: torch.device):
    """Device copies of the padded pair weights and the bin edges for one
    static del_g, in float32."""
    ng = len(del_g)
    w2 = np.zeros(e_pad(ng))
    w2[: ng * ng] = pair_weights(del_g)
    return (torch.as_tensor(w2, dtype=torch.float32, device=device),
            torch.as_tensor(g_bin_edges(del_g), dtype=torch.float32,
                            device=device))


def _rebin_rows(keys, w, lo_e, hi_e, edges, mode):
    """The rebin of sorted rows: (rows, n) keys and weights -> (rows, NG)."""
    ghi = torch.cumsum(w, dim=-1)
    glo = ghi - w
    if mode == "full":
        inter = (torch.minimum(ghi[..., None], hi_e)
                 - torch.maximum(glo[..., None], lo_e)).clamp_min_(0.0)
        num = (inter * keys[..., None]).sum(dim=-2)
        den = inter.sum(dim=-2)
    else:
        c = torch.minimum((edges - glo[..., None]).clamp_min_(0.0),
                          w[..., None])
        s = (c * keys[..., None]).sum(dim=-2)
        wsum = c.sum(dim=-2)
        num, den = s[:, 1:] - s[:, :-1], wsum[:, 1:] - wsum[:, :-1]
    return num / den.clamp_min(DEN_FLOOR)


def combine_lean_plain(tau_a, tau_b, del_g, mode: str = "full"):
    """Plain PyTorch version of one mode on (R, NG) tensors: ``torch.sort``
    (stable) with the weights gathered by its permutation, ``cumsum`` and
    the overlap or edge-sum rebin for ``full``/``edges``; ``torch.sort``
    alone for ``sortonly``; ``torch.roll`` of the padded row for
    ``rollonly``. The result has tau_a's type."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    del_g = np.asarray(del_g, dtype=np.float64)
    ng, rows = del_g.shape[0], tau_a.shape[0]
    n = ng * ng
    pairs = (tau_a[:, :, None] + tau_b[:, None, :]).reshape(rows, n)
    if mode == "rollonly":
        row = pairs.new_full((rows, ref_pad(ng)),
                             torch.finfo(pairs.dtype).max)
        row[:, :n] = pairs
        return torch.roll(row, roll_shift(ng), dims=1)[:, :ng]
    if mode == "sortonly":
        return torch.sort(pairs, dim=1).values[:, :ng]
    w2 = pairs.new_tensor(pair_weights(del_g))
    edges = pairs.new_tensor(g_bin_edges(del_g))
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (n * (ng + 1)))
    out = []
    for r in range(0, rows, chunk):
        keys, order = torch.sort(pairs[r:r + chunk], dim=1, stable=True)
        out.append(_rebin_rows(keys, w2[order], edges[:-1], edges[1:],
                               edges, mode))
    return torch.cat(out) if out else pairs[:, :ng].clone()


def _check_cuda_inputs(tau_a, tau_b, ng, mode, rows_per_cta):
    for name, t in (("tau_a", tau_a), ("tau_b", tau_b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}; the variants are "
                            "float32 only, as the TPU tool is")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tau_b.device != tau_a.device:
        raise ValueError("tau_a and tau_b lie on different devices")
    if tau_a.dim() != 2 or tau_a.shape != tau_b.shape:
        raise ValueError(
            f"need two (R, NG) tensors of one shape, got {tuple(tau_a.shape)}"
            f" and {tuple(tau_b.shape)}")
    if tau_a.shape[1] != ng:
        raise ValueError(f"rows have {tau_a.shape[1]} g-ordinates, del_g {ng}")
    if not 1 <= ng <= MAX_NG:
        raise ValueError(f"NG={ng} outside 1..{MAX_NG} (rows of <= 512)")
    if tau_a.shape[0] * ng >= 2**31:
        raise ValueError("too many rows for 32-bit row indexing")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if rows_per_cta not in ROW_TILES or (rows_per_cta != ROW_TILE
                                         and mode != "full"):
        raise ValueError(f"rows per block {rows_per_cta}: {ROW_TILE} for "
                         f"every mode, {ROW_TILES[:-1]} for full")


def combine_lean(tau_a, tau_b, del_g, mode: str = "full",
                 rows_per_cta: int = ROW_TILE):
    """One mode of the variants on (R, NG) float32 tensors. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel with
    ``rows_per_cta`` rows per block and adds one to
    ``combine_lean.launches[mode]``."""
    del_g = tuple(float(x) for x in np.asarray(del_g, dtype=np.float64))
    ng = len(del_g)
    if tau_a.dtype != torch.float32:
        raise TypeError(f"tau_a: dtype {tau_a.dtype}; the variants are "
                        "float32 only, as the TPU tool is")
    if tau_a.device.type == "cpu":
        return combine_lean_plain(tau_a, tau_b, del_g, mode)
    if tau_a.device.type != "cuda":
        raise ValueError(f"no overlap variants for device {tau_a.device}")
    _check_cuda_inputs(tau_a, tau_b, ng, mode, rows_per_cta)
    w2, edges = _tables(del_g, tau_a.device)
    out = torch.empty_like(tau_a)
    err = _library().overlap_variant_f32(
        tau_a.data_ptr(), tau_b.data_ptr(), w2.data_ptr(), edges.data_ptr(),
        out.data_ptr(), tau_a.shape[0], ng, e_pad(ng),
        ref_pad(ng).bit_length() - 1, MODES.index(mode), rows_per_cta,
        tau_a.device.index or 0,
        torch.cuda.current_stream(tau_a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"overlap_variant launch failed: CUDA error {err}")
    combine_lean.launches[mode] += 1
    return out


combine_lean.launches = dict.fromkeys(MODES, 0)
