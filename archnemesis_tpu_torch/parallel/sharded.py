"""Wave sharding of the runtime line-by-line synthesis.

Port of the JAX package's ``parallel/sharded.py``. The synthesis tiles the
wave grid into static blocks whose line gathers already include the
75 cm-1 far-wing window and the pressure-shift margin (``ops/lbl.py:
build_blocks``). That halo makes wave sharding local: each wave shard owns
a contiguous run of blocks plus exactly the slice of the sorted line list
its blocks reference, lines near a shard boundary duplicated into both
neighbours' slices. Line data are fixed for a whole run, so the halo is
resolved once, at partition time, and the synthesis needs no collective.

``shard_lbl_blocks`` makes the JAX package's partition, field by field.
Its kernel packing follows the port's kernel (``ops/lbl_cuda.py:
kernel_inputs``: ten line columns, the wave grid's two parts, each block's
exact (start, count) line range), not the Pallas kernel's 512-line chunk
ranges, and ``place`` puts it on the rank's device once. ``shard_runtime_lbl``
partitions every gas of a ``RuntimeLBL``; ``forward.runtime_lbl_tau`` then
calls ``sharded_lbl_cross_section``, one kernel launch per shard per gas
(``ops/lbl_cuda.py:lbl_kernel_packed``; the plain version on the CPU), and
every later per-wave stage runs on the rank's own waves. The only exchange
of the forward is the gather of the calc-grid spectrum (``parallel/mesh.py:
WaveSlice.gather``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from archnemesis_tpu_torch.ops.lbl import LblBlocks, default_factor
from archnemesis_tpu_torch.ops.lbl_cuda import (
    LblSpec,
    kernel_inputs,
    lbl_kernel_packed,
)
from archnemesis_tpu_torch.parallel.mesh import WaveMesh, WaveSlice
from archnemesis_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardedLblData:
    """Per-gas static partition of (blocks, lines) over wave shards.

    The leading axis of every array is the shard index. The host partition
    (host numpy) has the JAX package's fields; ``packed`` holds the kernel
    inputs of this rank's shards on its device once ``place`` has run."""

    n_shards: int
    blocks_per_shard: int
    block_width: int
    max_lines_per_block: int
    n_wave: int  # true (untrimmed) grid length

    # (S, Bs, M) block->line gathers, RELATIVE to the shard's line slice
    line_idx: Any
    line_mask: Any
    wn: Any  # (S, Bs * W) padded wave grid
    wn_lo: Any  # (S, Bs * W) float32 lo parts (two-float delta, ops/lbl.py)
    # (S, Lmax) halo'd line-parameter slices
    nu: Any
    nu_lo: Any  # (S, Lmax) float32 lo parts of the line centres
    sw: Any
    elower: Any
    stim_ref: Any
    broad: Any  # (S, 6, Lmax)

    # the port's kernel ranges: (S, Bs) first line of each block in its
    # shard's slice and the block's line count; (S,) each shard's slice
    # [line_lo, line_hi) of the full list (its halo'd line count)
    starts: Any = None
    counts: Any = None
    line_lo: Any = None
    line_hi: Any = None
    include_pressure_shift: bool = True

    # placed by ``place``: this rank's shard indices and, per shard, the
    # kernel inputs (``ops/lbl_cuda.py:kernel_inputs``) on its device
    shards: tuple = ()
    packed: tuple = ()

    def shard_lines(self, ll, s: int):
        """The line list of shard ``s``: ``ll`` with its halo'd slice."""
        return dataclasses.replace(
            ll, nu=self.nu[s], sw=self.sw[s], elower=self.elower[s],
            stim_ref=self.stim_ref[s], broad=self.broad[s])

    def shard_blocks(self, s: int) -> LblBlocks:
        """The blocking of shard ``s`` against its line slice."""
        return LblBlocks(
            block_width=self.block_width, n_blocks=self.blocks_per_shard,
            max_lines_per_block=self.max_lines_per_block,
            line_idx=self.line_idx[s], line_mask=self.line_mask[s],
            wn_pad=self.wn[s], n_wave=self.blocks_per_shard * self.block_width,
            starts=self.starts[s], counts=self.counts[s])


def shard_lbl_blocks(ll, blocks, n_shards: int,
                     include_pressure_shift: bool = True) -> ShardedLblData:
    """Host-side partitioner: contiguous block groups + halo'd line slices
    (the lines each group's gathers reference), padded to uniform shapes,
    with each block's line range relative to its shard's slice."""
    b, w, m = blocks.n_blocks, blocks.block_width, blocks.max_lines_per_block
    bs = -(-b // n_shards)
    bp = bs * n_shards

    idx = np.zeros((bp, m), dtype=np.int64)
    idx[:b] = blocks.line_idx
    mask = np.zeros((bp, m))
    mask[:b] = blocks.line_mask
    wn = np.full(bp * w, blocks.wn_pad[-1],
                 dtype=np.asarray(blocks.wn_pad).dtype)
    wn[: b * w] = blocks.wn_pad

    lo = np.zeros(n_shards, dtype=np.int64)
    hi = np.zeros(n_shards, dtype=np.int64)
    for s in range(n_shards):
        rows_i = idx[s * bs:(s + 1) * bs]
        rows_m = mask[s * bs:(s + 1) * bs] > 0
        if rows_m.any():
            lo[s] = rows_i[rows_m].min()
            hi[s] = rows_i[rows_m].max() + 1
    lmax = max(int((hi - lo).max()), 1)

    def slice_pad(arr, fill):
        arr = np.asarray(arr)
        out = np.full((n_shards, lmax), fill, dtype=arr.dtype)
        for s in range(n_shards):
            out[s, :hi[s] - lo[s]] = arr[lo[s]:hi[s]]
        return out

    broad = np.zeros((n_shards, 6, lmax), dtype=np.asarray(ll.broad).dtype)
    rel_idx = np.zeros((n_shards, bs, m), dtype=np.int32)
    rel_mask = np.zeros((n_shards, bs, m))
    for s in range(n_shards):
        broad[s, :, :hi[s] - lo[s]] = np.asarray(ll.broad)[:, lo[s]:hi[s]]
        rows_m = mask[s * bs:(s + 1) * bs]
        rel_idx[s] = np.where(rows_m > 0, idx[s * bs:(s + 1) * bs] - lo[s], 0)
        rel_mask[s] = rows_m

    nu_sl = slice_pad(ll.nu, 1.0)
    wn_row = wn.reshape(n_shards, bs * w)

    def lo_part(x):
        x = np.asarray(x, np.float64)
        return (x - x.astype(np.float32)).astype(np.float32)

    counts = (rel_mask > 0).sum(axis=2).astype(np.int64)
    starts = np.where(counts > 0, rel_idx[:, :, 0], 0).astype(np.int64)
    return ShardedLblData(
        n_shards=n_shards, blocks_per_shard=bs, block_width=w,
        max_lines_per_block=m, n_wave=blocks.n_wave,
        line_idx=rel_idx, line_mask=rel_mask, wn=wn_row, wn_lo=lo_part(wn_row),
        # pad values keep the physics finite: nu=1 (alpha_d > 0),
        # stim_ref=1; sw=0 and mask=0 already zero the contribution
        nu=nu_sl, nu_lo=lo_part(nu_sl), sw=slice_pad(ll.sw, 0.0),
        elower=slice_pad(ll.elower, 0.0),
        stim_ref=slice_pad(ll.stim_ref, 1.0), broad=broad,
        starts=starts, counts=counts, line_lo=lo, line_hi=hi,
        include_pressure_shift=bool(include_pressure_shift),
    )


def shard_spec(ll, sh: ShardedLblData, s: int, lineshape: str = "voigt",
               s_floor: float = 0.0, wn_calc_window: float = 25.0,
               wn_approx_window: float = 75.0, factor=None,
               packed=None) -> LblSpec:
    """The synthesis of shard ``s`` (its line slice, its blocks, the
    options) with its packed kernel inputs (``kernel_inputs``), if
    given."""
    if packed is not None:
        cols = packed["cols"]
        packed = {(cols.dtype, cols.device): packed}
    return LblSpec(
        ll=sh.shard_lines(ll, s), blocks=sh.shard_blocks(s),
        lineshape=lineshape, s_floor=float(s_floor),
        wn_calc_window=float(wn_calc_window),
        wn_approx_window=float(wn_approx_window),
        include_pressure_shift=sh.include_pressure_shift,
        factor=float(default_factor(ll) if factor is None else factor),
        packed=packed)


def place(sh: ShardedLblData, ll, mesh: WaveMesh, dtype=torch.float64,
          device=None) -> ShardedLblData:
    """The partition with the kernel inputs of this rank's wave shards
    packed in ``dtype`` on ``device`` (None = the CUDA card), once."""
    device = resolve_device(device)
    shards = tuple(mesh.wave_shards())
    if mesh.n_wave != sh.n_shards:
        raise ValueError(f"mesh has {mesh.n_wave} wave shards, the "
                         f"partition {sh.n_shards}")
    packed = tuple(kernel_inputs(shard_spec(ll, sh, s), dtype, device)
                   for s in shards)
    return dataclasses.replace(sh, shards=shards, packed=packed)


def shard_runtime_lbl(rt, mesh: WaveMesh, dtype=torch.float64, device=None):
    """Partition a windowed ``RuntimeLBL``'s per-gas blocks over the mesh's
    wave shards and place this rank's kernel inputs in ``dtype`` on
    ``device`` (None = the CUDA card). The result carries the partition
    (``shard_data``) and the rank's ``wave_slice``: the forward then runs
    the synthesis and every later per-wave stage on the rank's waves and
    gathers the spectrum."""
    if not rt.blocks:
        raise ValueError("shard a windowed RuntimeLBL (rt.windowed(...))")
    shards = tuple(
        place(shard_lbl_blocks(ll, blk, mesh.n_wave, shift), ll, mesh,
              dtype=dtype, device=device)
        for ll, blk, shift in zip(rt.line_lists, rt.blocks,
                                  rt.include_pressure_shift))
    lens = {sh.blocks_per_shard * sh.block_width for sh in shards}
    if len(lens) != 1:
        raise ValueError(f"the gases' wave shards differ in length: {lens}")
    ws = WaveSlice(mesh=mesh, n_wave=int(np.asarray(rt.wave).shape[0]),
                   shard_len=lens.pop())
    lo, hi = ws.bounds()
    if hi <= lo:
        raise ValueError(f"rank {mesh.rank} holds no wave of the grid: "
                         f"{np.asarray(rt.wave).shape[0]} waves over "
                         f"{mesh.n_wave} shards of {ws.shard_len}")
    return dataclasses.replace(rt, shard_data=shards, wave_slice=ws)


def sharded_lbl_cross_section(
    ll, sh: ShardedLblData, mesh: WaveMesh, t_calc, p_calc, amb_frac,
    lineshape: str = "voigt", s_floor: float = 0.0,
    wn_calc_window: float = 25.0, wn_approx_window: float = 75.0,
    include_pressure_shift: bool = True, factor=None,
):
    """k(NWAVE_rank, NLAY) on this rank's wave shards: one synthesis per
    shard on its own line slice and blocks (its halo), concatenated and
    cut to the rank's part of the true grid; no collective. A CUDA tensor
    launches the packed kernel once per shard (``lbl_kernel_packed``), a
    CPU tensor runs the plain version per shard. Forward-mode
    differentiable as ``ops/lbl_cuda.py:lbl_cross_section``."""
    if bool(include_pressure_shift) != sh.include_pressure_shift:
        raise ValueError("the partition was packed with include_pressure_"
                         f"shift={sh.include_pressure_shift}")
    if tuple(mesh.wave_shards()) != sh.shards:
        raise ValueError(f"the partition was placed for shards {sh.shards}, "
                         f"this rank computes {tuple(mesh.wave_shards())}")
    ks = [lbl_kernel_packed(
        shard_spec(ll, sh, s, lineshape, s_floor, wn_calc_window,
                   wn_approx_window, factor, packed),
        t_calc, p_calc, amb_frac)
        for s, packed in zip(sh.shards, sh.packed)]
    first = sh.shards[0] * sh.blocks_per_shard * sh.block_width
    return torch.cat(ks)[: max(sh.n_wave - first, 0)]
