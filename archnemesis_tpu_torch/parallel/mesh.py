"""Wave sharding of the forward model over ``torch.distributed``.

Port of the JAX package's ``parallel/mesh.py``. The domain's parallel axes:

- ``wave``: the wavenumber grid. Every per-wave stage (k interpolation,
  random overlap, line-by-line synthesis, CIA, Rayleigh, dust, emission)
  is independent along it, so each wave shard runs on its own;
- ``data``: geometries, FOV points, retrievals: data parallelism.

The JAX package annotates its inputs and lets GSPMD place the work. PyTorch
has no such partitioner, so the port writes the SPMD program out: a
``WaveMesh`` is a (data, wave) grid of *logical shards* over the ranks of a
process group. Each rank owns a contiguous run of the grid (in data-major
order) and computes its wave shards one after another; with no group (one
process) it owns them all, the counterpart of the JAX tests' 8-device
virtual CPU mesh. Ranks exchange data once per forward: the calc-grid
spectrum is gathered (``WaveSlice.gather``) before the instrument function,
as the JAX design gathers it in the convolution. The OE algebra stays
replicated on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class WaveMesh:
    """A (data, wave) grid of logical shards over the ranks of ``group``
    (None: one process, which owns every shard).

    Rank r owns shards ``[r * per, (r + 1) * per)`` of the grid in
    data-major order, ``per = n_data * n_wave / world``: either whole data
    rows or a contiguous part of one row, so every rank owns the same run
    of wave shards in each of its data rows."""

    n_data: int
    n_wave: int
    group: object = None

    def __post_init__(self):
        if self.n_data < 1 or self.n_wave < 1:
            raise ValueError(f"mesh ({self.n_data}, {self.n_wave}) is empty")
        n, world = self.n_data * self.n_wave, self.world
        if n % world:
            raise ValueError(f"{n} shards do not split over {world} ranks")
        per = n // world
        if per % self.n_wave and self.n_wave % per:
            raise ValueError(
                f"{per} shards per rank neither fill whole rows of "
                f"{self.n_wave} wave shards nor divide one")

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "wave": self.n_wave}

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def per_rank(self) -> int:
        return self.n_data * self.n_wave // self.world

    @property
    def owners(self) -> np.ndarray:
        """(n_data, n_wave) rank that owns each shard (the JAX mesh's
        ``devices`` array, with ranks in place of devices)."""
        flat = np.arange(self.n_data * self.n_wave) // self.per_rank
        return flat.reshape(self.n_data, self.n_wave)

    def data_rows(self, rank: int | None = None) -> range:
        """The data rows that ``rank`` (default: this one) works on."""
        rank = self.rank if rank is None else rank
        first = rank * self.per_rank
        return range(first // self.n_wave,
                     (first + self.per_rank - 1) // self.n_wave + 1)

    def wave_shards(self, rank: int | None = None) -> range:
        """The wave shards that ``rank`` (default: this one) computes, the
        same run in each of its data rows."""
        rank = self.rank if rank is None else rank
        if self.per_rank >= self.n_wave:
            return range(self.n_wave)
        first = (rank * self.per_rank) % self.n_wave
        return range(first, first + self.per_rank)


def make_mesh(n_wave: int | None = None, n_data: int = 1) -> WaveMesh:
    """A (data, wave) mesh over the default process group where
    ``torch.distributed`` is initialised, else over one process. ``n_wave``
    defaults to one wave shard per rank and data row (the JAX
    ``make_mesh``'s one device per shard)."""
    group = None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    if n_wave is None:
        n_wave = max(world // n_data, 1)
    return WaveMesh(n_data=n_data, n_wave=n_wave, group=group)


@dataclass(frozen=True)
class WaveSlice:
    """This rank's part of a wave-sharded grid of ``n_wave`` points cut into
    ``mesh.n_wave`` shards of ``shard_len`` points (the last ones padded
    where the grid does not fill them)."""

    mesh: WaveMesh
    n_wave: int
    shard_len: int

    def bounds(self, rank: int | None = None) -> tuple:
        """(lo, hi): the grid points of ``rank``'s wave shards."""
        shards = self.mesh.wave_shards(rank)
        lo = shards.start * self.shard_len
        return lo, max(min(shards.stop * self.shard_len, self.n_wave), lo)

    def gather(self, x, dim: int = 0):
        """The full grid along ``dim`` from this rank's part of it on every
        rank (one collective over the mesh's group; with no group this rank
        holds the whole grid already). Differentiable in forward mode:
        under ``torch.func`` the tangents are gathered too, all of a vmapped
        batch in one collective."""
        return _GatherWaves.apply(x, self, dim % x.dim())


def _all_gather_waves(x, ws: WaveSlice, dim: int):
    """The collective: every rank's part, padded to its shards' length,
    gathered and cut back to the rank's data row of the full grid."""
    mesh = ws.mesh
    lo, hi = ws.bounds()
    if x.shape[dim] != hi - lo:
        raise ValueError(f"{x.shape[dim]} points along dim {dim}, this "
                         f"rank's wave shards hold {hi - lo}")
    if mesh.group is None:
        return x
    length = len(mesh.wave_shards()) * ws.shard_len
    part = x.movedim(dim, 0)
    pad = part.new_zeros((length - part.shape[0], *part.shape[1:]))
    part = torch.cat([part, pad]).contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.world)]
    dist.all_gather(parts, part, group=mesh.group)
    row = mesh.data_rows().start
    pieces = []
    for r in range(mesh.world):
        if row in mesh.data_rows(r):
            r_lo, r_hi = ws.bounds(r)
            pieces.append(parts[r][: r_hi - r_lo])
    return torch.cat(pieces).movedim(0, dim)


class _GatherWaves(torch.autograd.Function):
    """x (this rank's waves along ``dim``) -> the full grid; forward mode
    only: the tangent is gathered the same way."""

    @staticmethod
    def forward(x, ws, dim):
        return _all_gather_waves(x, ws, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.ws, ctx.dim = inputs
        ctx.like = x.new_zeros(()).expand(x.shape)

    @staticmethod
    def jvp(ctx, dx, _ws, _dim):
        # a missing tangent is a zero tangent
        dx = torch.zeros_like(ctx.like) if dx is None else dx
        return _GatherWaves.apply(dx, ctx.ws, ctx.dim)

    @staticmethod
    def vmap(info, in_dims, x, ws, dim):
        # the batch first, every tangent of it in one collective
        return _GatherWaves.apply(x.movedim(in_dims[0], 0), ws, dim + 1), 0


def shard_ktables_by_wave(ktab, mesh: WaveMesh):
    """This rank's part of wave-sharded k-tables: ``k``, ``wave`` and the
    host log-k table cut to the rank's wave shards, the rest as it is, and
    the ``wave_slice`` that the forward gathers its spectrum with. NWAVE
    must split into ``mesh.n_wave`` equal shards (``retrievals.
    make_retrieval_setup(wave_pad_multiple=n_wave)`` pads the windowed
    grid so)."""
    nwave = ktab.wave.shape[0]
    if nwave % mesh.n_wave:
        raise ValueError(f"NWAVE={nwave} does not split into {mesh.n_wave} "
                         "equal wave shards (pad the window to a multiple)")
    ws = WaveSlice(mesh=mesh, n_wave=nwave, shard_len=nwave // mesh.n_wave)
    lo, hi = ws.bounds()
    extra = {}
    if ktab.logk is not None:
        extra["logk"] = ktab.logk[:, lo:hi]
    return ktab.replace(wave=ktab.wave[lo:hi], k=ktab.k[:, lo:hi],
                        wave_slice=ws, **extra)
