"""Multi-process execution: process-group start-up and the host-major mesh.

Port of the JAX package's ``parallel/multihost.py``:

1. every process calls :func:`initialize` before it builds a mesh; it
   starts ``torch.distributed`` (NCCL between CUDA cards, gloo on the CPU)
   from the launcher's environment or explicit arguments, and is a no-op
   in a single process;
2. the mesh lays the ``data`` axis across hosts and the ``wave`` axis within
   one (:func:`hosts_axis_mesh`), so the wave gather stays inside a host and
   only the data-parallel axis crosses hosts;
3. every process runs the same program on its own shards (SPMD);
   :func:`process_local_batch` assembles the global batch from each
   process's rows.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from archnemesis_tpu_torch.parallel.mesh import WaveMesh, make_mesh


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> int:
    """Start ``torch.distributed`` for a multi-process run; returns this
    process's rank (0 in a single process).

    The arguments default from the launcher's environment (``WORLD_SIZE``,
    ``RANK``; ``MASTER_ADDR``/``MASTER_PORT`` through ``init_method
    "env://"``). A no-op when neither the arguments nor the environment ask
    for more than one process: single-process runs, the tests' included,
    never start a group. ``init_method`` alone (``"file://..."``,
    ``"tcp://localhost:<port>"``) starts a group even of one process.
    ``backend`` defaults to NCCL where a CUDA card is visible, else gloo."""
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None:
        if world_size in (None, 1):
            return 0  # single process: nothing to initialise
        init_method = "env://"
    if dist.is_initialized():
        return dist.get_rank()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=1 if world_size is None else world_size,
                            rank=0 if rank is None else rank)
    return dist.get_rank()


def hosts_axis_mesh(n_hosts: Optional[int] = None,
                    n_shards: Optional[int] = None) -> WaveMesh:
    """A (hosts x wave shards) mesh: ``data`` across hosts, ``wave`` within
    one.

    ``n_shards`` logical shards in all (default: one per rank) laid out as
    (n_hosts, n_shards / n_hosts); ranks own contiguous runs in data-major
    order, so with one process per host each owns its host's row. In one
    process ``n_hosts`` simulates that layout: the partition and the gather
    are the same, only the transport differs."""
    mesh = make_mesh()
    world = mesh.world
    if n_hosts is None:
        n_hosts = world
    if n_shards is None:
        n_shards = world
    if n_shards % n_hosts:
        raise ValueError(
            f"{n_shards} shards do not split over {n_hosts} hosts")
    return WaveMesh(n_data=n_hosts, n_wave=n_shards // n_hosts,
                    group=mesh.group)


def process_local_batch(mesh: WaveMesh, local_batch):
    """The global batch from this process's part of it, as the JAX
    function's ``make_array_from_process_local_data``: each process passes
    the rows of the data shards it owns (ranks sharing a data row pass the
    same rows), and every process gets the whole batch back along the
    first axis, in data-row order, through one ``all_gather`` over the
    mesh's group (after a small one of the parts' shapes, so that parts
    that differ raise on every rank). In a single process the batch comes
    back unchanged.
    Every rank's part must have the same shape, on the group's device, and
    the global batch must split into ``n_data`` equal parts."""
    local = torch.as_tensor(local_batch)
    if mesh.group is None:
        return _check_split(local, mesh)
    world = mesh.world
    shape = torch.tensor(local.shape, dtype=torch.int64, device=local.device)
    shapes = [torch.empty_like(shape) for _ in range(world)]
    dist.all_gather(shapes, shape, group=mesh.group)
    if any(not torch.equal(x, shape) for x in shapes):
        raise ValueError("local batches differ in shape across ranks: "
                         f"{[tuple(x.tolist()) for x in shapes]}")
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    # one part per data row run: ranks own contiguous runs in data-major
    # order, so the first owner of each run supplies it
    seen, pieces = set(), []
    for r in range(world):
        rows = mesh.data_rows(r)
        if rows.start not in seen:
            seen.add(rows.start)
            pieces.append(parts[r])
    return _check_split(torch.cat(pieces), mesh)


def _check_split(batch, mesh: WaveMesh):
    if batch.shape[0] % mesh.n_data:
        raise ValueError(f"a batch of {batch.shape[0]} does not split over "
                         f"{mesh.n_data} data rows")
    return batch
