"""Wave sharding of the port over a real two-rank process group: two
processes (``torch.multiprocessing`` spawn, a gloo group rendezvousing on a
``file://`` store in the test's temporary directory, no network), each
owning half of the wave shards, run the same program; every rank's
gathered spectrum and Jacobian columns must equal the unsharded ones it
computes itself (float64: rtol 1e-12 forward, 1e-10 Jacobian, as the JAX
package's sharded tests). This file imports no JAX: the spawned processes
import it."""

import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from archnemesis_tpu_torch.forward import forward_nadir, make_forward_config
from archnemesis_tpu_torch.io.legacy import load_deck
from archnemesis_tpu_torch.parallel import mesh as mesh_mod
from archnemesis_tpu_torch.parallel import multihost
from archnemesis_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_ktables_by_wave,
)
from archnemesis_tpu_torch.parallel.sharded import shard_runtime_lbl
from archnemesis_tpu_torch.retrievals import make_retrieval_setup

FDRET = "tests/fixtures/jupiter_fdret"
CO_RUNTIME = "tests/fixtures/co_runtime"
WORLD = 2
N_WAVE = 4  # two wave shards per rank
TIMEOUT_S = 600


def _assert_close(got, want, rtol):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=want.abs().max().item() * rtol * 1e-2)


def _ktable_deck(mesh):
    """Forward and 3 Jacobian columns of jupiter_fdret, sharded and not."""
    plain = make_retrieval_setup(FDRET, "cirstest", wave_pad_multiple=N_WAVE,
                                 device="cpu")
    sharded = make_retrieval_setup(
        FDRET, "cirstest", wave_pad_multiple=N_WAVE, device="cpu",
        ktab_transform=lambda kt: shard_ktables_by_wave(kt, mesh))
    xa = torch.as_tensor(plain.sv.xa)
    nx = xa.shape[0]
    basis = torch.eye(nx, dtype=xa.dtype)[[0, nx // 2, nx - 1]]

    def columns(fn):
        return torch.func.jacfwd(lambda v: fn(xa + v @ basis))(
            xa.new_zeros(3))

    _assert_close(sharded.forward_fn(xa), plain.forward_fn(xa), 1e-12)
    _assert_close(columns(sharded.forward_fn), columns(plain.forward_fn),
                  1e-10)


def _runtime_deck(mesh):
    """The runtime deck on its first 512 waves, sharded and not."""
    deck = load_deck(CO_RUNTIME, "cirstest")
    nconv = int(deck.geometry.nconv[0])
    vconv = deck.geometry.vconv[:nconv, 0]
    rt = dataclasses.replace(deck.ktables,
                             wave=np.asarray(deck.ktables.wave)[:512])
    rt = rt.windowed(vconv.min(), vconv.max())
    rt_sh = shard_runtime_lbl(rt, mesh, device="cpu")
    cfg = make_forward_config(deck.atmosphere, rt, None,
                              iray=deck.settings.iray,
                              ispace=deck.settings.ispace, gasgiant=True)

    def forward(rt_run):
        return forward_nadir(deck.atmosphere, deck.layer_config, rt_run,
                             None, None, deck.surface, cfg, emiss_ang=0.0,
                             device="cpu")

    _assert_close(forward(rt_sh), forward(rt), 1e-12)
    return rt_sh.wave_slice.bounds()


def _worker(rank, store, out_dir):
    torch.set_num_threads(1)
    gathers = []
    gather = mesh_mod._all_gather_waves

    def counted(x, ws, dim):
        gathers.append(list(x.shape))
        return gather(x, ws, dim)

    mesh_mod._all_gather_waves = counted
    got = multihost.initialize(init_method=f"file://{store}",
                               world_size=WORLD, rank=rank, backend="gloo")
    try:
        mesh = make_mesh(n_wave=N_WAVE)
        hosts = multihost.hosts_axis_mesh(n_hosts=WORLD, n_shards=8)
        # each rank passes its own half of the batch and gets all of it
        batch = multihost.process_local_batch(
            hosts, np.arange(8.0)[4 * rank:4 * rank + 4])
        try:  # local parts of different lengths: every rank raises
            multihost.process_local_batch(
                hosts, np.arange(8.0)[4 * rank:4 * rank + 4 - rank])
            mismatch = None
        except ValueError as exc:
            mismatch = str(exc)
        _ktable_deck(mesh)
        bounds = _runtime_deck(mesh)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(dict(
                rank=got, world=mesh.world, shards=list(mesh.wave_shards()),
                hosts_rows=list(hosts.data_rows()),
                hosts_owners=hosts.owners.tolist(), batch=batch.tolist(),
                mismatch=mismatch,
                runtime_bounds=list(bounds), gathers=gathers), f)
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_match_unsharded(tmp_path):
    ctx = mp.spawn(_worker, args=(str(tmp_path / "store"), str(tmp_path)),
                   nprocs=WORLD, join=False)
    # join returns False while ranks remain (and raises if one failed)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the ranks did not finish in {TIMEOUT_S} s")
    for p in ctx.processes:
        assert not p.is_alive() and p.exitcode == 0
    runs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(WORLD)]
    for r, run in enumerate(runs):
        assert (run["rank"], run["world"]) == (r, WORLD)
        assert run["shards"] == [2 * r, 2 * r + 1]
        # one host per rank: rank r owns data row r
        assert run["hosts_rows"] == [r]
        assert run["hosts_owners"] == [[0] * 4, [1] * 4]
        assert run["batch"] == list(np.arange(8.0))
        assert "differ in shape" in run["mismatch"]
        # each rank synthesises its own half of the 512-wave sub-grid
        assert run["runtime_bounds"] == [256 * r, 256 * (r + 1)]
        # collectives: the k-table forward (primal), its Jacobian (primal
        # and the 3 tangents in one), the runtime forward
        assert [len(s) for s in run["gathers"]] == [2, 2, 3, 2]
        assert run["gathers"][2][0] == 3
