"""Wave sharding of the port (``archnemesis_tpu_torch/parallel/``) in one
process, runtime line-by-line: the partition against the JAX package's,
field by field; the sharded forward against the unsharded port and the JAX
forward; a sharded JAX ``RuntimeLBL`` carried across; the multi-process
helpers in one process. The k-table deck is
``tests/test_torch_sharded_ktables.py``, a real two-rank process group
``tests/test_torch_gloo.py``. Tolerances as the JAX package's sharded tests
(``tests/test_sharded_forward.py``): float64, rtol 1e-12 between sharded
and unsharded; against JAX, the port-vs-JAX bound of the unsharded
runtime tests."""

import dataclasses

import numpy as np
import pytest
import torch

from archnemesis_tpu.forward import forward_nadir as jax_forward_nadir
from archnemesis_tpu.forward import make_forward_config as jax_config
from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
from archnemesis_tpu.parallel.mesh import make_mesh as jax_make_mesh
from archnemesis_tpu.parallel.sharded import (
    shard_lbl_blocks as jax_shard_lbl_blocks,
)
from archnemesis_tpu.parallel.sharded import (
    shard_runtime_lbl as jax_shard_runtime_lbl,
)
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.forward import forward_nadir, make_forward_config
from archnemesis_tpu_torch.io.legacy import load_deck
from archnemesis_tpu_torch.parallel import multihost
from archnemesis_tpu_torch.parallel.mesh import WaveMesh, make_mesh
from archnemesis_tpu_torch.parallel.sharded import (
    shard_lbl_blocks,
    shard_runtime_lbl,
)
from port_cases import CO_RUNTIME, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SUBGRID = 512  # waves of the runtime deck's sub-grid (the JAX test's)
PARTITION_FIELDS = ("line_idx", "line_mask", "wn", "wn_lo", "nu", "nu_lo",
                    "sw", "elower", "stim_ref", "broad")


def _runtime_case(load, wave=SUBGRID):
    """(deck, windowed RuntimeLBL on the first ``wave`` points) of the
    runtime deck through one package's ``load_deck``."""
    deck = load(CO_RUNTIME, "cirstest")
    nconv = int(deck.geometry.nconv[0])
    vconv = deck.geometry.vconv[:nconv, 0]
    rt = dataclasses.replace(deck.ktables,
                             wave=np.asarray(deck.ktables.wave)[:wave])
    return deck, rt.windowed(vconv.min(), vconv.max())


@pytest.fixture(scope="module")
def runtime():
    """The port's runtime sub-grid deck and its forward on the CPU: the
    unsharded spectrum and a function of a RuntimeLBL."""
    deck, rt = _runtime_case(load_deck)
    st = deck.settings
    cfg = make_forward_config(deck.atmosphere, rt, None, iray=st.iray,
                              ispace=st.ispace, gasgiant=True)

    def forward(rt_run):
        return forward_nadir(deck.atmosphere, deck.layer_config, rt_run,
                             None, None, deck.surface, cfg, emiss_ang=0.0,
                             device="cpu")

    return rt, forward, forward(rt)


@pytest.mark.parametrize("n_shards", [3, 8])
def test_shard_lbl_blocks_matches_jax(n_shards):
    """The same partition as the JAX package's, field by field, and the
    port's block ranges are those of its relative gathers."""
    _, jrt = _runtime_case(jax_load_deck, wave=1600)
    jll, jblk = jrt.line_lists[0], jrt.blocks[0]
    want = jax_shard_lbl_blocks(jll, jblk, n_shards)
    got = shard_lbl_blocks(convert.line_list(jll), convert.lbl_blocks(jblk),
                           n_shards)
    for name in ("n_shards", "blocks_per_shard", "block_width",
                 "max_lines_per_block", "n_wave"):
        assert getattr(got, name) == getattr(want, name), name
    for name in PARTITION_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for s in range(n_shards):
        live = got.line_mask[s] > 0
        first = np.where(got.counts[s] > 0, got.line_idx[s][:, 0], 0)
        np.testing.assert_array_equal(got.starts[s], first)
        np.testing.assert_array_equal(got.counts[s], live.sum(axis=1))


def test_runtime_forward_sharded_matches(runtime):
    """8 wave shards (4 of them past the 4 blocks of the sub-grid, empty)
    against the unsharded port at rtol 1e-12, one synthesis per shard."""
    rt, forward, want = runtime
    mesh = make_mesh(n_wave=8)
    rt_sh = shard_runtime_lbl(rt, mesh, device="cpu")
    sh = rt_sh.shard_data[0]
    assert sh.shards == tuple(range(8)) and len(sh.packed) == 8
    assert rt_sh.wave_slice.bounds() == (0, SUBGRID)
    got = forward(rt_sh)
    assert got.shape == want.shape == (SUBGRID, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=np.abs(want.numpy()).max() * 1e-14)


def test_runtime_forward_matches_jax(runtime):
    """The sharded port against the JAX forward (unsharded; the JAX package's
    own tests hold its sharded forward to it at rtol 1e-12) at rtol 1e-10:
    the packages' lineshape and emission reductions differ in order."""
    rt, forward, _ = runtime
    jdeck, jrt = _runtime_case(jax_load_deck)
    st = jdeck.settings
    cfg = jax_config(jdeck.atmosphere, jrt, None, iray=st.iray,
                     ispace=st.ispace, gasgiant=True)
    want = np.asarray(jax_forward_nadir(
        jdeck.atmosphere, jdeck.layer_config, jrt, None, None, jdeck.surface,
        cfg, emiss_ang=0.0))
    got = forward(shard_runtime_lbl(rt, make_mesh(n_wave=4), device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=np.abs(want).max() * 1e-14)


def test_sharded_runtime_lbl_converts(runtime, monkeypatch):
    """A JAX ``RuntimeLBL`` sharded over the 8-device virtual mesh comes
    across partitioned again over 8 shards in one process, with the same
    partition and the same spectrum; its kernel inputs go to the card
    unless the CPU is asked for."""
    rt, forward, want = runtime
    _, jrt = _runtime_case(jax_load_deck)
    jrt_sh = jax_shard_runtime_lbl(jrt, jax_make_mesh(n_wave=8, n_data=1))
    got_rt = convert.runtime_lbl(jrt_sh, device="cpu")
    assert got_rt.wave_slice.mesh.n_wave == 8
    sh, jsh = got_rt.shard_data[0], jrt_sh.shard_data[0]
    for name in PARTITION_FIELDS:
        np.testing.assert_array_equal(getattr(sh, name),
                                      np.asarray(getattr(jsh, name)),
                                      err_msg=name)
    np.testing.assert_allclose(forward(got_rt).numpy(), want.numpy(),
                               rtol=1e-12, atol=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.runtime_lbl(jrt_sh)


def test_runtime_retrieval_setup_sharded_matches():
    """The retrieval set-up's ``ktab_transform`` hook shards the runtime
    deck's windowed lines (every geometry's) over 4 wave shards; the
    forward function gathers the spectrum before the channel interpolation
    and equals the unsharded one at rtol 1e-12."""
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    mesh = make_mesh(n_wave=4)
    plain = make_retrieval_setup(CO_RUNTIME, "cirstest", device="cpu")
    sharded = make_retrieval_setup(
        CO_RUNTIME, "cirstest", device="cpu",
        ktab_transform=lambda rt: shard_runtime_lbl(rt, mesh, device="cpu"))
    xa = torch.as_tensor(plain.sv.xa)
    want = plain.forward_fn(xa)
    np.testing.assert_allclose(sharded.forward_fn(xa).numpy(), want.numpy(),
                               rtol=1e-12, atol=0)


def test_multihost_single_process(monkeypatch):
    """``initialize`` is a no-op in one process; ``hosts_axis_mesh`` lays
    data across hosts and wave shards within one, contiguous; the global
    batch is assembled from the processes' rows (one process holds all of
    them here)."""
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() == 0
    assert multihost.initialize(world_size=1) == 0
    assert not torch.distributed.is_initialized()

    mesh = multihost.hosts_axis_mesh(n_hosts=2, n_shards=8)
    assert mesh.shape == {"data": 2, "wave": 4} and mesh.group is None
    assert (mesh.owners == 0).all() and mesh.per_rank == 8
    assert list(mesh.data_rows()) == [0, 1]
    assert list(mesh.wave_shards()) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="hosts"):
        multihost.hosts_axis_mesh(n_hosts=3, n_shards=8)
    # one process holds the whole batch: it comes back unchanged, as from
    # the JAX function in one process
    batch = np.arange(8.0 * 6).reshape(8, 6)
    np.testing.assert_array_equal(
        multihost.process_local_batch(mesh, batch).numpy(), batch)
    with pytest.raises(ValueError, match="split"):
        multihost.process_local_batch(mesh, batch[:7])


def test_wave_mesh_layouts():
    """Which shards a rank owns, for ranks of a group of 4 (the layout does
    not need the group to exist: ranks are passed explicitly)."""

    class Four(WaveMesh):
        @property
        def world(self):
            return 4

    split_rows = Four(n_data=1, n_wave=8)  # 2 wave shards per rank
    assert [list(split_rows.wave_shards(r)) for r in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    whole_rows = Four(n_data=8, n_wave=2)  # 2 data rows per rank
    assert [list(whole_rows.data_rows(r)) for r in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    assert list(whole_rows.wave_shards(3)) == [0, 1]
    np.testing.assert_array_equal(Four(n_data=2, n_wave=4).owners,
                                  [[0, 0, 1, 1], [2, 2, 3, 3]])
    with pytest.raises(ValueError, match="split"):
        Four(n_data=1, n_wave=6)
    with pytest.raises(ValueError, match="rows"):
        Four(n_data=3, n_wave=4)  # 3 shards per rank: neither rows nor part
