"""Wave sharding of the port (``archnemesis_tpu_torch/parallel/``) on the
k-table deck ``jupiter_fdret`` in one process: the retrieval set-up's
forward over a (2 data x 4 wave) mesh of logical shards
(``make_retrieval_setup(wave_pad_multiple=4, ktab_transform=
shard_ktables_by_wave)``) against the unsharded port and the JAX forward,
and 3 Jacobian columns through ``jacfwd`` and the spectrum gather's
``vmap`` rule. Tolerances as the JAX package's sharded tests
(``tests/test_sharded_forward.py``): float64, rtol 1e-12 forward and 1e-10
Jacobian between sharded and unsharded. torch keeps its default threads,
as the other retrieval files do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.retrievals import make_retrieval_setup as jax_setup
from archnemesis_tpu_torch.parallel import mesh as mesh_mod
from archnemesis_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_ktables_by_wave,
)
from archnemesis_tpu_torch.retrievals import make_retrieval_setup
from port_cases import FDRET


@pytest.fixture(scope="module")
def fdret():
    """jupiter_fdret padded to 4 wave shards: the port unsharded, the port
    over a (2 data x 4 wave) mesh in one process, and the JAX set-up."""
    plain = make_retrieval_setup(FDRET, "cirstest", wave_pad_multiple=4,
                                 device="cpu")
    mesh = make_mesh(n_wave=4, n_data=2)
    sharded = make_retrieval_setup(
        FDRET, "cirstest", wave_pad_multiple=4, device="cpu",
        ktab_transform=lambda kt: shard_ktables_by_wave(kt, mesh))
    return plain, sharded, jax_setup(FDRET, "cirstest", wave_pad_multiple=4)


def test_ktable_forward_sharded_matches(fdret):
    """rtol 1e-12 against the unsharded port; rtol 1e-8 against the JAX
    forward (``tests/test_torch_retrieval.py``'s port-vs-JAX bound)."""
    plain, sharded, jax_s = fdret
    kt = sharded.deck.ktables
    assert kt.wave_slice is None  # the deck keeps its whole tables
    xa = torch.as_tensor(plain.sv.xa)
    want = plain.forward_fn(xa)
    got = sharded.forward_fn(xa)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=want.abs().max().item() * 1e-14)
    y_jax = np.asarray(
        jax.jit(jax_s.forward_fn)(jnp.asarray(plain.sv.xa)))
    np.testing.assert_allclose(got.numpy(), y_jax, rtol=1e-8, atol=0)


def test_jacobian_columns_sharded_match(fdret, monkeypatch):
    """3 Jacobian columns through ``jacfwd``: rtol 1e-10 of the unsharded
    port's, and the gather runs once for the primal and once for all three
    tangents (its ``vmap`` rule)."""
    plain, sharded, _ = fdret
    xa = torch.as_tensor(plain.sv.xa)
    nx = xa.shape[0]
    basis = torch.eye(nx, dtype=xa.dtype)[[0, nx // 2, nx - 1]]

    def columns(fn):
        return torch.func.jacfwd(lambda v: fn(xa + v @ basis))(
            xa.new_zeros(3))

    calls = []
    gather = mesh_mod._all_gather_waves

    def counted(x, ws, dim):
        calls.append(tuple(x.shape))
        return gather(x, ws, dim)

    monkeypatch.setattr(mesh_mod, "_all_gather_waves", counted)
    got = columns(sharded.forward_fn)
    want = columns(plain.forward_fn)
    assert got.shape == want.shape == (plain.y.shape[0], 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=want.abs().max().item() * 1e-12)
    assert sorted(len(s) for s in calls) == [2, 3]  # primal, 3 tangents
    assert max(calls, key=len)[0] == 3
