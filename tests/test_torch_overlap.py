"""Random-overlap combine of the PyTorch port vs the JAX package.

The port's plain combine (torch.sort + gather + cumsum + interval-overlap
contraction) is held against the JAX XLA combine in float64 and against the
Pallas kernel, run in interpret mode as the JAX package's own tests run it,
in float32. The CUDA kernel is held against the plain version on the card
only (``cuda`` marker; skipped without one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu.ops.overlap import _combine_pair as jax_combine_pair
from archnemesis_tpu.ops.overlap import g_bin_edges as jax_g_bin_edges
from archnemesis_tpu.ops.overlap import mix_gas_k as jax_mix_gas_k
from archnemesis_tpu.ops.overlap import overlap_nstraddle as jax_nstraddle
from archnemesis_tpu.ops.overlap_pallas import combine_pair_pallas
from archnemesis_tpu_torch.ops import overlap, overlap_cuda
from port_cases import gauss_del_g, overlap_inputs


def _jax_tables(del_g):
    w2 = (jnp.asarray(del_g)[:, None] * jnp.asarray(del_g)[None, :]).reshape(-1)
    return w2, jnp.asarray(jax_g_bin_edges(del_g))


@pytest.mark.parametrize("ng", [10, 20])
def test_plain_combine_matches_jax_float64(ng):
    del_g = gauss_del_g(ng)
    ta, tb = overlap_inputs(64, ng, seed=ng)
    want = np.asarray(jax_combine_pair(*_jax_tables(del_g), jnp.asarray(ta),
                                       jnp.asarray(tb)))
    got = overlap_cuda.combine_pair_plain(torch.as_tensor(ta),
                                          torch.as_tensor(tb), del_g)
    assert got.dtype == torch.float64
    # rtol 1e-8: equal keys may be ordered differently by the two sorts,
    # which moves the prefix sums by rounding only
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=0)


@pytest.mark.parametrize("ng", [10, 20])
def test_plain_combine_matches_pallas_interpret_float32(ng):
    del_g = gauss_del_g(ng).astype(np.float32)
    key = tuple(float(v) for v in del_g)
    ta, tb = overlap_inputs(32, ng, seed=100 + ng)
    ta, tb = ta.astype(np.float32), tb.astype(np.float32)
    want = np.asarray(combine_pair_pallas(jnp.asarray(ta), jnp.asarray(tb),
                                          key, True))
    got = overlap_cuda.combine_pair(torch.as_tensor(ta), torch.as_tensor(tb),
                                    del_g)
    assert got.dtype == torch.float32
    # the JAX package's own Pallas-vs-XLA bound (tests/test_overlap_pallas.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-7)


@pytest.fixture(scope="module")
def mix_case():
    """k-distributions of 4 gases with the skip rules exercised: gas 1 is
    empty in layer 0, gas 0 (the first accumulated) in layer 2, and gas 3
    everywhere."""
    ng, nwave, nlay, ngas = 10, 12, 5, 4
    rng = np.random.default_rng(5)
    k_gas = np.sort(rng.uniform(0, 1e-22, (nwave, ng, nlay, ngas)), axis=1)
    k_gas[:, :, 0, 1] = 0.0
    k_gas[:, :, 2, 0] = 0.0
    k_gas[..., 3] = 0.0
    amounts = rng.uniform(1e20, 1e24, (ngas, nlay))
    return gauss_del_g(ng), k_gas, amounts


def test_mix_gas_k_matches_jax(mix_case):
    del_g, k_gas, amounts = mix_case
    want = np.asarray(jax_mix_gas_k(del_g, jnp.asarray(k_gas),
                                    jnp.asarray(amounts), use_pallas=False))
    overlap_cuda.combine_pair.launches = 0
    got = overlap.mix_gas_k(del_g, torch.as_tensor(k_gas),
                            torch.as_tensor(amounts))
    # the plain version on a CPU tensor: no kernel launches
    assert overlap_cuda.combine_pair.launches == 0
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=0)
    # skip rules: a gas empty everywhere changes nothing; where the
    # accumulated gas 0 is empty, the result is a mix of gases 1 and 2 only
    without_3 = overlap.mix_gas_k(del_g, torch.as_tensor(k_gas[..., :3]),
                                  torch.as_tensor(amounts[:3]))
    np.testing.assert_array_equal(got.numpy(), without_3.numpy())


def test_mix_gas_k_single_gas_is_scaled_k(mix_case):
    del_g, k_gas, amounts = mix_case
    got = overlap.mix_gas_k(del_g, torch.as_tensor(k_gas[..., :1]),
                            torch.as_tensor(amounts[:1]))
    np.testing.assert_array_equal(
        got.numpy(), k_gas[..., 0] * amounts[0][None, None, :])


@pytest.mark.parametrize("ng,e", [(1, 32), (4, 32), (6, 64), (10, 128),
                                  (16, 256), (20, 512), (32, 1024)])
def test_e_pad(ng, e):
    assert overlap_cuda.e_pad(ng) == e


def test_g_bin_edges_match_jax():
    del_g = gauss_del_g(20)
    np.testing.assert_array_equal(overlap.g_bin_edges(del_g),
                                  jax_g_bin_edges(del_g))


@pytest.mark.parametrize("ng", [1, 10, 20])
def test_overlap_nstraddle_matches_jax(ng):
    del_g = gauss_del_g(ng)
    assert overlap.overlap_nstraddle(del_g) == jax_nstraddle(del_g)


@pytest.mark.parametrize("ng", [10, 20, 32])
def test_rebin_overlaps_at_most_n_plus_ng_minus_1(ng):
    """The operation count behind the kernel's bound: the sorted elements
    tile [0, 1] end to end, so the rebin has at most NG^2 + NG - 1 nonzero
    (element, bin) overlaps per row."""
    del_g = gauss_del_g(ng)
    ta, tb = overlap_inputs(64, ng, seed=ng)
    tau = torch.as_tensor(ta[:, :, None] + tb[:, None, :]).reshape(64, -1)
    w_s = torch.as_tensor(overlap.pair_weights(del_g))[tau.argsort(dim=-1)]
    ghi = torch.cumsum(w_s, dim=-1)
    glo = ghi - w_s
    edges = torch.as_tensor(overlap.g_bin_edges(del_g))
    inter = (torch.minimum(ghi[..., None], edges[1:])
             - torch.maximum(glo[..., None], edges[:-1]))
    overlaps = (inter > 0).sum(dim=(1, 2))
    assert int(overlaps.max()) <= ng * ng + ng - 1
    n = ng * ng
    want = 2 * n + n * (ng - 1).bit_length() + 7 * (n + ng - 1) + ng
    assert chip_smoke.combine_ops_per_row(ng, presorted=True) == want
    assert chip_smoke.is_sorted_along_g(torch.as_tensor(ta),
                                        torch.as_tensor(tb))


def test_wrapper_refuses_other_devices():
    a = torch.zeros((4, 10), device="meta")
    with pytest.raises(ValueError, match="device"):
        overlap_cuda.combine_pair(a, a, gauss_del_g(10))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ng", [10, 20, 32])
def test_kernel_matches_plain_on_card(cuda, ng, dtype):
    del_g = gauss_del_g(ng)
    ta, tb = overlap_inputs(1000, ng, seed=7)
    a = torch.as_tensor(ta, dtype=dtype, device=cuda)
    b = torch.as_tensor(tb, dtype=dtype, device=cuda)
    before = overlap_cuda.combine_pair.launches
    got = overlap_cuda.combine_pair(a, b, del_g)
    torch.cuda.synchronize()
    assert overlap_cuda.combine_pair.launches == before + 1
    want = overlap_cuda.combine_pair_plain(a, b, del_g)
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0.0)
        return
    # float32: held to the float64 result of the same inputs, and to the
    # float32 plain version up to NG=20 (at NG=32 the plain version's own
    # rounding error nears the bound)
    want64 = overlap_cuda.combine_pair_plain(a.double(), b.double(), del_g)
    torch.testing.assert_close(got.double(), want64, rtol=2e-5, atol=1e-7)
    if ng <= 20:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-7)
