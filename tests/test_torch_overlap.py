"""Random-overlap combine of the PyTorch port vs the JAX package.

The port's plain combine (torch.sort + gather + cumsum + interval-overlap
contraction) is held against the JAX XLA combine in float64 and against the
Pallas kernel, run in interpret mode as the JAX package's own tests run it,
in float32. Its forward-mode derivative (``jvp``, ``jacfwd``: the fused
primal + tangent combine) is held against ``jax.jvp``/``jax.jacfwd`` through
the Pallas kernel in interpret mode and through the XLA combine, on tie-free
inputs as the JAX package's tests take them. The CUDA kernels are held
against the plain versions on the card only (``cuda`` marker; skipped
without one).
"""

import jax
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
from port_cases import gauss_del_g, overlap_inputs, tiefree_overlap_inputs


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


@pytest.mark.parametrize("case", ["unsorted_a", "unsorted_b", "unsorted_both"])
@pytest.mark.parametrize("ng", [7, 20])
def test_plain_combine_unsorted_rows_matches_jax_float64(ng, case):
    """Rows not sorted along g have one answer: the JAX XLA combine's, which
    the kernel's per-row sort must reproduce. Each value keeps the weight
    of its g-ordinate, so it is not the answer of the rows sorted."""
    del_g = gauss_del_g(ng)
    ta, tb = chip_smoke.combine_cases(64, ng, seed=ng)[case]
    assert not chip_smoke.is_sorted_along_g(torch.as_tensor(ta),
                                            torch.as_tensor(tb))
    want = np.asarray(jax_combine_pair(*_jax_tables(del_g), jnp.asarray(ta),
                                       jnp.asarray(tb)))
    got = overlap_cuda.combine_pair_plain(torch.as_tensor(ta),
                                          torch.as_tensor(tb), del_g)
    # rtol 1e-8 as above: equal keys may be ordered differently
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=0)


def test_combine_cases_are_what_they_say():
    """The hard cases of the card's tests: shuffled rows are permutations of
    the sorted ones, tied rows tie, zero rows are zero."""
    ng = 7
    cases = chip_smoke.combine_cases(chip_smoke.HARD_ROWS, ng, seed=ng)
    ta, tb = cases["sorted"]
    for name, (a, b) in cases.items():
        assert a.shape == b.shape == (chip_smoke.HARD_ROWS, ng), name
    np.testing.assert_array_equal(np.sort(cases["unsorted_both"][0], axis=1),
                                  ta)
    np.testing.assert_array_equal(np.sort(cases["unsorted_a"][0], axis=1), ta)
    np.testing.assert_array_equal(cases["unsorted_a"][1], tb)
    np.testing.assert_array_equal(np.sort(cases["unsorted_b"][1], axis=1), tb)
    a, b = cases["ties"]
    half = chip_smoke.HARD_ROWS // 2
    assert (a[:half] == a[:half, :1]).all() and (b[:half] == b[:half, :1]).all()
    pairs = (a[half:, :, None] + b[half:, None, :]).reshape(half + 1, -1)
    assert all(len(np.unique(p)) < ng * ng // 2 for p in pairs)
    assert not cases["zeros"][0].any() and not cases["zeros"][1].any()
    # no rows-per-block choice of the primal or the fused kernel divides
    # the row count
    assert all(chip_smoke.HARD_ROWS % w for w in
               chip_smoke.PRIMAL_WARP_CHOICES + chip_smoke.TAN_WARP_CHOICES)


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


def _tiesfree(rows, ng, seed, dtype=np.float32):
    """Sorted rows as tests/test_overlap_pallas.py:48 draws them."""
    rng = np.random.default_rng(seed)
    ta = np.sort(rng.uniform(0.1, 4, (rows, ng)).astype(dtype), axis=1)
    tb = np.sort(rng.uniform(0.1, 2, (rows, ng)).astype(dtype), axis=1)
    return ta, tb, rng.standard_normal((rows, ng)).astype(dtype)


@pytest.mark.parametrize("ng", [10, 20])
def test_jvp_matches_jax_tiesfree(ng):
    """One tangent pair: the port against jax.jvp through the Pallas kernel
    (interpret mode) and through the XLA combine, at the JAX package's own
    bound (tests/test_overlap_pallas.py:62-65), float32."""
    del_g = gauss_del_g(ng).astype(np.float32)
    key = tuple(float(v) for v in del_g)
    w2, edges = _jax_tables(del_g)
    ta, tb, v = _tiesfree(32, ng, seed=4)
    primals = (jnp.asarray(ta), jnp.asarray(tb))
    tangents = (jnp.asarray(v), jnp.asarray(0.5 * v))
    o_p, jv_p = jax.jvp(lambda a, b: combine_pair_pallas(a, b, key, True),
                        primals, tangents)
    o_x, jv_x = jax.jvp(lambda a, b: jax_combine_pair(w2, edges, a, b),
                        primals, tangents)
    out, jv = torch.func.jvp(
        lambda a, b: overlap_cuda.combine_pair(a, b, del_g),
        (torch.as_tensor(ta), torch.as_tensor(tb)),
        (torch.as_tensor(v), torch.as_tensor(0.5 * v)))
    for want_o, want_jv in ((o_p, jv_p), (o_x, jv_x)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_o),
                                   rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(jv.numpy(), np.asarray(want_jv),
                                   rtol=2e-3, atol=2e-4)


def test_jvp_matches_jax_float64():
    """float64, NG=20: the port's fused plain version against jax.jvp of the
    XLA combine at rtol 1e-8 of the tangent's peak (the two sorts may order
    the sums differently only at ties, which these rows do not have)."""
    ng = 20
    del_g = gauss_del_g(ng)
    w2, edges = _jax_tables(del_g)
    ta, tb, v = _tiesfree(48, ng, seed=7, dtype=np.float64)
    _, want = jax.jvp(lambda a, b: jax_combine_pair(w2, edges, a, b),
                      (jnp.asarray(ta), jnp.asarray(tb)),
                      (jnp.asarray(v), jnp.asarray(0.5 * v)))
    _, got = torch.func.jvp(
        lambda a, b: overlap_cuda.combine_pair(a, b, del_g),
        (torch.as_tensor(ta), torch.as_tensor(tb)),
        (torch.as_tensor(v), torch.as_tensor(0.5 * v)))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())


def test_jacfwd_is_one_fused_call_and_matches_jax():
    """jacfwd through the combine equals jax.jacfwd through the Pallas
    kernel (interpret) and the XLA combine, and makes ONE fused call for
    all tangents (tests/test_overlap_pallas.py:90-113)."""
    ng = 10
    del_g = gauss_del_g(ng).astype(np.float32)
    key = tuple(float(v) for v in del_g)
    w2, edges = _jax_tables(del_g)
    ta, tb, _ = _tiesfree(8, ng, seed=11)
    s0 = jnp.asarray([1.0, 1.0], dtype=jnp.float32)
    jp = np.asarray(jax.jacfwd(lambda s: combine_pair_pallas(
        jnp.asarray(ta) * s[0], jnp.asarray(tb) * s[1], key, True))(s0))
    jx = np.asarray(jax.jacfwd(lambda s: jax_combine_pair(
        w2, edges, jnp.asarray(ta) * s[0], jnp.asarray(tb) * s[1]))(s0))

    def f(s):
        return overlap_cuda.combine_pair(torch.as_tensor(ta) * s[0],
                                         torch.as_tensor(tb) * s[1], del_g)

    fused = overlap_cuda.combine_pair_with_tangents
    before, launched = fused.calls, fused.launches
    got = torch.func.jacfwd(f)(torch.ones(2, dtype=torch.float32)).numpy()
    assert fused.calls == before + 1
    assert fused.launches == launched  # CPU tensors launch no kernel
    np.testing.assert_allclose(got, jp, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got, jx, rtol=2e-4, atol=1e-6)


def test_jacfwd_through_mix_gas_k_one_fused_call_per_pair(mix_case):
    """jacfwd through mix_gas_k: NGAS - 1 fused calls whatever the number
    of tangents, and the Jacobian of jax.jacfwd through the XLA path."""
    del_g, k_gas, amounts = mix_case
    k_gas, amounts = k_gas[..., :3], amounts[:3]

    def f_jax(s):
        return jax_mix_gas_k(del_g, jnp.asarray(k_gas) * s[0],
                             jnp.asarray(amounts) * s[1:4, None],
                             use_pallas=False)

    def f(s):
        return overlap.mix_gas_k(del_g, torch.as_tensor(k_gas) * s[0],
                                 torch.as_tensor(amounts) * s[1:4, None])

    s0 = np.array([1.0, 0.7, 1.3, 0.9])
    want = np.asarray(jax.jacfwd(f_jax)(jnp.asarray(s0)))
    fused = overlap_cuda.combine_pair_with_tangents
    before = fused.calls
    got = torch.func.jacfwd(f)(torch.as_tensor(s0)).numpy()
    assert fused.calls == before + 2
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())


def test_vmap_over_batched_primals_folds_into_rows():
    """vmap over batched primals and tangents
    (tests/test_overlap_pallas.py:157-175): each batch member equals its own
    unbatched evaluation."""
    ng = 10
    del_g = gauss_del_g(ng)
    rng = np.random.default_rng(12)
    ta = torch.as_tensor(np.sort(rng.uniform(0.1, 4, (3, 4, ng)), -1))
    tb = torch.as_tensor(np.sort(rng.uniform(0.1, 2, (3, 4, ng)), -1))

    def f(a, b):
        return torch.func.jvp(
            lambda x, y: overlap_cuda.combine_pair(x, y, del_g),
            (a, b), (a * 0.1, b * 0.2))

    out_v, jv_v = torch.vmap(f)(ta, tb)
    for i in range(3):
        out_i, jv_i = f(ta[i], tb[i])
        torch.testing.assert_close(out_v[i], out_i, rtol=1e-12, atol=0)
        torch.testing.assert_close(jv_v[i], jv_i, rtol=1e-12, atol=1e-15)
    # primals alone
    out_p = torch.vmap(lambda a, b: overlap_cuda.combine_pair(a, b, del_g))(
        ta, tb)
    torch.testing.assert_close(out_p, out_v, rtol=0, atol=0)


def test_missing_tangent_acts_as_zero():
    ng = 10
    del_g = gauss_del_g(ng)
    ta, tb, v = _tiesfree(6, ng, seed=2, dtype=np.float64)
    a, b, v = torch.as_tensor(ta), torch.as_tensor(tb), torch.as_tensor(v)
    _, only_a = torch.func.jvp(
        lambda x: overlap_cuda.combine_pair(x, b, del_g), (a,), (v,))
    _, with_zero = torch.func.jvp(
        lambda x, y: overlap_cuda.combine_pair(x, y, del_g),
        (a, b), (v, torch.zeros_like(b)))
    torch.testing.assert_close(only_a, with_zero, rtol=0, atol=0)
    # the tangent of a sum of the two inputs' tangents is the sum
    _, only_b = torch.func.jvp(
        lambda y: overlap_cuda.combine_pair(a, y, del_g), (b,), (v,))
    _, both = torch.func.jvp(
        lambda x, y: overlap_cuda.combine_pair(x, y, del_g), (a, b), (v, v))
    torch.testing.assert_close(only_a + only_b, both, rtol=1e-12, atol=1e-14)


def test_fused_plain_on_tied_rows_is_finite_and_keeps_the_primal():
    """Tied and all-zero rows: the tangent there depends on the sort's
    order, so only the primal and finiteness are held."""
    ng = 20
    del_g = gauss_del_g(ng)
    ta, tb = overlap_inputs(32, ng, seed=3)
    rng = np.random.default_rng(3)
    dta = torch.as_tensor(rng.standard_normal((3, 32, ng)))
    dtb = torch.as_tensor(rng.standard_normal((3, 32, ng)))
    a, b = torch.as_tensor(ta), torch.as_tensor(tb)
    out, dout = overlap_cuda.combine_pair_with_tangents(a, b, dta, dtb, del_g)
    torch.testing.assert_close(out, overlap_cuda.combine_pair_plain(a, b, del_g),
                               rtol=0, atol=0)
    assert dout.shape == (3, 32, ng) and torch.isfinite(dout).all()


def test_combine_has_no_reverse_mode():
    """As the TPU kernel (custom_jvp only), the combine has no backward."""
    a = torch.rand(4, 10, dtype=torch.float64, requires_grad=True)
    out = overlap_cuda.combine_pair(a, a.detach(), gauss_del_g(10))
    with pytest.raises(NotImplementedError):
        out.sum().backward()


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
    # float32 also against the float32 plain version only up to NG=20: at
    # NG=32 the plain version's own rounding error nears the bound
    _hold_to_plain(got, a, b, del_g)


def _hold_to_plain(got, a, b, del_g):
    """Phase 2's bounds: float64 rtol 1e-12; float32 rtol 2e-5 / atol 1e-7
    against the float64 result of the same inputs, and against the float32
    plain version up to NG=20."""
    want = overlap_cuda.combine_pair_plain(a, b, del_g)
    if got.dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0.0)
        return
    want64 = overlap_cuda.combine_pair_plain(a.double(), b.double(), del_g)
    torch.testing.assert_close(got.double(), want64, rtol=2e-5, atol=1e-7)
    if a.shape[1] <= 20:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ng", chip_smoke.HARD_NGS)
def test_kernel_matches_plain_on_card_hard_rows(cuda, ng, dtype):
    """Rows unsorted along g (in a, in b, in both), heavy ties, all-zero
    rows, at every NG class and a row count that leaves the last block
    ragged."""
    del_g = gauss_del_g(ng)
    for name, (ta, tb) in chip_smoke.combine_cases(
            chip_smoke.HARD_ROWS, ng, seed=ng).items():
        a = torch.as_tensor(ta, dtype=dtype, device=cuda)
        b = torch.as_tensor(tb, dtype=dtype, device=cuda)
        got = overlap_cuda.combine_pair(a, b, del_g)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), name
        _hold_to_plain(got, a, b, del_g)


@pytest.mark.cuda
@pytest.mark.parametrize("warps", chip_smoke.PRIMAL_WARP_CHOICES)
def test_kernel_launches_give_equal_bits(cuda, warps):
    """No atomics: two launches on the same input give the same bits, and
    the rows per block change nothing."""
    ng = 20
    del_g = gauss_del_g(ng)
    ta, tb = overlap_inputs(20_000, ng, seed=1)
    a = torch.as_tensor(ta, dtype=torch.float32, device=cuda)
    b = torch.as_tensor(tb, dtype=torch.float32, device=cuda)
    key = tuple(float(x) for x in del_g)
    first = overlap_cuda._combine_primal(a, b, key, warps=warps)
    torch.testing.assert_close(first, overlap_cuda.combine_pair(a, b, del_g),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        first, overlap_cuda._combine_primal(a, b, key, warps=warps),
        rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_tan", [1, 3])
@pytest.mark.parametrize("ng", [10, 20, 32])
def test_tangent_kernel_matches_plain_on_card(cuda, ng, n_tan, dtype):
    """The fused kernel on tie-free rows (pair sums on an integer lattice,
    so float32 and float64 sort them alike): its primal the primal kernel's
    bit for bit (the two share its code), its tangents the plain version's,
    and a second launch the first one's bits (no atomics)."""
    del_g = gauss_del_g(ng)
    ta, tb = tiefree_overlap_inputs(500, ng, seed=9)
    rng = np.random.default_rng(9)
    a = torch.as_tensor(ta, dtype=dtype, device=cuda)
    b = torch.as_tensor(tb, dtype=dtype, device=cuda)
    da = torch.as_tensor(rng.standard_normal((n_tan, 500, ng)), dtype=dtype,
                         device=cuda)
    db = torch.as_tensor(rng.standard_normal((n_tan, 500, ng)), dtype=dtype,
                         device=cuda)
    fused = overlap_cuda.combine_pair_with_tangents
    before = fused.launches
    out, dout = fused(a, b, da, db, del_g)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    torch.testing.assert_close(out, overlap_cuda.combine_pair(a, b, del_g),
                               rtol=0, atol=0)
    out2, dout2 = fused(a, b, da, db, del_g)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    torch.testing.assert_close(dout2, dout, rtol=0, atol=0)
    _, want = overlap_cuda.combine_pair_with_tangents_plain(
        a.double(), b.double(), da.double(), db.double(), del_g)
    peak = float(want.abs().max())
    tol = (1e-12 if dtype == torch.float64
           else chip_smoke.tangent_f32_tol(del_g))
    torch.testing.assert_close(dout.double(), want, rtol=tol, atol=tol * peak)
    # jacfwd on the card: one fused launch for all tangents
    before = fused.launches
    jac = torch.func.jacfwd(
        lambda s: overlap_cuda.combine_pair(a * s[0], b * s[1], del_g))(
            torch.ones(2, dtype=dtype, device=cuda))
    assert fused.launches == before + 1 and jac.shape == (500, ng, 2)
