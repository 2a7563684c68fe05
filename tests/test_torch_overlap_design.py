"""The fused tangent combine's design (``csrc/overlap_combine.cu``,
``combine_tan_kernel``) held on the CPU where it can be.

A numpy mirror of the kernel's path: the row's pair sums in the merge's
order (runs a_(i) + b_(j) over j, equal keys in run order), the prefix sum
of the weights as the kernel's scan takes it (a serial scan of each lane's
slice, then a warp scan of the slices' totals), lane j's walk of bin j with
the 128-eps slack on the g-axis adding each overlap into column j of the
bin-owned matrices MA (by the element's ia) and MB (by ib), then
``dout = (da . MA + db . MB) / den``. It is held in float64 to the port's
plain fused version, which ``tests/test_torch_overlap.py`` holds to the JAX
package, and once directly to ``jax.jvp`` of the JAX package's XLA combine.
A count test shows the walk covers every positive overlap and gives no
column an element from outside its bin's slack, in float32 too, where the
scan's prefix sums are monotone only to within a few eps. The kernel itself
is held to the plain version on the card (``chip_smoke.py`` phase 5 and the
``cuda`` tests of ``tests/test_torch_overlap.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.ops.overlap import _combine_pair as jax_combine_pair
from archnemesis_tpu.ops.overlap import g_bin_edges as jax_g_bin_edges
from archnemesis_tpu_torch.ops import overlap, overlap_cuda
from port_cases import gauss_del_g, kernel_scan, tiefree_overlap_inputs

NGS = (1, 2, 3, 7, 20, 31, 32)
SLACK_EPS = 128  # the kernel's kSlackEps
def mirror_row(a_row, b_row, w2, edges):
    """One row through the kernel's steps, in the dtype of the inputs.

    Returns (out (NG,), den (NG,), MA, MB (NG, NG), walks): walks[j] lists
    bin j's walked elements as (sorted position, ghi, g_lo, overlap)."""
    dtype = a_row.dtype.type
    ng = a_row.size
    n = ng * ng
    ia = np.argsort(a_row, kind="stable")  # rank counting, ties by index
    ib = np.argsort(b_row, kind="stable")
    keys = (a_row[ia][:, None] + b_row[ib][None, :]).reshape(n)
    pay_a = np.repeat(ia, ng)
    pay_b = np.tile(ib, ng)
    order = np.argsort(keys, kind="stable")  # equal keys: the left run first
    keys, pay_a, pay_b = keys[order], pay_a[order], pay_b[order]
    w = w2[pay_a * ng + pay_b]
    ghi = kernel_scan(w)
    slack = dtype(SLACK_EPS) * np.finfo(dtype).eps
    tiny = np.finfo(dtype).tiny
    out = np.zeros(ng, dtype)
    den_out = np.zeros(ng, dtype)
    ma = np.zeros((ng, ng), dtype)
    mb = np.zeros((ng, ng), dtype)
    walks = []
    for j in range(ng):
        lo_j, hi_j = edges[j], edges[j + 1]
        first = lo_j - slack
        e, top = 0, n
        while e < top:
            c = (e + top) >> 1
            if ghi[c] > first:
                top = c
            else:
                e = c + 1
        last = hi_j + slack
        num = den = dtype(0)
        walk = []
        for e in range(e, n):
            g_lo = ghi[e] - w[e]
            inter = min(ghi[e], hi_j) - max(g_lo, lo_j)
            inter = inter if inter > 0 else dtype(0)
            num = num + keys[e] * inter
            den = den + inter
            ma[pay_a[e], j] += inter
            mb[pay_b[e], j] += inter
            walk.append((e, ghi[e], g_lo, inter))
            if ghi[e] >= last:
                break
        den = max(den, tiny)
        out[j] = num / den
        den_out[j] = den
        walks.append(walk)
    return out, den_out, ma, mb, walks


def mirror_fused(ta, tb, dta, dtb, del_g, dtype=np.float64):
    """(out (R, NG), dout (T, R, NG)) of the mirror over all rows."""
    w2 = overlap.pair_weights(del_g).astype(dtype)
    edges = overlap.g_bin_edges(del_g).astype(dtype)
    ta, tb = ta.astype(dtype), tb.astype(dtype)
    dta, dtb = dta.astype(dtype), dtb.astype(dtype)
    out = np.zeros_like(ta)
    dout = np.zeros_like(dta)
    for r in range(ta.shape[0]):
        out[r], den, ma, mb, _ = mirror_row(ta[r], tb[r], w2, edges)
        dout[:, r] = (dta[:, r] @ ma + dtb[:, r] @ mb) / den
    return out, dout


def design_case(ng: int, order: str, rows: int = 12, n_tan: int = 3):
    """Tie-free rows (sorted along g, or shuffled along g) and tangents."""
    ta, tb = tiefree_overlap_inputs(rows, ng, seed=ng)
    rng = np.random.default_rng(100 + ng)
    if order == "shuffled":
        ta, tb = rng.permuted(ta, axis=1), rng.permuted(tb, axis=1)
    dta = rng.standard_normal((n_tan, rows, ng))
    dtb = rng.standard_normal((n_tan, rows, ng))
    return ta, tb, dta, dtb


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("ng", NGS)
def test_mirror_matches_plain_fused_float64(ng, order):
    """The bin-owned matrices give the plain fused combine's tangents (and
    its primal) in float64 at rtol 1e-12 of the peak."""
    del_g = gauss_del_g(ng)
    ta, tb, dta, dtb = design_case(ng, order)
    got_out, got_dout = mirror_fused(ta, tb, dta, dtb, del_g)
    want_out, want_dout = overlap_cuda.combine_pair_with_tangents_plain(
        *(torch.as_tensor(x) for x in (ta, tb, dta, dtb)), del_g)
    want_out, want_dout = want_out.numpy(), want_dout.numpy()
    np.testing.assert_allclose(got_dout, want_dout, rtol=1e-12,
                               atol=1e-12 * np.abs(want_dout).max())
    np.testing.assert_allclose(got_out, want_out, rtol=1e-12,
                               atol=1e-12 * np.abs(want_out).max())


@pytest.mark.parametrize("ng", [7, 20])
def test_mirror_matches_jax_jvp_float64(ng):
    """One tangent pair through the mirror against jax.jvp of the JAX
    package's XLA combine, float64, at the bound of
    tests/test_torch_overlap.py:test_jvp_matches_jax_float64."""
    del_g = gauss_del_g(ng)
    ta, tb, dta, dtb = design_case(ng, "shuffled", n_tan=1)
    w2 = (jnp.asarray(del_g)[:, None] * jnp.asarray(del_g)[None, :]).reshape(-1)
    edges = jnp.asarray(jax_g_bin_edges(del_g))
    _, want = jax.jvp(lambda a, b: jax_combine_pair(w2, edges, a, b),
                      (jnp.asarray(ta), jnp.asarray(tb)),
                      (jnp.asarray(dta[0]), jnp.asarray(dtb[0])))
    _, got = mirror_fused(ta, tb, dta, dtb, del_g)
    want = np.asarray(want)
    np.testing.assert_allclose(got[0], want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ng", NGS)
def test_walk_covers_every_overlap_within_the_slack(ng, dtype):
    """Bin j's walk visits every element with a positive overlap with bin
    j, and only elements whose g-interval meets the bin widened by the
    slack (plus the few eps by which the scan's prefix sums stray from
    monotone); so column j of MA and MB receives exactly bin j's
    overlaps. Rows sorted and shuffled along g."""
    del_g = gauss_del_g(ng)
    w2 = overlap.pair_weights(del_g).astype(dtype)
    edges = overlap.g_bin_edges(del_g).astype(dtype)
    eps = np.finfo(dtype).eps
    slack = SLACK_EPS * eps
    visits = 0
    for order in ("sorted", "shuffled"):
        ta, tb, _, _ = design_case(ng, order)
        for r in range(ta.shape[0]):
            a_row, b_row = ta[r].astype(dtype), tb[r].astype(dtype)
            _, _, ma, mb, walks = mirror_row(a_row, b_row, w2, edges)
            # the row's elements and every positive overlap, from the same
            # prefix sums
            walked_all = {e: (ghi, g_lo) for walk in walks
                          for e, ghi, g_lo, _ in walk}
            assert len(walked_all) == ng * ng  # every element in some bin
            for j, walk in enumerate(walks):
                lo_j, hi_j = edges[j], edges[j + 1]
                walked = {e for e, *_ in walk}
                positive = {e for e, (ghi, g_lo) in walked_all.items()
                            if min(ghi, hi_j) - max(g_lo, lo_j) > 0}
                assert positive <= walked, (order, r, j)
                for e, ghi, g_lo, inter in walk:
                    assert ghi > lo_j - slack - 8 * eps, (order, r, j, e)
                    assert g_lo < hi_j + slack + 8 * eps, (order, r, j, e)
                    assert inter >= 0
                visits += len(walk)
                # the column holds the bin's overlaps and nothing else
                total = sum(inter for *_, inter in walk)
                np.testing.assert_allclose(ma[:, j].sum(dtype=np.float64),
                                           total, rtol=4 * ng * eps)
                np.testing.assert_allclose(mb[:, j].sum(dtype=np.float64),
                                           total, rtol=4 * ng * eps)
    # at most n + NG - 1 overlaps a row, and a slack element or two a bin
    assert visits <= 2 * 12 * (ng * ng + ng - 1 + 2 * ng)
