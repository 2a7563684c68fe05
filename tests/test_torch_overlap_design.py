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

The primal kernel (``combine_primal_kernel``) takes the same arithmetic
another way, one thread a row: ``stream_row`` follows its steps (a loser
tree over the NG run heads, ordered by key then run; the slice sums and
the warp scan's add tree taken as the elements stream past; each
element's overlaps added into the bins it touches, a bin closed when the
stream passes its upper edge and the slack). It is held to ``mirror_row``
bit for bit in float32 and float64, on rows sorted, shuffled, tied and
zero, and on bins that one element spans.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.ops.overlap import _combine_pair as jax_combine_pair
from archnemesis_tpu.ops.overlap import g_bin_edges as jax_g_bin_edges
from archnemesis_tpu_torch.ops import overlap, overlap_cuda
import chip_smoke
from port_cases import (
    WIDE_DEL_G,
    gauss_del_g,
    kernel_scan,
    tiefree_overlap_inputs,
    wide_overlap_inputs,
)

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


def _stable_order(x):
    """Indices of x in ascending order, ties by index, by insertion sort
    (the primal kernel's sort of a row that is not sorted along g)."""
    order = []
    for k in range(x.size):
        i = len(order)
        while i > 0 and x[order[i - 1]] > x[k]:
            i -= 1
        order.insert(i, k)
    return np.array(order)


def _first_leaf(c: int, ng: int) -> int:
    """The lowest run among the leaves below node c of the loser tree
    (nodes 1 .. NG - 1, leaf NG + r for run r)."""
    lo = hi = c
    while hi < ng:
        lo, hi = 2 * lo, 2 * hi + 1
    return max(lo, ng) - ng


def stream_row(a_row, b_row, w2, edges):
    """One row through the primal kernel's steps (one thread a row), in the
    dtype of the inputs; returns out (NG,).

    The NG runs a_(i) + b_(j) stream out of a loser tree in the order
    (key, run, position); each element's weight is summed serially within
    slices of the warp scan's length, each slice offset by the scan's add
    tree over the slices' totals (a ring of each level's past sums); its
    overlaps go into the bins it touches, bin jb and jb + 1 in registers
    and any further one spilled, and bin jb closes at the first element
    whose upper end passes its upper edge plus the slack. Products and sums
    round separately, as in ``mirror_row``."""
    dtype = a_row.dtype.type
    ng = a_row.size
    n = ng * ng
    ia, ib = _stable_order(a_row), _stable_order(b_row)
    sa, sb = a_row[ia], b_row[ib]
    spent = 64

    def head(r, j):
        """(key, run, position) of run r's j-th element."""
        if j == ng:
            return (dtype(np.inf), spent, j)
        return (sa[r] + sb[j], r, j)

    def before(x, y):
        return x[0] < y[0] or (x[0] == y[0] and x[1] < y[1])

    # sorted rows give keys that rise with the run, so every match of the
    # first heads is won by the lower run
    tree = [None] + [head(max(_first_leaf(2 * p, ng),
                              _first_leaf(2 * p + 1, ng)), 0)
                     for p in range(1, ng)]
    winner = head(0, 0)

    size = ((n + 31) // 32) | 1
    ring = [[dtype(0)] * (1 << k) for k in range(5)]  # ring[k][i]: v_k[x-1-i]

    def scan_offset(total, x):
        """v_5[x], the warp scan's inclusive sum at slice x."""
        v = total
        for k in range(5):
            old = ring[k][-1]
            ring[k] = [v] + ring[k][:-1]
            if x >= (1 << k):
                v = v + old
        return v

    slack = dtype(SLACK_EPS) * np.finfo(dtype).eps
    tiny = np.finfo(dtype).tiny
    zero = dtype(0)
    num = [zero] * ng
    den = [zero] * ng
    spill = {}
    jb = 0
    n0 = d0 = n1 = d1 = zero

    def edge_pair(j):
        """(edge j, edge j + 1), the second the first past the last bin."""
        return edges[j], edges[min(j + 1, ng)]

    e0, e1 = edge_pair(0)
    e2 = edges[min(2, ng)] if ng > 1 else e1
    off = local = zero
    pos = 0
    for e in range(n):
        key, r, j = winner
        w = w2[ia[r] * ng + ib[j]]
        cand = head(r, j + 1)
        p = (ng + r) >> 1
        while p:
            if before(tree[p], cand):
                tree[p], cand = cand, tree[p]
            p >>= 1
        winner = cand

        local = (zero if pos == 0 else local) + w
        ghi = local + off
        g_lo = ghi - w
        if jb < ng:
            inter = min(ghi, e1) - max(g_lo, e0)
            if inter > 0:
                n0, d0 = n0 + key * inter, d0 + inter
            inter = min(ghi, e2) - max(g_lo, e1)
            if inter > 0:
                n1, d1 = n1 + key * inter, d1 + inter
            k = jb + 2
            while k < ng and edges[k] < ghi:
                inter = min(ghi, edges[k + 1]) - max(g_lo, edges[k])
                if inter > 0:
                    sn, sd = spill.get(k, (zero, zero))
                    spill[k] = (sn + key * inter, sd + inter)
                k += 1
            while jb < ng and ghi >= e1 + slack:
                num[jb], den[jb] = n0, d0
                jb += 1
                n0, d0 = n1, d1
                n1, d1 = spill.pop(jb + 1, (zero, zero))
                e0, e1 = e1, e2
                e2 = edges[jb + 2] if jb + 2 <= ng else e1
        pos += 1
        if pos == size:
            off = scan_offset(local, e // size)
            pos = 0
    for k in range(jb, ng):
        num[k], den[k] = ((n0, d0) if k == jb else (n1, d1) if k == jb + 1
                          else spill.get(k, (zero, zero)))
    return np.array([x / max(d, tiny) for x, d in zip(num, den)], dtype)


def _stream_cases(ng: int):
    """name -> (a, b, del_g): ``chip_smoke.combine_cases`` on Gauss-Legendre
    bins; with NG = 7 also rows of one scale in a and b, sorted and
    shuffled, on ``WIDE_DEL_G``."""
    cases = {name: (a, b, gauss_del_g(ng)) for name, (a, b) in
             chip_smoke.combine_cases(6, ng, seed=ng).items()}
    if ng == 7:
        rng = np.random.default_rng(ng)
        a, b = wide_overlap_inputs(6, seed=ng)
        cases["wide_sorted"] = (a, b, WIDE_DEL_G)
        cases["wide_shuffled"] = (rng.permuted(a, axis=1),
                                  rng.permuted(b, axis=1), WIDE_DEL_G)
    return cases


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ng", NGS)
def test_stream_row_matches_mirror_bit_for_bit(ng, dtype):
    """The primal kernel's streamed merge, scan and rebin give the
    warp-per-row arithmetic's every bit: the same element order, the same
    prefix sums, each bin's overlaps added in the same order."""
    for name, (ta, tb, del_g) in _stream_cases(ng).items():
        w2 = overlap.pair_weights(del_g).astype(dtype)
        edges = overlap.g_bin_edges(del_g).astype(dtype)
        for r in range(ta.shape[0]):
            a_row, b_row = ta[r].astype(dtype), tb[r].astype(dtype)
            want = mirror_row(a_row, b_row, w2, edges)[0]
            got = stream_row(a_row, b_row, w2, edges)
            assert got.tobytes() == want.tobytes(), (name, r, got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stream_row_wide_case_reaches_the_spill(dtype):
    """The wide case holds elements that overlap three bins or more (the
    third one past the two register bins: the spill) and bins narrower
    than the float32 slack, in both dtypes."""
    ta, tb, del_g = _stream_cases(7)["wide_sorted"]
    w2 = overlap.pair_weights(del_g).astype(dtype)
    edges = overlap.g_bin_edges(del_g).astype(dtype)
    assert (np.diff(edges)[3:5] < SLACK_EPS * np.finfo(np.float32).eps).all()
    most = 0
    for r in range(ta.shape[0]):
        walks = mirror_row(ta[r].astype(dtype), tb[r].astype(dtype), w2,
                           edges)[4]
        bins_of = {}
        for j, walk in enumerate(walks):
            for e, _, _, inter in walk:
                if inter > 0:
                    bins_of[e] = bins_of.get(e, 0) + 1
        most = max(most, max(bins_of.values()))
    assert most >= 3
