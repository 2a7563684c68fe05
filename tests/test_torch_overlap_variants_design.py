"""The combine variants' designs (``csrc/overlap_variants.cu``, kernel 3)
held on the CPU where they can be.

Numpy mirrors of each mode's algorithm, held to the plain versions
(``ops/overlap_variants.py:combine_lean_plain``), which
``tests/test_torch_tools.py`` holds to the TPU tool:

- ``edges``: the row in the merge's order (runs a_(i) + b_(j) over j, equal
  keys in run order), the prefix sums of the weights and of key * weight as
  the kernel's scan takes them, and the rebin by a binary search of each
  bin edge (the 128-eps slack below it, then a walk to the element that
  straddles it), S and W read from the prefix sums and that element; in
  float64 against the float64 plain version, and in float32 against it at
  ``chip_smoke.variant_f32_tol``, the bound the card is held to;
- ``rollonly``: the direct index formula, out[r, c] = padded[(c - S) mod
  e_ref], bit for bit;
- ``sortonly``: the merge on the keys alone as the kernel runs it (the
  first level in registers by counts, then the merge-path tree with each
  lane's odd slice started by its co-rank search), its first NG against
  ``torch.sort``.

The kernel itself is held to the plain versions on the card
(``chip_smoke.py`` phase 12 and the ``cuda`` tests of
``tests/test_torch_tools.py``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu_torch.ops import overlap_variants as ov
from archnemesis_tpu_torch.ops.overlap import g_bin_edges, pair_weights
from port_cases import WARP, gauss_del_g, kernel_scan

SLACK_EPS = 128  # the kernel's kSlackEps
DESIGN_NGS = (1, 2, 4, 20, 32)


def variant_rows(rows: int, ng: int, seed: int):
    """(rows, NG) float64 log-normal rows as the tool makes them: sorted
    along g, then all-zero rows, rows with many tied values (rounded to one
    decimal) and rows shuffled along g in a, in b and in both."""
    rng = np.random.default_rng(seed)
    a, b = (np.sort(np.exp(rng.normal(-2, 2, (rows, ng))), axis=1)
            for _ in range(2))
    a[0] = b[0] = 0.0
    a[1:3], b[1:3] = np.round(a[1:3], 1), np.round(b[1:3], 1)
    a[3:5] = rng.permuted(a[3:5], axis=1)
    b[4:6] = rng.permuted(b[4:6], axis=1)
    return a, b


def merge_order(a_row, b_row):
    """The row's pair sums and original index pairs in the kernel's merge
    order: a and b sorted (ties by index), runs a_(i) + b_(j) over j, and
    equal keys in run order."""
    ng = a_row.size
    ia = np.argsort(a_row, kind="stable")
    ib = np.argsort(b_row, kind="stable")
    keys = (a_row[ia][:, None] + b_row[ib][None, :]).reshape(ng * ng)
    pay_a, pay_b = np.repeat(ia, ng), np.tile(ib, ng)
    order = np.argsort(keys, kind="stable")
    return keys[order], pay_a[order], pay_b[order]


def edge_sums(keys, w, ghi, pkw, x, slack):
    """S(x), W(x) as a lane of the kernel reads them."""
    dtype = w.dtype.type
    n = w.size
    first = x - slack
    e, top = 0, n
    while e < top:
        c = (e + top) >> 1
        if ghi[c] > first:
            top = c
        else:
            e = c + 1
    while e < n and ghi[e] <= x:
        e += 1
    s = pkw[e - 1] if e > 0 else dtype(0)
    wsum = ghi[e - 1] if e > 0 else dtype(0)
    if e < n:
        part = min(max(x - (ghi[e] - w[e]), dtype(0)), w[e])
        s = dtype(float(keys[e]) * float(part) + float(s))
        wsum = wsum + part
    return s, wsum


def edges_mirror(a, b, del_g, dtype):
    """The edges mode's rows in ``dtype``."""
    w2 = pair_weights(del_g).astype(dtype)
    edges = g_bin_edges(del_g).astype(dtype)
    a, b = a.astype(dtype), b.astype(dtype)
    ng = a.shape[1]
    slack = dtype(SLACK_EPS) * np.finfo(dtype).eps
    out = np.zeros_like(a)
    for r in range(a.shape[0]):
        keys, pay_a, pay_b = merge_order(a[r], b[r])
        w = w2[pay_a * ng + pay_b]
        ghi = kernel_scan(w)
        pkw = kernel_scan(w, keys=keys)
        sums = [edge_sums(keys, w, ghi, pkw, x, slack) for x in edges]
        s = np.array([v[0] for v in sums], dtype)
        wsum = np.array([v[1] for v in sums], dtype)
        out[r] = (s[1:] - s[:-1]) / np.maximum(wsum[1:] - wsum[:-1],
                                               dtype(ov.DEN_FLOOR))
    return out


@pytest.mark.parametrize("ng", DESIGN_NGS)
def test_search_rebin_matches_plain_float64(ng):
    """The search-based edge rebin gives the plain edges mode in float64 at
    rtol 1e-12 of each value plus 1e-12 of its row's peak, on rows with
    ties, zeros and rows not sorted along g."""
    del_g = gauss_del_g(ng)
    a, b = variant_rows(10, ng, seed=ng)
    got = edges_mirror(a, b, del_g, np.float64)
    want = ov.combine_lean_plain(torch.as_tensor(a), torch.as_tensor(b),
                                 del_g, "edges").numpy()
    peak = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-12 * (np.abs(want) + peak))


@pytest.mark.parametrize("ng", (4, 20, 32))
def test_search_rebin_float32_within_the_card_bound(ng):
    """In float32 the search rebin (one float32 prefix sum of key * weight,
    no two-float sum) stays within ``chip_smoke.variant_f32_tol`` of each
    row's peak of the float64 plain version, the bound the card's kernel is
    held to, on the tool's log-normal rows."""
    del_g = gauss_del_g(ng)
    a, b = variant_rows(24, ng, seed=100 + ng)
    a, b = a.astype(np.float32), b.astype(np.float32)
    got = edges_mirror(a, b, del_g, np.float32).astype(np.float64)
    want = ov.combine_lean_plain(torch.as_tensor(a).double(),
                                 torch.as_tensor(b).double(), del_g,
                                 "edges").numpy()
    peak = np.abs(want).max(axis=1, keepdims=True)
    peak = np.where(peak > 0, peak, 1.0)
    assert np.max(np.abs(got - want) / peak) <= chip_smoke.variant_f32_tol(
        del_g, "edges")


@pytest.mark.parametrize("ng", range(1, 33))
def test_rollonly_index_formula_bit_for_bit(ng):
    """out[r, c] = padded[(c - S) mod e_ref], padded[e] = a[r, e // NG] +
    b[r, e % NG] below NG^2 and the float32 maximum above, equals the plain
    version (``torch.roll`` of the padded row) bit for bit."""
    a, b = (x.astype(np.float32) for x in variant_rows(7, ng, seed=ng))
    e_ref, shift = ov.ref_pad(ng), ov.roll_shift(ng)
    e = (np.arange(ng) - shift) & (e_ref - 1)
    live = e < ng * ng
    ia, ib = np.where(live, e // ng, 0), np.where(live, e % ng, 0)
    got = np.where(live, a[:, ia] + b[:, ib], np.finfo(np.float32).max)
    want = ov.combine_lean_plain(torch.as_tensor(a), torch.as_tensor(b),
                                 gauss_del_g(ng), "rollonly").numpy()
    np.testing.assert_array_equal(got.astype(np.float32), want)


def keys_merge(a_row, b_row):
    """The sorted pair sums as the kernel's merge on keys alone produces
    them: a and b put in order, the first level merging runs 2k and 2k + 1
    by counts (x_j to j + #{y < x_j}, y_j to j + #{x <= y_j}), then the
    merge-path tree, lane l writing its odd slice of each level from the
    co-rank its binary search finds (equal keys: the left run first)."""
    ng = a_row.size
    n = ng * ng
    sa, sb = np.sort(a_row), np.sort(b_row)
    buf = np.zeros(n, a_row.dtype)
    for i in range(0, ng, 2):
        x = sa[i] + sb
        if i + 1 == ng:
            buf[i * ng:i * ng + ng] = x
            break
        y = sa[i + 1] + sb
        for j in range(ng):
            buf[i * ng + j + np.sum(y < x[j])] = x[j]
            buf[i * ng + j + np.sum(x <= y[j])] = y[j]
    spent = np.finfo(a_row.dtype).max
    slice_ = ((n + WARP - 1) // WARP) | 1
    run = 2 * ng
    while run < n:
        other = np.zeros_like(buf)
        for lane in range(WARP):
            d, d_end = min(lane * slice_, n), min(lane * slice_ + slice_, n)
            while d < d_end:
                s = d // (2 * run) * (2 * run)
                mid, end = min(s + run, n), min(s + 2 * run, n)
                stop, k = min(d_end, end), d - s
                lo, hi = max(0, k - (end - mid)), min(k, mid - s)
                while lo < hi:
                    c = (lo + hi) >> 1
                    if buf[s + c] <= buf[mid + k - c - 1]:
                        lo = c + 1
                    else:
                        hi = c
                x, y = s + lo, mid + k - lo
                while d < stop:
                    ex = buf[x] if x < mid else spent
                    ey = buf[y] if y < end else spent
                    if ex <= ey:
                        other[d], x = ex, x + 1
                    else:
                        other[d], y = ey, y + 1
                    d += 1
        buf = other
        run *= 2
    return buf


@pytest.mark.parametrize("ng", (1, 2, 3, 4, 7, 20, 31, 32))
def test_keys_only_merge_matches_torch_sort(ng):
    """The keys-only merge sorts every row's pair sums as ``torch.sort``
    does, bit for bit, so its first NG are ``sortonly``'s plain version; on
    rows with ties, zeros and rows not sorted along g, in float32."""
    a, b = (x.astype(np.float32) for x in variant_rows(6, ng, seed=ng + 50))
    got = np.stack([keys_merge(a[r], b[r]) for r in range(a.shape[0])])
    pairs = torch.as_tensor(a)[:, :, None] + torch.as_tensor(b)[:, None, :]
    want = torch.sort(pairs.reshape(a.shape[0], ng * ng), dim=1).values
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(
        got[:, :ng], ov.combine_lean_plain(torch.as_tensor(a),
                                           torch.as_tensor(b),
                                           gauss_del_g(ng),
                                           "sortonly").numpy())
