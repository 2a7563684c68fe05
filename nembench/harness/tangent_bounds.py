"""Least time of the random-overlap combine's tangent work on an H100, from
the cell's shapes: a frozen copy of the port's card script's count for
the fused primal-plus-tangent combine (``chip_smoke.py:fused_bound_ms``),
defined on the work and not on the kernel that does it, so that a chunked
or a fused design reads the same bound."""

from __future__ import annotations

from nembench.harness.bounds import (
    PEAK_BYTES_S,
    PEAK_F32_OPS_S,
    PEAK_F64_OPS_S,
    combine_ops_per_row,
)


def tangent_ops_per_row(ng: int) -> int:
    """Operations one row needs per tangent beyond the primal's: the n =
    NG^2 sums da[i] + db[j], a multiply-add (2) per (element, bin) overlap
    (at most n + NG - 1), and NG scalings by 1 / den."""
    n = ng * ng
    return n + 2 * (n + ng - 1) + ng


def fused_combine_bytes(rows: int, ng: int, n_tan: int, itemsize: int) -> int:
    """Bytes one combine with ``n_tan`` tangents reads and writes at the
    least: the primal's two inputs and its output, and each tangent's two
    inputs and its output, (R, NG) each."""
    return 3 * (1 + n_tan) * rows * ng * itemsize


def fused_combine_bound_ms(rows: int, ng: int, n_tan: int,
                           itemsize: int, presorted: bool = True) -> float:
    """Least time of one combine with ``n_tan`` tangents: the larger of its
    bytes over HBM bandwidth and its operations (the primal's and
    ``tangent_ops_per_row`` per tangent) over the peak of its type."""
    bytes_ms = fused_combine_bytes(rows, ng, n_tan, itemsize) / PEAK_BYTES_S * 1e3
    peak = PEAK_F32_OPS_S if itemsize == 4 else PEAK_F64_OPS_S
    ops = combine_ops_per_row(ng, presorted) + n_tan * tangent_ops_per_row(ng)
    return max(bytes_ms, rows * ops / peak * 1e3)
