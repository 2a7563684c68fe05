"""A/B timing of the random-overlap combine's variants on the card: the
port's counterpart of ``tools/bench_overlap_variants.py``.

    python -m archnemesis_tpu_torch.tools.overlap_variants [names ...]

The TPU tool's inputs (``default_rng(0)``, rows of 20 log-normal values
sorted along g, R = 8192 x 71, Gauss-Legendre del_g) and its variant
names: ``check`` (the lean combine against the combine kernel, max relative
difference: 0, since both run one row code), ``current`` (the combine
kernel, ``ops/overlap_cuda.py:combine_pair``), ``lean``, ``edges``,
``sortonly``, ``rollonly`` (the modes of
``ops/overlap_variants.py:combine_lean`` at 256 rows per block) and
``lean8`` .. ``lean128`` (the full mode at 8 .. 128 rows per block).

The modes take the combine kernel apart stage by stage, on its own row
code (``csrc/overlap_row.cuh``):

- ``lean``: the combine kernel's row, with the tool's denominator floor
  and its rows taken in turn by the block's warps; its time against
  ``current`` is what the row layout costs;
- ``edges``: the kernel's merge and weight scan, with a second prefix sum
  of key * weight and a rebin by NG + 1 binary searches of the bin edges:
  ``lean - edges`` is what the per-bin walk costs against a search;
- ``sortonly``: the kernel's merge on the keys alone (4-byte elements, no
  index pair): ``current - sortonly`` is what the kernel spends beyond the
  merge (the scan, the rebin and the 8-byte element);
- ``rollonly``: one coalesced pass that reads the inputs and writes NG
  values a row, the device-memory floor of any combine at these shapes.

Prints ms per pair combine, the median of CUDA-event times, with the
card's name and power limit. Default: every name.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair
from archnemesis_tpu_torch.ops.overlap_variants import ROW_TILES, combine_lean
from archnemesis_tpu_torch.tools.common import (
    card_line,
    median_ms,
    require_cuda,
)

NG = 20
ROWS = 8192 * 71
NAMES = ("check", "current", "lean", "edges", "sortonly", "rollonly",
         *(f"lean{t}" for t in ROW_TILES[:-1]))


def inputs(rows: int = ROWS, ng: int = NG, device="cuda"):
    """(tau_a, tau_b, del_g): the TPU tool's float32 inputs on ``device``."""
    del_g = 0.5 * np.polynomial.legendre.leggauss(ng)[1]
    rng = np.random.default_rng(0)
    a, b = (np.sort(np.exp(rng.normal(-2, 2, (rows, ng))), axis=1)
            for _ in range(2))
    return (torch.as_tensor(a, dtype=torch.float32, device=device),
            torch.as_tensor(b, dtype=torch.float32, device=device), del_g)


def variants(tau_a, tau_b, del_g) -> dict:
    """name -> a call of that variant on the inputs."""
    calls = {
        "current": lambda: combine_pair(tau_a, tau_b, del_g),
        "lean": lambda: combine_lean(tau_a, tau_b, del_g, "full"),
        "edges": lambda: combine_lean(tau_a, tau_b, del_g, "edges"),
        "sortonly": lambda: combine_lean(tau_a, tau_b, del_g, "sortonly"),
        "rollonly": lambda: combine_lean(tau_a, tau_b, del_g, "rollonly"),
    }
    for tile in ROW_TILES[:-1]:
        calls[f"lean{tile}"] = (
            lambda t=tile: combine_lean(tau_a, tau_b, del_g, "full", t))
    return calls


def lean_vs_current(tau_a, tau_b, del_g) -> float:
    """Max relative difference of the lean combine from the combine
    kernel (the TPU tool's ``check``)."""
    ref = combine_pair(tau_a, tau_b, del_g)
    lean = combine_lean(tau_a, tau_b, del_g, "full")
    return ((ref - lean).abs() / ref.abs().clamp_min(1e-30)).max().item()


def run(names, tau_a, tau_b, del_g) -> dict:
    """Print and return ``{name: ms per pair}`` of the named variants on the
    inputs (``check`` prints the lean combine's difference from the
    combine kernel)."""
    if "check" in names:
        print(f"lean-vs-current max rel diff: "
              f"{lean_vs_current(tau_a, tau_b, del_g):.3e}", flush=True)
    calls = variants(tau_a, tau_b, del_g)
    times = {}
    for name in names:
        if name in calls:
            times[name] = median_ms(calls[name])
            print(f"  {name:10s} {times[name]:9.4f} ms/pair", flush=True)
    return times


def main(argv=None) -> int:
    require_cuda()
    which = list(argv if argv is not None else sys.argv[1:]) or list(NAMES)
    unknown = sorted(set(which) - set(NAMES))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; names: {NAMES}")
    print(f"card: {card_line()}")
    run(which, *inputs())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
