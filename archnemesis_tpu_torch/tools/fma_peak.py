"""The float32 FMA-peak probe of the card: the port's counterpart of
``tools/bench_vpu_peak.py``.

    python -m archnemesis_tpu_torch.tools.fma_peak

Runs the kernel of ``csrc/fma_peak.cu`` (``ops/fma_peak.py:fma_chain``) on
the TPU tool's input, 72,704 x 512 float32 ones (1/8 of the overlap
problem's rows), checks it against the plain version bit for bit on a
random input, and prints the median device time (CUDA events), the rate in
TFLOP/s counting 2 x 512 flops per element as the TPU tool does, its share
of the data sheet's float32 peak, the FFMA count of the kernel's SASS where
``cuobjdump`` exists, and the card's name and power limit.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from archnemesis_tpu_torch.ops import fma_peak
from archnemesis_tpu_torch.tools.common import (
    card_line,
    median_ms,
    require_cuda,
)

ROWS = 8192 * 71 // 8  # the TPU tool's 72,704 rows
COLS = 512
# H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet, dense,
# 700 W)
PEAK_F32_FLOPS = 67e12
CHECK_ROWS = 4096
# one SASS instruction line: /*offset*/ [@predicate] OPCODE ...
_SASS_LINE = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)")


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    return path if os.path.isfile(path) else None


def sass_opcodes(lib_path: str):
    """Opcode counts of the probe kernel's SASS in the built library
    (``cuobjdump -sass``), or None where the toolkit has no cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = collections.Counter()
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "fma_peak_kernel" in line
            continue
        m = _SASS_LINE.match(line)
        if inside and m:
            counts[m.group(1).split(".")[0]] += 1
    return counts


def check(seed: int = 0) -> int:
    """The kernel against ``fma_chain_plain`` on CHECK_ROWS x 512 uniform
    values in [0.5, 2) (and a ragged tail of 3 elements); returns the number
    of elements that differ (0: equal bit for bit)."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0.5, 2.0, CHECK_ROWS * COLS + 3),
                        dtype=torch.float32, device="cuda")
    got = fma_peak.fma_chain(x)
    want = fma_peak.fma_chain_plain(x)
    torch.cuda.synchronize()
    return int((got != want).sum().item())


def measure(reps: int = 20) -> dict:
    """Time the probe on the TPU tool's input: ``ms`` (median of ``reps``),
    ``tflops`` and ``share`` of PEAK_F32_FLOPS, ``plain_ms`` (one call of
    the plain version on the same input), ``bound_ms`` (its flops at the
    peak) and ``max_abs_err`` of the kernel against the plain version."""
    x = torch.ones((ROWS, COLS), dtype=torch.float32, device="cuda")
    out = fma_peak.fma_chain(x)
    ms = median_ms(lambda: fma_peak.fma_chain(x), reps=reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = fma_peak.fma_chain_plain(x)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = (out - plain).abs().max().item()
    flops = x.numel() * fma_peak.FLOPS_PER_ELEMENT
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, flops=flops,
                tflops=flops / ms / 1e9,
                share=flops / ms / 1e-3 / PEAK_F32_FLOPS,
                bound_ms=flops / PEAK_F32_FLOPS * 1e3)


def main() -> int:
    require_cuda()
    card = card_line()
    built = fma_peak.build()
    differ = check()
    rec = measure()
    print(f"card: {card}")
    print(f"kernel vs plain on {CHECK_ROWS * COLS + 3} random elements: "
          f"{differ} differ")
    ops = sass_opcodes(built["path"])
    if ops is None:
        print("SASS: no cuobjdump in the toolkit")
    else:
        print(f"SASS of fma_peak_kernel: {ops['FFMA']} FFMA, {ops['FMUL']} "
              f"FMUL, {ops['FADD']} FADD of {sum(ops.values())} instructions")
    print(f"FMA peak probe, {ROWS} x {COLS} float32: {rec['ms']:.4f} ms "
          f"(median), {rec['tflops']:.2f} TFLOP/s = {rec['share']:.4f} of "
          f"the {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s data-sheet peak; plain "
          f"{rec['plain_ms']:.2f} ms; max_abs_err {rec['max_abs_err']:.3e}")
    return 0 if differ == 0 and rec["max_abs_err"] == 0.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
