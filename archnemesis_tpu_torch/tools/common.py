"""What the port's tools share: the card's description, a CUDA-event
timer and the toolkit's disassembler."""

from __future__ import annotations

import os
import re
import shutil
import subprocess

import numpy as np
import torch


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call in ms over ``reps`` calls,
    each between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def require_cuda():
    """Raise unless a CUDA card is visible: the tools measure the card and
    have no CPU fallback."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card")


# one SASS instruction line: /*offset*/ [@predicate] OPCODE ...
SASS_LINE = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)")


def cuobjdump():
    """Path of the toolkit's ``cuobjdump``, or None where it has none."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    return path if os.path.isfile(path) else None
