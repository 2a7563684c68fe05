"""float32 fused multiply-add throughput probe: the Hopper kernel and its
plain version.

``fma_chain`` launches the hand-written CUDA kernel in ``csrc/fma_peak.cu``
on a CUDA float32 tensor and raises on any other: it has no CPU path and
never falls back. ``fma_chain_plain`` is the same function in PyTorch, on
any device: the CPU's version and the kernel's oracle.

Both compute the function of the TPU kernel ``run``
(``tools/bench_vpu_peak.py:39``) elementwise: ``y = x*1.0000001 + 0.5``,
``z = x*0.9999999 - 0.25``, then 256 steps of ``y = y*1.0000001 + x`` and
``z = z*0.9999999 + x``, and ``y + z``. Every multiply-add is one fused,
once-rounded float32 FMA, as the card's FFMA is and as XLA contracts the
JAX kernel's ``y * c + x`` on the CPU, so the three agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from archnemesis_tpu_torch.ops import cuda_build

UP = 1.0000001
DOWN = 0.9999999
STEPS = 256  # per chain: NITER = 512 multiply-adds over the two chains
FLOPS_PER_ELEMENT = 2 * 2 * STEPS  # an FMA is 2 flops, as the TPU tool counts


def build() -> dict:
    """Compile the kernel library (once per source content) and return
    ``{"path", "seconds", "ptxas"}`` (``ops.cuda_build.build``)."""
    return cuda_build.build("fma_peak")


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(build()["path"])
    lib.fma_peak_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.fma_peak_f32.restype = ctypes.c_int
    return lib


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as an FFMA: the product is exact
    in float64, the sum is rounded to odd there (the float64 sum and its
    exact error by two-sum; an inexact sum with an even last bit moves one
    step toward the exact value), and that rounds to nearest float32
    without a double-rounding error (53 >= 24 + 2 bits)."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float64, device=a.device)
               for v in (a, b, c))
    p = a * b
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    odd = (s.view(torch.int64) & 1) == 1
    toward = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where((err == 0) | odd, s, toward).to(torch.float32)


def fma_chain_plain(x):
    """The probe's recurrence on a float32 tensor, each multiply-add rounded
    once (``fma32``); on the tensor's own device."""
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, the probe is float32")
    up = torch.tensor(UP, dtype=torch.float32)
    down = torch.tensor(DOWN, dtype=torch.float32)
    y = fma32(x, up, 0.5)
    z = fma32(x, down, -0.25)
    for _ in range(STEPS):
        y = fma32(y, up, x)
        z = fma32(z, down, x)
    return y + z


def fma_chain(x):
    """One launch of the kernel on a contiguous CUDA float32 tensor; adds
    one to ``fma_chain.launches``. Raises on any other tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"fma_chain runs on the CUDA card, not {x.device} "
                         "(fma_chain_plain is the CPU version)")
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, the probe is float32")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    err = _library().fma_peak_f32(
        x.data_ptr(), out.data_ptr(), x.numel(), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fma_peak launch failed: CUDA error {err}")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0
