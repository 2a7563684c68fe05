"""Random-overlap pair combine: the Hopper kernel and its plain version.

``combine_pair`` is the wrapper every caller uses. On a CPU tensor it runs
the plain PyTorch version (``combine_pair_plain``); on a CUDA tensor it
launches the hand-written CUDA kernel in ``csrc/overlap_combine.cu`` or
raises. It never falls back from the card to the plain version.

The kernel replaces the TPU kernel ``combine_pair_pallas``
(``archnemesis_tpu/ops/overlap_pallas.py:398``). It is built with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface at first use
(under ``build/`` at the repository root), and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from archnemesis_tpu_torch.ops.overlap import (
    _combine_pair,
    g_bin_edges,
    pair_weights,
)

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "overlap_combine.cu",
)
_BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "overlap_combine",
)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_NG = 32  # e_pad = next pow2 of NG*NG must fit 32 per lane of one warp

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def e_pad(ng: int) -> int:
    """Padded element count of one row: next power of two of NG*NG, at
    least one per lane of a warp."""
    return max(32, 1 << (ng * ng - 1).bit_length())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build() -> dict:
    """Compile the kernel library (once per source content) and return
    ``{"path", "seconds", "ptxas"}``; ``seconds`` is 0 when it was built
    before. Raises if nvcc fails."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out_dir = os.path.join(_BUILD_ROOT, digest.hexdigest()[:16])
    lib = os.path.join(out_dir, "liboverlap_combine.so")
    log = os.path.join(out_dir, "ptxas.txt")
    if os.path.exists(lib):
        with open(log) as f:
            return {"path": lib, "seconds": 0.0, "ptxas": f.read()}
    nvcc = _nvcc()
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"no nvcc at {nvcc}: the kernel is built with the "
                           "CUDA toolkit (set CUDA_HOME or PATH)")
    os.makedirs(out_dir, exist_ok=True)
    # each building process writes its own file and renames it into place
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, _SOURCE],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {_SOURCE}:\n{proc.stderr}"
        )
    with open(log, "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, lib)
    return {"path": lib, "seconds": seconds, "ptxas": proc.stderr}


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(build()["path"])
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"overlap_combine_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _tables(del_g: tuple, dtype: torch.dtype, device: torch.device):
    """Device copies of the padded pair weights and the bin edges for one
    static del_g (built once per del_g, dtype and device)."""
    ng = len(del_g)
    w2 = np.zeros(e_pad(ng))
    w2[: ng * ng] = pair_weights(del_g)
    edges = g_bin_edges(del_g)
    return (torch.as_tensor(w2, dtype=dtype, device=device),
            torch.as_tensor(edges, dtype=dtype, device=device))


def combine_pair_plain(tau_a, tau_b, del_g):
    """Plain PyTorch combine of two (R, NG) k-distributions (torch.sort +
    gather + cumsum + interval-overlap contraction)."""
    del_g = np.asarray(del_g, dtype=np.float64)
    return _combine_pair(pair_weights(del_g), g_bin_edges(del_g), tau_a, tau_b)


def _check_cuda_inputs(tau_a, tau_b, ng):
    for name, t in (("tau_a", tau_a), ("tau_b", tau_b)):
        if t.requires_grad or (
            torch.autograd.forward_ad.unpack_dual(t).tangent is not None
        ):
            raise NotImplementedError(
                f"{name} carries a gradient: the kernel's tangent co-sort "
                "comes with the retrieval slice of the port"
            )
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not float32/float64")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tau_a.dim() != 2 or tau_a.shape != tau_b.shape:
        raise ValueError(
            f"need two (R, NG) tensors of one shape, got {tuple(tau_a.shape)}"
            f" and {tuple(tau_b.shape)}"
        )
    if tau_a.dtype != tau_b.dtype or tau_a.device != tau_b.device:
        raise ValueError("tau_a and tau_b differ in dtype or device")
    if tau_a.shape[1] != ng:
        raise ValueError(f"rows have {tau_a.shape[1]} g-ordinates, del_g {ng}")
    if not 1 <= ng <= MAX_NG:
        raise ValueError(f"NG={ng} outside 1..{MAX_NG} (e_pad <= 1024)")
    if tau_a.shape[0] * ng >= 2**31:
        raise ValueError("too many rows for 32-bit row indexing")


def combine_pair(tau_a, tau_b, del_g):
    """Random-overlap combine of two (R, NG) k-distributions.

    del_g: the NG host g-bin widths (tuple or numpy). CPU tensors go to the
    plain version; CUDA tensors launch the kernel (float32 or float64) and
    add one to ``combine_pair.launches`` per launch.
    """
    if tau_a.device.type == "cpu":
        return combine_pair_plain(tau_a, tau_b, del_g)
    if tau_a.device.type != "cuda":
        raise ValueError(f"no overlap combine for device {tau_a.device}")
    del_g = tuple(float(x) for x in np.asarray(del_g, dtype=np.float64))
    ng = len(del_g)
    _check_cuda_inputs(tau_a, tau_b, ng)
    w2, edges = _tables(del_g, tau_a.dtype, tau_a.device)
    out = torch.empty_like(tau_a)
    rows = tau_a.shape[0]
    fn = getattr(_library(), f"overlap_combine_{_DTYPES[tau_a.dtype]}")
    stream = torch.cuda.current_stream(tau_a.device).cuda_stream
    err = fn(tau_a.data_ptr(), tau_b.data_ptr(), w2.data_ptr(),
             edges.data_ptr(), out.data_ptr(), rows, ng, e_pad(ng),
             tau_a.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"overlap_combine launch failed: CUDA error {err}")
    combine_pair.launches += 1
    return out


combine_pair.launches = 0
