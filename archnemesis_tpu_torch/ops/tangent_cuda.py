"""Tangent passes of the correlated-k forward under ``torch.func.jacfwd``:
the Hopper kernels and their plain versions.

``gas_tau_tangent`` forms the stacked tangents of one gas's optical depth
from its factored k (``ops/ktab.py:LayerK.tau``); ``skip_rows_`` applies
the random overlap's skip rule to the tangents of one combine in place
(``ops/overlap_cuda.py:mix_pair``). On a CPU tensor each runs its plain
PyTorch version; on a CUDA tensor it launches its kernel in
``csrc/tangent_ops.cu`` or raises. Neither falls back from the card to
the plain version. The library is built with ``nvcc`` at first use
(``ops/cuda_build.py``) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from archnemesis_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def build() -> dict:
    """Compile the kernel library (once per source content) and return
    ``{"path", "seconds", "ptxas"}`` (``ops.cuda_build.build``)."""
    return cuda_build.build("tangent_ops")


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(build()["path"])
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"gas_tau_tangent_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"skip_rows_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(name, device, *args):
    if device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {device}")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(_library(), name)(*args, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def gas_tau_tangent_plain(k, dk_dv, dk_du, a, b, c):
    """``gas_tau_tangent`` in plain PyTorch, on any device."""
    def lay(x):
        return x[:, :, None, :, None]

    out = k[None] * lay(c)
    out = torch.addcmul(out, dk_du[None], lay(b))
    return torch.addcmul(out, dk_dv[None], lay(a))


def gas_tau_tangent(k, dk_dv, dk_du, a, b, c):
    """(T, B, NWAVE, NLAY, NG) tangents dk_dv a + dk_du b + k c of B
    states' optical depths of one gas: ``k``, ``dk_dv``, ``dk_du`` (B,
    NWAVE, NLAY, NG); ``a``, ``b``, ``c`` (T, B, NLAY) per-layer
    coefficients (amount dv, amount du, d amount). One kernel launch on
    the card."""
    if k.device.type == "cpu":
        return gas_tau_tangent_plain(k, dk_dv, dk_du, a, b, c)
    ins = [x.contiguous() for x in (k, dk_dv, dk_du, a, b, c)]
    for x in ins:
        if x.dtype != k.dtype or x.device != k.device:
            raise ValueError("gas_tau_tangent: inputs differ in dtype or "
                             "device")
    if k.dtype not in _DTYPES:
        raise TypeError(f"gas_tau_tangent: dtype {k.dtype}")
    n_batch, nwave, nlay, ng = k.shape
    n_tan = a.shape[0]
    if (dk_dv.shape != k.shape or dk_du.shape != k.shape
            or any(x.shape != (n_tan, n_batch, nlay) for x in (a, b, c))):
        raise ValueError("gas_tau_tangent: factors (B, NWAVE, NLAY, NG) and "
                         "coefficients (T, B, NLAY)")
    out = k.new_empty((n_tan, n_batch, nwave, nlay, ng))
    _launch(f"gas_tau_tangent_{_DTYPES[k.dtype]}", k.device,
            *(x.data_ptr() for x in ins), out.data_ptr(), k.numel(), nlay,
            ng, n_batch, n_tan)
    gas_tau_tangent.launches += 1
    return out


gas_tau_tangent.launches = 0


def skip_rows_plain(dout, da, db, skip_a, skip_b):
    """``skip_rows_``'s values in plain PyTorch, on any device, as a new
    tensor."""
    return torch.where(skip_b[None, :, None], da,
                       torch.where(skip_a[None, :, None], db, dout))


def skip_rows_(dout, da, db, skip_a, skip_b):
    """The random overlap's skip rule on a combine's tangents, in place on
    ``dout`` (T, R, NG) and returned: rows where ``skip_b`` take ``da``'s
    values, else rows where ``skip_a`` take ``db``'s; ``skip_a``,
    ``skip_b``: (R,) bool. On the card one launch, which copies only the
    skipped rows."""
    if dout.device.type == "cpu":
        return dout.copy_(skip_rows_plain(dout, da, db, skip_a, skip_b))
    n_tan, rows, ng = dout.shape
    da, db = da.contiguous(), db.contiguous()
    if (not dout.is_contiguous() or da.shape != dout.shape
            or db.shape != dout.shape or dout.dtype not in _DTYPES
            or skip_a.shape != (rows,) or skip_b.shape != (rows,)):
        raise ValueError("skip_rows_: (T, R, NG) contiguous tangents and "
                         "(R,) flags")
    flags = [s.contiguous().to(torch.uint8) for s in (skip_a, skip_b)]
    _launch(f"skip_rows_{_DTYPES[dout.dtype]}", dout.device,
            dout.data_ptr(), da.data_ptr(), db.data_ptr(),
            *(f.data_ptr() for f in flags), rows, ng, n_tan)
    skip_rows_.launches += 1
    return dout


skip_rows_.launches = 0
