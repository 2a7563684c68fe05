"""Random-overlap pair combine: the Hopper kernels and their plain versions.

``combine_pair`` is the wrapper every caller uses. On a CPU tensor it runs
the plain PyTorch version (``combine_pair_plain``); on a CUDA tensor it
launches the hand-written CUDA kernel in ``csrc/overlap_combine.cu`` or
raises. It never falls back from the card to the plain version.

``combine_pair`` is differentiable in forward mode only, as the TPU kernel
is (``custom_jvp``): its ``jvp`` calls ``combine_pair_with_tangents``, the
fused primal + tangent combine, which dispatches the same way (plain version
``combine_pair_with_tangents_plain`` on the CPU, the fused kernel on the
card, whose primal is the primal kernel's result bit for bit). Under
``torch.func.jacfwd`` the fused combine's ``vmap`` rule stacks all tangents
and makes ONE call, so a Jacobian costs one sort pass per combine, not one
per state element.

``mix_pair`` is ``ops/overlap.py:mix_gas_k``'s step: the combine with the
random overlap's skip rule (a row where one distribution has no opacity
takes the other). Its forward-mode rule runs the fused combine and applies
the rule to that combine's own fresh tangents in place
(``ops/tangent_cuda.py:skip_rows_``), so a step costs one pass over the
tangents.

The kernels replace the TPU kernels ``combine_pair_pallas``
(``archnemesis_tpu/ops/overlap_pallas.py:398``) and its tangent co-sort
(``_combine_pallas`` with tangents, ``:270-329``). They are built with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface at
first use (``ops/cuda_build.py``, under ``build/`` at the repository root),
and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from archnemesis_tpu_torch.ops import cuda_build
from archnemesis_tpu_torch.ops.overlap import (
    _combine_pair,
    _combine_pair_with_tangents,
    g_bin_edges,
    pair_weights,
)

MAX_NG = 32  # NG lanes of one warp

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def build() -> dict:
    """Compile the kernel library (once per source content) and return
    ``{"path", "seconds", "ptxas"}`` (``ops.cuda_build.build``)."""
    return cuda_build.build("overlap_combine")


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(build()["path"])
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"overlap_combine_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"overlap_combine_tan_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _tables(del_g: tuple, dtype: torch.dtype, device: torch.device):
    """Device copies of the NG*NG pair weights (by ia * NG + ib) and the
    NG + 1 bin edges for one static del_g (built once per del_g, dtype and
    device)."""
    return (torch.as_tensor(pair_weights(del_g), dtype=dtype, device=device),
            torch.as_tensor(g_bin_edges(del_g), dtype=dtype, device=device))


def combine_pair_plain(tau_a, tau_b, del_g):
    """Plain PyTorch combine of two (R, NG) k-distributions (torch.sort +
    gather + cumsum + interval-overlap contraction)."""
    del_g = np.asarray(del_g, dtype=np.float64)
    return _combine_pair(pair_weights(del_g), g_bin_edges(del_g), tau_a, tau_b)


def combine_pair_with_tangents_plain(tau_a, tau_b, dta, dtb, del_g):
    """Plain PyTorch fused combine: (R, NG) x2 and tangents (T, R, NG) x2
    -> (out (R, NG), dout (T, R, NG)); the tangents ride the primal's sort
    permutation and are rebinned with its overlaps and denominators."""
    del_g = np.asarray(del_g, dtype=np.float64)
    return _combine_pair_with_tangents(
        pair_weights(del_g), g_bin_edges(del_g), tau_a, tau_b, dta, dtb)


def _check_cuda_inputs(tau_a, tau_b, ng, tangents=()):
    for name, t in (("tau_a", tau_a), ("tau_b", tau_b), *tangents):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not float32/float64")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != tau_a.dtype or t.device != tau_a.device:
            raise ValueError(f"{name} and tau_a differ in dtype or device")
    if tau_a.dim() != 2 or tau_a.shape != tau_b.shape:
        raise ValueError(
            f"need two (R, NG) tensors of one shape, got {tuple(tau_a.shape)}"
            f" and {tuple(tau_b.shape)}"
        )
    if tau_a.shape[1] != ng:
        raise ValueError(f"rows have {tau_a.shape[1]} g-ordinates, del_g {ng}")
    if not 1 <= ng <= MAX_NG:
        raise ValueError(f"NG={ng} outside 1..{MAX_NG}")
    if tau_a.shape[0] * ng >= 2**31:
        raise ValueError("too many rows for 32-bit row indexing")
    for name, t in tangents:
        if t.dim() != 3 or t.shape[1:] != tau_a.shape:
            raise ValueError(
                f"{name} must be (T, R, NG) = (T, {tau_a.shape[0]}, {ng}), "
                f"got {tuple(t.shape)}")
    if tangents and tangents[0][1].shape != tangents[1][1].shape:
        raise ValueError("dta and dtb differ in shape")


def _del_g_key(del_g) -> tuple:
    return tuple(float(x) for x in np.asarray(del_g, dtype=np.float64))


def _combine_primal(tau_a, tau_b, del_g: tuple):
    """The primal combine on plain (not dual, not batched) tensors. On the
    card one thread takes one row, in blocks of the warp count that keeps
    the most rows resident on an SM (``csrc/overlap_combine.cu:
    launch_primal``)."""
    if tau_a.device.type == "cpu":
        return combine_pair_plain(tau_a, tau_b, del_g)
    if tau_a.device.type != "cuda":
        raise ValueError(f"no overlap combine for device {tau_a.device}")
    ng = len(del_g)
    _check_cuda_inputs(tau_a, tau_b, ng)
    w2, edges = _tables(del_g, tau_a.dtype, tau_a.device)
    out = torch.empty_like(tau_a)
    rows = tau_a.shape[0]
    fn = getattr(_library(), f"overlap_combine_{_DTYPES[tau_a.dtype]}")
    stream = torch.cuda.current_stream(tau_a.device).cuda_stream
    err = fn(tau_a.data_ptr(), tau_b.data_ptr(), w2.data_ptr(),
             edges.data_ptr(), out.data_ptr(), rows, ng,
             tau_a.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"overlap_combine launch failed: CUDA error {err}")
    combine_pair.launches += 1
    return out


def _combine_fused(tau_a, tau_b, dta, dtb, del_g: tuple):
    """The fused combine on plain tensors; dta, dtb are (T, R, NG). On the
    card the rows per block are the count that keeps the most rows resident
    on an SM (``csrc/overlap_combine.cu:launch_tan_instance``)."""
    combine_pair_with_tangents.calls += 1
    if tau_a.device.type == "cpu":
        return combine_pair_with_tangents_plain(tau_a, tau_b, dta, dtb, del_g)
    if tau_a.device.type != "cuda":
        raise ValueError(f"no overlap combine for device {tau_a.device}")
    ng = len(del_g)
    _check_cuda_inputs(tau_a, tau_b, ng, (("dta", dta), ("dtb", dtb)))
    w2, edges = _tables(del_g, tau_a.dtype, tau_a.device)
    out = torch.empty_like(tau_a)
    dout = torch.empty_like(dta)
    rows = tau_a.shape[0]
    fn = getattr(_library(), f"overlap_combine_tan_{_DTYPES[tau_a.dtype]}")
    stream = torch.cuda.current_stream(tau_a.device).cuda_stream
    err = fn(tau_a.data_ptr(), tau_b.data_ptr(), dta.data_ptr(),
             dtb.data_ptr(), w2.data_ptr(), edges.data_ptr(), out.data_ptr(),
             dout.data_ptr(), rows, ng, dta.shape[0],
             tau_a.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(
            f"overlap_combine_tan launch failed: CUDA error {err}")
    combine_pair_with_tangents.launches += 1
    return out, dout


def _stack_batch(x, dim, batch_size):
    """A vmapped operand with its batch axis first (broadcast if it has
    none)."""
    if dim is None:
        return x.unsqueeze(0).expand(batch_size, *x.shape)
    return x.movedim(dim, 0)


def _skips(tau_a, tau_b):
    """(skip_a, skip_b): the rows whose largest-g optical depth is <= 0."""
    return tau_a[:, -1] <= 0.0, tau_b[:, -1] <= 0.0


def _fused_tangent(tau_a, tau_b, dta, dtb, del_g: tuple, skip: bool):
    """The fused combine's tangents (T, R, NG) on plain tensors; with
    ``skip`` the random overlap's skip rule applied to them in place
    (``ops/tangent_cuda.py:skip_rows_``)."""
    _, dout = _combine_fused(tau_a, tau_b, dta, dtb, del_g)
    if skip:
        from archnemesis_tpu_torch.ops.tangent_cuda import skip_rows_

        skip_rows_(dout, dta, dtb, *_skips(tau_a, tau_b))
    return dout


class _CombineTangent(torch.autograd.Function):
    """(tau_a, tau_b, dta, dtb) -> the combine's tangent on (R, NG)
    tensors, by the fused combine (its primal unused); one tangent pair
    per call unless vmapped."""

    @staticmethod
    def forward(tau_a, tau_b, dta, dtb, del_g, skip):
        return _fused_tangent(tau_a, tau_b, dta.unsqueeze(0).contiguous(),
                              dtb.unsqueeze(0).contiguous(), del_g, skip)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, tau_a, tau_b, dta, dtb, del_g, skip):
        a_dim, b_dim, da_dim, db_dim = in_dims[:4]
        n = info.batch_size
        if a_dim is None and b_dim is None:
            # the jacfwd case: primals shared, tangents stacked on axis 0,
            # one call for all of them
            da = _stack_batch(dta, da_dim, n).contiguous()
            db = _stack_batch(dtb, db_dim, n).contiguous()
            return _fused_tangent(tau_a, tau_b, da, db, del_g, skip), 0
        # batched primals: fold the batch axis into rows
        ng = tau_a.shape[-1]

        def flat(x, dim):
            return _stack_batch(x, dim, n).reshape(-1, ng).contiguous()

        dout = _fused_tangent(
            flat(tau_a, a_dim), flat(tau_b, b_dim),
            flat(dta, da_dim).unsqueeze(0), flat(dtb, db_dim).unsqueeze(0),
            del_g, skip)
        return dout[0].reshape(n, -1, ng), 0


class _CombinePair(torch.autograd.Function):
    """(tau_a, tau_b) -> out with a forward-mode derivative only (the TPU
    kernel has a custom_jvp and no transpose); with ``skip`` the random
    overlap's skip rule: tau_a where tau_b's largest g is <= 0, else tau_b
    where tau_a's is, else the combine."""

    @staticmethod
    def forward(tau_a, tau_b, del_g, skip):
        out = _combine_primal(tau_a, tau_b, del_g)
        if not skip:
            return out
        skip_a, skip_b = _skips(tau_a, tau_b)
        return torch.where(skip_b[:, None], tau_a,
                           torch.where(skip_a[:, None], tau_b, out))

    @staticmethod
    def setup_context(ctx, inputs, output):
        tau_a, tau_b, del_g, skip = inputs
        ctx.save_for_forward(tau_a, tau_b)
        ctx.del_g, ctx.skip = del_g, skip

    @staticmethod
    def jvp(ctx, dta, dtb, *_):
        tau_a, tau_b = ctx.saved_tensors
        # a missing tangent on one input is a zero tangent
        dta = torch.zeros_like(tau_a) if dta is None else dta
        dtb = torch.zeros_like(tau_b) if dtb is None else dtb
        return _CombineTangent.apply(tau_a, tau_b, dta, dtb, ctx.del_g,
                                     ctx.skip)

    @staticmethod
    def vmap(info, in_dims, tau_a, tau_b, del_g, skip):
        # batched primals: fold the batch axis into rows
        n, ng = info.batch_size, tau_a.shape[-1]
        a = _stack_batch(tau_a, in_dims[0], n).reshape(-1, ng).contiguous()
        b = _stack_batch(tau_b, in_dims[1], n).reshape(-1, ng).contiguous()
        out = _CombinePair.apply(a, b, del_g, skip)
        return out.reshape(n, -1, ng), 0


def combine_pair(tau_a, tau_b, del_g):
    """Random-overlap combine of two (R, NG) k-distributions.

    del_g: the NG host g-bin widths (tuple or numpy). CPU tensors go to the
    plain version; CUDA tensors launch the kernel (float32 or float64) and
    add one to ``combine_pair.launches`` per launch. Forward-mode
    differentiable (``torch.func.jvp``/``jacfwd``, ``forward_ad``): the
    tangents go through ``combine_pair_with_tangents``.
    """
    return _CombinePair.apply(tau_a, tau_b, _del_g_key(del_g), False)


combine_pair.launches = 0


def mix_pair(tau_a, tau_b, del_g):
    """The random overlap's mixture of two (R, NG) k-distributions with its
    skip rule (``ops/overlap.py:mix_gas_k``'s step): ``tau_a`` in rows where
    ``tau_b``'s largest g is <= 0, else ``tau_b`` where ``tau_a``'s is, else
    ``combine_pair``'s values, launches and derivative; the rule is applied
    to the fused combine's fresh tangents in place."""
    return _CombinePair.apply(tau_a, tau_b, _del_g_key(del_g), True)


def combine_pair_with_tangents(tau_a, tau_b, dta, dtb, del_g):
    """Fused primal + tangent combine: (R, NG) x2 and stacked tangents
    (T, R, NG) x2 -> (out (R, NG), dout (T, R, NG)), all T tangents through
    one sort pass. CPU tensors go to the plain version; CUDA tensors launch
    the fused kernel and add one to ``.launches``. ``.calls`` counts
    every fused call on either device."""
    return _combine_fused(tau_a, tau_b, dta, dtb, _del_g_key(del_g))


combine_pair_with_tangents.launches = 0
combine_pair_with_tangents.calls = 0
