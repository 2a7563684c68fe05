"""Line-by-line cross-section: the Hopper kernel and its dispatch.

``lbl_cross_section`` is the wrapper ``ops.lbl.lbl_cross_section`` calls.
On a CPU tensor it runs the plain PyTorch version
(``ops.lbl.lbl_cross_section_plain``); on a CUDA tensor it launches the
hand-written CUDA kernel in ``csrc/lbl_cross_section.cu`` or raises. It
never falls back from the card to the plain version.

It is differentiable in forward mode, as the TPU kernel is (a custom_jvp
whose tangent comes from the non-kernel path, ``lbl_pallas.py:292-307``):
an ``autograd.Function`` whose ``jvp`` returns the plain version's tangent.
Its ``vmap`` rule folds a batch of layer states into the layer axis, so a
batched primal is still one launch; under ``torch.func.jacfwd`` the primal
is not batched and launches once per call, whatever the number of tangents.

The kernel replaces the TPU kernel ``lbl_cross_section_pallas``
(``archnemesis_tpu/ops/lbl_pallas.py:228``); ``lbl_kernel_packed`` is the
entry of its wave-sharded twin ``lbl_cross_section_pallas_packed``
(``lbl_pallas.py:312``): the same kernel, its inputs packed once per shard
at partition time. It is built with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use
(``ops/cuda_build.py``, under ``build/`` at the repository root), and bound
with ``ctypes``.

A launch runs two passes: one thread per (layer, line) writes the line's
physics into a record, then one block per (wave block, layer) sums the
lines of its range, each (block, line) classed once as skip, wing, core or
straddle. Its static inputs (``kernel_inputs``) are kept in the spec's
``packed`` dict by (dtype, device) (``static_inputs``): a ``RuntimeLBL``
hands each gas's dict to every synthesis, which packs at its first launch
(``io/linedata.py:RuntimeLBL.packed_inputs``); a wave-sharded partition
packs each shard's at partition time (``parallel/sharded.py:place``); a
spec without a dict packs them for its one launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from archnemesis_tpu_torch.constants import C2_CGS
from archnemesis_tpu_torch.io.linedata import LineList
from archnemesis_tpu_torch.ops import cuda_build
from archnemesis_tpu_torch.ops.lbl import (
    DOPPLER_CONST,
    LblBlocks,
    default_factor,
    lbl_cross_section_plain,
    partition_ratio,
    two_float,
    uses_two_float,
)
from archnemesis_tpu_torch.ops.voigt import LINESHAPES

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
# the lineshape id the kernel takes: the index of its name in LINESHAPES
SHAPE_IDS = {name: i for i, name in enumerate(LINESHAPES)}
# the pair pass has ceil(width / waves per thread) threads, at most 512
MAX_BLOCK_WIDTH = 512
MAX_GRID_Y = 65535  # layers (times a vmapped batch) per launch
# values of one (layer, line) record of the first pass
RECORD_FIELDS = 8


def build() -> dict:
    """Compile the kernel library (once per source content) and return
    ``{"path", "seconds", "ptxas"}`` (``ops.cuda_build.build``)."""
    return cuda_build.build("lbl_cross_section")


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(build()["path"])
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"lbl_cross_section_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_double] * 9 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@dataclass(frozen=True, eq=False)
class LblSpec:
    """The static inputs of one synthesis: the line list, its blocking and
    the options (host values; the layer state is the Function's input)."""

    ll: LineList
    blocks: LblBlocks
    lineshape: str
    s_floor: float
    wn_calc_window: float
    wn_approx_window: float
    include_pressure_shift: bool
    factor: float
    # the kernel's static inputs (``kernel_inputs``) by (dtype, device),
    # packed into it at the first launch of each (``static_inputs``); None:
    # packed for each launch
    packed: dict | None = None
    # a wave shard's synthesis (``lbl_kernel_packed``, counted there)
    sharded: bool = False

    def plain(self, t_calc, p_calc, amb_frac):
        return lbl_cross_section_plain(
            self.ll, self.blocks, t_calc, p_calc, amb_frac,
            lineshape=self.lineshape, s_floor=self.s_floor,
            wn_calc_window=self.wn_calc_window,
            wn_approx_window=self.wn_approx_window,
            include_pressure_shift=self.include_pressure_shift,
            factor=self.factor)


def kernel_inputs(spec: LblSpec, dtype, device) -> dict:
    """The kernel's static inputs on ``device``: ``cols`` (10, N) line
    columns in ``dtype``, ``wn`` (2, NB * W) wave grid hi/lo parts, and
    ``ranges`` (2, NB) int32 block line ranges; ``twofloat`` says whether
    the lo parts are used."""
    ll, blocks = spec.ll, spec.blocks
    twofloat = uses_two_float(ll, dtype)
    if twofloat:
        nu_hi, nu_lo = two_float(ll.nu)
        wn_hi, wn_lo = two_float(blocks.wn_pad)
    else:
        nu_hi, nu_lo = ll.nu, np.zeros(ll.n_lines)
        wn_hi, wn_lo = blocks.wn_pad, np.zeros(blocks.wn_pad.shape[0])
    d_amb = (ll.broad[5] if spec.include_pressure_shift
             else np.zeros(ll.n_lines))
    cols = np.stack([nu_hi, nu_lo, ll.sw, ll.elower, ll.stim_ref,
                     ll.broad[0], ll.broad[1], ll.broad[3], ll.broad[4],
                     d_amb]).astype(np.float64)
    wn = np.stack([wn_hi, wn_lo]).astype(np.float64)
    ranges = np.stack([blocks.starts, blocks.counts]).astype(np.int32)
    kernel_inputs.calls += 1
    return dict(
        cols=torch.as_tensor(cols, dtype=dtype, device=device),
        wn=torch.as_tensor(wn, dtype=dtype, device=device),
        ranges=torch.as_tensor(ranges, device=device),
        twofloat=twofloat,
    )


kernel_inputs.calls = 0


def static_inputs(spec: LblSpec, dtype, device) -> dict:
    """The spec's static kernel inputs in ``dtype`` on ``device``: from
    ``spec.packed``, packed into it at the first call for the (dtype,
    device), or for this call alone where the spec has no dict. It runs in
    the Function's forward, below any ``torch.func`` transform, so the
    tensors it keeps are plain. A wave shard's inputs are packed at
    partition time; other types or devices raise."""
    if spec.packed is None:
        return kernel_inputs(spec, dtype, device)
    key = (dtype, torch.device(device))
    static = spec.packed.get(key)
    if static is None:
        if spec.sharded:
            raise ValueError(f"the shard's inputs were packed as "
                             f"{list(spec.packed)}, the layers are {dtype} "
                             f"on {device}")
        static = spec.packed[key] = kernel_inputs(spec, dtype, device)
    return static


def _check_cuda_inputs(spec: LblSpec, t, p, amb):
    if t.dtype not in _DTYPES:
        raise TypeError(f"t_calc: dtype {t.dtype} not float32/float64")
    for name, x in (("t_calc", t), ("p_calc", p), ("amb_frac", amb)):
        if x.dim() != 1 or x.shape != t.shape:
            raise ValueError(f"{name} must be (NLAY,) = {tuple(t.shape)}, "
                             f"got {tuple(x.shape)}")
        if x.device != t.device:
            raise ValueError(f"{name} is on {x.device}, t_calc on {t.device}")
    blocks = spec.blocks
    if not 1 <= blocks.block_width <= MAX_BLOCK_WIDTH:
        raise ValueError(f"block width {blocks.block_width} outside "
                         f"1..{MAX_BLOCK_WIDTH}")
    if t.shape[0] > MAX_GRID_Y:
        raise ValueError(f"{t.shape[0]} layers, the kernel takes at most "
                         f"{MAX_GRID_Y} per launch")
    if 10 * spec.ll.n_lines >= 2**31:
        raise ValueError("too many lines for 32-bit line indexing")
    if spec.lineshape not in SHAPE_IDS:
        raise ValueError(f"unknown lineshape {spec.lineshape!r}")


def _launch(spec: LblSpec, static: dict, t, p, amb):
    """One launch of the CUDA kernel with the packed ``static`` inputs on
    (NLAY,) CUDA tensors; returns k (NWAVE, NLAY) in ``t``'s type."""
    _check_cuda_inputs(spec, t, p, amb)
    ll, blocks = spec.ll, spec.blocks
    dtype, device = t.dtype, t.device
    cols = static["cols"]
    if cols.dtype != dtype or cols.device != device:
        raise ValueError(f"inputs packed as {cols.dtype} on {cols.device}, "
                         f"the layers are {dtype} on {device}")
    nlay = t.shape[0]
    lay = torch.stack([t, p.to(dtype), amb.to(dtype),
                       partition_ratio(ll, t)], dim=1).contiguous()
    # the line pass's records, read by the pair pass
    rec = torch.empty(max(nlay * ll.n_lines, 1) * RECORD_FIELDS, dtype=dtype,
                      device=device)
    out = torch.empty((blocks.n_wave, nlay), dtype=dtype, device=device)
    fn = getattr(_library(), f"lbl_cross_section_{_DTYPES[dtype]}")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(static["cols"].data_ptr(), static["wn"].data_ptr(),
             static["ranges"].data_ptr(), lay.data_ptr(), rec.data_ptr(),
             out.data_ptr(), ll.n_lines, blocks.n_blocks, blocks.block_width,
             blocks.n_wave, nlay, SHAPE_IDS[spec.lineshape],
             int(static["twofloat"]), float(ll.t_ref), float(ll.p_ref),
             float(ll.mass), float(spec.s_floor), float(spec.wn_calc_window),
             float(spec.wn_approx_window), float(spec.factor), C2_CGS,
             DOPPLER_CONST, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(
            f"lbl_cross_section launch failed: CUDA error {err}")
    return out


def _primal(spec: LblSpec, t, p, amb):
    """The primal synthesis on plain (not dual, not batched) tensors."""
    lbl_cross_section.calls += 1
    if t.device.type == "cpu":
        return spec.plain(t, p, amb)
    if t.device.type != "cuda":
        raise ValueError(f"no LBL synthesis for device {t.device}")
    out = _launch(spec, static_inputs(spec, t.dtype, t.device), t, p, amb)
    entry = lbl_kernel_packed if spec.sharded else lbl_cross_section
    entry.launches += 1
    return out


def _stack_batch(x, dim, batch_size):
    """A vmapped operand with its batch axis first (broadcast if it has
    none)."""
    if dim is None:
        return x.unsqueeze(0).expand(batch_size, *x.shape)
    return x.movedim(dim, 0)


class _LblCrossSection(torch.autograd.Function):
    """(t_calc, p_calc, amb_frac) -> k (NWAVE, NLAY) with a forward-mode
    derivative only (the TPU kernel has a custom_jvp and no transpose)."""

    @staticmethod
    def forward(t, p, amb, spec):
        return _primal(spec, t, p, amb)

    @staticmethod
    def setup_context(ctx, inputs, output):
        t, p, amb, spec = inputs
        ctx.save_for_forward(t, p, amb)
        ctx.spec = spec

    @staticmethod
    def jvp(ctx, dt, dp, damb, _):
        primals = ctx.saved_tensors
        # a missing tangent on one input is a zero tangent
        tangents = tuple(torch.zeros_like(x) if d is None else d
                         for x, d in zip(primals, (dt, dp, damb)))
        _, dk = torch.func.jvp(ctx.spec.plain, primals, tangents)
        return dk

    @staticmethod
    def vmap(info, in_dims, t, p, amb, spec):
        # batched layer states: fold the batch axis into the layers
        n, nlay = info.batch_size, t.shape[-1]
        flat = (_stack_batch(x, d, n).reshape(-1)
                for x, d in zip((t, p, amb), in_dims[:3]))
        k = _LblCrossSection.apply(*flat, spec)  # (NWAVE, n * NLAY)
        return k.reshape(k.shape[0], n, nlay).movedim(1, 0), 0


def lbl_cross_section(
    ll: LineList,
    blocks: LblBlocks,
    t_calc,
    p_calc,
    amb_frac,
    lineshape: str = "voigt",
    s_floor: float = 0.0,
    wn_calc_window: float = 25.0,
    wn_approx_window: float = 75.0,
    include_pressure_shift: bool = True,
    factor: float | None = None,
    packed: dict | None = None,
):
    """k(NWAVE, NLAY) [cm^2 molecule^-1] from (NLAY,) tensors t_calc (K),
    p_calc (atm), amb_frac on one device. CPU tensors go to the plain
    version; CUDA tensors launch the kernel (float32 or float64) and add
    one to ``lbl_cross_section.launches`` per launch. ``packed``: a dict
    that keeps the kernel's static inputs by (dtype, device) across calls
    (``static_inputs``); None packs them for this launch. ``.calls``
    counts every primal synthesis on either device. Forward-mode
    differentiable through ``torch.func`` (``jvp``, ``jacfwd``): the
    tangent is itself a ``torch.func.jvp`` of the plain version, which
    ``torch.autograd.forward_ad`` cannot nest."""
    spec = make_spec(ll, blocks, lineshape, s_floor, wn_calc_window,
                     wn_approx_window, include_pressure_shift, factor,
                     packed)
    return _LblCrossSection.apply(t_calc, p_calc, amb_frac, spec)


def make_spec(ll: LineList, blocks: LblBlocks, lineshape: str = "voigt",
              s_floor: float = 0.0, wn_calc_window: float = 25.0,
              wn_approx_window: float = 75.0,
              include_pressure_shift: bool = True,
              factor: float | None = None,
              packed: dict | None = None) -> LblSpec:
    """The ``LblSpec`` of ``lbl_cross_section``'s arguments."""
    return LblSpec(
        ll=ll, blocks=blocks, lineshape=lineshape, s_floor=float(s_floor),
        wn_calc_window=float(wn_calc_window),
        wn_approx_window=float(wn_approx_window),
        include_pressure_shift=bool(include_pressure_shift),
        factor=float(default_factor(ll) if factor is None else factor),
        packed=packed,
    )


lbl_cross_section.launches = 0
lbl_cross_section.calls = 0


def lbl_kernel_packed(spec: LblSpec, t_calc, p_calc, amb_frac):
    """k(NWAVE, NLAY) of a synthesis whose kernel inputs were packed once on
    the device (``spec.packed``, by (dtype, device)): the entry of the
    wave-sharded synthesis (``parallel/sharded.py``), one launch per shard,
    without the per-call host packing and copies. CUDA tensors launch the
    kernel and add one to ``lbl_kernel_packed.launches``; CPU tensors run
    the plain version. Forward-mode differentiable as
    ``lbl_cross_section``."""
    if not spec.packed:
        raise ValueError("the spec carries no packed kernel inputs")
    return _LblCrossSection.apply(t_calc, p_calc, amb_frac,
                                  dataclasses.replace(spec, sharded=True))


lbl_kernel_packed.launches = 0
