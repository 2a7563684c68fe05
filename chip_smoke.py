#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``archnemesis_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``); exits non-zero
without them. Phases, each of which fails the run on its own:

1. device and build: the card's name and power limit, the torch/CUDA
   versions; every kernel library built from the checkout, one nvcc per
   source, all started together: the random-overlap kernels (primal and
   fused primal + tangent kernel,
   ``archnemesis_tpu_torch/csrc/overlap_combine.cu``),
   the line-by-line cross-section (``csrc/lbl_cross_section.cu``), the
   combine's A/B variants (``csrc/overlap_variants.cu``) and the FMA-peak
   probe (``csrc/fma_peak.cu``), with the build times and ptxas' register
   reports;
2. kernel vs plain: the kernel against its plain PyTorch version at NG
   10, 20 and 32 (the largest the kernel takes) in float32 (rtol 2e-5,
   atol 1e-7, the JAX package's own Pallas-vs-XLA bound) and float64
   (rtol 1e-12), with tied and all-zero rows, and at the headline's
   581,632 rows; then at NG 1, 2, 3, 7, 20, 31, 32 on 4,099 rows (a
   ragged last block) with rows unsorted along g in a, in b and in both,
   heavy ties and all-zero rows (``combine_cases``). Every float32 kernel
   result is also held to the float64 result of the same inputs at the
   float32 bound, which alone holds at NG=32: there the plain float32
   version's own error nears the bound. Both float32 versions' errors
   against float64 are printed. At full size two launches must give equal
   bits, and the kernel is timed at 4, 8 and 16 rows per block;
3. the golden deck (``tests/fixtures/jupiter_nadir``) read with the port's
   readers: float64 layer optical depths and convolved spectrum within
   rtol 1e-5 of ``tests/goldens/jupiter_nadir_fm.npz``; float32
   (``cast_deck``) within 1e-4 max / 1e-5 median relative error of the
   float64 spectrum;
4. the headline forward: 8192 waves x 20 g x 71 layers x 7 gases in
   float32, which must launch the kernel 6 times per forward and agree
   with its float64 counterpart within the same float32 bounds; its
   median time over 12 runs, waves/s and peak device memory;
5. tangent kernel vs plain: the fused primal + tangent combine against its
   plain PyTorch version at NG 10, 20, 32, T = 1, 3, 81 tangents, R = 4096
   and the retrieval's 39,689 rows, on tie-free rows (pair sums on an
   integer lattice, so float32 and float64 sort them alike): float64 at
   rtol 1e-12 of the tangents' peak, float32 at ``tangent_f32_tol`` (2e-5
   of the peak up to NG = 10, 6.8e-5 at NG = 32) against the float64 result
   of the same inputs, and against the float32 plain version up to NG =
   20; the fused primal equal to the primal kernel's bit for bit (they
   share its code). Then the hard rows of phase 2 (``combine_cases`` at
   NG 1, 2, 3, 7, 20, 31, 32 on 4,099 rows: a ragged last block, rows
   unsorted along g, ties, all-zero rows): the primal bit for bit and the
   tangents finite (on tied keys they depend on the order of equal keys),
   and tie-free rows shuffled along g, whose tangents are held to the
   plain version as above. At T = 81, R = 39,689, NG = 20 in both types
   two launches and a launch replayed from a ``torch.cuda.CUDAGraph`` give
   equal bits; the time beside the bound, the time of a launch with no
   tangents beside kernel 1's (the merge's share), and the time per rows
   per block (``TAN_WARP_CHOICES``);
6. the retrieval on the card, through ``retrievals.make_retrieval_setup``
   and ``retrieval_nemesis`` with ``device="cuda"``: on ``jupiter_nadir``
   in float64 the a priori and measurement vector, ``forward_fn(XN)`` and
   one JVP column against the reference goldens, the ``jacfwd`` column
   equal to that JVP, and exactly 6 fused launches per forward-plus-Jacobian
   evaluation (81 tangents); on a copy of ``jupiter_fdret`` the whole
   retrieval against ``tests/goldens/jupiter_retrieval.npz``; then the
   median time and peak memory of one evaluation in float64 and float32,
   float32 against float64 (spectrum inside the float32 bounds, Jacobian
   within ``JAC_F32_BOUND`` of each column's peak), and the wall-clock of a
   3-iteration retrieval;
7. LBL kernel vs plain: the cross-section kernel against its plain
   PyTorch version and the reference (``tests/goldens/co_lbl.npz``, line
   data from the ``.npz`` export: the card's machine has no h5py) on that
   golden's grid and cases, for all six lineshapes with s_floor > 0, no
   shift and the iso-0 factor, at block widths 128, 200, 1 and 512 and
   with blocks that hold no lines, and in a pressure-shift case that moves
   line centres across the blocks' core/wing boundaries
   (``SHIFT_CASE_STATE``; its class changes are counted and must be some):
   float64 within rtol 1e-10, float32 within 5e-5 max / 2e-5 median
   relative error of float64 (the JAX package's co_runtime_voigt bound);
   in the shift case float32 within that bound of the plain float32
   version, and against float64 no further off than the plain float32
   version plus the bound (both errors printed);
   at the full-width configuration (80,000 waves x 5,092 lines x 40
   layers) two float32 launches equal bit for bit, float32 against the
   plain version and, on 2 layers, float64 against the plain float64
   version; the kernel's time beside its operation bound
   (``lbl_bound_ms``; beside it the bound with the nested continued
   fraction's operation count, as given before the ratio form), per waves
   per thread (1, 2, 4) of the pair pass and per staging of its record
   tiles (plain loads or double-buffered ``cp.async``, bit for bit), the
   device times of its line and pair passes (``torch.profiler``), the
   (block, line) class counts; the plain version's time over all 40
   layers;
8. the runtime golden deck (``tests/fixtures/co_runtime``, copied with its
   line data pointed at the export) through ``load_deck``: float64 TAUGAS
   and SPECONV within rtol 1e-7 / 1e-6 of ``co_runtime_fm.npz``, float32
   within the float32 bound, 1 launch per forward;
9. the LBL headline forward (``synthetic.lbl_headline``, float32): 1
   launch per forward and no packing of the static kernel inputs after
   the first, median time of 12 forwards, waves/s, peak memory, float32
   within the float32 bound of the float64 forward;
10. the runtime retrieval on the card: ``forward_fn(xa)`` and
    ``forward_and_jacobian`` (15 tangents) in float64 equal to the port's
    CPU result, 1 launch per evaluation, the wall-clock and phi history of
    ``retrieval_nemesis(niter=3)`` on the card and on the CPU;
11. the float32 FMA-peak probe (``csrc/fma_peak.cu``): the kernel equal to
    its plain version bit for bit on random input, the FFMA count of its
    SASS, then the probe tool's measurement at 72,704 x 512 (the main
    path: ``tools/fma_peak.measure``, 24 launches): TFLOP/s and the share
    of the data-sheet peak;
12. the combine's A/B variants (``csrc/overlap_variants.cu``): every mode
    against its plain version at R = 581,632, NG = 20 (``sortonly`` and
    ``rollonly`` bit for bit; ``full`` and ``edges`` within
    ``variant_f32_tol`` of each row's peak of the float64 result, and
    within the sum of the two modes' bounds of kernel 1), ``full`` equal
    to itself bit for bit at every row tile; then the variants tool (the
    main path: ``tools/overlap_variants.run``) with ms per mode and per
    rows-per-block, and the library time of ``torch.topk`` (sortonly) and
    ``torch.roll`` (rollonly);
13. the LBL headline's synthesis as 4 logical wave shards through the
    packed entry (``ops/lbl_cuda.py:lbl_kernel_packed``): the shards'
    concatenation equal to the unsharded kernel bit for bit and, on all 40
    layers, within the float32 bound of the plain version; ms per shard
    launch beside each shard's bound, its halo (lines per shard); then the
    sharded LBL headline forward (the main path: 4 launches) against the
    unsharded one;
14. the wave-sharded forward with ``torch.distributed`` on the card: a
    one-rank NCCL group started through ``parallel.multihost.initialize``
    with a ``file://`` store; ``jupiter_nadir`` in float64, forward and 3
    Jacobian columns, sharded over 4 wave shards (k-tables) against
    unsharded, and the ``co_runtime`` retrieval set-up with its runtime
    deck sharded over 4 shards against unsharded (forward and Jacobian),
    every spectrum gathered through the group;

then a JSON line of the kernels (launches on the main paths, error, times,
bound, library time) and, last, ``{"ok": true, "device": {...}}``. ``--profile`` adds
``torch.profiler`` traces of three headline forwards, of one
forward-plus-Jacobian evaluation and of three LBL headline forwards: device
time by kernel, the device's busy share, and Chrome traces in ``build/``.

TF32 is switched off for matmuls and cuDNN: the g-quadrature and emission
``einsum``s must run in full float32, as the JAX package computes them.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

LAYER_GOLDEN = "tests/goldens/jupiter_layering.npz"
FM_GOLDEN = "tests/goldens/jupiter_nadir_fm.npz"
DECK = "tests/fixtures/jupiter_nadir"
FDRET = "tests/fixtures/jupiter_fdret"
OE_GOLDEN = "tests/goldens/jupiter_oe.npz"
FD_GOLDEN = "tests/goldens/jupiter_fd_jac.npz"
RETRIEVAL_GOLDEN = "tests/goldens/jupiter_retrieval.npz"
CIA_TAB = "archnemesis_tpu/data/reference_data/cia/isotest.tab"
# the runtime line-by-line slice: the CO line list's export (the card's
# machine has no h5py), the reference's cross-sections and the runtime deck
LINEDATA_NPZ = "archnemesis_tpu_torch/data/CO_1_ambient_AIR.npz"
CO_LBL_GOLDEN = "tests/goldens/co_lbl.npz"
CO_RUNTIME = "tests/fixtures/co_runtime"
CO_RUNTIME_GOLDEN = "tests/goldens/co_runtime_fm.npz"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# float64 outside the tensor cores (the same data sheet: 34 TFLOP/s)
PEAK_F64_OPS_S = 34e12

F32_BOUNDS = (1.0e-4, 1.0e-5)  # max / median relative error vs float64
# largest float32-vs-float64 error of the Jacobian relative to each
# column's own peak. The first run on the card read 4.8e-4 on jupiter_nadir:
# the worst columns are those of the levels far above and below the
# weighting functions, whose peaks lie up to 12 orders under the largest
# and rest on layers with tau ~ 1e-9 (before rt/emission.py formed the
# transmission differences with expm1 they were lost altogether in
# float32: error 1.3 of peak). Twice the reading, and the loosest allowed.
JAC_F32_BOUND = 1.0e-3
HEADLINE_RUNS = 12
JACOBIAN_RUNS = 5
# float32 line-by-line synthesis against float64: max / median relative
# error, the JAX package's own co_runtime_voigt bound
# (tests/test_f32_parity.py:23)
LBL_F32_BOUNDS = (5.0e-5, 2.0e-5)
# float64 kernel against the plain version and the reference golden (the
# JAX package's Pallas-vs-XLA bound, tests/test_lbl_pallas.py:38)
LBL_F64_RTOL = 1.0e-10
LBL_KERNEL_RUNS = 10
# the layers of the full-width configuration on which the float64 plain
# version (3.3 GB per (block, line, wave) temporary) is compared
LBL_COMPARE_LAYERS = (0, 39)
# the retrieval's pair combine: 559 waves x 71 layers, 81 state elements
TAN_ROWS, TAN_NTAN = 39_689, 81
# the fused kernel's rows per block, timed at the retrieval's shape
TAN_WARP_CHOICES = (4, 8)


def rel_err(a, b):
    """|a - b| / max(|b|, 1e-3 max|b|), elementwise (0 where b is all
    zero and a equals it)."""
    scale = max(1e-3 * np.abs(b).max(), np.finfo(np.float64).tiny)
    return np.abs(a - b) / np.maximum(np.abs(b), scale)


def gauss_del_g(ng: int) -> np.ndarray:
    """Gauss-Legendre g-bin widths on [0, 1]."""
    return 0.5 * np.polynomial.legendre.leggauss(ng)[1]


def overlap_inputs(rows: int, ng: int, seed: int) -> tuple:
    """Two (rows, NG) float64 arrays of sorted k-distributions with tied
    and all-zero rows (as the JAX package's Pallas tests make them)."""
    rng = np.random.default_rng(seed)
    ta = np.sort(rng.uniform(0, 4, (rows, ng)), axis=1)
    tb = np.sort(rng.uniform(0, 2, (rows, ng)), axis=1)
    ta[:10] = 0.0
    tb[5:15] = 0.0
    return ta, tb


def tiefree_overlap_inputs(rows: int, ng: int, seed: int) -> tuple:
    """Two (rows, NG) float64 arrays, sorted along g, whose NG*NG pair sums
    are distinct integers times 2**-16: no two keys tie or come close in
    float32 or in float64, so every sort puts them in one order. a = M *
    (distinct integers), b = distinct integers below M."""
    rng = np.random.default_rng(seed)
    m = 64
    a = np.sort(rng.permuted(np.tile(np.arange(4096), (rows, 1)),
                             axis=1)[:, :ng], axis=1) * float(m)
    b = np.sort(rng.permuted(np.tile(np.arange(m), (rows, 1)),
                             axis=1)[:, :ng], axis=1).astype(np.float64)
    return a * 2.0**-16, b * 2.0**-16


# rows of the hard cases of phase 2: not a multiple of any rows-per-block
# choice of the primal kernel, so the last block is ragged
HARD_ROWS = 4099
HARD_NGS = (1, 2, 3, 7, 20, 31, 32)
# the primal kernel's rows per block, timed at the headline shape
PRIMAL_WARP_CHOICES = (4, 8, 16)


def combine_cases(rows: int, ng: int, seed: int) -> dict:
    """name -> two (rows, NG) float64 arrays: ``sorted`` (``overlap_inputs``,
    with tied and all-zero rows), ``unsorted_a`` / ``unsorted_b`` /
    ``unsorted_both`` (those rows shuffled along g), ``ties`` (half the rows
    one repeated value, the rest small integers times 1/4, so that the pair
    sums are exact and tie everywhere) and ``zeros``."""
    rng = np.random.default_rng(seed)
    ta, tb = overlap_inputs(rows, ng, seed)
    sa, sb = rng.permuted(ta, axis=1), rng.permuted(tb, axis=1)
    ties_a = np.sort(rng.integers(0, 4, (rows, ng)), axis=1) * 0.25
    ties_b = np.sort(rng.integers(0, 3, (rows, ng)), axis=1) * 0.25
    half = rows // 2
    ties_a[:half] = rng.uniform(0, 4, (half, 1))
    ties_b[:half] = rng.uniform(0, 2, (half, 1))
    return {
        "sorted": (ta, tb),
        "unsorted_a": (sa, tb),
        "unsorted_b": (ta, sb),
        "unsorted_both": (sa, sb),
        "ties": (ties_a, ties_b),
        "zeros": (np.zeros((rows, ng)), np.zeros((rows, ng))),
    }


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length()


def combine_ops_per_row(ng: int, presorted: bool) -> int:
    """Operations one row of the combine needs (not the kernel's own
    count): the n = NG^2 pair sums; the sort of the n keys, one comparison
    each: a merge of the NG presorted runs of NG keys (n ceil(log2 NG)) when
    both inputs are sorted along g, else a merge sort (n ceil(log2 n)); the
    n-step prefix sum; the rebin, 7 operations (a min, a max, a subtraction,
    a clamp, a multiply-add (2), an add) per (element, bin) overlap, of
    which there are at most n + NG - 1, since the elements tile [0, 1] end
    to end and each of the NG - 1 inner bin edges splits at most one; NG
    divisions."""
    n = ng * ng
    sort = n * _ceil_log2(ng if presorted else n)
    return n + sort + n + 7 * (n + ng - 1) + ng


def combine_bound_ms(rows: int, ng: int, itemsize: int,
                     presorted: bool) -> tuple:
    """(bound_ms, bound_by) of one combine on an H100: the larger of its
    bytes (two inputs read, one output written) over HBM bandwidth and
    its operations over the float32 peak."""
    bytes_ms = 3 * rows * ng * itemsize / PEAK_BYTES_S * 1e3
    ops_ms = rows * combine_ops_per_row(ng, presorted) / PEAK_F32_OPS_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def tangent_ops_per_row(ng: int) -> int:
    """Operations one row needs per tangent pair beyond the primal's: the
    n = NG^2 sums da[ia] + db[ib], a multiply-add (2) per (element, bin)
    overlap (at most n + NG - 1), and NG scalings by 1 / den."""
    n = ng * ng
    return n + 2 * (n + ng - 1) + ng


def tangent_f32_tol(del_g) -> float:
    """float32 bound of a rebinned tangent, relative to the tangents' peak:
    phase 2's 2e-5, or where that is larger the rounding of an overlap's two
    prefix sums near 1 (eps32 each) against the narrowest bin (6.8e-5 at
    NG=32, where the card's first run read 2.2e-5)."""
    return max(2e-5, 2 * float(np.finfo(np.float32).eps) / float(min(del_g)))


def fused_bound_ms(rows: int, ng: int, n_tan: int, itemsize: int,
                   presorted: bool) -> tuple:
    """(bound_ms, bound_by) of one fused primal + tangent combine on an
    H100: the larger of its bytes (the primal's three (R, NG) arrays plus
    two (T, R, NG) reads and one write) over HBM bandwidth and its
    operations (the primal's plus ``tangent_ops_per_row`` per tangent) over
    the peak rate of its type."""
    bytes_ms = 3 * (1 + n_tan) * rows * ng * itemsize / PEAK_BYTES_S * 1e3
    peak = PEAK_F32_OPS_S if itemsize == 4 else PEAK_F64_OPS_S
    ops = combine_ops_per_row(ng, presorted) + n_tan * tangent_ops_per_row(ng)
    ops_ms = rows * ops / peak * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def is_sorted_along_g(*taus) -> bool:
    """Whether every row of every (R, NG) tensor is non-decreasing."""
    return all(bool((t.diff(dim=1) >= 0).all()) for t in taus)


def golden_deck(device):
    """The jupiter_nadir deck as ``tests/test_forward_nadir.py`` sets it up,
    read with the port's readers: (atm, laycfg, ktab, cia, aero, surf, cfg)
    in float64 on ``device``."""
    import torch

    from archnemesis_tpu_torch.core.spectra import (
        AerosolOptics,
        KTables,
        SurfaceSpec,
    )
    from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
    from archnemesis_tpu_torch.enums import (
        ParaH2Ratio,
        RayleighScatteringMode,
        WaveUnit,
    )
    from archnemesis_tpu_torch.forward import make_forward_config
    from archnemesis_tpu_torch.io.cia import read_cia_tab
    from archnemesis_tpu_torch.io.ktables import read_kls

    dl = np.load(LAYER_GOLDEN)
    wave = np.load(FM_GOLDEN)["WAVE"]

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                               device=device)

    atm = Atmosphere(
        h=dev(dl["H"]), p=dev(dl["P"]), t=dev(dl["T"]), vmr=dev(dl["VMR"]),
        dust=dev(dl["DUST"]), parah2=dev(dl["PARAH2"]),
        molwt=dev(dl["MOLWT"]), radius=dev(dl["RADIUS"]),
        latitude=dev(dl["LATITUDE"]),
        gas_id=tuple(int(x) for x in dl["ID"]),
        iso_id=tuple(int(x) for x in dl["ISO"]),
        planet=int(dl["PLANET"]),
        dust_units_flag=tuple(int(x) for x in dl["DUST_UNITS_FLAG"]) or None,
    )
    laycfg = LayerConfig(
        nlay=int(dl["NLAY"]), laytyp=int(dl["LAYTYP"]),
        layint=int(dl["LAYINT"]),
        layht=max(float(dl["LAYHT"]), float(dl["H"][0])),
    )
    tables = read_kls(f"{DECK}/cirstest.kls", wavemin=wave.min(),
                      wavemax=wave.max())
    ktab = KTables.from_tables(tables, device=device)
    cia = read_cia_tab(CIA_TAB, dnu=1.0, npara=0,
                       inormal=ParaH2Ratio.NORMAL, device=device)
    # deck .xsc: 6 wave points, all-zero extinction
    aero = AerosolOptics(
        wave=dev([0.0, 700.0, 750.0, 900.0, 950.0, 2000.0]),
        kext=dev(np.zeros((6, 1))), ksca=dev(np.zeros((6, 1))),
    )
    surf = SurfaceSpec(tsurf=dev(0.0), vem=dev([0.0, 1e5]),
                       emissivity=dev(np.zeros(2)), galb=dev(0.0),
                       gasgiant=True)
    cfg = make_forward_config(
        atm, ktab, cia, iray=RayleighScatteringMode.GAS_GIANT_ATM,
        ispace=WaveUnit.Wavenumber_cm, gasgiant=True,
    )
    return atm, laycfg, ktab, cia, aero, surf, cfg


def cast(deck, dtype):
    """``cast_deck`` over the structures of a deck tuple (the float32 path
    prescales CIA and attaches the host log k-table)."""
    from archnemesis_tpu_torch.core.spectra import cast_deck

    atm, laycfg, ktab, cia, aero, surf, cfg = deck
    return (cast_deck(atm, dtype), laycfg, cast_deck(ktab, dtype),
            cast_deck(cia, dtype), cast_deck(aero, dtype),
            cast_deck(surf, dtype), cfg)


def deck_forward(deck, device):
    """(spectrum (NWAVE,), SPECONV (NCONV,), diagnostics) of the deck."""
    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.ops.convolution import conv_channel_interp

    dfm = np.load(FM_GOLDEN)
    atm, laycfg, ktab, cia, aero, surf, cfg = deck
    spec, diag = forward_nadir(atm, laycfg, ktab, cia, aero, surf, cfg,
                               emiss_ang=0.0, sol_ang=180.0,
                               return_diagnostics=True, device=device)
    nconv = int(dfm["NCONV"][0])
    vconv = np.asarray(dfm["VCONV"][:nconv, 0])
    speconv = conv_channel_interp(ktab.wave, spec[:, 0],
                                  spec.new_tensor(vconv))
    return spec[:, 0], speconv, diag


def _print(*args):
    print(*args, flush=True)


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` calls (CUDA
    events), after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    """The card and the versions; every kernel library built from the
    checkout's sources, one nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from archnemesis_tpu_torch.ops import (
        fma_peak,
        lbl_cuda,
        overlap_cuda,
        overlap_variants,
    )
    from archnemesis_tpu_torch.tools.common import card_line

    card = card_line()
    _print(f"card: {card}")
    _print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    modules = (overlap_cuda, lbl_cuda, overlap_variants, fma_peak)
    with ThreadPoolExecutor(max_workers=len(modules)) as pool:
        futures = [pool.submit(m.build) for m in modules]
        builds = [f.result() for f in futures]
    for built in builds:
        _print(f"built {built['path']} in {built['seconds']:.2f} s")
        _print(built["ptxas"].strip())
    _print(f"kernel builds: {time.perf_counter() - t0:.2f} s of wall time")
    return card


def _check_combine(out, a, b, del_g, what: str) -> float:
    """Hold one kernel result to the plain version at phase 2's bounds;
    returns the max abs error against the plain version of its type."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair_plain

    tols = {torch.float32: dict(rtol=2e-5, atol=1e-7),
            torch.float64: dict(rtol=1e-12, atol=0.0)}
    ng, dtype = a.shape[1], a.dtype
    ref = combine_pair_plain(a, b, del_g)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    line = f"kernel vs plain {what}: max_abs_err={err:.3e}"
    # the float32 bound holds two float32 versions to each other up to
    # NG=20; at NG=32 the plain version's own rounding error comes near
    # it, so there the float32 kernel is held to the float64 result
    # only. Every float32 kernel result is held to it as well.
    checks = []
    if dtype == torch.float64 or ng <= 20:
        checks.append(torch.allclose(out, ref, **tols[dtype]))
    if dtype == torch.float32:
        ref64 = combine_pair_plain(a.double(), b.double(), del_g)
        checks.append(torch.allclose(out.double(), ref64, **tols[dtype]))
        k64 = rel_err(out.double().cpu().numpy(), ref64.cpu().numpy())
        p64 = rel_err(ref.double().cpu().numpy(), ref64.cpu().numpy())
        line += (f"; vs float64: kernel max rel {k64.max():.3e}, plain"
                 f" max rel {p64.max():.3e}")
    ok = all(checks) and bool(torch.isfinite(out).all())
    _print(f"{line} ({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"kernel disagrees with plain ({what})")
    return err


def phase_kernel_vs_plain():
    """Kernel vs plain on the card; returns the headline-shape record."""
    import torch

    from archnemesis_tpu_torch.ops import overlap_cuda
    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_plain,
    )

    cases = [(ng, dt, 4096) for ng in (10, 20, 32)
             for dt in (torch.float32, torch.float64)]
    rows_full = 581_632
    cases.append((20, torch.float32, rows_full))
    record = None
    for ng, dtype, rows in cases:
        del_g = gauss_del_g(ng)
        ta, tb = overlap_inputs(rows, ng, seed=ng + rows)
        a = torch.as_tensor(ta, dtype=dtype, device="cuda")
        b = torch.as_tensor(tb, dtype=dtype, device="cuda")
        out = combine_pair(a, b, del_g)
        err = _check_combine(out, a, b, del_g, f"NG={ng} {dtype} rows={rows}")
        if rows == rows_full:
            # no atomics: a second launch on the same input gives the same
            # bits
            again = combine_pair(a, b, del_g)
            if not torch.equal(out, again):
                raise AssertionError("two launches differ at full size")
            _print("two launches at full size: equal bits")
            ms = _cuda_ms(lambda: combine_pair(a, b, del_g), reps=20)
            plain_ms = _cuda_ms(lambda: combine_pair_plain(a, b, del_g),
                                reps=3, warmup=1)
            presorted = is_sorted_along_g(a, b)
            bound_ms, bound_by = combine_bound_ms(rows, ng, a.element_size(),
                                                  presorted)
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            _print(f"combine at R={rows}, NG={ng}, float32: kernel "
                   f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                   f"{bound_ms:.4f} ms ({bound_by}; "
                   f"{combine_ops_per_row(ng, presorted)} ops/row, inputs "
                   f"{'' if presorted else 'not '}sorted along g)")
            key = tuple(float(x) for x in del_g)
            by_warps = {w: _cuda_ms(lambda w=w: overlap_cuda._combine_primal(
                a, b, key, warps=w), reps=20) for w in PRIMAL_WARP_CHOICES}
            _print("combine by rows per block: " + ", ".join(
                f"{w}: {t:.4f} ms" for w, t in by_warps.items())
                + " (the wrapper lets the launch choose)")

    # rows unsorted along g, heavy ties, all-zero rows, every NG class, a
    # ragged last block
    for ng in HARD_NGS:
        del_g = gauss_del_g(ng)
        for name, (ta, tb) in combine_cases(HARD_ROWS, ng, seed=ng).items():
            for dtype in (torch.float32, torch.float64):
                a = torch.as_tensor(ta, dtype=dtype, device="cuda")
                b = torch.as_tensor(tb, dtype=dtype, device="cuda")
                _check_combine(combine_pair(a, b, del_g), a, b, del_g,
                               f"NG={ng} {dtype} {name} rows={HARD_ROWS}")
    return record


def phase_golden_deck():
    import torch

    dfm = np.load(FM_GOLDEN)
    deck64 = golden_deck("cuda")
    spec64, conv64, diag = deck_forward(deck64, "cuda")
    for name, key in (("taugas", "TAUGAS"), ("taucia", "TAUCIA"),
                      ("tauray", "TAURAY"), ("taudust", "TAUDUST"),
                      ("tautot", "TAUTOT")):
        want = dfm[key]
        atol = 1e-14 * max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(diag[name].cpu().numpy(), want,
                                   rtol=1e-5, atol=atol, err_msg=name)
    nconv = int(dfm["NCONV"][0])
    np.testing.assert_allclose(conv64.cpu().numpy(),
                               dfm["SPECONV"][:nconv, 0], rtol=1e-5, atol=0)
    _print("golden deck float64: layer taus and SPECONV within rtol 1e-5")

    _, conv32, _ = deck_forward(cast(deck64, torch.float32), "cuda")
    r = rel_err(conv32.double().cpu().numpy(), conv64.cpu().numpy())
    _print(f"golden deck float32 vs float64: max rel {r.max():.3e}, "
           f"median rel {np.median(r):.3e}")
    if not (r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]):
        raise AssertionError("float32 deck outside 1e-4 / 1e-5 of float64")


def profile_forward(forward, runs: int = 3, what: str = "headline forward",
                    trace: str = "build/headline_trace.json"):
    """Device time by kernel and the device's busy share over ``runs``
    calls of ``forward`` (``torch.profiler``); the trace goes to
    ``build/``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    _print(f"profile of {runs} x {what}: wall {wall_us / 1e3:.3f} "
           f"ms, device busy {busy_us / 1e3:.3f} ms "
           f"(share {busy_us / wall_us:.4f}), "
           f"{sum(e.count for e in kernels) // runs} launches each")
    for e in kernels[:15]:
        _print(f"  {e.self_device_time_total / runs / 1e3:9.4f} ms/call "
               f"{e.count // runs:5d} launches/call  {e.key[:100]}")
    os.makedirs("build", exist_ok=True)
    prof.export_chrome_trace(trace)


def kernel_device_ms(fn, runs: int = 5) -> dict:
    """Device time per call of ``fn`` by kernel name, in ms, over ``runs``
    calls (``torch.profiler``, CUDA activity only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / runs / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def phase_headline(profile: bool = False):
    """Drive the headline forward; returns (launches of the main path,
    median ms)."""
    import torch

    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair
    from archnemesis_tpu_torch.synthetic import NWAVE, headline_deck

    atm, laycfg, ktab, surf, cfg = headline_deck(dtype=torch.float32,
                                                 device="cuda")

    def forward():
        return forward_nadir(atm, laycfg, ktab, None, None, surf, cfg,
                             emiss_ang=0.0, device="cuda")

    # the main path, counted on its own
    combine_pair.launches = 0
    spec = forward()
    torch.cuda.synchronize()
    launches = combine_pair.launches
    if launches != 6:
        raise AssertionError(f"{launches} kernel launches, expected 6")
    if spec.shape != (NWAVE, 1) or not torch.isfinite(spec).all():
        raise AssertionError("headline spectrum not finite (8192, 1)")

    torch.cuda.reset_peak_memory_stats()
    times = []
    before = combine_pair.launches
    for i in range(HEADLINE_RUNS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward()
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    if combine_pair.launches - before != 6 * (HEADLINE_RUNS + 2):
        raise AssertionError("kernel launches did not rise by 6 per forward")
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times))
    _print(f"headline forward (8192 x 20 x 71 x 7 gases, float32): median "
           f"{ms:.3f} ms over {len(times)} runs (min {min(times):.3f}, "
           f"max {max(times):.3f}); {NWAVE / ms * 1e3:.1f} waves/s; peak "
           f"memory {peak / 2**30:.3f} GiB")

    atm64, laycfg, ktab64, surf64, cfg = headline_deck(dtype=torch.float64,
                                                       device="cuda")
    spec64 = forward_nadir(atm64, laycfg, ktab64, None, None, surf64, cfg,
                           emiss_ang=0.0, device="cuda")
    r = rel_err(spec.double().cpu().numpy(), spec64.cpu().numpy())
    _print(f"headline float32 vs float64: max rel {r.max():.3e}, "
           f"median rel {np.median(r):.3e}")
    if not (r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]):
        raise AssertionError("float32 headline outside 1e-4 / 1e-5 of float64")
    if profile:
        profile_forward(forward)
    return launches, ms


def graph_replay_equal(fn) -> bool:
    """Whether one call of ``fn`` (a tuple of tensors out) captured in a
    ``torch.cuda.CUDAGraph`` and replayed gives the direct call's bits."""
    import torch

    direct = fn()
    side = torch.cuda.Stream()  # warm-up off the capturing stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(direct, captured))
    del graph, captured
    return same


def phase_tangent_kernel_vs_plain():
    """Fused primal + tangent kernel vs plain on the card; returns the
    float32 record at the retrieval's shape."""
    import torch

    from archnemesis_tpu_torch.ops import overlap_cuda
    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_with_tangents,
        combine_pair_with_tangents_plain,
    )

    def on_card(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device="cuda")

    def check(ta, tb, dta, dtb, del_g, what, vs_plain32=True,
              time_it=False):
        """The fused kernel on tie-free rows in both types: dout against
        the plain float64 result (and, with ``vs_plain32``, the plain
        float32 one up to NG = 20), out equal to the primal kernel's bit for
        bit. Returns the float32 record when ``time_it``."""
        ng = ta.shape[1]
        a64, b64, da64, db64 = (on_card(x, torch.float64)
                                for x in (ta, tb, dta, dtb))
        _, ref64 = combine_pair_with_tangents_plain(a64, b64, da64, db64,
                                                    del_g)
        peak = ref64.abs().max().item()
        record = None
        for dtype in (torch.float64, torch.float32):
            a, b, da, db = (x.to(dtype) for x in (a64, b64, da64, db64))
            out, dout = combine_pair_with_tangents(a, b, da, db, del_g)
            torch.cuda.synchronize()
            # the inputs are exact in float32, so ref64 is the float64
            # result of the same inputs for both types
            err = (dout.double() - ref64).abs().max().item()
            tol = 1e-12 if dtype == torch.float64 else tangent_f32_tol(del_g)
            checks = [err <= tol * peak,
                      torch.equal(out, combine_pair(a, b, del_g))]
            line = (f"tangent kernel vs plain {what} {dtype}: "
                    f"max_abs_err={err:.3e} (peak {peak:.3e}); primal equal "
                    f"to kernel 1's: {checks[1]}")
            if dtype == torch.float32:
                _, ref32 = combine_pair_with_tangents_plain(a, b, da, db,
                                                            del_g)
                e32 = (dout - ref32).abs().max().item()
                p32 = (ref32.double() - ref64).abs().max().item()
                if vs_plain32 and ng <= 20:
                    checks.append(e32 <= tol * peak)
                line += (f"; vs float32 plain {e32:.3e} (plain float32 vs "
                         f"float64 {p32:.3e})")
            ok = all(checks)
            _print(f"{line} ({'ok' if ok else 'FAIL'})")
            if not ok:
                raise AssertionError(f"tangent kernel disagrees ({what}, "
                                     f"{dtype})")
            if not time_it:
                continue
            # no atomics: a second launch, and one replayed from a CUDA
            # graph, give the same bits
            again = combine_pair_with_tangents(a, b, da, db, del_g)
            if not (torch.equal(out, again[0])
                    and torch.equal(dout, again[1])):
                raise AssertionError(f"two fused launches differ ({dtype})")
            del again
            if not graph_replay_equal(lambda: combine_pair_with_tangents(
                    a, b, da, db, del_g)):
                raise AssertionError(f"CUDA-graph replay differs ({dtype})")
            _print(f"fused combine {what} {dtype}: two launches and a "
                   "CUDA-graph replay give equal bits")
            n_tan, rows = da.shape[:2]
            ms = _cuda_ms(lambda: combine_pair_with_tangents(
                a, b, da, db, del_g), reps=10)
            plain_ms = _cuda_ms(lambda: combine_pair_with_tangents_plain(
                a, b, da, db, del_g), reps=2, warmup=1)
            presorted = is_sorted_along_g(a, b)
            bound_ms, bound_by = fused_bound_ms(rows, ng, n_tan,
                                                a.element_size(), presorted)
            _print(f"fused combine at T={n_tan}, R={rows}, NG={ng}, {dtype}: "
                   f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                   f"{bound_ms:.4f} ms ({bound_by}; "
                   f"{tangent_ops_per_row(ng)} ops/row/tangent)")
            # the launch without tangents (phase A: the merge, the
            # matrices and out) beside kernel 1; the rest is phase B's
            none = da[:0]
            merge_ms = _cuda_ms(lambda: combine_pair_with_tangents(
                a, b, none, none, del_g), reps=10)
            kernel1_ms = _cuda_ms(lambda: combine_pair(a, b, del_g), reps=10)
            tan_bytes_ms = (3 * n_tan * rows * ng * a.element_size()
                            / PEAK_BYTES_S * 1e3)
            _print(f"fused combine phases, {dtype}: T=0 {merge_ms:.4f} ms "
                   f"(kernel 1 alone {kernel1_ms:.4f} ms); T={n_tan} less "
                   f"T=0 {ms - merge_ms:.4f} ms against {tan_bytes_ms:.4f} "
                   "ms for the tangents' bytes")
            key = tuple(float(x) for x in del_g)
            by_warps = {w: _cuda_ms(lambda w=w: overlap_cuda._combine_fused(
                a, b, da, db, key, warps=w), reps=10)
                for w in TAN_WARP_CHOICES}
            _print(f"fused combine by rows per block, {dtype}: " + ", ".join(
                f"{w}: {t:.4f} ms" for w, t in by_warps.items())
                + f" (bound {bound_ms:.4f} ms; the wrapper lets the launch "
                "choose)")
            if dtype == torch.float32:
                record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        return record

    cases = [(ng, t, 4096) for ng in (10, 20, 32) for t in (1, 3, TAN_NTAN)]
    cases.append((20, TAN_NTAN, TAN_ROWS))
    record = None
    for ng, n_tan, rows in cases:
        ta, tb = tiefree_overlap_inputs(rows, ng, seed=ng + n_tan)
        rng = np.random.default_rng(rows + n_tan)
        dta = rng.standard_normal((n_tan, rows, ng))
        dtb = rng.standard_normal((n_tan, rows, ng))
        got = check(ta, tb, dta, dtb, gauss_del_g(ng),
                    f"NG={ng} T={n_tan} rows={rows}",
                    time_it=rows == TAN_ROWS)
        record = got or record

    # tied and all-zero rows: the primal bit for bit; the tangents depend
    # on the order of equal keys and need only be finite
    for ng in (10, 20, 32):
        del_g = gauss_del_g(ng)
        ta, tb = overlap_inputs(4096, ng, seed=ng)
        rng = np.random.default_rng(ng)
        for dtype in (torch.float32, torch.float64):
            a, b = on_card(ta, dtype), on_card(tb, dtype)
            da = on_card(rng.standard_normal((3, 4096, ng)), dtype)
            out, dout = combine_pair_with_tangents(a, b, da, da, del_g)
            if not (torch.equal(out, combine_pair(a, b, del_g))
                    and torch.isfinite(dout).all()):
                raise AssertionError(f"tied rows fail ({ng}, {dtype})")
    _print("tied and all-zero rows: fused primal equal to kernel 1's bit "
           "for bit, tangents finite")

    # the hard rows of phase 2 (a ragged last block, rows unsorted along g,
    # heavy ties, all-zero rows) at every NG class: the primal bit for bit,
    # the tangents finite (on tied keys they depend on the order of equal
    # keys); and tie-free rows shuffled along g, whose tangents are held to
    # the plain float64 version. Not to the plain float32 one: on these
    # rows its serial cumsum of the NG^2 weights strays further from
    # float64 than the kernel's scan (at NG = 20, unsorted_both, the card's
    # first run read the kernel 1.83e-4 from the plain float32 version and
    # 5.6e-5 from float64, against a bound of 1.27e-4)
    for ng in HARD_NGS:
        del_g = gauss_del_g(ng)
        rng = np.random.default_rng(ng)
        dta = rng.standard_normal((3, HARD_ROWS, ng))
        dtb = rng.standard_normal((3, HARD_ROWS, ng))
        for name, (ta, tb) in combine_cases(HARD_ROWS, ng, seed=ng).items():
            for dtype in (torch.float32, torch.float64):
                a, b, da, db = (on_card(x, dtype) for x in (ta, tb, dta, dtb))
                out, dout = combine_pair_with_tangents(a, b, da, db, del_g)
                if not (torch.equal(out, combine_pair(a, b, del_g))
                        and torch.isfinite(dout).all()):
                    raise AssertionError(
                        f"fused kernel on hard rows fails (NG={ng} {name} "
                        f"{dtype})")
        ta, tb = tiefree_overlap_inputs(HARD_ROWS, ng, seed=ng)
        sa, sb = rng.permuted(ta, axis=1), rng.permuted(tb, axis=1)
        for name, (xa, xb) in (("sorted", (ta, tb)), ("unsorted_a", (sa, tb)),
                               ("unsorted_b", (ta, sb)),
                               ("unsorted_both", (sa, sb))):
            check(xa, xb, dta, dtb, del_g,
                  f"NG={ng} tie-free {name} rows={HARD_ROWS}",
                  vs_plain32=False)
    _print(f"hard rows at NG {HARD_NGS}, {HARD_ROWS} rows: fused primal "
           "equal to kernel 1's bit for bit on every case, tangents finite")
    return record


def _fused_launches(fn):
    """(result of fn(), fused-kernel launches it made), counted from 0."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair_with_tangents,
    )

    combine_pair_with_tangents.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, combine_pair_with_tangents.launches


def copy_deck(src: str, base: str) -> str:
    """A copy of a deck under ``base`` with the shared k-tables linked
    beside it (its .kls names them by relative path)."""
    dst = os.path.join(base, "deck")
    shutil.copytree(src, dst)
    os.symlink(os.path.abspath("tests/fixtures/ktables"),
               os.path.join(base, "ktables"))
    return dst


def phase_retrieval(profile: bool = False):
    """The OE retrieval through the port's entry points on the card;
    returns the fused kernel's launches in one forward-plus-Jacobian
    evaluation of the full deck."""
    import torch

    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup,
        retrieval_nemesis,
    )

    # --- the full deck in float64 against the reference goldens
    d = np.load(OE_GOLDEN)
    fd = np.load(FD_GOLDEN)
    s64 = make_retrieval_setup(DECK, "cirstest", device="cuda")
    np.testing.assert_allclose(s64.sv.xa, d["XA"], rtol=1e-10)
    np.testing.assert_allclose(s64.sv.sa, d["SA"], rtol=1e-8)
    np.testing.assert_allclose(s64.y, d["Y"], rtol=1e-10)
    np.testing.assert_allclose(np.diag(s64.se), np.diag(d["SE"]), rtol=1e-10)
    nx, ny = s64.sv.nx, s64.y.shape[0]
    xn = torch.as_tensor(d["XN"], device="cuda")
    j = int(fd["J"])
    tangent = torch.zeros(nx, dtype=torch.float64, device="cuda")
    tangent[j] = 1.0
    yn_jvp, dy = torch.func.jvp(s64.forward_fn, (xn,), (tangent,))
    np.testing.assert_allclose(yn_jvp.cpu().numpy(), d["YN"], rtol=0,
                               atol=5e-5 * np.abs(d["YN"]).max())
    np.testing.assert_allclose(dy.cpu().numpy(), fd["COL"], rtol=0,
                               atol=3e-5 * np.abs(fd["COL"]).max())

    # the main path of this slice, counted on its own: one
    # forward-plus-Jacobian evaluation, all 81 tangents in one pass
    (yn64, kk64), launches = _fused_launches(
        lambda: forward_and_jacobian(s64.forward_fn, xn))
    if launches != 6:
        raise AssertionError(f"{launches} fused launches, expected 6")
    if kk64.shape != (ny, nx) or not torch.isfinite(kk64).all():
        raise AssertionError(f"Jacobian not finite ({ny}, {nx})")
    np.testing.assert_allclose(
        kk64[:, j].cpu().numpy(), dy.cpu().numpy(), rtol=1e-10,
        atol=1e-12 * kk64.abs().max().item())
    torch.testing.assert_close(yn64, yn_jvp, rtol=1e-12, atol=0)
    _print(f"jupiter_nadir float64 on the card (NX={nx}, NY={ny}): a priori "
           "and measurement vector equal the golden; forward_fn(XN) within "
           "5e-5 and the JVP column within 3e-5 of peak of the reference; "
           "jacfwd column equals the JVP; 6 fused launches per evaluation")

    # --- the whole retrieval on the reduced deck against the reference
    g = np.load(RETRIEVAL_GOLDEN)
    with tempfile.TemporaryDirectory() as tmp:
        deck = copy_deck(FDRET, tmp)
        res = retrieval_nemesis(deck, "cirstest", niter=int(g["niter"]),
                                philimit=float(g["philimit"]),
                                write_outputs=False, device="cuda")
    yn_ref, xn_ref, st_ref = g["YN"], g["XN"], g["ST"]
    np.testing.assert_allclose(res.yn, yn_ref, rtol=5e-3,
                               atol=np.median(np.abs(yn_ref)) * 1e-4)
    np.testing.assert_allclose(res.xn, xn_ref, rtol=1e-3,
                               atol=1e-3 * np.abs(xn_ref).max())
    phi_ref = np.asarray(g["PHI_HIST"], dtype=float)
    n = min(len(phi_ref), len(res.phi_history))
    np.testing.assert_allclose(res.phi_history[:n], phi_ref[:n], rtol=1e-3)
    scale = np.abs(np.diagonal(st_ref)).max()
    np.testing.assert_allclose(res.st, st_ref, rtol=2e-2, atol=scale * 5e-3)
    np.testing.assert_allclose(np.diagonal(res.st), np.diagonal(st_ref),
                               rtol=2e-2)
    _print(f"jupiter_fdret retrieval float64 on the card: {res.n_iter} "
           f"iterations, phi {['%.6e' % p for p in res.phi_history]}; YN, XN, "
           "PHI_HIST, ST within the reference trajectory's tolerances")

    # --- timing of one evaluation, float64 and float32
    s32 = make_retrieval_setup(DECK, "cirstest", device="cuda",
                               dtype=torch.float32)
    xn32 = xn.float()
    results = {}
    for name, setup, x in (("float64", s64, xn), ("float32", s32, xn32)):
        forward_and_jacobian(setup.forward_fn, x)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(JACOBIAN_RUNS):
            t0 = time.perf_counter()
            out, launched = _fused_launches(
                lambda: forward_and_jacobian(setup.forward_fn, x))
            times.append((time.perf_counter() - t0) * 1e3)
            if launched != 6:
                raise AssertionError(f"{launched} fused launches ({name})")
        peak = torch.cuda.max_memory_allocated()
        results[name] = out
        _print(f"forward-plus-Jacobian on jupiter_nadir ({nx} tangents, "
               f"{name}): median {np.median(times):.3f} ms over "
               f"{len(times)} runs (min {min(times):.3f}, max "
               f"{max(times):.3f}); peak memory {peak / 2**30:.3f} GiB")
        del out
    yn32, kk32 = results["float32"]
    r = rel_err(yn32.double().cpu().numpy(), yn64.cpu().numpy())
    col_peak = kk64.abs().max(dim=0).values
    jac_err = ((kk32.double() - kk64).abs().max(dim=0).values
               / col_peak).max().item()
    _print(f"retrieval float32 vs float64: spectrum max rel {r.max():.3e}, "
           f"median rel {np.median(r):.3e}; Jacobian max error over column "
           f"peak {jac_err:.3e} (bound {JAC_F32_BOUND:.1e})")
    if not (r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]):
        raise AssertionError("float32 retrieval spectrum outside 1e-4 / 1e-5")
    if not jac_err < JAC_F32_BOUND:
        raise AssertionError("float32 Jacobian outside its bound")
    results.clear()

    # --- wall-clock of a 3-iteration retrieval on the full deck
    for name, dtype in (("float64", torch.float64),
                        ("float32", torch.float32)):
        t0 = time.perf_counter()
        res3, launched = _fused_launches(lambda: retrieval_nemesis(
            DECK, "cirstest", niter=3, philimit=0.001, write_outputs=False,
            device="cuda", dtype=dtype))
        wall = time.perf_counter() - t0
        hist = res3.phi_history
        if not (np.isfinite(res3.xn).all() and hist[-1] < hist[0]):
            raise AssertionError(f"retrieval ({name}) did not reduce phi")
        _print(f"retrieval_nemesis(jupiter_nadir, niter=3, {name}): "
               f"{wall:.3f} s wall, {res3.n_iter} iterations accepted, "
               f"{launched} fused launches, phi "
               f"{['%.6e' % p for p in hist]}")

    if profile:
        profile_forward(
            lambda: forward_and_jacobian(s64.forward_fn, xn), runs=1,
            what="forward-plus-Jacobian (float64, 81 tangents)",
            trace="build/jacobian_trace.json")
        profile_forward(
            lambda: forward_and_jacobian(s32.forward_fn, xn32), runs=1,
            what="forward-plus-Jacobian (float32, 81 tangents)",
            trace="build/jacobian32_trace.json")
    return launches


# ---- runtime line-by-line slice ------------------------------------------

# Operations the line-by-line synthesis needs (not the kernel's own count),
# counting an exp, a pow, a sqrt and a division as one operation each.
# Re w(z) by the Weideman-24 expansion: the two shifted arguments (2), |.|^2
# (3), the reciprocal (2 divisions, 1 negation), the Moebius map (6), 23
# complex Horner steps of 4 multiplies and 3 adds (161), the last product
# (6), the doubling and offset (4), the real part of the final product (3).
LBL_OPS_WEIDEMAN = 188
# Re w(z) by the 6-convergent continued fraction as the ratio of two
# polynomials in t = 1/z^2 (the float32 kernel's form, ops/voigt.py:
# cf_ratio_re; |z|^2 comes from the branch test): 1/|z|^2 (1), 1/z (2),
# t = (1/z)^2 (5), the two cubics' leading steps with real coefficients (3
# each) and their two complex Horner steps each (4 x 7), p5 / z (6), the
# imaginary part of p5 conj(p6) / z (3), |p6|^2 (3), its reciprocal (1) and
# the scaling (2).
LBL_OPS_CF = 57
# the nested form's count (per convergent |d|^2 (3), its reciprocal (1), the
# two updates (3 each); then |d|^2, a multiply and a division (5)), in
# which the bound was given before the ratio form; printed beside it so
# that times compare with earlier runs
LBL_OPS_CF_NESTED = 65
# every (line, wave) pair inside the window: the delta (4 with two floats,
# 1 in float64), two window tests (4 compares), the weighted add (2)
LBL_OPS_PAIR_F32, LBL_OPS_PAIR_F64 = 10, 7
# a core pair beyond Re w: x = delta * scale, the float32 branch test
# |z|^2 > 49 (4), the normalisation (3 multiplies)
LBL_OPS_CORE_F32, LBL_OPS_CORE_F64 = 8, 4
# a wing pair beyond the above: delta^2 and a division
LBL_OPS_WING = 2
# per (layer, line): Boltzmann factor (2), stimulated emission (4), the
# strength (4), the Doppler width (2), the Lorentz width (2 pows, 6), the
# shift (2), the lineshape's two parameters (2), the s_floor test (1), and
# the wing value f(wn_calc) wn_calc^2 (the continued fraction in float32,
# the expansion in float64, plus 9)
LBL_OPS_LINE = 25


def lbl_pair_counts(ll, blocks, t, p, amb, wn_calc=25.0, wn_approx=75.0):
    """(core_cf, core_weideman, wing, lines) pair counts of one synthesis,
    from its inputs: for each (layer, line) of non-zero strength, the waves
    within wn_calc of the shifted centre (split at |z|^2 = 49), and those
    between wn_calc and wn_approx. t, p [atm], amb: (NLAY,) float64."""
    import torch

    from archnemesis_tpu_torch.ops.lbl import layer_line_params

    s, alpha, gamma, shift = (x.numpy() for x in layer_line_params(
        ll, *(torch.as_tensor(np.asarray(x, dtype=np.float64))
              for x in (t, p, amb))))
    wave = blocks.wn_pad[:blocks.n_wave]
    ctr = ll.nu[None, :] + shift
    live = s > 0

    def within(half):
        """waves with |wave - ctr| < half (clipped to the window)"""
        lo = np.searchsorted(wave, ctr - half, side="left")
        hi = np.searchsorted(wave, ctr + half, side="left")
        return np.where(live, hi - lo, 0)

    core, full = within(wn_calc), within(wn_approx)
    scale = np.sqrt(np.log(2.0)) / alpha
    y = gamma * scale
    half_w = np.where(y < 7.0, np.sqrt(np.maximum(49.0 - y * y, 0.0)) / scale,
                      0.0)
    weid = np.minimum(within(half_w), core)
    return (int((core - weid).sum()), int(weid.sum()), int((full - core).sum()),
            int(live.sum()))


def lbl_bound_ms(ll, blocks, t, p, amb, itemsize: int,
                 cf_ops: int = LBL_OPS_CF) -> tuple:
    """(bound_ms, bound_by, ops) of one synthesis on an H100: the larger of
    its bytes (the ten line columns, the wave grid's two parts, the block
    ranges and the layer scalars read once, k written once) over HBM
    bandwidth and the operations these inputs need over the peak rate of
    the type. In float32 a core pair takes the continued fraction
    (``cf_ops`` operations) where |z|^2 > 49 and the Weideman expansion
    elsewhere; float64 takes the expansion everywhere."""
    cf, weid, wing, lines = lbl_pair_counts(ll, blocks, t, p, amb)
    nlay = len(t)
    if itemsize == 4:
        pair, core, peak, line_w = (LBL_OPS_PAIR_F32, LBL_OPS_CORE_F32,
                                    PEAK_F32_OPS_S, cf_ops)
        ops = (cf * (pair + core + cf_ops)
               + weid * (pair + core + LBL_OPS_WEIDEMAN))
    else:
        pair, core, peak, line_w = (LBL_OPS_PAIR_F64, LBL_OPS_CORE_F64,
                                    PEAK_F64_OPS_S, LBL_OPS_WEIDEMAN)
        ops = (cf + weid) * (pair + core + LBL_OPS_WEIDEMAN)
    ops += wing * (pair + LBL_OPS_WING) + lines * (LBL_OPS_LINE + line_w)
    nbytes = itemsize * (10 * ll.n_lines + 2 * blocks.wn_pad.size
                         + 4 * nlay + blocks.n_wave * nlay) + 8 * blocks.n_blocks
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / peak * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", ops
    return bytes_ms, "bytes", ops


# the pressure-shift case of phase 7: ambient shifts of +-0.95 cm-1/atm
# (alternating by line) and layers up to 1.95 atm move line centres by up
# to 1.67 cm-1, less than build_blocks' 2 cm-1 shift margin, against 2.54
# cm-1 blocks of co_lbl's 0.02 cm-1 grid: the core/wing boundaries of many
# (block, line) pairs move across a block. (T [K], p [atm], ambient
# fraction) per layer
SHIFT_D_AMB = 0.95
SHIFT_CASE_STATE = ((150.0, 0.01, 1.0), (250.0, 1.0, 1.0), (220.0, 1.95, 0.9))


def shifted_lines(ll):
    """The line list with the shift case's ambient pressure shifts."""
    import dataclasses

    broad = ll.broad.copy()
    broad[5] = SHIFT_D_AMB * np.where(np.arange(ll.n_lines) % 2, 1.0, -1.0)
    return dataclasses.replace(ll, broad=broad)


# (block, line) classes of the LBL pair pass and the margin of its class
# test, relative to wn_approx + 1 cm-1 (csrc/lbl_cross_section.cu:
# line_class)
SKIP, WING, CORE, STRADDLE = 0, 1, 2, 3
CLASS_MARGIN = 1.0e-4


def block_line_classes(spec, t, p, amb):
    """(NLAY, NB, M) classes of the LBL pair pass for the lines of every
    block (``blocks.line_idx``; ``SKIP`` on padding and on zero strength),
    from the deltas at each block's first and last wave in the kernel's
    arithmetic and ``t``'s type: the host's copy of the rule of the
    kernel's ``line_class``, which the kernel applies on the card while it
    stages the lines. A class other than ``STRADDLE`` holds for every wave
    between, since the computed delta is monotone in the wave up to a few
    ulps, well inside the margin."""
    import torch

    from archnemesis_tpu_torch.ops.lbl import (
        layer_line_params,
        line_column,
        two_float,
        uses_two_float,
    )

    ll, blocks = spec.ll, spec.blocks
    strength, _, _, shift = layer_line_params(ll, t, p, amb)
    if not spec.include_pressure_shift:
        shift = torch.zeros_like(shift)
    dev = t.device
    idx = torch.as_tensor(blocks.line_idx, dtype=torch.long, device=dev)
    w = blocks.block_width
    ends = np.stack([blocks.wn_pad[::w], blocks.wn_pad[w - 1::w]], axis=1)
    if uses_two_float(ll, t.dtype):
        nu_hi, nu_lo = (torch.as_tensor(x, device=dev)[idx][None, :, :, None]
                        for x in two_float(ll.nu))
        e_hi, e_lo = (torch.as_tensor(x, device=dev)[None, :, None, :]
                      for x in two_float(ends))
        d = ((e_hi - nu_hi) + (e_lo - nu_lo)) - shift[:, idx][..., None]
    else:
        centre = line_column(ll.nu, t)[idx][None] + shift[:, idx]
        d = t.new_tensor(ends)[None, :, None, :] - centre[..., None]
    wc, wa = spec.wn_calc_window, spec.wn_approx_window
    margin = CLASS_MARGIN * (abs(wa) + 1.0)
    wcore = min(wc, wa)
    first, last = d[..., 0], d[..., 1]
    cls = torch.full(first.shape, STRADDLE, dtype=torch.int64, device=dev)
    cls[((first >= wc + margin) & (last < wa - margin))
        | ((first >= -wa + margin) & (last < -wc - margin))] = WING
    cls[(first >= -wcore + margin) & (last < wcore - margin)] = CORE
    cls[(last < -wa - margin) | (first >= wa + margin)] = SKIP
    s = strength[:, idx]
    mask = torch.as_tensor(blocks.line_mask > 0, device=dev)
    return torch.where((s >= spec.s_floor) & (s != 0) & mask, cls, SKIP)


def class_changes(spec, t, p, amb) -> tuple:
    """(class counts (skip, wing, core, straddle) over all layers, number
    of (layer, block, line) whose class differs from the one without the
    pressure shift) of the pair pass by the host's rule
    (``block_line_classes``), in ``t``'s type, layer by layer."""
    import dataclasses

    import torch

    unshifted = dataclasses.replace(spec, include_pressure_shift=False)
    counts, changed = np.zeros(4, dtype=np.int64), 0
    for i in range(t.shape[0]):
        lay = (t[i:i + 1], p[i:i + 1], amb[i:i + 1])
        cls = block_line_classes(spec, *lay)
        counts += torch.bincount(cls.reshape(-1), minlength=4).cpu().numpy()
        changed += int((cls != block_line_classes(unshifted, *lay)).sum())
    return counts, changed


def lbl_kernel_and_plain(ll, blocks, t, p, amb, **kw):
    """(kernel, plain) k of one synthesis on the card: the wrapper's launch
    and the plain version on the same (NLAY,) CUDA tensors."""
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.ops.lbl import lbl_cross_section_plain

    k = lbl_cuda.lbl_cross_section(ll, blocks, t, p, amb, **kw)
    return k, lbl_cross_section_plain(ll, blocks, t, p, amb, **kw)


def _lbl_f32_check(k32, k64, what: str) -> tuple:
    """float32 against float64 at the LBL float32 bound; returns (max,
    median) relative error."""
    r = rel_err(k32.double().cpu().numpy(), k64.double().cpu().numpy())
    ok = r.max() < LBL_F32_BOUNDS[0] and np.median(r) < LBL_F32_BOUNDS[1]
    _print(f"{what}: float32 vs float64 max rel {r.max():.3e}, median rel "
           f"{np.median(r):.3e} ({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"{what}: float32 outside "
                             f"{LBL_F32_BOUNDS[0]:.0e} / {LBL_F32_BOUNDS[1]:.0e}")
    return float(r.max()), float(np.median(r))


def _lbl_f64_check(k, ref, what: str):
    """float64 kernel against float64 ``ref`` at ``LBL_F64_RTOL``."""
    import torch

    err = ((k - ref).abs() / ref.abs().clamp_min(1e-300)).max().item()
    ok = torch.allclose(k, ref, rtol=LBL_F64_RTOL, atol=0.0)
    _print(f"{what}: float64 max rel {err:.3e} ({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"{what}: float64 outside rtol {LBL_F64_RTOL}")


def phase_lbl_kernel_vs_plain():
    """The LBL kernel against its plain version and the reference on the
    card; returns the record of the full-width configuration."""
    import dataclasses

    import torch

    from archnemesis_tpu_torch.forward import (
        ATM_TO_PA,
        forward_nadir,
        runtime_ambient_fraction,
    )
    from archnemesis_tpu_torch.io.linedata import (
        _slice_lines,
        read_ans_linedata,
    )
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.ops.lbl import (
        build_blocks,
        lbl_cross_section_plain,
    )
    from archnemesis_tpu_torch.ops.voigt import LINESHAPES
    from archnemesis_tpu_torch.synthetic import lbl_headline

    def card(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    ll = read_ans_linedata(LINEDATA_NPZ, gas_id=5, iso_id=1)
    # --- the reference's cross-sections (tests/test_lbl.py)
    d = np.load(CO_LBL_GOLDEN)
    blocks = build_blocks(d["WAVE"], ll.nu)
    t, p, amb = (card(d["CASES"][:, i]) for i in range(3))
    k64, plain64 = lbl_kernel_and_plain(ll, blocks, t, p, amb)
    _lbl_f64_check(k64, plain64, "co_lbl kernel vs plain")
    _lbl_f64_check(k64, card(d["K"]), "co_lbl kernel vs reference")
    k32 = lbl_cuda.lbl_cross_section(ll, blocks, t.float(), p.float(),
                                     amb.float())
    _lbl_f32_check(k32, card(d["K"]), "co_lbl kernel")

    # --- every lineshape on the same grid and cases with s_floor > 0, no
    # shift and the iso-0 factor, at block widths 128, 200, 1 and 512 (the
    # last three not multiples of the waves per thread, 512 the largest
    # block), and with the lines above 2100 cm-1 dropped, so that the upper
    # blocks hold none
    ll0 = dataclasses.replace(ll, iso_id=0)
    for lls, width in ((ll0, 128), (ll0, 200), (ll0, 1), (ll0, 512),
                       (_slice_lines(ll0, 2000.0, 2100.0), 128)):
        blk = build_blocks(d["WAVE"], lls.nu, block_width=width)
        empty = int((blk.counts == 0).sum())
        for shape in LINESHAPES:
            kw = dict(lineshape=shape, s_floor=1.0e-25,
                      include_pressure_shift=False)
            k64, plain64 = lbl_kernel_and_plain(lls, blk, t, p, amb, **kw)
            what = (f"{shape}, W={width}, {lls.n_lines} lines, {empty} "
                    "blocks without lines")
            _lbl_f64_check(k64, plain64, what)
            k32 = lbl_cuda.lbl_cross_section(lls, blk, t.float(), p.float(),
                                             amb.float(), **kw)
            _lbl_f32_check(k32, plain64, what)
    if empty == 0:
        raise AssertionError("the last grid has no block without lines")

    # --- the pressure-shift case: line centres moved across the blocks'
    # core/wing boundaries, every lineshape
    lls = shifted_lines(ll)
    blk = build_blocks(d["WAVE"], lls.nu)
    ts, ps, ambs = (card(v) for v in zip(*SHIFT_CASE_STATE))
    counts, changed = class_changes(lbl_cuda.make_spec(lls, blk),
                                    ts.float(), ps.float(), ambs.float())
    _print(f"shift case: (block, line) classes skip / wing / core / straddle "
           f"{counts.tolist()}, {changed} differ from the unshifted ones")
    if changed == 0:
        raise AssertionError("the shift case moves no line across a class")
    # float32 against the plain float32 version: a float32 shift of ~1.7
    # cm-1 is itself off by ~1e-7 cm-1, which moves a narrow Gaussian's
    # far core by up to ~1.7e-4 relative in both versions alike; against
    # float64, the kernel may be no further off than the plain float32
    # version plus the float32 bound
    for shape in LINESHAPES:
        k64, plain64 = lbl_kernel_and_plain(lls, blk, ts, ps, ambs,
                                            lineshape=shape)
        _lbl_f64_check(k64, plain64, f"{shape}, shift case")
        k32, plain32 = lbl_kernel_and_plain(lls, blk, ts.float(), ps.float(),
                                            ambs.float(), lineshape=shape)
        _lbl_f32_check(k32, plain32, f"{shape}, shift case, kernel vs plain")
        want = plain64.cpu().numpy()
        r_k, r_p = (rel_err(x.double().cpu().numpy(), want)
                    for x in (k32, plain32))
        ok = (r_k.max() < r_p.max() + LBL_F32_BOUNDS[0]
              and np.median(r_k) < LBL_F32_BOUNDS[1])
        _print(f"{shape}, shift case, against float64: kernel float32 max "
               f"rel {r_k.max():.3e} (median {np.median(r_k):.3e}), plain "
               f"float32 max rel {r_p.max():.3e} (median "
               f"{np.median(r_p):.3e}) ({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"{shape}, shift case: the float32 kernel "
                                 "is further from float64 than the plain "
                                 "float32 version allows")

    # --- the full-width configuration, at the inputs its forward gives
    atm, laycfg, rt, surf, cfg = lbl_headline(dtype=torch.float32,
                                              device="cuda")
    _, diag = forward_nadir(atm, laycfg, rt, None, None, surf, cfg,
                            emiss_ang=0.0, return_diagnostics=True,
                            device="cuda")
    layers = diag["layers"]
    t32 = layers.temp
    p32 = layers.press / ATM_TO_PA
    amb32 = runtime_ambient_fraction(cfg, layers, 0)
    lls, blk = rt.line_lists[0], rt.blocks[0]
    spec = lbl_cuda.make_spec(lls, blk)
    static = lbl_cuda.kernel_inputs(spec, torch.float32, t32.device)

    def kernel():
        return lbl_cuda.lbl_cross_section(
            lls, blk, t32, p32, amb32,
            packed={(torch.float32, t32.device): static})

    def plain():
        return lbl_cross_section_plain(lls, blk, t32, p32, amb32)

    k32 = kernel()
    same = torch.equal(k32, kernel())
    _print(f"full width: two float32 launches equal bit for bit: {same} "
           f"({'ok' if same else 'FAIL'})")
    if not same:
        raise AssertionError("two full-width launches differ")
    ms = _cuda_ms(kernel, reps=LBL_KERNEL_RUNS)
    state = (t32, p32, amb32)
    sweep = {}
    for v in lbl_cuda.VOIGT_WAVES_PER_THREAD:
        k_v = lbl_cuda._launch(spec, static, *state, waves_per_thread=v)
        _lbl_f32_check(k_v, k32.double(), f"{v} waves per thread, against "
                       "the default")
        sweep[v] = (_cuda_ms(lambda: lbl_cuda._launch(
            spec, static, *state, waves_per_thread=v), reps=LBL_KERNEL_RUNS),
            torch.equal(k_v, k32))
    _print("full width by waves per thread: " + ", ".join(
        f"{v}: {t_ms:.4f} ms (bits equal the default launch's: {eq})"
        for v, (t_ms, eq) in sweep.items()))
    # how the pair pass stages its record tiles, timed in turns
    staging = {name: [] for name in lbl_cuda.STAGING}
    for name in staging:
        k_s = lbl_cuda._launch(spec, static, *state, staging=name)
        if not torch.equal(k_s, k32):
            raise AssertionError(f"{name} staging changes the bits")
    for _ in range(3):
        for name, t_s in staging.items():
            t_s.append(_cuda_ms(lambda: lbl_cuda._launch(
                spec, static, *state, staging=name), reps=LBL_KERNEL_RUNS))
    _print("full width by staging of the record tiles (3 turns, bits equal "
           "the default launch's): " + "; ".join(
               f"{name}: " + " / ".join(f"{t_ms:.4f}" for t_ms in t_s)
               + " ms" for name, t_s in staging.items()))
    # the two passes' device times (the line pass alone is too short for
    # events around its launches, which would time the host)
    by_kernel = kernel_device_ms(kernel)
    line_ms, pair_ms = (sum(v for k, v in by_kernel.items() if name in k)
                        for name in ("line_kernel", "pair_kernel"))
    counts, changed = class_changes(spec, *state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain32 = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (k32 - plain32).abs().max().item()
    _lbl_f32_check(k32, plain32, "full width, kernel vs plain (float32)")
    del plain32
    sel = list(LBL_COMPARE_LAYERS)
    t64, p64, a64 = (x[sel].double() for x in (t32, p32, amb32))
    k64, plain64 = lbl_kernel_and_plain(lls, blk, t64, p64, a64)
    _lbl_f64_check(k64, plain64, f"full width, layers {sel}")
    _lbl_f32_check(k32[:, sel], plain64, f"full width, layers {sel}")
    del k64, plain64
    host = [x.double().cpu().numpy() for x in (t32, p32, amb32)]
    bound_ms, bound_by, ops = lbl_bound_ms(lls, blk, *host, itemsize=4)
    nested_ms = lbl_bound_ms(lls, blk, *host, itemsize=4,
                             cf_ops=LBL_OPS_CF_NESTED)[0]
    cf, weid, wing, lines = lbl_pair_counts(lls, blk, *host)
    _print(f"lbl_cross_section at {blk.n_wave} waves x {lls.n_lines} lines x "
           f"{len(t32)} layers, float32: kernel {ms:.4f} ms, plain "
           f"{plain_ms:.4f} ms (all {len(t32)} layers, one call), bound "
           f"{bound_ms:.4f} ms (with the nested fraction's count: "
           f"{nested_ms:.4f} ms) ({bound_by}; {ops:.4e} operations: "
           f"{cf:.4e} continued-fraction and {weid:.4e} Weideman core pairs, "
           f"{wing:.4e} wing pairs, {lines} (layer, line) terms); "
           f"max_abs_err {err:.3e}")
    _print(f"lbl_cross_section passes (device time, torch.profiler): line "
           f"pass {line_ms:.4f} ms, pair pass {pair_ms:.4f} ms, beside the "
           f"bound {bound_ms:.4f} ms; (block, line) classes skip / wing / "
           f"core / straddle {counts.tolist()} over {len(t32)} layers "
           f"({changed} moved by the pressure shift)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def copy_runtime_deck(base: str) -> str:
    """A copy of the runtime deck under ``base`` whose ``.lls`` reads the
    line data from its ``.npz`` export (DBASE_LD / DBASE_PF), so that a
    machine without h5py reads it through the port's ``load_deck``."""
    dst = os.path.join(base, "deck")
    shutil.copytree(CO_RUNTIME, dst)
    lls = os.path.join(dst, "cirstest.lls")
    with open(lls) as f:
        lines = f.readlines()
    npz = os.path.abspath(LINEDATA_NPZ)
    with open(lls, "w") as f:
        for line in lines:
            key = line.split()[0] if line.split() else ""
            f.write(f"{key:<17}{npz}\n" if key in ("DBASE_LD", "DBASE_PF")
                    else line)
    return dst


def runtime_deck_forward(deck_dir: str, dtype, device):
    """(TAUGAS, SPECONV, launches) of the runtime deck as
    ``tests/test_forward_runtime.py`` sets it up (the a-priori state
    applied, lines windowed to the channel range), through the port."""
    import torch

    from archnemesis_tpu_torch.core.spectra import cast_deck
    from archnemesis_tpu_torch.forward import forward_nadir, make_forward_config
    from archnemesis_tpu_torch.io.legacy import load_deck
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.ops.convolution import conv_channel_interp
    from archnemesis_tpu_torch.retrieval.statevector import (
        apply_state,
        read_apr,
    )

    deck = load_deck(deck_dir, "cirstest")
    sv = read_apr(os.path.join(deck_dir, "cirstest.apr"), deck.atmosphere)
    atm = apply_state(deck.atmosphere, torch.as_tensor(sv.xa), sv)
    nconv = int(deck.geometry.nconv[0])
    vconv = deck.geometry.vconv[:nconv, 0]
    rt = deck.ktables.windowed(vconv.min(), vconv.max())
    cfg = make_forward_config(atm, rt, None, iray=deck.settings.iray,
                              ispace=deck.settings.ispace, gasgiant=True)
    atm, surf = cast_deck(atm, dtype), cast_deck(deck.surface, dtype)
    lbl_cuda.lbl_cross_section.launches = 0
    spec, diag = forward_nadir(atm, deck.layer_config, rt, None, None, surf,
                               cfg, emiss_ang=0.0, return_diagnostics=True,
                               device=device)
    launches = lbl_cuda.lbl_cross_section.launches
    conv = conv_channel_interp(spec.new_tensor(rt.wave), spec[:, 0],
                               spec.new_tensor(vconv))
    return diag["taugas"], conv, launches


def phase_lbl_golden_deck():
    """The runtime deck through the port's load_deck on the card."""
    d = np.load(CO_RUNTIME_GOLDEN)
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        deck = copy_runtime_deck(tmp)
        tau64, conv64, n64 = runtime_deck_forward(deck, torch.float64, "cuda")
        _, conv32, n32 = runtime_deck_forward(deck, torch.float32, "cuda")
    want = d["TAUGAS"]
    np.testing.assert_allclose(tau64.cpu().numpy(), want, rtol=1e-7,
                               atol=1e-10 * np.abs(want).max())
    nconv = int(d["NCONV"][0])
    np.testing.assert_allclose(conv64.cpu().numpy(), d["SPECONV"][:nconv, 0],
                               rtol=1e-6, atol=0)
    if (n64, n32) != (1, 1):
        raise AssertionError(f"{n64}, {n32} launches per forward, expected 1")
    _print("runtime deck float64 (line data from the .npz export): TAUGAS "
           "within rtol 1e-7, SPECONV within rtol 1e-6 of the golden; 1 "
           "launch per forward")
    _lbl_f32_check(conv32, conv64, "runtime deck SPECONV")


def phase_lbl_headline(profile: bool = False):
    """Drive the runtime line-by-line headline forward; returns (launches of
    the main path, median ms)."""
    import torch

    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.synthetic import LBL_NWAVE, lbl_headline

    atm, laycfg, rt, surf, cfg = lbl_headline(dtype=torch.float32,
                                              device="cuda")

    def forward():
        return forward_nadir(atm, laycfg, rt, None, None, surf, cfg,
                             emiss_ang=0.0, device="cuda")

    # the main path, counted on its own
    lbl_cuda.lbl_cross_section.launches = 0
    spec = forward()
    torch.cuda.synchronize()
    launches = lbl_cuda.lbl_cross_section.launches
    if launches != 1:
        raise AssertionError(f"{launches} LBL launches, expected 1")
    if spec.shape != (LBL_NWAVE, 1) or not torch.isfinite(spec).all():
        raise AssertionError(f"LBL headline spectrum not finite "
                             f"({LBL_NWAVE}, 1)")

    torch.cuda.reset_peak_memory_stats()
    times = []
    before = lbl_cuda.lbl_cross_section.launches
    packs = lbl_cuda.kernel_inputs.calls
    for i in range(HEADLINE_RUNS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward()
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    if lbl_cuda.lbl_cross_section.launches - before != HEADLINE_RUNS + 2:
        raise AssertionError("LBL launches did not rise by 1 per forward")
    packs = lbl_cuda.kernel_inputs.calls - packs
    _print(f"static kernel inputs packed in {HEADLINE_RUNS + 2} forwards "
           f"after the first: {packs} ({'ok' if packs == 0 else 'FAIL'})")
    if packs:
        raise AssertionError("the LBL forward packs its static inputs per "
                             "call")
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times))
    nlines = rt.line_lists[0].n_lines
    _print(f"LBL headline forward ({LBL_NWAVE} waves x {nlines} lines x "
           f"{laycfg.nlay} layers, float32): median {ms:.3f} ms over "
           f"{len(times)} runs (min {min(times):.3f}, max {max(times):.3f}); "
           f"{LBL_NWAVE / ms * 1e3:.1f} waves/s; peak memory "
           f"{peak / 2**30:.3f} GiB")

    atm64, laycfg, rt64, surf64, cfg = lbl_headline(dtype=torch.float64,
                                                    device="cuda")
    spec64 = forward_nadir(atm64, laycfg, rt64, None, None, surf64, cfg,
                           emiss_ang=0.0, device="cuda")
    _lbl_f32_check(spec, spec64, "LBL headline spectrum")
    if profile:
        profile_forward(forward, what="LBL headline forward",
                        trace="build/lbl_headline_trace.json")
    return launches, ms


def phase_lbl_retrieval():
    """The retrieval entry point on a copy of the runtime deck, on the card
    against the port's CPU result; returns the launches of one
    forward-plus-Jacobian evaluation."""
    import torch

    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup,
        retrieval_nemesis,
    )

    with tempfile.TemporaryDirectory() as tmp:
        deck = copy_runtime_deck(tmp)
        cpu = make_retrieval_setup(deck, "cirstest", device="cpu")
        gpu = make_retrieval_setup(deck, "cirstest", device="cuda")
        ngas = gpu.deck.ktables.ngas
        xa = torch.as_tensor(cpu.sv.xa)
        yn_cpu, kk_cpu = forward_and_jacobian(cpu.forward_fn, xa)
        y0 = gpu.forward_fn(xa.cuda())
        lbl_cuda.lbl_cross_section.launches = 0
        yn, kk = forward_and_jacobian(gpu.forward_fn, xa.cuda())
        torch.cuda.synchronize()
        launches = lbl_cuda.lbl_cross_section.launches
        if launches != ngas:
            raise AssertionError(f"{launches} LBL launches per evaluation, "
                                 f"expected {ngas}")
        for what, got, want in (("forward_fn(xa)", y0, yn_cpu),
                                ("spectrum", yn, yn_cpu)):
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=1e-10, atol=0, err_msg=what)
        # the Jacobian at rtol 1e-10 and, for entries that are rounding
        # noise (the first card run read 2 of 900 near 1e-31, 21 orders
        # under their column's peak), within 1e-10 of each column's peak
        col_peak = kk_cpu.abs().max(dim=0).values.numpy()
        np.testing.assert_array_less(
            np.abs(kk.cpu().numpy() - kk_cpu.numpy()),
            1e-10 * np.abs(kk_cpu.numpy()) + 1e-10 * col_peak[None, :]
            + np.finfo(np.float64).tiny)
        _print(f"runtime retrieval set-up on the card (NX={gpu.sv.nx}, "
               f"NY={gpu.y.shape[0]}), float64: forward_fn(xa) and the "
               f"spectrum equal the CPU's at rtol 1e-10, the Jacobian at "
               f"rtol 1e-10 + 1e-10 of each column's peak; {launches} "
               f"launch per evaluation ({ngas} gas)")
        hist = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res = retrieval_nemesis(deck, "cirstest", niter=3,
                                    write_outputs=False, device=device)
            wall = time.perf_counter() - t0
            hist[device] = res.phi_history
            if not (np.isfinite(res.xn).all()
                    and res.phi_history[-1] < res.phi_history[0]):
                raise AssertionError(f"runtime retrieval ({device}) did not "
                                     "reduce phi")
            _print(f"retrieval_nemesis(co_runtime, niter=3, float64, "
                   f"{device}): {wall:.3f} s wall, {res.n_iter} iterations, "
                   f"phi {['%.6e' % x for x in res.phi_history]}")
    np.testing.assert_allclose(hist["cuda"], hist["cpu"], rtol=1e-8)
    return launches



# ---- the last TPU kernels: the FMA-peak probe, the combine's variants,
# ---- the packed LBL shard entry; wave sharding over torch.distributed

# the wave shards of phases 13 and 14
N_SHARDS = 4


def phase_fma_peak():
    """Kernel 4 against its plain version bit for bit, its SASS, then the
    probe tool's measurement (the main path); returns the record."""
    from archnemesis_tpu_torch.ops import fma_peak
    from archnemesis_tpu_torch.tools import fma_peak as tool

    differ = tool.check()
    _print(f"fma_peak kernel vs plain on {tool.CHECK_ROWS * tool.COLS + 3} "
           f"random float32 elements: {differ} differ "
           f"({'ok' if differ == 0 else 'FAIL'})")
    if differ:
        raise AssertionError("the FMA probe differs from its plain version")
    ops = tool.sass_opcodes(fma_peak.build()["path"])
    if ops is None:
        _print("fma_peak SASS: no cuobjdump in the toolkit")
    else:
        # two unrolled copies of 4 elements x 2 chains x (2 + 256) FMAs
        # (the 16-byte path and the ragged end), nothing folded
        want = 2 * 4 * 2 * (fma_peak.STEPS + 1)
        _print(f"fma_peak SASS: {ops['FFMA']} FFMA (expected {want}), "
               f"{ops['FMUL']} FMUL, {ops['FADD']} FADD of "
               f"{sum(ops.values())} instructions")
        if ops["FFMA"] != want or ops["FMUL"]:
            raise AssertionError("the probe's loop is not the FFMA chains")

    # the main path, counted on its own
    fma_peak.fma_chain.launches = 0
    rec = tool.measure()
    launches = fma_peak.fma_chain.launches
    if rec["max_abs_err"] != 0.0:
        raise AssertionError("the probe differs from its plain version")
    numel = rec["flops"] // fma_peak.FLOPS_PER_ELEMENT
    bytes_ms = 8 * numel / PEAK_BYTES_S * 1e3
    ops_ms = rec["flops"] / PEAK_F32_OPS_S * 1e3
    _print(f"fma_peak at {tool.ROWS} x {tool.COLS} float32 ones: kernel "
           f"{rec['ms']:.4f} ms (median of 20), {rec['tflops']:.3f} TFLOP/s "
           f"= {rec['share']:.4f} of the data sheet's "
           f"{PEAK_F32_OPS_S / 1e12:.0f} TFLOP/s; plain {rec['plain_ms']:.3f} "
           f"ms; bound {ops_ms:.4f} ms (operations; bytes {bytes_ms:.4f}); "
           f"{launches} launches")
    return dict(launches=launches, max_abs_err=rec["max_abs_err"],
                ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None)


def variant_f32_tol(del_g, mode: str) -> float:
    """float32 bound of a variant kernel's rebinned values against the
    float64 plain version, relative to each row's peak: ``tangent_f32_tol``
    for ``full`` (the rounding of an overlap's prefix sums against the
    narrowest bin, 2.7e-5 at NG = 20; the card's first run read 1.35e-5)
    and twice that for ``edges``, which subtracts two cumulative edge sums
    that reach the row's total (read 2.37e-5). The kernel and the plain
    float32 version are held to each other within three times the bound:
    the plain version's serial cumsum over NG^2 weights is the less
    accurate of the two (read 5.1e-5 and 6.0e-5 of the peak)."""
    return tangent_f32_tol(del_g) * (2.0 if mode == "edges" else 1.0)


def variant_bound_ms(mode: str, rows: int, ng: int, presorted: bool) -> tuple:
    """(bound_ms, bound_by) of one variant call in float32: the combine's
    bound for ``full`` and ``edges``; for ``sortonly`` the larger of the
    bytes and the merge of NG presorted runs of NG pair sums (the n pair
    sums and n ceil(log2 NG) comparisons); for ``rollonly`` the bytes in and
    out."""
    if mode in ("full", "edges"):
        return combine_bound_ms(rows, ng, 4, presorted)
    bytes_ms = 3 * rows * ng * 4 / PEAK_BYTES_S * 1e3
    if mode == "rollonly":
        return bytes_ms, "bytes"
    n = ng * ng
    ops_ms = rows * (n + n * _ceil_log2(ng)) / PEAK_F32_OPS_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def phase_overlap_variants():
    """Kernel 3, every mode against its plain version at the tool's shape,
    then the variants tool (the main path); returns one record per mode."""
    import torch

    from archnemesis_tpu_torch.ops import overlap_variants as ov
    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair
    from archnemesis_tpu_torch.tools import overlap_variants as tool

    a, b, del_g = tool.inputs()
    rows, ng = a.shape
    n = ng * ng
    presorted = is_sorted_along_g(a, b)
    pairs = (a[:, :, None] + b[:, None, :]).reshape(rows, n)
    padded = pairs.new_full((rows, ov.ref_pad(ng)), torch.finfo(a.dtype).max)
    padded[:, :n] = pairs
    library = {
        "sortonly": lambda: torch.topk(pairs, ng, largest=False).values,
        "rollonly": lambda: torch.roll(padded, ov.roll_shift(ng), dims=1),
    }
    kernel1 = combine_pair(a, b, del_g)
    records = {}
    for mode in ov.MODES:
        got = ov.combine_lean(a, b, del_g, mode)
        plain = ov.combine_lean_plain(a, b, del_g, mode)
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        line = f"overlap_variants {mode} vs plain at R={rows}, NG={ng}: "
        if mode in library:
            ok = torch.equal(got, plain)
            lib = library[mode]()[:, :ng]
            ok = ok and torch.equal(lib, got)
            line += (f"equal bit for bit: {ok}; the library call "
                     f"({'torch.topk' if mode == 'sortonly' else 'torch.roll'}"
                     f") equal too")
        else:
            ref = ov.combine_lean_plain(a.double(), b.double(), del_g, mode)
            peak = ref.abs().max(dim=1, keepdim=True).values.clamp_min(1e-300)
            k_err = ((got.double() - ref).abs() / peak).max().item()
            p_err = ((plain.double() - ref).abs() / peak).max().item()
            kp_err = ((got - plain).double().abs() / peak).max().item()
            tol = variant_f32_tol(del_g, mode)
            # kernel 1 is held to the float64 result at the full mode's
            # bound (phase 2 holds it to its own), so the two variants
            # differ from it by at most the sum of the two bounds
            k1_err = ((got - kernel1).double().abs() / peak).max().item()
            k1_tol = tol + variant_f32_tol(del_g, "full")
            ok = k_err <= tol and kp_err <= 3 * tol and k1_err <= k1_tol
            line += (f"max_abs_err {err:.3e}; of each row's peak: kernel vs "
                     f"float64 {k_err:.3e}, plain float32 vs float64 "
                     f"{p_err:.3e}, kernel vs plain {kp_err:.3e} (bound "
                     f"{tol:.2e}, {3 * tol:.2e} between the two), vs "
                     f"kernel 1 {k1_err:.3e} (bound {k1_tol:.2e})")
        if mode == "full":
            same = all(
                torch.equal(ov.combine_lean(a, b, del_g, mode, t), got)
                for t in ov.ROW_TILES[:-1])
            ok = ok and same
            line += f"; equal to itself at every row tile: {same}"
        _print(f"{line} ({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"overlap variant {mode} disagrees")
        plain_ms = _cuda_ms(lambda: ov.combine_lean_plain(a, b, del_g, mode),
                            reps=2, warmup=1)
        bound_ms, bound_by = variant_bound_ms(mode, rows, ng, presorted)
        library_ms = (_cuda_ms(library[mode], reps=10) if mode in library
                      else None)
        records[mode] = dict(max_abs_err=err, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)

    # the main path, counted on its own: the variants tool
    for mode in ov.MODES:
        ov.combine_lean.launches[mode] = 0
    times = tool.run(list(tool.NAMES), a, b, del_g)
    torch.cuda.synchronize()
    for mode, name in zip(ov.MODES, ("lean", "edges", "sortonly",
                                     "rollonly")):
        rec = records[mode]
        rec.update(ms=times[name], launches=ov.combine_lean.launches[mode])
        if rec["launches"] == 0:
            raise AssertionError(f"the tool did not launch {mode}")
        lib = ("" if rec["library_ms"] is None
               else f", library {rec['library_ms']:.4f} ms")
        _print(f"overlap_variants {mode}: {rec['ms']:.4f} ms per pair "
               f"(kernel 1: {times['current']:.4f}), plain "
               f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
               f"({rec['bound_by']}){lib}; {rec['launches']} launches")
    _print("overlap_variants full by rows per block: " + ", ".join(
        f"{t}: {times['lean' if t == ov.ROW_TILE else f'lean{t}']:.4f} ms"
        for t in ov.ROW_TILES))
    return records


def phase_sharded_lbl(profile: bool = False):
    """The LBL headline's synthesis as N_SHARDS logical wave shards through
    the packed entry, then the sharded LBL headline forward (the main
    path); returns the record."""
    import torch

    from archnemesis_tpu_torch.forward import (
        ATM_TO_PA,
        forward_nadir,
        runtime_ambient_fraction,
    )
    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.parallel.mesh import WaveMesh
    from archnemesis_tpu_torch.parallel.sharded import (
        shard_runtime_lbl,
        shard_spec,
        sharded_lbl_cross_section,
    )
    from archnemesis_tpu_torch.synthetic import LBL_NWAVE, lbl_headline

    atm, laycfg, rt, surf, cfg = lbl_headline(dtype=torch.float32,
                                              device="cuda")
    mesh = WaveMesh(n_data=1, n_wave=N_SHARDS)  # one process, no group
    rt_sh = shard_runtime_lbl(rt, mesh, dtype=torch.float32, device="cuda")
    sh, ll, blk = rt_sh.shard_data[0], rt.line_lists[0], rt.blocks[0]
    _, diag = forward_nadir(atm, laycfg, rt, None, None, surf, cfg,
                            emiss_ang=0.0, return_diagnostics=True,
                            device="cuda")
    layers = diag["layers"]
    state = (layers.temp, layers.press / ATM_TO_PA,
             runtime_ambient_fraction(cfg, layers, 0))
    host_state = [x.double().cpu().numpy() for x in state]

    k_sh = sharded_lbl_cross_section(ll, sh, mesh, *state)
    k_un = lbl_cuda.lbl_cross_section(ll, blk, *state)
    torch.cuda.synchronize()
    same = torch.equal(k_sh, k_un)
    _print(f"sharded synthesis ({N_SHARDS} shards) equals the unsharded "
           f"kernel bit for bit: {same} ({'ok' if same else 'FAIL'})")
    if not same:
        raise AssertionError("the sharded synthesis differs from kernel 2")
    specs = [shard_spec(ll, sh, s, packed=packed)
             for s, packed in zip(sh.shards, sh.packed)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = torch.cat([spec.plain(*state) for spec in specs])[:sh.n_wave]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (k_sh - plain).abs().max().item()
    _lbl_f32_check(k_sh, plain, f"sharded synthesis vs the plain version "
                   f"per shard, all {len(state[0])} layers")
    del plain

    shard_ms, bounds, nested_ms = [], [], 0.0
    for s, spec in zip(sh.shards, specs):
        ms = _cuda_ms(lambda: lbl_cuda.lbl_kernel_packed(spec, *state),
                      reps=5)
        bound_ms, bound_by, ops = lbl_bound_ms(spec.ll, spec.blocks,
                                               *host_state, itemsize=4)
        nested_ms += lbl_bound_ms(spec.ll, spec.blocks, *host_state,
                                  itemsize=4, cf_ops=LBL_OPS_CF_NESTED)[0]
        shard_ms.append(ms)
        bounds.append((bound_ms, bound_by, ops))
        halo = int(sh.line_hi[s] - sh.line_lo[s])
        _print(f"shard {s}: waves {s * spec.blocks.n_wave}-"
               f"{(s + 1) * spec.blocks.n_wave - 1} (padded), lines "
               f"[{sh.line_lo[s]}, {sh.line_hi[s]}) = {halo} of "
               f"{ll.n_lines}; kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
               f"({bound_by}, {ops:.4e} operations)")
    total_ms = _cuda_ms(lambda: sharded_lbl_cross_section(ll, sh, mesh,
                                                          *state), reps=5)
    static = lbl_cuda.kernel_inputs(lbl_cuda.make_spec(ll, blk),
                                    state[0].dtype, state[0].device)
    packed = {(state[0].dtype, state[0].device): static}
    un_ms = _cuda_ms(lambda: lbl_cuda.lbl_cross_section(
        ll, blk, *state, packed=packed), reps=5)
    un_bound, _, un_ops = lbl_bound_ms(ll, blk, *host_state, itemsize=4)
    sh_ops = sum(o for _, _, o in bounds)
    bound_ms = sum(b for b, _, _ in bounds)
    pad_waves = sh.n_shards * sh.blocks_per_shard * sh.block_width - sh.n_wave
    _print(f"sharded synthesis: {N_SHARDS} launches, {total_ms:.4f} ms "
           f"({sum(shard_ms):.4f} ms over the launches timed one by one), "
           f"bound {bound_ms:.4f} ms ({sh_ops:.4e} operations; the nested "
           f"fraction's count {nested_ms:.4f} ms); unsharded "
           f"kernel {un_ms:.4f} ms, bound {un_bound:.4f} ms ({un_ops:.4e}); "
           f"the halo and the {pad_waves} pad waves add {sh_ops - un_ops:.4e} "
           f"operations; plain {plain_ms:.1f} ms per shard in all")

    def forward(rt_run):
        return forward_nadir(atm, laycfg, rt_run, None, None, surf, cfg,
                             emiss_ang=0.0, device="cuda")

    # the main path, counted on its own
    lbl_cuda.lbl_kernel_packed.launches = 0
    spec_sh = forward(rt_sh)
    torch.cuda.synchronize()
    launches = lbl_cuda.lbl_kernel_packed.launches
    if launches != N_SHARDS:
        raise AssertionError(f"{launches} packed launches, expected "
                             f"{N_SHARDS}")
    spec_un = forward(rt)
    if spec_sh.shape != (LBL_NWAVE, 1) or not torch.isfinite(spec_sh).all():
        raise AssertionError("sharded LBL spectrum not finite")
    torch.testing.assert_close(spec_sh, spec_un, rtol=1e-6, atol=0)
    times = {}
    for name, rt_run in (("sharded", rt_sh), ("unsharded", rt),
                         ("sharded again", rt_sh)):
        t = []
        for i in range(HEADLINE_RUNS + 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            forward(rt_run)
            end.record()
            end.synchronize()
            if i >= 2:
                t.append(start.elapsed_time(end))
        times[name] = float(np.median(t))
    _print(f"LBL headline forward, {N_SHARDS} wave shards in one process: "
           f"median {times['sharded']:.3f} / {times['sharded again']:.3f} ms "
           f"against {times['unsharded']:.3f} ms unsharded (spectra equal "
           f"{torch.equal(spec_sh, spec_un)}, within rtol 1e-6); "
           f"{launches} packed launches per forward")
    if profile:
        profile_forward(lambda: forward(rt_sh),
                        what="sharded LBL headline forward",
                        trace="build/lbl_sharded_trace.json")
    return dict(launches=launches, max_abs_err=err, ms=total_ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bounds[0][1], library_ms=None)


def phase_distributed():
    """The wave-sharded forward on the card through a one-rank NCCL group:
    jupiter_nadir (k-tables) and co_runtime (runtime LBL), sharded against
    unsharded; returns the packed launches of one runtime evaluation."""
    import torch
    import torch.distributed as dist

    from archnemesis_tpu_torch.ops import lbl_cuda
    from archnemesis_tpu_torch.parallel import multihost
    from archnemesis_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_ktables_by_wave,
    )
    from archnemesis_tpu_torch.parallel.sharded import shard_runtime_lbl
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    with tempfile.TemporaryDirectory() as tmp:
        rank = multihost.initialize(init_method=f"file://{tmp}/store",
                                    world_size=1, rank=0)
        try:
            backend = dist.get_backend()
            mesh = make_mesh(n_wave=N_SHARDS)
            if (rank, backend, mesh.world) != (0, "nccl", 1) or (
                    mesh.group is None):
                raise AssertionError(f"rank {rank}, backend {backend}")
            plain = make_retrieval_setup(DECK, "cirstest", device="cuda",
                                         wave_pad_multiple=N_SHARDS)
            sharded = make_retrieval_setup(
                DECK, "cirstest", device="cuda", wave_pad_multiple=N_SHARDS,
                ktab_transform=lambda kt: shard_ktables_by_wave(kt, mesh))
            xa = torch.as_tensor(plain.sv.xa, device="cuda")
            y0, y1 = plain.forward_fn(xa), sharded.forward_fn(xa)
            np.testing.assert_allclose(
                y1.cpu().numpy(), y0.cpu().numpy(), rtol=1e-12,
                atol=1e-14 * y0.abs().max().item())
            nx = xa.shape[0]
            basis = torch.eye(nx, dtype=xa.dtype,
                              device="cuda")[[0, nx // 2, nx - 1]]

            def columns(fn):
                return torch.func.vmap(
                    lambda v: torch.func.jvp(fn, (xa,), (v,))[1])(basis)

            j0, j1 = columns(plain.forward_fn), columns(sharded.forward_fn)
            np.testing.assert_allclose(
                j1.cpu().numpy(), j0.cpu().numpy(), rtol=1e-10,
                atol=1e-12 * j0.abs().max().item())
            _print(f"jupiter_nadir float64 over {N_SHARDS} wave shards "
                   f"({backend} group of {mesh.world}, file:// store; NY = "
                   f"{y0.shape[0]}): forward equal to unsharded at rtol "
                   f"1e-12, 3 Jacobian columns at rtol 1e-10 (max diff "
                   f"{(y1 - y0).abs().max().item():.3e} / "
                   f"{(j1 - j0).abs().max().item():.3e})")

            deck = copy_runtime_deck(os.path.join(tmp, "co"))
            rt_plain = make_retrieval_setup(deck, "cirstest", device="cuda")
            rt_sharded = make_retrieval_setup(
                deck, "cirstest", device="cuda",
                ktab_transform=lambda rt: shard_runtime_lbl(
                    rt, mesh, dtype=torch.float64, device="cuda"))
            xr = torch.as_tensor(rt_plain.sv.xa, device="cuda")
            yn0, kk0 = forward_and_jacobian(rt_plain.forward_fn, xr)
            lbl_cuda.lbl_kernel_packed.launches = 0
            yn1, kk1 = forward_and_jacobian(rt_sharded.forward_fn, xr)
            torch.cuda.synchronize()
            launches = lbl_cuda.lbl_kernel_packed.launches
            if launches != N_SHARDS:
                raise AssertionError(f"{launches} packed launches per "
                                     f"evaluation, expected {N_SHARDS}")
            np.testing.assert_allclose(yn1.cpu().numpy(), yn0.cpu().numpy(),
                                       rtol=1e-12, atol=0)
            col_peak = kk0.abs().max(dim=0).values
            np.testing.assert_array_less(
                (kk1 - kk0).abs().cpu().numpy(),
                (1e-10 * kk0.abs() + 1e-10 * col_peak[None, :]).cpu().numpy()
                + np.finfo(np.float64).tiny)
            _print(f"co_runtime float64, runtime deck over {N_SHARDS} wave "
                   f"shards through the group: spectrum equal to unsharded "
                   f"at rtol 1e-12, Jacobian ({kk1.shape[1]} columns) at rtol "
                   f"1e-10 + 1e-10 of each column's peak; {launches} packed "
                   "launches per evaluation")
        finally:
            dist.destroy_process_group()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    card = phase_build()
    record = phase_kernel_vs_plain()
    phase_golden_deck()
    profile = "--profile" in sys.argv[1:]
    launches, _ = phase_headline(profile=profile)
    tan_record = phase_tangent_kernel_vs_plain()
    tan_launches = phase_retrieval(profile=profile)
    lbl_record = phase_lbl_kernel_vs_plain()
    phase_lbl_golden_deck()
    lbl_launches, _ = phase_lbl_headline(profile=profile)
    phase_lbl_retrieval()
    fma_record = phase_fma_peak()
    variant_records = phase_overlap_variants()
    packed_record = phase_sharded_lbl(profile=profile)
    phase_distributed()

    kernels = [dict(
        name="overlap_combine",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/overlap_combine.cu",
        replaces="archnemesis_tpu/ops/overlap_pallas.py:398",
        launches=launches,
        max_abs_err=record["max_abs_err"],
        ms=record["ms"],
        plain_ms=record["plain_ms"],
        bound_ms=record["bound_ms"],
        bound_by=record["bound_by"],
        library_ms=None,
    ), dict(
        name="overlap_combine_tan",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/overlap_combine.cu",
        replaces="archnemesis_tpu/ops/overlap_pallas.py:292",
        launches=tan_launches,
        max_abs_err=tan_record["max_abs_err"],
        ms=tan_record["ms"],
        plain_ms=tan_record["plain_ms"],
        bound_ms=tan_record["bound_ms"],
        bound_by=tan_record["bound_by"],
        library_ms=None,
    ), dict(
        name="lbl_cross_section",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/lbl_cross_section.cu",
        replaces="archnemesis_tpu/ops/lbl_pallas.py:228",
        launches=lbl_launches,
        max_abs_err=lbl_record["max_abs_err"],
        ms=lbl_record["ms"],
        plain_ms=lbl_record["plain_ms"],
        bound_ms=lbl_record["bound_ms"],
        bound_by=lbl_record["bound_by"],
        library_ms=None,
    ), dict(
        name="lbl_cross_section_packed",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/lbl_cross_section.cu",
        replaces="archnemesis_tpu/ops/lbl_pallas.py:312",
        **packed_record,
    )]
    kernels += [dict(
        name=f"overlap_variants_{mode}",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/overlap_variants.cu",
        replaces="tools/bench_overlap_variants.py:131",
        **rec,
    ) for mode, rec in variant_records.items()]
    kernels.append(dict(
        name="fma_peak",
        route="cuda",
        source="archnemesis_tpu_torch/csrc/fma_peak.cu",
        replaces="tools/bench_vpu_peak.py:39",
        **fma_record,
    ))
    _print(f"total {time.perf_counter() - t0:.1f} s")
    _print(card)
    _print(json.dumps({"kernels": kernels}))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
