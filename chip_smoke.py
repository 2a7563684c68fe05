#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``archnemesis_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``); exits non-zero
without them. Phases, each of which fails the run on its own:

1. device and build: the card's name and power limit, the torch/CUDA
   versions; the random-overlap kernels (primal and tangent variant, one
   source) built from ``archnemesis_tpu_torch/csrc/overlap_combine.cu``
   with the build time and ptxas' register report;
2. kernel vs plain: the kernel against its plain PyTorch version at NG
   10, 20 and 32 (the largest the kernel takes) in float32 (rtol 2e-5,
   atol 1e-7, the JAX package's own Pallas-vs-XLA bound) and float64
   (rtol 1e-12), with tied and all-zero rows, and at the headline's
   581,632 rows. Every float32 kernel result is also held to the float64
   result of the same inputs at the float32 bound, which alone holds at
   NG=32: there the plain float32 version's own error nears the bound.
   Both float32 versions' errors against float64 are printed;
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
   of the same inputs, and against the float32 plain version up to NG = 20; the fused primal equal to the primal kernel's bit
   for bit, also on tied and all-zero rows, where the tangents need only be
   finite (they depend on the order of equal keys). Times at T = 81,
   R = 39,689, NG = 20 in both types beside the bound;
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

then a JSON line of the kernels (launches on the main paths, error, times,
bound) and, last, ``{"ok": true, "device": {...}}``. ``--profile`` adds
``torch.profiler`` traces of three headline forwards and of one
forward-plus-Jacobian evaluation: device time by kernel, the device's busy
share, and Chrome traces in ``build/``.

TF32 is switched off for matmuls and cuDNN: the g-quadrature and emission
``einsum``s must run in full float32, as the JAX package computes them.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
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
# the retrieval's pair combine: 559 waves x 71 layers, 81 state elements
TAN_ROWS, TAN_NTAN = 39_689, 81


def rel_err(a, b):
    """|a - b| / max(|b|, 1e-3 max|b|), elementwise."""
    scale = np.abs(b).max()
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3 * scale)


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
    import torch

    from archnemesis_tpu_torch.ops import overlap_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _print(f"card: {card}")
    _print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"device {torch.cuda.get_device_name(0)}")
    built = overlap_cuda.build()
    _print(f"built {built['path']} in {built['seconds']:.2f} s")
    _print(built["ptxas"].strip())
    return card


def phase_kernel_vs_plain():
    """Kernel vs plain on the card; returns the headline-shape record."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_plain,
    )

    tols = {torch.float32: dict(rtol=2e-5, atol=1e-7),
            torch.float64: dict(rtol=1e-12, atol=0.0)}
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
        ref = combine_pair_plain(a, b, del_g)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        line = (f"kernel vs plain NG={ng} {dtype} rows={rows}: "
                f"max_abs_err={err:.3e}")
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
        ok = all(checks)
        _print(f"{line} ({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"kernel disagrees with plain ({ng}, {dtype})")
        if rows == rows_full:
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


def phase_tangent_kernel_vs_plain():
    """Fused primal + tangent kernel vs plain on the card; returns the
    float32 record at the retrieval's shape."""
    import torch

    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_with_tangents,
        combine_pair_with_tangents_plain,
    )

    def on_card(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device="cuda")

    cases = [(ng, t, 4096) for ng in (10, 20, 32) for t in (1, 3, TAN_NTAN)]
    cases.append((20, TAN_NTAN, TAN_ROWS))
    record = None
    for ng, n_tan, rows in cases:
        del_g = gauss_del_g(ng)
        ta, tb = tiefree_overlap_inputs(rows, ng, seed=ng + n_tan)
        rng = np.random.default_rng(rows + n_tan)
        dta = rng.standard_normal((n_tan, rows, ng))
        dtb = rng.standard_normal((n_tan, rows, ng))
        a64, b64, da64, db64 = (on_card(x, torch.float64)
                                for x in (ta, tb, dta, dtb))
        _, ref64 = combine_pair_with_tangents_plain(a64, b64, da64, db64,
                                                    del_g)
        peak = ref64.abs().max().item()
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
            line = (f"tangent kernel vs plain NG={ng} T={n_tan} rows={rows} "
                    f"{dtype}: max_abs_err={err:.3e} (peak {peak:.3e})")
            if dtype == torch.float32 and ng <= 20:
                _, ref32 = combine_pair_with_tangents_plain(a, b, da, db,
                                                            del_g)
                e32 = (dout - ref32).abs().max().item()
                checks.append(e32 <= tol * peak)
                line += f"; vs float32 plain {e32:.3e}"
            ok = all(checks)
            _print(f"{line} ({'ok' if ok else 'FAIL'})")
            if not ok:
                raise AssertionError(
                    f"tangent kernel disagrees ({ng}, {n_tan}, {dtype})")
            if rows != TAN_ROWS:
                continue
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
            if dtype == torch.float32:
                record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)

    # tied and all-zero rows: the primal is the primal kernel's bit for bit;
    # the tangents depend on the order of equal keys and need only be finite
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
    _print("tied and all-zero rows: fused primal equals the primal kernel's, "
           "tangents finite")
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
    )]
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
