#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``archnemesis_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Needs one CUDA card and ``nvcc`` (``/usr/local/cuda``); exits non-zero
without them. Phases, each of which fails the run on its own:

1. device and build: the card's name and power limit, the torch/CUDA
   versions; the random-overlap kernel built from
   ``archnemesis_tpu_torch/csrc/overlap_combine.cu`` with the build time
   and ptxas' register report;
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

then a JSON line of the kernels (launches on the main path, error, times,
bound) and, last, ``{"ok": true, "device": {...}}``. ``--profile`` adds a
``torch.profiler`` trace of three headline forwards: device time by kernel,
the device's busy share, and a Chrome trace in ``build/``.

TF32 is switched off for matmuls and cuDNN: the g-quadrature and emission
``einsum``s must run in full float32, as the JAX package computes them.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

LAYER_GOLDEN = "tests/goldens/jupiter_layering.npz"
FM_GOLDEN = "tests/goldens/jupiter_nadir_fm.npz"
DECK = "tests/fixtures/jupiter_nadir"
CIA_TAB = "archnemesis_tpu/data/reference_data/cia/isotest.tab"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

F32_BOUNDS = (1.0e-4, 1.0e-5)  # max / median relative error vs float64
HEADLINE_RUNS = 12


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


def profile_forward(forward, runs: int = 3):
    """Device time by kernel and the device's busy share over ``runs``
    forwards (``torch.profiler``); the trace goes to ``build/``."""
    import os

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
    _print(f"profile of {runs} headline forwards: wall {wall_us / 1e3:.3f} "
           f"ms, device busy {busy_us / 1e3:.3f} ms "
           f"(share {busy_us / wall_us:.4f})")
    for e in kernels[:15]:
        _print(f"  {e.self_device_time_total / runs / 1e3:9.4f} ms/forward "
               f"{e.count // runs:5d} launches/forward  {e.key[:100]}")
    os.makedirs("build", exist_ok=True)
    prof.export_chrome_trace("build/headline_trace.json")


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
    launches, _ = phase_headline(profile="--profile" in sys.argv[1:])

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
