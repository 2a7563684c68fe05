"""The repository's two synthetic throughput configurations.

The 7-gas Jupiter correlated-k configuration (``bench.py``'s headline
case): an 81-level Jupiter-like profile cut into 71 equal-log-pressure
layers, seven gases (H2, He, C2H2, C2H6, CH4, C2H4, NH3) with k-tables on
8192 waves x 20 Gauss-Legendre g-ordinates x 15 pressures x 12
temperatures, made from a seed. ``headline_arrays`` returns the numbers as
float64 numpy (so another implementation can be fed the same inputs);
``headline_deck`` builds the port's structures from them.

The runtime line-by-line configuration (``bench.py:68-137``, its LBL case):
the CO line list of ``tests/fixtures/linedata`` tiled 60 times with jittered
centres, synthesised on 80,000 waves at 0.001 cm-1 through a 41-level
Mars-like profile cut into 40 layers (``lbl_headline``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from archnemesis_tpu_torch.core.spectra import KTables, SurfaceSpec
from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
from archnemesis_tpu_torch.enums import RayleighScatteringMode, WaveUnit
from archnemesis_tpu_torch.forward import make_forward_config
from archnemesis_tpu_torch.io.linedata import RuntimeLBL, read_ans_linedata
from archnemesis_tpu_torch.ops.ktab import host_log_ktable
from archnemesis_tpu_torch.utils.device import resolve_device

NWAVE, NG, NLAY, NPRO = 8192, 20, 71, 81
GAS_IDS = (39, 40, 26, 27, 6, 28, 11)
ISO_IDS = (0, 0, 0, 0, 1, 0, 0)


def headline_arrays(nwave: int = NWAVE, seed: int = 0) -> dict:
    """Profiles and k-tables of the configuration, float64 numpy.

    ``nwave`` cuts the wave grid (same span, fewer points); every other
    width is the full one.
    """
    rng = np.random.default_rng(seed)
    h = np.linspace(-8.0e4, 4.0e5, NPRO)
    p = 1.0e6 * np.exp(-(h - h[0]) / 4.0e4)
    t = 165.0 + 140.0 * np.exp(-(h - h[0]) / 1.2e5)
    vmr = np.concatenate([
        np.full((NPRO, 1), 0.86),
        np.full((NPRO, 1), 0.13),
        np.full((NPRO, 5), 2.0e-3),
    ], axis=1)

    x, w = np.polynomial.legendre.leggauss(NG)
    g_ord, del_g = 0.5 * (x + 1), 0.5 * w
    wave = np.linspace(5.0, 1500.0, nwave)
    press_grid = np.logspace(-8, np.log10(20.0), 15)
    temp_grid = np.linspace(70.0, 400.0, 12)
    centres = rng.uniform(100, 1400, 8)
    band = 1e-4 + np.exp(
        -0.5 * ((wave[:, None] - centres[None, :]) / 80.0) ** 2
    ).sum(1)
    k = (
        2e-22
        * band[None, :, None, None, None]
        * np.exp(2.5 * (g_ord - 0.7))[None, None, :, None, None]
        * (press_grid / press_grid.max())[None, None, None, :, None] ** 0.15
        * (temp_grid / 150.0)[None, None, None, None, :] ** -0.5
        * np.ones((len(GAS_IDS), 1, 1, 1, 1))
    )
    return dict(
        h=h, p=p, t=t, vmr=vmr, dust=np.zeros((NPRO, 0)),
        parah2=np.zeros(NPRO), molwt=np.full(NPRO, 2.3e-3),
        radius=np.asarray(7.1492e7), latitude=np.asarray(0.0),
        wave=wave, g_ord=g_ord, del_g=del_g, press=press_grid,
        temp=temp_grid, k=k,
    )


def headline_deck(nwave: int = NWAVE, dtype=torch.float32, device=None,
                  seed: int = 0):
    """(atm, laycfg, ktab, surf, cfg) of the configuration on ``device``
    (None = CUDA) in ``dtype``. Below float64 the k-table carries its
    host-float64 log table (``host_log_ktable``), as the float32 path
    requires."""
    device = resolve_device(device)
    a = headline_arrays(nwave, seed)

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    atm = Atmosphere(
        h=dev(a["h"]), p=dev(a["p"]), t=dev(a["t"]), vmr=dev(a["vmr"]),
        dust=dev(a["dust"]), parah2=dev(a["parah2"]), molwt=dev(a["molwt"]),
        radius=dev(a["radius"]), latitude=dev(a["latitude"]),
        gas_id=GAS_IDS, iso_id=ISO_IDS, planet=5,
    )
    laycfg = LayerConfig(nlay=NLAY, laytyp=1, layint=1, layht=float(a["h"][0]))
    narrow = torch.finfo(dtype).bits < 64
    ktab = KTables(
        wave=dev(a["wave"]), g_ord=dev(a["g_ord"]), del_g=dev(a["del_g"]),
        press=dev(a["press"]), temp=dev(a["temp"]), k=dev(a["k"]),
        logk=(torch.as_tensor(host_log_ktable(a["k"]), device=device)
              if narrow else None),
        gas_id=GAS_IDS, iso_id=ISO_IDS,
    )
    surf = SurfaceSpec(
        tsurf=dev(0.0), vem=dev([0.0, 1e5]), emissivity=dev(np.zeros(2)),
        galb=dev(0.0), gasgiant=True,
    )
    cfg = make_forward_config(
        atm, ktab, None, iray=RayleighScatteringMode.GAS_GIANT_ATM,
        ispace=WaveUnit.Wavenumber_cm, gasgiant=True,
    )
    return atm, laycfg, ktab, surf, cfg


# the CO line list and partition function of
# tests/fixtures/linedata/CO_1_ambient_AIR.h5, exported for machines without
# h5py (io.linedata.export_ans_linedata)
LBL_LINEDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "CO_1_ambient_AIR.npz")
LBL_NWAVE, LBL_NLAY, LBL_NPRO = 80_000, 40, 41
LBL_GAS_IDS, LBL_ISO_IDS = (5, 2), (1, 0)
LBL_WINDOW = (2100.0, 2200.0)


def lbl_line_list():
    """The CO line list tiled 60 times, each copy's centres shifted by one
    uniform draw in [-20, 20] cm-1 (``default_rng(1)``), strengths divided
    by 60, sorted by centre: a CH4-like line density at a stated shape."""
    ll = read_ans_linedata(LBL_LINEDATA, gas_id=5, iso_id=1)
    rng = np.random.default_rng(1)
    reps = 60
    nu = np.concatenate(
        [ll.nu + rng.uniform(-20.0, 20.0) for _ in range(reps)]
    )
    order = np.argsort(nu)

    def tile(a):
        return np.concatenate([a] * reps)[order]

    return dataclasses.replace(
        ll, nu=nu[order], sw=tile(ll.sw) / reps, elower=tile(ll.elower),
        stim_ref=tile(ll.stim_ref),
        broad=np.stack([tile(ll.broad[i]) for i in range(6)]),
    )


def lbl_headline_arrays(nwave: int = LBL_NWAVE) -> dict:
    """Profiles and wave grid of the configuration, float64 numpy;
    ``nwave`` cuts the grid (same start and step, fewer points)."""
    h = np.linspace(0.0, 8.0e4, LBL_NPRO)
    return dict(
        h=h, p=700.0 * np.exp(-h / 1.1e4), t=210.0 - 60.0 * (h / 8.0e4),
        vmr=np.concatenate([np.full((LBL_NPRO, 1), 8.0e-4),
                            np.full((LBL_NPRO, 1), 0.95)], axis=1),
        dust=np.zeros((LBL_NPRO, 0)), parah2=np.zeros(LBL_NPRO),
        molwt=np.full(LBL_NPRO, 43.5e-3), radius=np.asarray(3.39e6),
        latitude=np.asarray(0.0),
        wave=np.arange(2110.0, 2190.0, 0.001)[:nwave],
    )


def lbl_headline(nwave: int = LBL_NWAVE, dtype=torch.float32, device=None):
    """(atm, laycfg, rt, surf, cfg) of the runtime line-by-line
    configuration: the atmosphere and surface on ``device`` (None = CUDA)
    in ``dtype``, the ``RuntimeLBL`` (float64 host line data, Voigt, 25 /
    75 cm-1 windows, pressure shift on, no continuum, as
    ``tests/fixtures/co_runtime/cirstest.lls``) windowed to 2100-2200 cm-1:
    5,092 lines on 625 blocks of 128 waves at full width."""
    device = resolve_device(device)
    a = lbl_headline_arrays(nwave)

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    rt = RuntimeLBL(
        wave=a["wave"], gas_id=(5,), iso_id=(1,),
        line_lists=(lbl_line_list(),), lineshape=("voigt",),
        wn_calc_window=(25.0,), wn_approx_window=(75.0,), s_floor=(0.0,),
        include_pressure_shift=(True,), include_continuum=(False,),
    ).windowed(*LBL_WINDOW)
    atm = Atmosphere(
        h=dev(a["h"]), p=dev(a["p"]), t=dev(a["t"]), vmr=dev(a["vmr"]),
        dust=dev(a["dust"]), parah2=dev(a["parah2"]), molwt=dev(a["molwt"]),
        radius=dev(a["radius"]), latitude=dev(a["latitude"]),
        gas_id=LBL_GAS_IDS, iso_id=LBL_ISO_IDS, planet=4,
    )
    laycfg = LayerConfig(nlay=LBL_NLAY, laytyp=1, layint=1, layht=0.0)
    surf = SurfaceSpec(
        tsurf=dev(0.0), vem=dev([0.0, 1e5]), emissivity=dev(np.zeros(2)),
        galb=dev(0.0), gasgiant=True,
    )
    cfg = make_forward_config(
        atm, rt, None, iray=RayleighScatteringMode.NOT_INCLUDED,
        ispace=WaveUnit.Wavenumber_cm, gasgiant=True,
    )
    return atm, laycfg, rt, surf, cfg
