"""Inputs shared by the tests that hold the PyTorch port against the JAX
package (``tests/test_torch_*.py``).

The same numbers go to both packages: a JAX structure is flattened with
``flat`` (its fields as numpy arrays, static fields as they are) and
carried across with ``archnemesis_tpu_torch.convert``.
"""

import dataclasses

import numpy as np
import torch

import chip_smoke
from chip_smoke import tiefree_overlap_inputs  # noqa: F401

from archnemesis_tpu.core.spectra import (
    AerosolOptics,
    KTables,
    SurfaceSpec,
)
from archnemesis_tpu.core.types import Atmosphere, LayerConfig
from archnemesis_tpu.enums import (
    ParaH2Ratio,
    RayleighScatteringMode,
    WaveUnit,
)
from archnemesis_tpu.forward import make_forward_config
from archnemesis_tpu.io.cia import read_cia_tab
from archnemesis_tpu.io.ktables import read_kls
from archnemesis_tpu_torch import convert

LAYER_GOLDEN = "tests/goldens/jupiter_layering.npz"
FM_GOLDEN = "tests/goldens/jupiter_nadir_fm.npz"
DECK = "tests/fixtures/jupiter_nadir"
CIA_TAB = "archnemesis_tpu/data/reference_data/cia/isotest.tab"


def flat(obj) -> dict:
    """A JAX structure's fields: arrays as numpy, static fields as they are."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        static = f.metadata.get("static", False)
        out[f.name] = v if static or not hasattr(v, "__array__") else np.asarray(v)
    return out


def to_port(deck, device="cpu"):
    """Carry a JAX (atm, laycfg, ktab, cia, aero, surf, cfg) deck across."""
    atm, laycfg, ktab, cia, aero, surf, cfg = deck

    def opt(fn, x):
        return None if x is None else fn(flat(x), device=device)

    return (
        convert.atmosphere(flat(atm), device=device),
        convert.layer_config(flat(laycfg)),
        convert.ktables(flat(ktab), device=device),
        opt(convert.cia_tables, cia),
        opt(convert.aerosol_optics, aero),
        opt(convert.surface_spec, surf),
        convert.forward_config(flat(cfg)),
    )


def layering_atmosphere():
    """(Atmosphere, golden npz) of the Jupiter layering golden, JAX side."""
    dl = np.load(LAYER_GOLDEN)
    atm = Atmosphere(
        h=dl["H"], p=dl["P"], t=dl["T"], vmr=dl["VMR"], dust=dl["DUST"],
        parah2=dl["PARAH2"], molwt=dl["MOLWT"], radius=dl["RADIUS"],
        latitude=dl["LATITUDE"],
        gas_id=tuple(int(x) for x in dl["ID"]),
        iso_id=tuple(int(x) for x in dl["ISO"]),
        planet=int(dl["PLANET"]),
        dust_units_flag=tuple(int(x) for x in dl["DUST_UNITS_FLAG"]) or None,
    )
    return atm, dl


def jax_golden_deck():
    """The jupiter_nadir deck as ``tests/test_forward_nadir.py`` builds it."""
    atm, dl = layering_atmosphere()
    laycfg = LayerConfig(
        nlay=int(dl["NLAY"]), laytyp=int(dl["LAYTYP"]),
        layint=int(dl["LAYINT"]),
        layht=max(float(dl["LAYHT"]), float(dl["H"][0])),
    )
    wave = np.load(FM_GOLDEN)["WAVE"]
    ktab = KTables.from_tables(read_kls(
        f"{DECK}/cirstest.kls", wavemin=wave.min(), wavemax=wave.max()))
    cia = read_cia_tab(CIA_TAB, dnu=1.0, npara=0, inormal=ParaH2Ratio.NORMAL)
    xsc_wave = np.array([0.0, 700.0, 750.0, 900.0, 950.0, 2000.0])
    aero = AerosolOptics(wave=xsc_wave, kext=np.zeros((6, 1)),
                         ksca=np.zeros((6, 1)))
    surf = SurfaceSpec(tsurf=np.asarray(0.0), vem=np.array([0.0, 1e5]),
                       emissivity=np.zeros(2), galb=np.asarray(0.0),
                       gasgiant=True)
    cfg = make_forward_config(
        atm, ktab, cia, iray=RayleighScatteringMode.GAS_GIANT_ATM,
        ispace=WaveUnit.Wavenumber_cm, gasgiant=True,
    )
    return atm, laycfg, ktab, cia, aero, surf, cfg


def jax_headline_deck(nwave):
    """The synthetic 7-gas configuration (``archnemesis_tpu_torch.synthetic``)
    as JAX float64 structures: (atm, laycfg, ktab, None, None, surf, cfg)."""
    from archnemesis_tpu_torch.synthetic import GAS_IDS, ISO_IDS, NLAY, headline_arrays

    a = headline_arrays(nwave)
    atm = Atmosphere(
        h=a["h"], p=a["p"], t=a["t"], vmr=a["vmr"], dust=a["dust"],
        parah2=a["parah2"], molwt=a["molwt"], radius=a["radius"],
        latitude=a["latitude"], gas_id=GAS_IDS, iso_id=ISO_IDS, planet=5,
    )
    laycfg = LayerConfig(nlay=NLAY, laytyp=1, layint=1, layht=float(a["h"][0]))
    ktab = KTables(wave=a["wave"], g_ord=a["g_ord"], del_g=a["del_g"],
                   press=a["press"], temp=a["temp"], k=a["k"],
                   gas_id=GAS_IDS, iso_id=ISO_IDS)
    surf = SurfaceSpec(tsurf=np.asarray(0.0), vem=np.array([0.0, 1e5]),
                       emissivity=np.zeros(2), galb=np.asarray(0.0),
                       gasgiant=True)
    cfg = make_forward_config(
        atm, ktab, None, iray=RayleighScatteringMode.GAS_GIANT_ATM,
        ispace=WaveUnit.Wavenumber_cm, gasgiant=True,
    )
    return atm, laycfg, ktab, None, None, surf, cfg


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


def np64(x):
    """numpy float64 copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


FDRET = "tests/fixtures/jupiter_fdret"


def flat_deck(deck) -> dict:
    """A JAX ``Deck``'s fields for ``convert.deck``: the component
    structures and the host dataclasses flattened, the rest as they are."""
    out = {}
    for f in dataclasses.fields(deck):
        v = getattr(deck, f.name)
        out[f.name] = flat(v) if dataclasses.is_dataclass(v) else v
    return out


def flat_state_vector(sv) -> dict:
    """A JAX ``StateVector``'s fields for ``convert.state_vector``."""
    out = {f.name: getattr(sv, f.name) for f in dataclasses.fields(sv)}
    out["entries"] = [
        {**{f.name: getattr(e, f.name) for f in dataclasses.fields(e)},
         "target": e.target.value}
        for e in sv.entries
    ]
    return out


def copy_deck(tmp_path_factory, name, deck=FDRET):
    """A temporary copy of a deck with the shared k-tables linked beside it
    (the deck's .kls names them by relative path); returns the deck
    directory."""
    return chip_smoke.copy_deck(deck, str(tmp_path_factory.mktemp(name)))
