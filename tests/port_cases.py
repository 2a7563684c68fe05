"""Inputs shared by the tests that hold the PyTorch port against the JAX
package (``tests/test_torch_*.py``).

The same numbers go to both packages: a JAX structure is flattened with
``flat`` (its fields as numpy arrays, static fields as they are) and
carried across with ``archnemesis_tpu_torch.convert``.
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
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
from archnemesis_tpu import forward as jfwd
from archnemesis_tpu.core.spectra import HapkeParams as JHapke
from archnemesis_tpu.forward import make_forward_config
from archnemesis_tpu.io.cia import read_cia_tab
from archnemesis_tpu.io.ktables import read_kls
from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
from archnemesis_tpu.rt.scattering import ScatterQuadrature as JQuad
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch import forward as tfwd
from archnemesis_tpu_torch.core.spectra import HapkeParams
from archnemesis_tpu_torch.enums import LowerBoundaryCondition
from archnemesis_tpu_torch.io.legacy import load_deck as port_load_deck
from archnemesis_tpu_torch.ops.convolution import conv_channel_interp
from archnemesis_tpu_torch.rt.scattering import ScatterQuadrature

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


# g-bins of which one element of the combine can span a whole bin, and two
# bins narrower than the float32 combine's 128-eps slack on the g-axis
WIDE_DEL_G = np.array([0.45, 0.01, 0.44, 5e-6, 5e-6, 0.09999])
WIDE_DEL_G = WIDE_DEL_G / WIDE_DEL_G.sum()


def wide_overlap_inputs(rows: int, seed: int) -> tuple:
    """Two (rows, 6) float64 arrays on one scale, sorted along g, for
    ``WIDE_DEL_G``: many rows put a wide element across a narrow bin."""
    rng = np.random.default_rng(seed)
    return tuple(np.sort(rng.uniform(0, 1, (2, rows, WIDE_DEL_G.size)),
                         axis=2))


def overlap_inputs(rows: int, ng: int, seed: int) -> tuple:
    """Two (rows, NG) float64 arrays of sorted k-distributions with tied
    and all-zero rows (as the JAX package's Pallas tests make them)."""
    rng = np.random.default_rng(seed)
    ta = np.sort(rng.uniform(0, 4, (rows, ng)), axis=1)
    tb = np.sort(rng.uniform(0, 2, (rows, ng)), axis=1)
    ta[:10] = 0.0
    tb[5:15] = 0.0
    return ta, tb


WARP = 32  # lanes of the kernels' warps


def kernel_scan(w: np.ndarray, keys=None) -> np.ndarray:
    """Inclusive prefix sum of ``w`` (of ``keys * w`` where ``keys`` is
    given) as the combine kernels take it, in w's dtype: lane l scans its
    slice of ceil(n / 32) rounded up to odd elements in order (with keys, a
    fused multiply-add an element, each rounded once), the warp scans the
    slices' totals (Hillis-Steele, shuffles up by 1, 2, 4, 8, 16), and each
    slice adds the totals before it."""
    dtype = w.dtype.type
    n = w.size
    size = ((n + WARP - 1) // WARP) | 1
    bounds = [(min(lane * size, n), min(lane * size + size, n))
              for lane in range(WARP)]
    ghi = np.zeros(n, dtype)
    totals = np.zeros(WARP, dtype)
    for lane, (b, e) in enumerate(bounds):
        if e <= b:
            continue
        if keys is None:
            ghi[b:e] = np.cumsum(w[b:e], dtype=dtype)
        else:
            run = 0.0
            for i in range(b, e):
                # float32: the product is exact in float64, and the sum
                # rounds there before it rounds to float32; float64: two
                # roundings. Either is within an ulp of the fused one.
                run = dtype(float(keys[i]) * float(w[i]) + float(run))
                ghi[i] = run
        totals[lane] = ghi[e - 1]
    incl = totals.copy()
    step = 1
    while step < WARP:
        up = np.concatenate([np.zeros(step, dtype), incl[:-step]])
        incl = np.where(np.arange(WARP) >= step, incl + up, incl).astype(dtype)
        step *= 2
    offset = np.concatenate([np.zeros(1, dtype), incl[:-1]])
    for lane, (b, e) in enumerate(bounds):
        ghi[b:e] = ghi[b:e] + offset[lane]
    return ghi


def np64(x):
    """numpy float64 copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


FDRET = "tests/fixtures/jupiter_fdret"

# computed on read (molwt, gravity radius, unit conversions, cia amagat
# scaling); everything else is parsed text and must be equal
COMPUTED = {"molwt", "radius", "k_cia"}


def assert_same_structure(got, want, name):
    """A port structure (tensors) field by field against the JAX package's
    (numpy): equal, or within rtol 1e-12 for the fields in ``COMPUTED``;
    nested structures (Hapke blocks) compared the same way."""
    if want is None:
        assert got is None, name
        return
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if not hasattr(got, f.name):
            assert w is None, f"{name}.{f.name} not carried"
            continue
        g = getattr(got, f.name)
        label = f"{name}.{f.name}"
        if w is None:
            assert g is None, label
        elif dataclasses.is_dataclass(w):
            assert_same_structure(g, w, label)
        elif isinstance(g, torch.Tensor) or isinstance(w, np.ndarray) \
                or hasattr(w, "__array__"):
            g, w = np64(g), np.asarray(w, dtype=np.float64)
            assert g.shape == w.shape, label
            if f.name in COMPUTED:
                np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=label)
            else:
                np.testing.assert_array_equal(g, w, err_msg=label)
        elif isinstance(w, (tuple, list)) and w and hasattr(w[0], "__array__"):
            for gi, wi in zip(g, w):
                np.testing.assert_array_equal(np64(gi), np.asarray(wi))
        else:
            # enums compare by value across the two packages
            assert (int(g) if hasattr(g, "value") else g) == \
                (int(w) if hasattr(w, "value") else w), label


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


def thin_fdret(base, nchan: int = 32, nlay: int = 16) -> str:
    """A copy of ``jupiter_fdret`` under ``base`` thinned as the JAX
    package's ``tests/test_nested_deck.py:_thin_deck`` thins it (its first
    ``nchan`` channels, ``nlay`` layers; the same pipeline and file
    formats); returns the deck directory."""
    import re

    deck = chip_smoke.copy_deck(FDRET, str(base))
    spx = os.path.join(deck, "cirstest.spx")
    lines = open(spx).read().splitlines()
    nconv = int(float(lines[1].split()[0]))
    head, chans = lines[:4], lines[4:4 + nconv]
    head[1] = f"        {nchan}"
    open(spx, "w").write("\n".join(head + chans[:nchan]) + "\n")
    st_path = os.path.join(deck, "cirstest.set")
    st = re.sub(r"(Number of atm layers :)\s*\d+", rf"\1  {nlay}",
                open(st_path).read())
    open(st_path, "w").write(st)
    return deck


# --- the runtime line-by-line slice

LINE_H5 = "tests/fixtures/linedata/CO_1_ambient_AIR.h5"
LINEDATA_NPZ = chip_smoke.LINEDATA_NPZ
CO_LBL_GOLDEN = chip_smoke.CO_LBL_GOLDEN
CO_RUNTIME = chip_smoke.CO_RUNTIME
CO_RUNTIME_GOLDEN = chip_smoke.CO_RUNTIME_GOLDEN
LLS = f"{CO_RUNTIME}/cirstest.lls"


def write_linedata_export(path: str = LINEDATA_NPZ):
    """Write the ``.npz`` export of the CO line list and partition function
    (``archnemesis_tpu_torch/data/CO_1_ambient_AIR.npz``, read on machines
    without h5py) from the HDF5 fixture."""
    from archnemesis_tpu_torch.io.linedata import export_ans_linedata

    export_ans_linedata(LINE_H5, path, gas_id=5, iso_id=1, ambient="AIR")


SO_H5 = "tests/fixtures/mars_so/mars_solocc.h5"


def write_deck_export(path: str = chip_smoke.SO_EXPORT):
    """Write the ``.npz`` export of the Mars solar-occultation run file
    (``archnemesis_tpu_torch/data/mars_solocc.npz``, read on machines
    without h5py) from the HDF5 fixture."""
    from archnemesis_tpu_torch.io.hdf5 import export_deck_hdf5

    export_deck_hdf5(SO_H5, path)


def lbl_voigt_grid(n: int = 4000, seed: int = 0):
    """(delta, alpha_d, gamma_l, |z|) float64: |z| log-uniform from 1e-3 to
    1e3 at a uniform angle in the first quadrant, Doppler widths from 1e-3
    to 0.3 cm-1 (so |delta| reaches every sub-Lorentzian chi band), the
    first ten deltas zero."""
    rng = np.random.default_rng(seed)
    z = 10.0 ** rng.uniform(-3.0, 3.0, n)
    angle = rng.uniform(0.0, np.pi / 2, n)
    alpha = 10.0 ** rng.uniform(-3.0, -0.5, n)
    x, y = z * np.cos(angle), z * np.sin(angle)
    x[:10] = 0.0
    z = np.hypot(x, y)
    scale = np.sqrt(np.log(2.0)) / alpha
    return x / scale, alpha, y / scale, z


def copy_runtime_deck(tmp_path_factory, name):
    """A temporary copy of the runtime deck whose ``.lls`` reads the line
    data's ``.npz`` export, as ``chip_smoke.py`` makes it on the card."""
    return chip_smoke.copy_runtime_deck(str(tmp_path_factory.mktemp(name)))


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block's torch work on ``n`` intra-op threads, restored
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's torch work on one intra-op thread: the suite runs in
    several worker processes that share the machine's cores, and torch's
    default of one thread per core oversubscribes them (its large
    elementwise passes then run many times slower). The count is restored
    after the module."""
    with torch_threads(1):
        yield


# --- the scattering slice: the Jupiter scattering deck in both packages

SCAT_DECK = "tests/fixtures/jupiter_scatter"
SCAT_FM_GOLDEN = "tests/goldens/jupiter_scatter_fm.npz"


def _scatter_window(kt_wave, wave):
    kw = np.asarray(kt_wave)
    return np.where((kw >= wave.min()) & (kw <= wave.max()))[0]


def scatter_decks():
    """(port deck, JAX deck), each with its k-tables cut to the golden's
    60 waves (the two goldens share the grid)."""
    wave = np.load(SCAT_FM_GOLDEN)["WAVE"]
    tdeck = port_load_deck(SCAT_DECK, "cirstest")
    jdeck = jax_load_deck(SCAT_DECK, "cirstest")
    sel = _scatter_window(jdeck.ktables.wave, wave)
    jkt = jdeck.ktables
    jdeck = dataclasses.replace(jdeck, ktables=jkt.replace(
        wave=np.asarray(jkt.wave)[sel], k=np.asarray(jkt.k)[:, sel]))
    tkt = tdeck.ktables
    tsel = torch.as_tensor(sel)
    tdeck = dataclasses.replace(tdeck, ktables=tkt.replace(
        wave=tkt.wave[tsel], k=tkt.k[:, tsel]))
    np.testing.assert_allclose(tdeck.ktables.wave.numpy(), wave, atol=2e-4)
    return tdeck, jdeck


def _scatter_cfgs(decks, gasgiant=None):
    tdeck, jdeck = decks
    st = jdeck.settings
    gg = jdeck.surface.gasgiant if gasgiant is None else gasgiant
    jcfg = jfwd.make_forward_config(
        jdeck.atmosphere, jdeck.ktables, jdeck.cia, iray=st.iray,
        ispace=st.ispace, gasgiant=gg)
    tcfg = tfwd.make_forward_config(
        tdeck.atmosphere, tdeck.ktables, tdeck.cia, iray=st.iray,
        ispace=st.ispace, gasgiant=gg)
    return tcfg, jcfg


def _scatter_angles(deck):
    g = deck.geometry
    return dict(emiss_ang=g.emiss_ang[0, 0], sol_ang=g.sol_ang[0, 0],
                azi_ang=g.azi_ang[0, 0], iray_phase=deck.settings.iray > 0)


def _scatter_quad(cls, st):
    return cls(mu=st.mu, wtmu=st.wtmu, nf=st.nf, nphi=st.nphi)


def scatter_forwards(decks, single, tsurf=None, jsurf=None, gasgiant=None):
    """(port spectrum, port diagnostics, JAX spectrum) of one forward."""
    tdeck, jdeck = decks
    tcfg, jcfg = _scatter_cfgs(decks, gasgiant)
    ts = tdeck.surface if tsurf is None else tsurf
    js = jdeck.surface if jsurf is None else jsurf
    targs = (tdeck.atmosphere, tdeck.layer_config, tdeck.ktables, tdeck.cia,
             tdeck.aerosol, ts, tdeck.stellar, tcfg)
    jargs = (jdeck.atmosphere, jdeck.layer_config, jdeck.ktables, jdeck.cia,
             jdeck.aerosol, js, jdeck.stellar, jcfg)
    if single:
        tspec, tdiag = tfwd.forward_singlescat_nadir(
            *targs, tdeck.hgphase, **_scatter_angles(tdeck),
            return_diagnostics=True, device="cpu")
        jspec = jfwd.forward_singlescat_nadir(*jargs, jdeck.hgphase,
                                              **_scatter_angles(jdeck))
    else:
        tspec, tdiag = tfwd.forward_scattering_nadir(
            *targs, _scatter_quad(ScatterQuadrature, tdeck.settings),
            tdeck.hgphase, **_scatter_angles(tdeck), return_diagnostics=True,
            device="cpu")
        jspec = jfwd.forward_scattering_nadir(
            *jargs, _scatter_quad(JQuad, jdeck.settings), jdeck.hgphase,
            **_scatter_angles(jdeck))
    return tspec, tdiag, np.asarray(jspec)


def speconv(golden, spec):
    """(the spectrum at the golden's channels, NCONV)."""
    nconv = int(golden["NCONV"][0])
    vconv = torch.as_tensor(golden["VCONV"][:nconv, 0])
    wave = torch.as_tensor(golden["WAVE"])
    return conv_channel_interp(wave, spec[:, 0], vconv).numpy(), nconv


def brdf_surfaces(decks, d, lowbc):
    """The golden's synthetic surface (``tests/test_forward_brdf.py``) on
    both packages' surface structures."""
    tdeck, jdeck = decks
    vem = d["VEM"]
    names = dict(sglalb="SGLALB", k="K", bs0="BS0", hs="hs", bc0="BC0",
                 hc="hc", roughness="ROUGHNESS", g1="G1", g2="G2", f="F")
    hap = {n: np.full(2, float(d["HAPKE_" + k])) for n, k in names.items()}
    common = dict(vem=vem, emissivity=np.full(2, float(d["EMISS"])),
                  tsurf=np.asarray(float(d["TSURF"])),
                  galb=np.asarray(float(d["GALB"])))
    on = (dict(on_albedo=np.full(2, float(d["ON_ALB"])),
               on_roughness=np.full(2, float(d["ON_ROUGH"])))
          if lowbc == 3 else dict(on_albedo=None, on_roughness=None))
    jsurf = jdeck.surface.replace(
        **common, **on, hapke=JHapke(vem=vem, **hap) if lowbc == 2 else None,
        lowbc=lowbc, gasgiant=False)

    def t(x):
        return None if x is None else torch.as_tensor(x)

    tsurf = tdeck.surface.replace(
        **{k: t(v) for k, v in {**common, **on}.items()},
        hapke=(HapkeParams(vem=t(vem), **{k: t(v) for k, v in hap.items()})
               if lowbc == 2 else None),
        lowbc=LowerBoundaryCondition(lowbc), gasgiant=False)
    return tsurf, jsurf


# --- the remaining models: the composed decks of chip_smoke's "models" phase

def _jax_atmosphere_as_arrays(deck_dir):
    """The deck's JAX atmosphere with its profiles as JAX arrays: the JAX
    knee model indexes the atmosphere by a sort order, which a jitted
    forward cannot do on numpy fields."""
    import jax.numpy as jnp

    atm = jax_load_deck(deck_dir, "cirstest").atmosphere
    return atm.replace(**{
        f.name: jnp.asarray(getattr(atm, f.name))
        for f in dataclasses.fields(atm)
        if not f.metadata.get("static", False)
        and getattr(atm, f.name) is not None})


def models_deck_case(tmp_path_factory, make_deck, columns: dict) -> dict:
    """A composed deck (``make_deck(base)``, e.g. ``chip_smoke.
    models_nadir_deck``) set up in both
    packages, and each package's forward at the a priori with its JVP
    along each column of ``columns`` ({name: (model id, offset in its
    block)}): the port's one ``vmap`` of ``jvp`` on two threads (its plain
    combine takes over a minute on one at these widths), the JAX
    package's jitted."""
    import jax
    import jax.numpy as jnp

    from archnemesis_tpu.retrievals import make_retrieval_setup as jax_setup
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    deck = make_deck(str(tmp_path_factory.mktemp(make_deck.__name__)))
    port = make_retrieval_setup(deck, "cirstest", device="cpu")
    jx = jax_setup(deck, "cirstest",
                   atm_override=_jax_atmosphere_as_arrays(deck))
    np.testing.assert_array_equal(port.sv.xa, jx.sv.xa)
    np.testing.assert_array_equal(port.y, jx.y)
    ix = {e.model_id: e.ix for e in port.sv.entries}
    cols = {name: ix[mid] + off for name, (mid, off) in columns.items()}
    basis = np.zeros((len(cols), port.sv.nx))
    basis[np.arange(len(cols)), list(cols.values())] = 1.0
    xa = port.sv.xa
    with torch_threads(2):
        y, dy = torch.func.vmap(
            lambda v: torch.func.jvp(port.forward_fn,
                                     (torch.as_tensor(xa),), (v,)),
            out_dims=(None, 0))(torch.as_tensor(basis))
    jy, jdy = jax.jit(jax.vmap(
        lambda v: jax.jvp(jx.forward_fn, (jnp.asarray(xa),), (v,)),
        out_axes=(None, 0)))(jnp.asarray(basis))
    return dict(port=port, y=y.numpy(), jy=np.asarray(jy),
                dy=dict(zip(cols, dy.numpy())),
                jdy=dict(zip(cols, np.asarray(jdy))))


def models_filter_deck(base: str) -> str:
    """A copy of jupiter_nadir under ``base`` for filter integration with
    a retrieved Doppler shift: IFORM = Integrated_radiance, its channels
    cut to the 15 of 801-829 cm-1 with FWHM < 0 and a .fil of Gaussian
    filters (13 samples over +-6 cm-1 each), and an .apr of model 0 and
    model 447."""
    import os

    deck = chip_smoke.copy_deck(DECK, base)
    spx = os.path.join(deck, "cirstest.spx")
    with open(spx) as f:
        lines = f.readlines()
    rows = [r for r in lines[4:]
            if r.split() and 800.0 <= float(r.split()[0]) <= 830.0]
    head = lines[0].split()
    with open(spx, "w") as f:
        f.write(f"{-1.0:12.4f} {' '.join(head[1:])}\n{len(rows):11d}\n")
        f.write("".join(lines[2:4]) + "".join(rows))
    with open(os.path.join(deck, "cirstest.fil"), "w") as f:
        f.write(f"{len(rows)}\n")
        for r in rows:
            vc = float(r.split()[0])
            v = np.linspace(vc - 6.0, vc + 6.0, 13)
            f.write(f"{vc}\n13\n")
            for vi, ai in zip(v, np.exp(-(((v - vc) / 3.0) ** 2))):
                f.write(f"{vi:.6f} {ai:.8f}\n")
    inp = os.path.join(deck, "cirstest.inp")
    with open(inp) as f:
        inp_lines = f.read().splitlines()
    inp_lines[7] = "6"  # IFORM = Integrated_radiance
    with open(inp, "w") as f:
        f.write("\n".join(inp_lines) + "\n")
    chip_smoke._write_apr(deck, [chip_smoke._apr_block("m447_doppler")])
    return deck


# --- non-LTE emissions, telluric transmission, multi-location

EMISS_DIR = "tests/fixtures/jupiter_emiss"
EM_GOLDEN = chip_smoke.EM_GOLDEN
EMISS_NAMES = chip_smoke.EMISS_NAMES


def write_emission_exports(out_dir: str = chip_smoke.PORT_DATA):
    """Write the ``.npz`` exports of the two emission tables
    (``archnemesis_tpu_torch/data/emiss_{c2h2_chem,nh3_fluor}.npz``, read
    on machines without h5py) from the HDF5 fixtures."""
    from archnemesis_tpu_torch.io.hdf5 import export_deck_hdf5

    for name in EMISS_NAMES:
        export_deck_hdf5(os.path.join(EMISS_DIR, name + ".h5"),
                         os.path.join(out_dir, name + ".npz"))


def telluric_ktables(wave):
    """(g_ord, del_g, k (2, NWAVE, NG, NP, NT), press [atm], temp [K]) of
    the two telluric gases (H2O, CO2): the seeded recipe of
    ``tests/test_telluric.py:_ktab`` (12 pressures x 8 temperatures x 10
    g) on the grid ``wave``."""
    press = np.logspace(-6, 0.1, 12)
    temp = np.linspace(150.0, 320.0, 8)
    rng = np.random.default_rng(4)
    x, w = np.polynomial.legendre.leggauss(10)
    g_ord, del_g = 0.5 * (x + 1), 0.5 * w
    band = 0.05 + np.exp(
        -0.5 * ((wave[:, None] - rng.uniform(wave[0], wave[-1], 5)) / 15.0)
        ** 2).sum(1)
    k = (5e-22 * band[None, :, None, None, None]
         * np.exp(2.0 * (g_ord - 0.6))[None, None, :, None, None]
         * (press / press.max())[None, None, None, :, None] ** 0.1
         * (temp / 250.0)[None, None, None, None, :] ** -0.4
         * np.array([1.0, 0.3])[:, None, None, None, None])
    return g_ord, del_g, k, press, temp


def write_telluric_tables(out_dir: str):
    """The two telluric ``.kta`` tables (``chip_smoke.TELLURIC_TABLES``),
    written by the port's ``write_kta`` on ``chip_smoke.TELLURIC_WAVE``."""
    from archnemesis_tpu_torch.io.ktables import write_kta

    wave = chip_smoke.TELLURIC_WAVE
    g_ord, del_g, k, press, temp = telluric_ktables(wave)
    for i, (name, gas_id) in enumerate(chip_smoke.TELLURIC_TABLES):
        write_kta(os.path.join(out_dir, name), gas_id, 0, g_ord, del_g,
                  press, temp, wave, k[i])


def write_telluric_run(deck_dir: str) -> str:
    """``<deck_dir>/cirstest.h5``: the JAX package's ``write_deck_hdf5`` of
    the jupiter_nadir copy in ``deck_dir`` (``chip_smoke.telluric_deck``,
    which holds the telluric tables), with a ``Telluric`` group: the CIRC
    Earth profile restricted to H2O and CO2 (its molecular weight as
    MOLWT, AMFORM 0), ALTITUDE 4207.3 m and EMISS_ANG 160 (as
    ``tests/test_telluric.py``), and the two tables by relative
    LOCATION. Returns the file's path."""
    import h5py

    from archnemesis_tpu.io.hdf5 import write_deck_hdf5
    from archnemesis_tpu.rt.telluric import extract_atmosphere_circ

    h5 = os.path.join(deck_dir, "cirstest.h5")
    write_deck_hdf5(h5, jax_load_deck(deck_dir, "cirstest"))
    circ = extract_atmosphere_circ()
    cols = [list(circ.gas_id).index(g) for g in (1, 2)]
    with h5py.File(h5, "a") as f:
        # the loaded deck's table locations are resolved paths: store them
        # relative to the deck, as the .kls names them
        sp = f["Spectroscopy"]
        locs = [os.path.relpath(x.decode(), deck_dir)
                for x in sp["LOCATION"][()]]
        del sp["LOCATION"]
        sp["LOCATION"] = np.asarray([x.encode() for x in locs])
        tg = f.create_group("Telluric")
        tg["ALTITUDE"] = chip_smoke.TELLURIC_ALTITUDE
        tg["EMISS_ANG"] = chip_smoke.TELLURIC_EMISS_ANG
        a = tg.create_group("Atmosphere")
        a["H"] = np.asarray(circ.h, dtype=np.float64)
        a["P"] = np.asarray(circ.p, dtype=np.float64)
        a["T"] = np.asarray(circ.t, dtype=np.float64)
        a["VMR"] = np.asarray(circ.vmr, dtype=np.float64)[:, cols]
        a["ID"] = np.asarray([1, 2], dtype=np.int32)
        a["ISO"] = np.asarray([0, 0], dtype=np.int32)
        a["AMFORM"] = 0
        a["MOLWT"] = np.asarray(circ.molwt, dtype=np.float64)
        a["IPLANET"] = 3
        a["LATITUDE"] = float(np.asarray(circ.latitude))
        sp = tg.create_group("Spectroscopy")
        sp["ILBL"] = 0
        sp["LOCATION"] = np.asarray(
            [name.encode() for name, _ in chip_smoke.TELLURIC_TABLES])
    return h5


def write_telluric_export(out_dir: str = chip_smoke.PORT_DATA):
    """Write the telluric run's committed files: the two tables and the
    ``.npz`` export of the run file (``chip_smoke.TELLURIC_EXPORT``), made
    in a temporary copy of jupiter_nadir."""
    import tempfile

    from archnemesis_tpu_torch.io.hdf5 import export_deck_hdf5

    write_telluric_tables(out_dir)
    with tempfile.TemporaryDirectory() as base:
        deck = chip_smoke.telluric_deck(base, tables_dir=out_dir)
        export_deck_hdf5(write_telluric_run(deck),
                         os.path.join(out_dir,
                                      os.path.basename(
                                          chip_smoke.TELLURIC_EXPORT)))


@pytest.fixture
def cuda():
    """The card, or a skip: the kernels are built with nvcc and have no
    CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is built with nvcc "
                    "and has no CPU mode")
    return torch.device("cuda")


# --- catalogue ingestion (HITRAN, GEISA, ExoMol): copies of the JAX
# package's test generators (tests/test_native.py, tests/test_hitran.py,
# tests/test_db_ingest.py), so that no JAX test module is imported


def _ffmt(x, w, p):
    s = f"{x:{w}.{p}f}"
    if len(s) > w:  # Fortran-style leading-zero drop: 0.0676 -> .0676
        s = s.replace("0.", ".", 1)
    assert len(s) == w
    return s


def synthetic_par(nrec=500, seed=0, width=160) -> bytes:
    """``nrec`` random .par records of molecules 1-55 with iso chars 1-9,
    0, A and B (``tests/test_native.py:_synthetic_par``)."""
    rng = np.random.default_rng(seed)
    lines = []
    iso_chars = "1234567890AB"  # includes 2020 extension codes
    for _ in range(nrec):
        mol = int(rng.integers(1, 56))
        iso = iso_chars[rng.integers(0, len(iso_chars))]
        rec = (
            f"{mol:2d}{iso}"
            + _ffmt(rng.uniform(1.0, 12000.0), 12, 6)
            + f"{rng.uniform(1e-32, 1e-19):10.3E}"
            + f"{rng.uniform(1e-6, 1e3):10.3E}"
            + _ffmt(rng.uniform(0.005, 0.3), 5, 4)
            + _ffmt(rng.uniform(0.005, 0.5), 5, 4)
            + _ffmt(rng.uniform(0.0, 9000.0), 10, 4)
            + _ffmt(rng.uniform(-0.5, 1.2), 4, 2)
            + _ffmt(rng.uniform(-0.05, 0.05), 8, 6)
        )
        lines.append(rec + " " * (width - len(rec)))
    return ("\n".join(lines) + "\n").encode()


def synth_par_lines():
    """40 CO (HITRAN mol 05) records of isotopes 1-3 in the 160-char
    format, every fifth with no self width
    (``tests/test_hitran.py:_synth_par_lines``)."""
    rng = np.random.default_rng(7)
    lines = []
    quanta = " " * 60
    errrefs = "0" * 6 + " 0 0 0 0 0 0"
    for i in range(40):
        mol = 5
        iso = (i % 3) + 1  # isos 1..3
        nu = 2050.0 + i * 3.17 + rng.uniform(0, 1)
        sw = 10 ** rng.uniform(-24, -20)
        a = 10 ** rng.uniform(-6, 1)
        g_air = rng.uniform(0.03, 0.09)
        g_self = rng.uniform(0.04, 0.1) if i % 5 else 0.0
        el = rng.uniform(0, 2000)
        n_air = rng.uniform(0.5, 0.8)
        delta = rng.uniform(-0.01, 0.01)
        rec = (
            f"{mol:2d}{iso:1d}{nu:12.6f}{sw:10.3E}{a:10.3E}"
            f"{g_air:5.3f}{g_self:5.3f}{el:10.4f}{n_air:4.2f}{delta:8.5f}"
        )
        rec += quanta + errrefs + " " + f"{21.0:7.1f}{19.0:7.1f}"
        assert len(rec) == 160, len(rec)
        lines.append(rec)
    return lines


def write_par(path, lines) -> str:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def geisa_records(n=40, seed=7) -> dict:
    """GEISA fields of CO iso 1 and 2 (every third 13CO)
    (``tests/test_db_ingest.py:geisa_bytes``)."""
    from archnemesis_tpu_torch.io.hitran import radtran_to_geisa

    rng = np.random.default_rng(seed)
    mol, code = radtran_to_geisa(5, 1)
    _, code2 = radtran_to_geisa(5, 2)
    return {
        "nu": np.sort(rng.uniform(2000.0, 2200.0, n)),
        "sw": 10.0 ** rng.uniform(-26, -20, n),
        "gamma_air": rng.uniform(0.04, 0.09, n).round(4),
        "elower": rng.uniform(0.0, 3000.0, n).round(4),
        "iso_code": np.where(np.arange(n) % 3 == 0, code2, code),
        "mol_id": np.full(n, mol),
        "a_einstein": 10.0 ** rng.uniform(-4, 2, n),
        "n_air": rng.uniform(0.4, 0.9, n).round(2),
        "delta_air": rng.uniform(-0.01, 0.01, n).round(6),
        "gamma_self": rng.uniform(0.05, 0.11, n).round(4),
        "n_self": rng.uniform(0.4, 0.9, n).round(2),
    }


def write_exomol_small(out_dir) -> tuple:
    """The four-state CO triple of ``tests/test_db_ingest.py:exomol_files``
    in ``out_dir``: (states, trans, broad) paths."""
    states = [(1, 0.0, 1.0, 0.0), (2, 2143.27, 3.0, 1.0),
              (3, 2147.08, 5.0, 2.0), (4, 4260.06, 3.0, 1.0)]
    paths = tuple(os.path.join(out_dir, f"co.{ext}")
                  for ext in ("states", "trans", "broad"))
    with open(paths[0], "w") as f:
        for i, e, g, j in states:
            f.write(f"{i:12d} {e:12.6f} {g:6.1f} {j:7.1f}\n")
    with open(paths[1], "w") as f:
        for iu, il, a in [(2, 1, 1.0e-2), (3, 1, 2.5e-2), (4, 2, 7.5e-3)]:
            f.write(f"{iu:12d} {il:12d} {a:10.4e}\n")
    with open(paths[2], "w") as f:
        f.write("a0 0.0700 0.70     0.0\n")
        f.write("a0 0.0650 0.65     1.0\n")
    return paths


LINELIST_FIELDS = ("gas_id", "iso_id", "mol_name", "t_ref", "p_ref", "mass",
                   "abundance", "nu", "sw", "elower", "stim_ref", "broad",
                   "pf_temp", "pf_q")


def assert_same_linelist(got, want, what=""):
    """Every field of two line lists equal, arrays bit for bit."""
    for name in LINELIST_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray) or hasattr(w, "shape"):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype, f"{what} {name}"
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            assert g == w, f"{what} {name}: {g!r} != {w!r}"
