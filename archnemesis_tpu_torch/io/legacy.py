"""Legacy NEMESIS deck loader (.inp/.set/.fla/.spx/.ref/aerosol.ref/
parah2.ref/.xsc/.kls/.lls/.cia/.sol/.apr).

Port of the JAX package's ``io/legacy.py``: host-side numpy parsing (formats
re-implemented from observation of the reference readers, Files.py:404
read_input_files, :1170 read_inp, :1269 read_set, :1383 read_fla;
Atmosphere_0.py:1353 read_ref, :1491 read_aerosol; Measurement_0.py:828
read_spx; Scatter_0.py:559 read_xsc; CIA_0.py:323 read_cia). The loader is
host-only: the structures it returns hold float64 CPU tensors (a runtime
line-by-line deck's ``RuntimeLBL``, float64 numpy), and the entry points
that compute (``retrievals.make_retrieval_setup``) move them to the card.
The ``.lta`` line-by-line table ``.lls`` branch and the Hapke ``.hap``
surface raise until their slices are ported; ``read_drv``/``write_drv``
wait.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

import torch

from archnemesis_tpu_torch.core.spectra import (
    AerosolOptics,
    CIATables,
    KTables,
    StellarSpec,
    SurfaceSpec,
)
from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
from archnemesis_tpu_torch.enums import (
    AtmosphericProfileFormat,
    LowerBoundaryCondition,
    ParaH2Ratio,
    SpectraUnit,
    SpectralCalculationMode,
    WaveUnit,
)
from archnemesis_tpu_torch.io.cia import read_cia_tab
from archnemesis_tpu_torch.io.ktables import read_kls
from archnemesis_tpu_torch.io.linedata import read_lls_runtime
from archnemesis_tpu_torch.rt.atmosphere import (
    calc_grav,
    calc_molwt,
    gas_molwt_per_column,
)
from archnemesis_tpu_torch.utils.datafiles import data_path, find_table


def _t(x):
    """float64 CPU tensor of a host array or scalar."""
    return torch.as_tensor(np.array(x, dtype=np.float64))


@dataclass
class Geometry:
    """Measurement geometry (the reference Measurement class's geometry
    block): ragged (NGEOM, NAV) padded to max."""

    fwhm: float
    latitude: float
    longitude: float
    ngeom: int
    nconv: np.ndarray  # (NGEOM,)
    nav: np.ndarray  # (NGEOM,)
    vconv: np.ndarray  # (NCONVMAX, NGEOM)
    meas: np.ndarray
    errmeas: np.ndarray
    flat: np.ndarray  # (NGEOM, NAVMAX)
    flon: np.ndarray
    sol_ang: np.ndarray
    emiss_ang: np.ndarray
    azi_ang: np.ndarray
    wgeom: np.ndarray
    tanhe: Optional[np.ndarray] = None
    woff: float = 0.0
    # per-channel tabulated filter functions (.fil, FWHM<0;
    # reference Measurement_0.read_fil:1072)
    nfil: Optional[np.ndarray] = None  # (NCONV,)
    vfil: Optional[np.ndarray] = None  # (NFILMAX, NCONV)
    afil: Optional[np.ndarray] = None  # (NFILMAX, NCONV)


@dataclass
class RunSettings:
    ispace: WaveUnit
    iscat: int
    ilbl: SpectralCalculationMode
    iform: SpectraUnit
    woff: float
    niter: int
    philimit: float
    inormal: ParaH2Ratio
    iray: int
    imie: int
    nmu: int
    nf: int
    nphi: int
    isol: bool
    dist: float
    lowbc: LowerBoundaryCondition
    galb: float
    tsurf: float
    v_doppler: float = 0.0
    mu: tuple = ()
    wtmu: tuple = ()
    ishape: int = 2  # InstrumentLineshape for FWHM>0 (reference default Gaussian, Measurement_0.py:235)
    vnorm: Optional[float] = None  # IFORM=5 normalisation wavelength (Measurement_0.py:145)


@dataclass
class Deck:
    atmosphere: Atmosphere
    layer_config: LayerConfig
    geometry: Geometry
    settings: RunSettings
    ktables: Optional[KTables] = None  # a RuntimeLBL for ILBL=1 decks
    cia: Optional[CIATables] = None
    aerosol: Optional[AerosolOptics] = None
    surface: Optional[SurfaceSpec] = None
    stellar: Optional[StellarSpec] = None
    apr_path: Optional[str] = None
    hgphase: Optional[tuple] = None  # (wave, f, g1, g2) from hgphaseN.dat
    telluric: Optional[object] = None  # set by HDF5 runs only
    fwh: Optional[tuple] = None  # (vfwhm, xfwhm) variable-FWHM table (.fwh)
    table_locations: Optional[tuple] = None  # source .kta/.lta paths
    cia_table: Optional[tuple] = None  # (name, dnu, npara) from the .cia file


def _skip_comments(path):
    with open(path) as f:
        lines = f.readlines()
    return [ln for ln in lines if not ln.startswith("#")]


def read_ref(path) -> Atmosphere:
    """.ref profile file (reference Atmosphere_0.read_ref:1353)."""
    lines = _skip_comments(path)
    toks = "".join(lines).split()
    it = iter(toks)

    amform = AtmosphericProfileFormat(int(next(it)))
    _ = next(it)  # unused flag line
    nplanet = int(next(it))
    xlat = float(next(it))
    npro = int(next(it))
    ngas = int(next(it))
    molwt_const = float(next(it)) if amform == AtmosphericProfileFormat.MOLECULAR_WEIGHT_DEFINED else None
    gas_id = np.zeros(ngas, dtype=int)
    iso_id = np.zeros(ngas, dtype=int)
    for i in range(ngas):
        gas_id[i] = int(next(it))
        iso_id[i] = int(next(it))
    # column-header tokens: the profile table header line has 3+ngas labels.
    rest = list(it)
    data = np.array([float(x) for x in rest[-(npro * (3 + ngas)):]]).reshape(
        npro, 3 + ngas
    )
    h = data[:, 0] * 1.0e3  # km -> m
    p = data[:, 1] * 101325.0  # atm -> Pa
    t = data[:, 2]
    vmr = data[:, 3:]

    masses = gas_molwt_per_column(gas_id, iso_id)
    if molwt_const is not None:
        molwt = _t(np.full(npro, molwt_const) / 1000.0)
    else:
        molwt = calc_molwt(_t(vmr), masses)

    grav, radius = calc_grav(_t(h), xlat, nplanet)
    return Atmosphere(
        h=_t(h),
        p=_t(p),
        t=_t(t),
        vmr=_t(vmr),
        dust=_t(np.zeros((npro, 0))),
        parah2=_t(np.zeros(npro)),
        molwt=molwt,
        radius=radius,
        latitude=_t(float(xlat)),
        gas_id=tuple(int(x) for x in gas_id),
        iso_id=tuple(int(x) for x in iso_id),
        planet=nplanet,
        amform=amform,
    )


def read_aerosol_ref(path, atm: Atmosphere) -> Atmosphere:
    """aerosol.ref (particles per gram of atmosphere;
    Atmosphere_0.read_aerosol:1491). Activates dust_units_flag=-1."""
    lines = _skip_comments(path)
    toks = "".join(lines).split()
    npro, naero = int(toks[0]), int(toks[1])
    data = np.array([float(x) for x in toks[2 : 2 + npro * (naero + 1)]]).reshape(
        npro, naero + 1
    )
    dust = data[:, 1:]
    return atm.replace(dust=_t(dust)).replace(
        dust_units_flag=tuple([-1] * naero)
    )


def read_parah2_ref(path, atm: Atmosphere) -> Atmosphere:
    lines = _skip_comments(path)
    toks = "".join(lines).split()
    npro = int(toks[0])
    data = np.array([float(x) for x in toks[1 : 1 + npro * 2]]).reshape(npro, 2)
    return atm.replace(parah2=_t(data[:, 1]))


def read_inp(path):
    with open(path) as f:
        lines = f.readlines()
    first = lines[0].split()
    ispace, iscat, ilbl = int(first[0]), int(first[1]), int(first[2])
    woff = float(lines[1].split()[0])
    niter = int(lines[3].split()[0])
    philimit = float(lines[4].split()[0])
    iform = int(lines[7].split()[0]) if len(lines) > 7 else 0
    v_doppler = float(lines[8].split()[0]) if len(lines) > 8 else 0.0
    return ispace, iscat, ilbl, woff, niter, philimit, iform, v_doppler


def read_fwh(path):
    """.fwh file: FWHM varying with wavelength for the k-table FWHM>0
    convolution (reference Measurement_0.conv FWHMEXIST branch,
    Measurement_0.py:2383-2400). Returns (vfwhm, xfwhm)."""
    with open(path) as f:
        n = int(f.readline().split()[0])
        rows = np.array([[float(x) for x in f.readline().split()[:2]]
                         for _ in range(n)])
    return rows[:, 0], rows[:, 1]


def read_fla(path):
    vals = []
    with open(path) as f:
        for line in f:
            s = line.split()
            if s:
                vals.append(int(s[0]))
    # inormal, iray, ih2o, ich4, io3, inh3, iptf, imie, iuv (iuv optional)
    while len(vals) < 9:
        vals.append(0)
    return vals[:9]


def read_set(path):
    with open(path) as f:
        f.readline()
        nmu = int(f.readline().split()[5])
        vals = []
        while len(vals) < 2 * nmu:
            vals += f.readline().split()
        mu = tuple(float(vals[2 * i]) for i in range(nmu))
        wtmu = tuple(float(vals[2 * i + 1]) for i in range(nmu))
        nf = int(f.readline().split()[5])
        nphi = int(f.readline().split()[8])
        isol = int(f.readline().split()[5])
        dist = float(f.readline().split()[5])
        lowbc = int(f.readline().split()[6])
        galb = float(f.readline().split()[3])
        tsurf = float(f.readline().split()[3])
        f.readline()
        layht = float(f.readline().split()[8])
        nlayer = int(f.readline().split()[5])
        laytp = int(f.readline().split()[3])
        layint = int(f.readline().split()[3])
    return dict(
        nmu=nmu, mu=mu, wtmu=wtmu, nf=nf, nphi=nphi, isol=bool(isol),
        dist=dist, lowbc=lowbc, galb=galb, tsurf=tsurf,
        layht=layht * 1.0e3, nlayer=nlayer, laytyp=laytp, layint=layint,
    )


def read_hgphase(ndust: int, directory: str = "."):
    """hgphaseN.dat files: per-wave two-term HG parameters (wave, f, g1, g2)
    (reference Scatter_0.read_hgphase:642). Returns wave (NWAVE,), and
    f/g1/g2 (NWAVE, NDUST)."""
    wave = None
    fr, g1, g2 = [], [], []
    for idust in range(ndust):
        rows = np.array([
            [float(x) for x in ln.split()[:4]]
            for ln in open(os.path.join(directory, f"hgphase{idust+1}.dat"))
            if ln.split()
        ])
        wave = rows[:, 0]
        fr.append(rows[:, 1])
        g1.append(rows[:, 2])
        g2.append(rows[:, 3])
    return wave, np.stack(fr, 1), np.stack(g1, 1), np.stack(g2, 1)


def read_fil(path):
    """.fil per-channel instrument filter functions (reference
    Measurement_0.read_fil:1072): NCONV, then per channel the centre
    wavenumber, NFIL and (v, a) samples. Returns (nfil (NC,), vfil, afil
    (NFILMAX, NC)) padded to the longest filter."""
    toks = open(path).read().split()
    it = iter(toks)
    nconv = int(next(it))
    nfil = np.zeros(nconv, dtype=np.int64)
    cols_v, cols_a = [], []
    for i in range(nconv):
        next(it)  # channel centre wavenumber (redundant with .spx)
        n = int(next(it))
        nfil[i] = n
        v = np.empty(n)
        a = np.empty(n)
        for j in range(n):
            v[j] = float(next(it))
            a[j] = float(next(it))
        cols_v.append(v)
        cols_a.append(a)
    m = int(nfil.max())
    vfil = np.zeros((m, nconv))
    afil = np.zeros((m, nconv))
    for i in range(nconv):
        vfil[: nfil[i], i] = cols_v[i]
        afil[: nfil[i], i] = cols_a[i]
    return nfil, vfil, afil


def read_spx(path, woff=0.0) -> Geometry:
    with open(path) as f:
        toks = f.read().split()
    it = iter(toks)
    fwhm = float(next(it))
    xlat = float(next(it))
    xlon = float(next(it))
    ngeom = int(next(it))
    nconv = np.zeros(ngeom, dtype=int)
    nav = np.zeros(ngeom, dtype=int)
    geo = {k: [] for k in ["flat", "flon", "sol", "emi", "azi", "wg"]}
    spec = []
    for i in range(ngeom):
        nconv[i] = int(next(it))
        nav[i] = int(next(it))
        g = {k: [] for k in geo}
        for _ in range(nav[i]):
            g["flat"].append(float(next(it)))
            g["flon"].append(float(next(it)))
            g["sol"].append(float(next(it)))
            g["emi"].append(float(next(it)))
            g["azi"].append(float(next(it)))
            g["wg"].append(float(next(it)))
        for k in geo:
            geo[k].append(g[k])
        rows = np.array(
            [float(next(it)) for _ in range(3 * nconv[i])]
        ).reshape(nconv[i], 3)
        spec.append(rows)

    ncmax, navmax = int(nconv.max()), int(nav.max())
    vconv = np.zeros((ncmax, ngeom))
    meas = np.zeros((ncmax, ngeom))
    errmeas = np.zeros((ncmax, ngeom))
    pads = {k: np.zeros((ngeom, navmax)) for k in geo}
    for i in range(ngeom):
        vconv[: nconv[i], i] = spec[i][:, 0] + woff
        meas[: nconv[i], i] = spec[i][:, 1]
        errmeas[: nconv[i], i] = spec[i][:, 2]
        for k in geo:
            pads[k][i, : nav[i]] = geo[k][i]

    tanhe = pads["sol"].copy() if pads["emi"].min() < 0.0 else None
    return Geometry(
        fwhm=fwhm, latitude=xlat, longitude=xlon, ngeom=ngeom,
        nconv=nconv, nav=nav, vconv=vconv, meas=meas, errmeas=errmeas,
        flat=pads["flat"], flon=pads["flon"], sol_ang=pads["sol"],
        emiss_ang=pads["emi"], azi_ang=pads["azi"], wgeom=pads["wg"],
        tanhe=tanhe, woff=woff,
    )


def read_xsc(path) -> AerosolOptics:
    lines = [ln for ln in open(path) if ln.strip()]
    naero = int(lines[0].split()[0])
    nwave = (len(lines) - 1) // 2
    wave = np.zeros(nwave)
    kext = np.zeros((nwave, naero))
    sglalb = np.zeros((nwave, naero))
    for i in range(nwave):
        s1 = lines[1 + 2 * i].split()
        wave[i] = float(s1[0])
        kext[i] = [float(x) for x in s1[1 : naero + 1]]
        s2 = lines[2 + 2 * i].split()
        sglalb[i] = [float(x) for x in s2[:naero]]
    return AerosolOptics(wave=_t(wave), kext=_t(kext),
                         ksca=_t(sglalb * kext))


def read_cia_file(path, inormal) -> CIATables:
    """.cia run file: table name, dnu, npara (CIA_0.read_cia:323); table
    resolved against the reference Data/cia directory."""
    with open(path) as f:
        name = f.readline().split()[0]
        dnu = float(f.readline().split()[0])
        npara = int(f.readline().split()[0])
    table = find_table(name, "cia", os.path.dirname(os.path.abspath(path)))
    if name.endswith(".h5"):
        raise NotImplementedError(
            "HDF5 CIA tables come with io/hdf5.py (ROADMAP Queue 1 item 13)")
    return read_cia_tab(table, dnu=dnu, npara=npara, inormal=inormal,
                        device="cpu")


def read_sol(path, dist, ispace) -> StellarSpec:
    """.sol run file (Stellar_0.read_sol:305): either names a stellar
    spectrum in Data/stellar, or holds it inline after a leading ``-1``."""
    from archnemesis_tpu_torch.io import stellar as stellar_io

    return stellar_io.read_sol(
        path, dist, stellar_data_dir=data_path("stellar"),
    )


def load_deck(deck_dir: str, runname: str) -> Deck:
    """Load a legacy deck into the port's structures, as float64 CPU
    tensors (reference read_input_files Files.py:404)."""
    cwd = os.getcwd()
    os.chdir(deck_dir)
    try:
        ispace, iscat, ilbl, woff, niter, philimit, iform, v_doppler = read_inp(
            runname + ".inp"
        )
        inormal, iray, *_rest, imie, _iuv = read_fla(runname + ".fla")
        setd = read_set(runname + ".set")

        atm = read_ref(runname + ".ref")
        if os.path.exists(runname + ".vpf"):
            svp = []
            with open(runname + ".vpf") as fh:
                for ln in fh.readlines()[1:]:
                    t = ln.split()
                    if len(t) >= 4:
                        svp.append((int(t[0]), int(t[1]), float(t[2]), int(t[3])))
            atm = atm.replace(svp=tuple(svp))
        if os.path.exists("aerosol.ref"):
            atm = read_aerosol_ref("aerosol.ref", atm)
        if os.path.exists("parah2.ref"):
            atm = read_parah2_ref("parah2.ref", atm)

        geom = read_spx(runname + ".spx", woff=woff)
        if geom.fwhm < 0.0 and os.path.exists(runname + ".fil"):
            nfil, vfil, afil = read_fil(runname + ".fil")
            if nfil.shape[0] != int(geom.nconv[0]):
                raise ValueError(
                    ".fil and .spx channel counts disagree "
                    f"({nfil.shape[0]} vs {int(geom.nconv[0])})"
                )
            geom = dataclasses.replace(geom, nfil=nfil, vfil=vfil, afil=afil)

        ktab = None
        if ilbl == SpectralCalculationMode.K_TABLES and os.path.exists(
            runname + ".kls"
        ):
            ktab = KTables.from_tables(read_kls(runname + ".kls"),
                                       device="cpu")
        elif ilbl == SpectralCalculationMode.LINE_BY_LINE_TABLES and os.path.exists(
            runname + ".lls"
        ):
            raise NotImplementedError(
                "line-by-line .lta tables (.lls): not ported yet (ROADMAP "
                "Queue 1 item 2)")
        elif ilbl == SpectralCalculationMode.LINE_BY_LINE_RUNTIME and os.path.exists(
            runname + ".lls"
        ):
            ktab = read_lls_runtime(runname + ".lls")

        table_locations = None
        for lst in (runname + ".kls", runname + ".lls"):
            if os.path.exists(lst):
                base = os.path.dirname(os.path.abspath(lst))
                table_locations = tuple(
                    ln.strip() if os.path.isabs(ln.strip())
                    else os.path.join(base, ln.strip())
                    for ln in open(lst) if ln.strip()
                )
                break

        cia = None
        cia_table = None
        if os.path.exists(runname + ".cia"):
            cia = read_cia_file(runname + ".cia", ParaH2Ratio(inormal))
            with open(runname + ".cia") as fh:
                cia_table = (fh.readline().split()[0],
                             float(fh.readline().split()[0]),
                             int(fh.readline().split()[0]))

        aero = read_xsc(runname + ".xsc") if os.path.exists(runname + ".xsc") else None

        gasgiant = setd["tsurf"] <= 0.0
        vem = np.array([0.0, 1.0e6])
        emissivity = np.zeros(2) if gasgiant else np.ones(2)
        if os.path.exists(runname + ".sur"):
            # surface emissivity spectrum (reference Surface_0.read_sur)
            toks = open(runname + ".sur").read().split()
            nem = int(toks[0])
            rows = np.array([float(x) for x in toks[1 : 1 + 2 * nem]]).reshape(
                nem, 2
            )
            vem, emissivity = rows[:, 0], rows[:, 1]
        lowbc = LowerBoundaryCondition(0 if gasgiant else setd["lowbc"])
        if lowbc == LowerBoundaryCondition.HAPKE and os.path.exists(
                runname + ".hap"):
            raise NotImplementedError(
                "Hapke surfaces (.hap) come with the scattering slice "
                "(ROADMAP Queue 1 item 11)")
        surf = SurfaceSpec(
            tsurf=_t(0.0 if gasgiant else setd["tsurf"]),
            vem=_t(vem),
            emissivity=_t(emissivity),
            galb=_t(0.0 if gasgiant else setd["galb"]),
            lowbc=lowbc,
            gasgiant=gasgiant,
        )

        stellar = None
        if setd["isol"] and os.path.exists(runname + ".sol"):
            stellar = read_sol(runname + ".sol", setd["dist"], ispace)

        laycfg = LayerConfig(
            nlay=setd["nlayer"],
            laytyp=setd["laytyp"],
            layint=setd["layint"],
            layht=max(setd["layht"], float(atm.h[0])),
        )
        settings = RunSettings(
            ispace=WaveUnit(ispace), iscat=iscat,
            ilbl=SpectralCalculationMode(ilbl), iform=SpectraUnit(iform),
            woff=woff, niter=niter, philimit=philimit,
            inormal=ParaH2Ratio(inormal), iray=iray, imie=imie,
            nmu=setd["nmu"], nf=setd["nf"], nphi=setd["nphi"],
            mu=setd["mu"], wtmu=setd["wtmu"],
            isol=setd["isol"], dist=setd["dist"],
            lowbc=LowerBoundaryCondition(setd["lowbc"]), galb=setd["galb"],
            tsurf=setd["tsurf"], v_doppler=v_doppler,
        )
        hg = None
        if aero is not None and os.path.exists("hgphase1.dat"):
            hg = read_hgphase(aero.ndust)

        apr = runname + ".apr" if os.path.exists(runname + ".apr") else None
        fwh = read_fwh(runname + ".fwh") if os.path.exists(
            runname + ".fwh") else None
        return Deck(
            atmosphere=atm, layer_config=laycfg, geometry=geom,
            settings=settings, ktables=ktab, cia=cia, aerosol=aero,
            surface=surf, stellar=stellar,
            apr_path=os.path.abspath(apr) if apr else None,
            hgphase=hg, fwh=fwh,
            table_locations=table_locations, cia_table=cia_table,
        )
    finally:
        os.chdir(cwd)
