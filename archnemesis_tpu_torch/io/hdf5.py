"""Single-file HDF5 run format loader (the reference's ``runname.h5``
layout, one group per component: Files.read_input_files_hdf5 Files.py:114
and the per-class read_hdf5 methods, e.g. Atmosphere_0.py:490).

Port of the JAX package's ``io/hdf5.py``. Units in the HDF5 format are SI
already (H in m, P in Pa), unlike the legacy text decks. The loader is
host-only and returns float64 CPU tensors, as ``io.legacy.load_deck`` does.

A machine without ``h5py`` reads the ``.npz`` export of a run file
(``export_deck_hdf5``: every dataset under its ``Group/NAME`` key, the
table locations as written); ``h5py`` is imported only to read or write a
``.h5`` (``write_deck_hdf5`` needs it).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from archnemesis_tpu_torch.core.spectra import (
    AerosolOptics,
    HapkeParams,
    KTables,
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
from archnemesis_tpu_torch.io.cia import read_cia_h5, read_cia_tab
from archnemesis_tpu_torch.io.ktables import _resolve_path, read_kta, read_lta
from archnemesis_tpu_torch.io.legacy import Deck, Geometry, RunSettings
from archnemesis_tpu_torch.io.stellar import stellar_from_group
from archnemesis_tpu_torch.models.base import host_array
from archnemesis_tpu_torch.rt.atmosphere import (
    calc_grav,
    calc_molwt,
    gas_molwt_per_column,
)
from archnemesis_tpu_torch.rt.telluric import Telluric
from archnemesis_tpu_torch.utils.datafiles import data_path


def _t(x):
    """float64 CPU tensor of a host array or scalar."""
    return torch.as_tensor(np.array(x, dtype=np.float64))


def _host_dataset(x) -> np.ndarray:
    """A dataset's value as a numpy array that ``np.savez`` stores without
    pickling (variable-length strings become bytes)."""
    a = np.asarray(x)
    if a.dtype == object:
        a = np.asarray([v.encode() if isinstance(v, str) else bytes(v)
                        for v in a.ravel()]).reshape(a.shape)
    if a.dtype.metadata:
        # h5py tags some dtypes with metadata, which .npy does not keep
        a = a.astype(np.dtype(a.dtype.str))
    return a


def _read_flat(path: str) -> dict:
    """{"Group/NAME": array} of every dataset of a run file (``.h5``) or of
    its ``.npz`` export."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs h5py; where h5py is missing, read the "
            "run file's .npz export (io.hdf5.export_deck_hdf5) instead"
        ) from e
    flat = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                flat[name] = _host_dataset(obj[()])
        f.visititems(visit)
    return flat


def read_run_groups(path: str) -> dict:
    """The run file's groups as nested dicts of host arrays: ``g["NAME"]``,
    ``"NAME" in g`` and ``g["NAME"][()]`` read as on an h5py group."""
    root: dict = {}
    for key, value in _read_flat(path).items():
        *groups, name = key.split("/")
        node = root
        for g in groups:
            node = node.setdefault(g, {})
        node[name] = value
    return root


def export_deck_hdf5(h5_path: str, npz_path: str) -> None:
    """Write the ``.npz`` export of a run file: every dataset under its
    ``Group/NAME`` key, strings (the table ``LOCATION``s) as written.
    ``load_deck_hdf5`` reads it where h5py is missing."""
    np.savez_compressed(npz_path, **_read_flat(h5_path))


def _scalar(g, name, cast=int, default=None):
    if g is None or name not in g:
        return default
    return cast(np.asarray(g[name][()]).item())


def _floats(g, name):
    return np.asarray(g[name][()], dtype=np.float64)


def _text(x) -> str:
    return x.decode() if isinstance(x, bytes) else str(x)


def _read_atmosphere_group(a) -> Atmosphere:
    """One Atmosphere group (reference Atmosphere_0.read_hdf5:490)."""
    h = _floats(a, "H")
    vmr = _floats(a, "VMR")
    dust = _floats(a, "DUST") if "DUST" in a else np.zeros((h.shape[0], 0))
    gas_id = tuple(int(x) for x in a["ID"][()])
    iso_id = tuple(int(x) for x in a["ISO"][()])
    amform = AtmosphericProfileFormat(_scalar(a, "AMFORM", default=1))
    planet = _scalar(a, "IPLANET")
    lat = _scalar(a, "LATITUDE", float, 0.0)
    if "MOLWT" in a:
        # AMFORM=0 carries an explicit molwt profile (reference
        # Atmosphere_0.write_hdf5 stores it; legacy .ref column 4)
        molwt = _t(_floats(a, "MOLWT"))
    else:
        molwt = calc_molwt(_t(vmr), gas_molwt_per_column(gas_id, iso_id))
    _, radius = calc_grav(_t(h), lat, planet)
    return Atmosphere(
        h=_t(h), p=_t(_floats(a, "P")), t=_t(_floats(a, "T")), vmr=_t(vmr),
        dust=_t(dust), parah2=_t(np.zeros_like(h)), molwt=molwt,
        radius=radius, latitude=_t(float(lat)),
        gas_id=gas_id, iso_id=iso_id, planet=planet, amform=amform,
    )


def _locations(sp) -> tuple:
    return tuple(_text(x) for x in np.atleast_1d(sp["LOCATION"][()]))


def _read_tables(sp, base_dir):
    """Spectroscopy group -> (KTables of the .kta or .lta tables, each
    location resolved against ``base_dir``, ILBL)."""
    ilbl = SpectralCalculationMode(_scalar(sp, "ILBL"))
    read = (read_lta if ilbl == SpectralCalculationMode.LINE_BY_LINE_TABLES
            else read_kta)
    tables = [read(_resolve_path(loc, base_dir)) for loc in _locations(sp)]
    ktab = (KTables.from_tables(tables, ilbl=ilbl, device="cpu")
            if tables else None)
    return ktab, ilbl


def _read_geometry(m) -> Geometry:
    """Measurement group (reference Measurement_0.read_hdf5:475)."""
    emiss = _floats(m, "EMISS_ANG")
    woff = _scalar(m, "WOFF", float, 0.0)
    zeros = np.zeros_like(emiss)

    def opt(name, fill):
        return _floats(m, name) if name in m else fill

    return Geometry(
        fwhm=_scalar(m, "FWHM", float, 0.0),
        latitude=_scalar(m, "LATITUDE", float, 0.0),
        longitude=_scalar(m, "LONGITUDE", float, 0.0),
        ngeom=_scalar(m, "NGEOM"),
        nconv=np.asarray(m["NCONV"][()]).astype(int),
        nav=np.asarray(m["NAV"][()]).astype(int),
        vconv=_floats(m, "VCONV") + woff,
        meas=_floats(m, "MEAS"), errmeas=_floats(m, "ERRMEAS"),
        flat=opt("FLAT", zeros), flon=opt("FLON", zeros),
        sol_ang=opt("SOL_ANG", zeros), emiss_ang=emiss,
        azi_ang=opt("AZI_ANG", zeros), wgeom=opt("WGEOM", zeros + 1),
        tanhe=_floats(m, "TANHE") if "TANHE" in m else None,
        woff=woff,
    )


def _read_cia(cg, base_dir):
    """CIA group (reference CIA_0.read_hdf5:250: a named table and
    INORMAL) -> (CIATables, (name, dnu, npara))."""
    name = _text(cg["CIATABLE"][()])
    inormal = ParaH2Ratio(_scalar(cg, "INORMAL", default=0))
    dnu = _scalar(cg, "DNU", float, 10.0)
    npara = _scalar(cg, "NPARA", default=0)
    tp = name if os.path.isabs(name) else data_path("cia", name)
    if not os.path.exists(tp):
        tp = os.path.join(base_dir, name)
    cia = (read_cia_h5(tp, inormal=inormal, device="cpu")
           if tp.endswith(".h5")
           else read_cia_tab(tp, dnu=dnu, npara=npara, inormal=inormal,
                             device="cpu"))
    return cia, (name, dnu, npara)


def _read_surface(su) -> SurfaceSpec:
    """Surface group, with its Hapke and Oren-Nayar parameter blocks
    (reference Surface_0.read_hdf5:535-545); no group = a gas giant."""
    tsurf = _scalar(su, "TSURF", float, 0.0)
    gasgiant = su is None or tsurf <= 0.0
    lowbc = LowerBoundaryCondition(_scalar(su, "LOWBC", default=0))
    hapke = on_albedo = on_roughness = None
    if su is not None and lowbc == LowerBoundaryCondition.HAPKE:
        hapke = HapkeParams(**{
            field: _t(_floats(su, key)) for field, key in (
                ("vem", "VEM"), ("sglalb", "SGLALB"), ("k", "K"),
                ("bs0", "BS0"), ("hs", "hs"), ("bc0", "BC0"), ("hc", "hc"),
                ("roughness", "ROUGHNESS"), ("g1", "G1"), ("g2", "G2"),
                ("f", "F"))})
    if su is not None and lowbc == LowerBoundaryCondition.OREN_NAYAR:
        on_albedo = _t(_floats(su, "ALBEDO"))
        on_roughness = _t(_floats(su, "ROUGHNESS"))
    return SurfaceSpec(
        tsurf=_t(0.0 if gasgiant else tsurf),
        vem=_t(_floats(su, "VEM") if su is not None else [0.0, 1e6]),
        emissivity=_t(_floats(su, "EMISSIVITY") if su is not None
                      else np.zeros(2)),
        galb=_t(_scalar(su, "GALB", float, 0.0)),
        hapke=hapke, on_albedo=on_albedo, on_roughness=on_roughness,
        lowbc=lowbc, gasgiant=gasgiant,
    )


def _read_telluric(tg, base_dir):
    """Telluric group (reference Telluric_0.read_hdf5:141): a nested
    Atmosphere and Spectroscopy, the observatory's ALTITUDE [m] and
    EMISS_ANG; the tables resolve against ``base_dir`` as the run's do."""
    ktab, _ = _read_tables(tg["Spectroscopy"], base_dir)
    return Telluric(
        atm=_read_atmosphere_group(tg["Atmosphere"]),
        ktables=ktab,
        altitude=_scalar(tg, "ALTITUDE", float, 0.0),
        emiss_ang=_scalar(tg, "EMISS_ANG", float, 180.0),
    )


def load_deck_hdf5(path: str, base_dir: str | None = None) -> Deck:
    """Load a ``runname.h5`` run, or its ``.npz`` export, into the port's
    structures as float64 CPU tensors. Relative table and CIA locations
    resolve against ``base_dir`` (None = the file's directory). A ``.h5``
    needs h5py; where it is missing this raises and names the export."""
    f = read_run_groups(path)
    if base_dir is None:
        base_dir = os.path.dirname(os.path.abspath(path))

    atm = _read_atmosphere_group(f["Atmosphere"])
    ly = f["Layer"]
    laycfg = LayerConfig(
        nlay=_scalar(ly, "NLAY"),
        laytyp=_scalar(ly, "LAYTYP"),
        layint=_scalar(ly, "LAYINT"),
        layht=_scalar(ly, "LAYHT", float, 0.0),
        h_base=_floats(ly, "H_base") if "H_base" in ly else None,
        p_base=_floats(ly, "P_base") if "P_base" in ly else None,
    )
    m = f["Measurement"]
    geom = _read_geometry(m)
    ktab, ilbl = _read_tables(f["Spectroscopy"], base_dir)
    cia = cia_table = None
    if "CIA" in f:
        cia, cia_table = _read_cia(f["CIA"], base_dir)

    sc = f.get("Scatter")
    aero = None
    if sc is not None and "KEXT" in sc and atm.ndust > 0:
        kext = _floats(sc, "KEXT")
        aero = AerosolOptics(wave=_t(_floats(sc, "WAVE")), kext=_t(kext),
                             ksca=_t(_floats(sc, "SGLALB") * kext))
    telluric = None
    if "Telluric" in f:
        telluric = _read_telluric(f["Telluric"], base_dir)
    surf = _read_surface(f.get("Surface"))
    rt = f.get("Retrieval")
    stellar = stellar_from_group(f.get("Stellar"))
    settings = RunSettings(
        ispace=WaveUnit(_scalar(m, "ISPACE", default=0)),
        iscat=_scalar(sc, "ISCAT", default=0), ilbl=ilbl,
        iform=SpectraUnit(_scalar(m, "IFORM", default=0)),
        woff=geom.woff, niter=_scalar(rt, "NITER", default=0),
        philimit=_scalar(rt, "PHILIMIT", float, 0.1),
        inormal=ParaH2Ratio.EQUILIBRIUM,
        iray=_scalar(sc, "IRAY", default=0),
        imie=_scalar(sc, "IMIE", default=0),
        nmu=_scalar(sc, "NMU", default=5), nf=_scalar(sc, "NF", default=0),
        nphi=_scalar(sc, "NPHI", default=100),
        isol=stellar is not None,
        dist=float(stellar.dist) if stellar is not None else 0.0,
        lowbc=surf.lowbc, galb=float(surf.galb),
        tsurf=_scalar(f.get("Surface"), "TSURF", float, 0.0),
        v_doppler=_scalar(m, "V_DOPPLER", float, 0.0),
        ishape=_scalar(m, "ISHAPE", default=0),
        # IFORM=5 normalisation (Measurement_0.py:563)
        vnorm=_scalar(m, "VNORM", float, None),
    )
    return Deck(
        atmosphere=atm, layer_config=laycfg, geometry=geom,
        settings=settings, ktables=ktab, cia=cia, aerosol=aero,
        surface=surf, stellar=stellar, apr_path=None, telluric=telluric,
        table_locations=_locations(f["Spectroscopy"]), cia_table=cia_table,
    )


def write_deck_hdf5(path: str, deck: Deck) -> None:
    """Write a Deck as a single ``runname.h5`` run file that
    ``load_deck_hdf5`` of either package reads: the legacy->HDF5
    conversion (reference Files.write_input_files_hdf5 through the
    per-class write_hdf5 methods, e.g. Atmosphere_0.write_hdf5:414,
    Measurement_0.write_hdf5:475); the JAX package's ``write_deck_hdf5``
    group for group. Spectral tables and CIA stay external files; the run
    file stores their locations. Needs h5py."""
    import h5py

    from archnemesis_tpu_torch.io.stellar import write_stellar_hdf5

    st = deck.settings
    atm = deck.atmosphere
    g = deck.geometry
    lc = deck.layer_config
    with h5py.File(path, "w") as f:
        a = f.create_group("Atmosphere")
        a["H"] = host_array(atm.h)
        a["P"] = host_array(atm.p)
        a["T"] = host_array(atm.t)
        a["VMR"] = host_array(atm.vmr)
        if atm.ndust > 0:
            a["DUST"] = host_array(atm.dust)
        a["ID"] = np.asarray(atm.gas_id, dtype=np.int32)
        a["ISO"] = np.asarray(atm.iso_id, dtype=np.int32)
        a["AMFORM"] = int(atm.amform)
        if int(atm.amform) == 0:
            a["MOLWT"] = host_array(atm.molwt)
        a["IPLANET"] = int(atm.planet)
        a["LATITUDE"] = float(host_array(atm.latitude))

        ly = f.create_group("Layer")
        ly["NLAY"] = int(lc.nlay)
        ly["LAYTYP"] = int(lc.laytyp)
        ly["LAYINT"] = int(lc.layint)
        ly["LAYHT"] = float(lc.layht)
        if lc.h_base is not None:
            ly["H_base"] = host_array(lc.h_base)
        if lc.p_base is not None:
            ly["P_base"] = host_array(lc.p_base)

        m = f.create_group("Measurement")
        m["NGEOM"] = int(g.ngeom)
        m["NCONV"] = np.asarray(g.nconv, dtype=np.int32)
        m["NAV"] = np.asarray(g.nav, dtype=np.int32)
        # VCONV already carries any .spx offset; WOFF=0 keeps a round trip
        # from applying it twice
        m["WOFF"] = 0.0
        for key, v in (("VCONV", g.vconv), ("MEAS", g.meas),
                       ("ERRMEAS", g.errmeas), ("FLAT", g.flat),
                       ("FLON", g.flon), ("SOL_ANG", g.sol_ang),
                       ("EMISS_ANG", g.emiss_ang), ("AZI_ANG", g.azi_ang),
                       ("WGEOM", g.wgeom)):
            m[key] = host_array(v)
        if g.tanhe is not None:
            m["TANHE"] = host_array(g.tanhe)
        m["FWHM"] = float(g.fwhm)
        m["LATITUDE"] = float(g.latitude)
        m["LONGITUDE"] = float(g.longitude)
        m["ISHAPE"] = int(st.ishape)
        m["ISPACE"] = int(st.ispace)
        m["IFORM"] = int(st.iform)
        m["V_DOPPLER"] = float(st.v_doppler)
        if st.vnorm is not None:
            m["VNORM"] = float(st.vnorm)

        sp = f.create_group("Spectroscopy")
        sp["ILBL"] = int(st.ilbl)
        sp["LOCATION"] = np.asarray(
            [s.encode() for s in (deck.table_locations or ())])

        if deck.cia_table is not None:
            cg = f.create_group("CIA")
            name, dnu, npara = deck.cia_table
            cg["CIATABLE"] = name.encode()
            cg["DNU"] = float(dnu)
            cg["NPARA"] = int(npara)
            cg["INORMAL"] = int(st.inormal)

        sc = f.create_group("Scatter")
        for key in ("iray", "imie", "iscat", "nmu", "nf", "nphi"):
            sc[key.upper()] = int(getattr(st, key))
        if deck.aerosol is not None:
            sc["WAVE"] = host_array(deck.aerosol.wave)
            kext = host_array(deck.aerosol.kext)
            ksca = host_array(deck.aerosol.ksca)
            sc["KEXT"] = kext
            with np.errstate(invalid="ignore", divide="ignore"):
                sc["SGLALB"] = np.where(kext > 0, ksca / kext, 0.0)

        if deck.surface is not None:
            su = f.create_group("Surface")
            su["TSURF"] = float(host_array(deck.surface.tsurf))
            su["VEM"] = host_array(deck.surface.vem)
            su["EMISSIVITY"] = host_array(deck.surface.emissivity)
            su["GALB"] = float(host_array(deck.surface.galb))
            su["LOWBC"] = int(deck.surface.lowbc)

        rt = f.create_group("Retrieval")
        rt["NITER"] = int(st.niter)
        rt["PHILIMIT"] = float(st.philimit)

    if deck.stellar is not None:
        write_stellar_hdf5(path, deck.stellar)
