"""Telluric transmission in the PyTorch port (``rt/telluric.py``, the
``Telluric`` group of ``io/hdf5.py``, model 202 and the telluric step of
``retrievals.make_retrieval_setup``) against the JAX package:
``telluric_transmission`` and ``apply_telluric`` (Doppler 10 km/s) on
``tests/test_telluric.py``'s case at rtol 1e-10; the CIRC extractor and the
ERA5 host functions; and the telluric run (``jupiter_nadir`` as an HDF5 run
with a ``Telluric`` group and model 202 in its .apr; the committed export
``chip_smoke.TELLURIC_EXPORT``) loaded from the ``.h5`` and from the
export alike, its set-up against JAX's, and the spectrum and Jacobian
columns (model 202's and two of model 0's) of a copy of the run file
thinned to its 600-700 cm-1 channels, read from the ``.h5`` and from its
export, against JAX's."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu.core.spectra import KTables as JKTables
from archnemesis_tpu.core.types import Atmosphere as JAtmosphere
from archnemesis_tpu.rt import telluric as jtel
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.io.hdf5 import load_deck_hdf5
from archnemesis_tpu_torch.models import MODEL_REGISTRY
from archnemesis_tpu_torch.rt import telluric as ttel
from port_cases import (
    assert_same_structure,
    cuda,  # noqa: F401 (a fixture)
    flat,
    np64,
    one_torch_thread,  # noqa: F401 (a fixture)
    telluric_ktables,
    write_telluric_export,
    write_telluric_run,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NP_ = 25
ALTITUDE = chip_smoke.TELLURIC_ALTITUDE
EMISS = chip_smoke.TELLURIC_EMISS_ANG


@pytest.fixture(scope="module")
def tel_case():
    """tests/test_telluric.py's Earth atmosphere and seeded k-tables (2000-
    2100 cm-1, 120 waves) as the JAX package's Telluric and the port's."""
    h = np.linspace(0.0, 8.0e4, NP_)
    p = 101325.0 * np.exp(-h / 7.5e3)
    t = (288.0 - 6.5e-3 * np.clip(h, 0, 1.2e4)
         + 2.0e-4 * np.clip(h - 1.2e4, 0, None))
    vmr = np.stack([1e-2 * np.exp(-h / 2.0e3), np.full(NP_, 4.0e-4)], axis=1)
    wave = np.linspace(2000.0, 2100.0, 120)
    g_ord, del_g, k, press, temp = telluric_ktables(wave)
    atm = JAtmosphere(
        h=h, p=p, t=t, vmr=vmr, dust=np.zeros((NP_, 0)),
        parah2=np.zeros(NP_), molwt=np.full(NP_, 28.96e-3),
        radius=np.asarray(6.371e6), latitude=np.asarray(19.8),
        gas_id=(1, 2), iso_id=(0, 0), planet=3)
    ktab = JKTables(wave=wave, g_ord=g_ord, del_g=del_g, press=press,
                    temp=temp, k=k, gas_id=(1, 2), iso_id=(0, 0))
    want = jtel.Telluric(atm=atm, ktables=ktab, altitude=ALTITUDE,
                         emiss_ang=EMISS)
    return want, convert.telluric(flat(want), device="cpu")


def test_transmission_matches_jax(tel_case):
    want, got = tel_case
    w_wave, w_trans = jtel.telluric_transmission(want)
    g_wave, g_trans = ttel.telluric_transmission(got)
    np.testing.assert_array_equal(g_wave.numpy(), np.asarray(w_wave))
    assert float(np.min(w_trans)) < 0.95  # the band absorbs
    np.testing.assert_allclose(g_trans.numpy(), np.asarray(w_trans),
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("ispace", [0, 1], ids=["wavenumber", "wavelength"])
def test_apply_telluric_matches_jax(tel_case, ispace):
    """The planetary grid shifted by a 10 km/s Doppler velocity, the
    telluric lines not: rtol 1e-10; no telluric leaves the spectrum."""
    want, got = tel_case
    wave = np.asarray(want.ktables.wave)
    spec = 1.0 + np.sin(wave / 7.0) ** 2
    w = jtel.apply_telluric(want, jnp.asarray(wave), jnp.asarray(spec),
                            v_doppler=10.0, ispace=ispace)
    g = ttel.apply_telluric(got, torch.as_tensor(wave),
                            torch.as_tensor(spec), v_doppler=10.0,
                            ispace=ispace)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=0)
    s = torch.as_tensor(spec)
    assert ttel.apply_telluric(None, torch.as_tensor(wave), s) is s


def test_transmission_jvp_matches_jax(tel_case):
    """The JVP of the transmission along model 202's H2O VMR scale (the
    Earth's layering under the transform) against JAX's, rtol 1e-10 of the
    peak."""
    want, got = tel_case
    entry = MODEL_REGISTRY[202].from_apr(
        __import__("io").StringIO("1.0 0.1\n"), [1, 0, 202], 0, {}).entry
    from archnemesis_tpu.models import MODEL_REGISTRY as JAX_MODELS

    def port_f(x):
        tel = MODEL_REGISTRY[202].apply_telluric(entry, got, x)
        return ttel.telluric_transmission(tel)[1]

    def jax_f(x):
        tel = JAX_MODELS[202].apply_telluric(entry, want, x)
        return jtel.telluric_transmission(tel)[1]

    one = np.ones(1)
    _, g = torch.func.jvp(port_f, (torch.as_tensor(one),),
                          (torch.as_tensor(one),))
    _, w = jax.jvp(jax_f, (jnp.asarray(one),), (jnp.asarray(one),))
    w = np.asarray(w)
    assert np.abs(w).max() > 0
    np.testing.assert_allclose(g.numpy(), w, rtol=0,
                               atol=1e-10 * np.abs(w).max())


def test_model_202_temperature_and_unknown_gas(tel_case):
    want, got = tel_case
    m = MODEL_REGISTRY[202]
    entry = m.from_apr(__import__("io").StringIO("1.0 0.1\n"), [0, 0, 202],
                       0, {}).entry
    x = torch.tensor([1.1], dtype=torch.float64)
    scaled = m.apply_telluric(entry, got, x)
    np.testing.assert_allclose(scaled.atm.t.numpy(),
                               np.asarray(want.atm.t) * 1.1, rtol=1e-15)
    assert m.apply_telluric(entry, None, x) is None
    bad = dataclasses.replace(entry, varident=(6, 0, 202))
    with pytest.raises(ValueError, match="not in telluric atmosphere"):
        m.apply_telluric(bad, got, x)


def test_extract_atmosphere_circ_matches_jax():
    got, want = ttel.extract_atmosphere_circ(), jtel.extract_atmosphere_circ()
    assert_same_structure(got, want, "circ")
    assert got.gas_id == (1, 2, 3, 4, 5, 6, 7, 22) and got.h.shape[0] == 54


def test_era5_host_functions_match_jax():
    """The CDS request, the grid interpolation and the profile assembly
    (with its hydrostatic rebalance, rtol 1e-10) as the JAX package's; the
    download path raises and names what it needs."""
    for args in (("01-01-2020", "10:47:13", 19.82067, -155.46806),
                 ("31-12-2020", "23:45:00", 0.0, 0.0)):
        g, w = ttel.era5_request(*args), jtel.era5_request(*args)
        assert g[0] == w[0] and g[1] == w[1]
        np.testing.assert_array_equal(g[2], w[2])
    press = ttel.era5_request("01-01-2020", "00:00:00", 19.8, -155.5)[2]
    n = press.size
    rng = np.random.default_rng(9)
    temp = 290.0 - 70.0 * np.linspace(0, 1, n) + rng.uniform(-2, 2, n)
    q = 1.0e-2 * np.exp(-np.linspace(0, 6, n))
    o3 = 1.0e-6 * np.exp(-((np.linspace(0, 1, n) - 0.8) / 0.2) ** 2)
    got = ttel.era5_profiles_to_atmosphere(press, temp, q, o3, 19.8, -155.5)
    want = jtel.era5_profiles_to_atmosphere(press, temp, q, o3, 19.8,
                                            -155.5)
    for name in ("h", "p", "t", "vmr", "molwt"):
        np.testing.assert_allclose(np64(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-10, atol=1e-9, err_msg=name)
    assert (got.gas_id, got.planet) == (want.gas_id, want.planet)
    lats = np.array([[19.75, 19.75], [20.0, 20.0]])
    lons = np.array([[-155.75, -155.5], [-155.75, -155.5]])
    f = rng.uniform(size=(2, 2, 3))
    np.testing.assert_allclose(
        ttel.grib_interp_location(f, lats, lons, 19.8, -155.6),
        jtel.grib_interp_location(f, lats, lons, 19.8, -155.6), rtol=1e-15)
    with pytest.raises(NotImplementedError, match="cdsapi.*pygrib"):
        ttel.extract_atmosphere_era5()


# --- the telluric run

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(deck directory, the run file written there by the JAX package's
    writer) of the telluric run."""
    base = str(tmp_path_factory.mktemp("telluric"))
    deck = chip_smoke.telluric_deck(base)
    return deck, write_telluric_run(deck)


def test_committed_files_equal_fresh_ones(tmp_path):
    """The committed tables and export equal a fresh write of them."""
    write_telluric_export(str(tmp_path))
    for name, _ in chip_smoke.TELLURIC_TABLES:
        with open(tmp_path / name, "rb") as a, \
                open(os.path.join(chip_smoke.PORT_DATA, name), "rb") as b:
            assert a.read() == b.read(), name
    export = os.path.basename(chip_smoke.TELLURIC_EXPORT)
    fresh = np.load(tmp_path / export)
    committed = np.load(chip_smoke.TELLURIC_EXPORT)
    assert sorted(fresh.files) == sorted(committed.files)
    for key in fresh.files:
        np.testing.assert_array_equal(fresh[key], committed[key], key)


def test_run_loads_alike_from_h5_and_export(run):
    """The port reads the ``.h5`` and the committed export into equal decks,
    both equal to the JAX package's read of the ``.h5`` (the Telluric
    group's tables by their relative LOCATIONs)."""
    from archnemesis_tpu.io.hdf5 import load_deck_hdf5 as jax_load_h5

    deck, h5 = run
    from_h5 = load_deck_hdf5(h5)
    from_npz = load_deck_hdf5(chip_smoke.TELLURIC_EXPORT, base_dir=deck)
    want = jax_load_h5(h5)
    for part in ("atmosphere", "geometry", "settings", "ktables", "cia",
                 "aerosol", "surface", "telluric"):
        assert_same_structure(getattr(from_h5, part), getattr(want, part),
                              part)
        assert_same_structure(getattr(from_npz, part), getattr(want, part),
                              part)
    assert from_npz.telluric.ktables.gas_id == (1, 2)


def _thin_run(h5, dst, vmin=600.0, vmax=700.0):
    """A copy of the run file keeping the channels in [vmin, vmax] cm-1
    (the set-up's calc window shrinks with them: ~40 waves), so that
    Jacobian columns are cheap on the CPU."""
    import shutil

    import h5py

    shutil.copy(h5, dst)
    with h5py.File(dst, "a") as f:
        m = f["Measurement"]
        nconv = int(m["NCONV"][()][0])
        v = m["VCONV"][()][:nconv, 0]
        keep = np.where((v >= vmin) & (v <= vmax))[0]
        for key in ("VCONV", "MEAS", "ERRMEAS"):
            x = m[key][()][keep]
            del m[key]
            m[key] = x
        del m["NCONV"]
        m["NCONV"] = np.asarray([keep.size], dtype=np.int32)
    return dst


def _jax_setup(deck, h5):
    """The JAX package's set-up on a run file: its
    ``make_retrieval_setup`` reads a legacy deck, so its loader is swapped
    for the run file's here."""
    import archnemesis_tpu.retrievals as jr
    from archnemesis_tpu.io.hdf5 import load_deck_hdf5 as jax_load_h5

    def load_run(d, r):
        return dataclasses.replace(jax_load_h5(h5),
                                   apr_path=os.path.join(d, r + ".apr"))

    mp = pytest.MonkeyPatch()
    mp.setattr(jr, "load_deck", load_run)
    try:
        return jr.make_retrieval_setup(deck, "cirstest")
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def full(run):
    """The port's telluric set-up on the committed export and the JAX
    package's on the ``.h5``."""
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    deck, h5 = run
    port = make_retrieval_setup(deck, "cirstest", device="cpu",
                                deck_file=chip_smoke.TELLURIC_EXPORT)
    return dict(port=port, jx=_jax_setup(deck, h5))


def test_setup_matches_jax(full):
    """The whole run (698 channels, models 0 and 202): the a priori, its
    covariance and the measurement as JAX's. Its spectrum is held to the
    CPU's on the card (``chip_smoke.py`` phase 24)."""
    port, jx = full["port"], full["jx"]
    assert [e.model_id for e in port.sv.entries] == [0, 202]
    assert port.deck.telluric is not None
    assert port.y.shape == (698,)
    np.testing.assert_array_equal(port.sv.xa, jx.sv.xa)
    np.testing.assert_array_equal(port.sv.sa, jx.sv.sa)
    np.testing.assert_array_equal(port.y, jx.y)


@pytest.fixture(scope="module")
def thin(run, tmp_path_factory):
    """The set-ups of the thinned run file (``_thin_run``) read from the
    ``.h5`` in both packages, and their JVPs along model 202's column and
    two of model 0's: the port's one ``vmap`` of ``jvp``, JAX's jitted."""
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    from archnemesis_tpu_torch.io.hdf5 import export_deck_hdf5

    deck, h5 = run
    thin_h5 = _thin_run(h5, os.path.join(deck, "thin.h5"))
    thin_npz = os.path.join(deck, "thin.npz")
    export_deck_hdf5(thin_h5, thin_npz)
    port = make_retrieval_setup(deck, "cirstest", device="cpu",
                                deck_file=thin_h5)
    port_npz = make_retrieval_setup(deck, "cirstest", device="cpu",
                                    deck_file=thin_npz)
    jx = _jax_setup(deck, thin_h5)
    cols = [port.sv.nx - 1, 20, 60]
    basis = np.zeros((len(cols), port.sv.nx))
    basis[np.arange(len(cols)), cols] = 1.0
    xa = port.sv.xa
    y, dy = torch.func.vmap(
        lambda v: torch.func.jvp(port.forward_fn, (torch.as_tensor(xa),),
                                 (v,)),
        out_dims=(None, 0))(torch.as_tensor(basis))
    jy, jdy = jax.jit(jax.vmap(
        lambda v: jax.jvp(jx.forward_fn, (jnp.asarray(xa),), (v,)),
        out_axes=(None, 0)))(jnp.asarray(basis))
    return dict(y=y.numpy(), jy=np.asarray(jy), dy=dy.numpy(),
                jdy=np.asarray(jdy), ny=port.y.shape[0],
                y_npz=port_npz.forward_fn(xa).numpy())


def test_jacobian_matches_jax(thin):
    """Model 202's column and two of model 0's within 1e-10 of each
    column's peak, the spectrum at rtol 1e-10, on the run's 600-700 cm-1
    channels; model 202's column is nonzero; the run's export gives the
    ``.h5``'s spectrum bit for bit."""
    assert 0 < thin["ny"] < 698
    np.testing.assert_array_equal(thin["y_npz"], thin["y"])
    np.testing.assert_allclose(thin["y"], thin["jy"], rtol=1e-10, atol=0)
    dy, jdy = thin["dy"], thin["jdy"]
    peak = np.abs(jdy).max(axis=1)
    assert np.all(peak > 0)
    err = np.abs(dy - jdy).max(axis=1) / peak
    assert err.max() < 1e-10, err


@pytest.mark.cuda
def test_telluric_setup_on_card_matches_cpu(cuda, tmp_path):
    """On the card, the telluric run thinned to its 600-700 cm-1 channels
    (``chip_smoke.thin_export`` of the committed export, no h5py): the
    forward through kernel 1 (6 launches for the planet, 1 for the
    telluric pair) equal to the CPU's within 1e-10, and the evaluation
    through kernel 1t (7 launches), model 202's column as the CPU's JVP
    within 1e-10 of its peak."""
    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_with_tangents,
    )
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    deck = chip_smoke.telluric_deck(str(tmp_path))
    thin = chip_smoke.thin_export(chip_smoke.TELLURIC_EXPORT,
                                  str(tmp_path / "thin.npz"), 600.0, 700.0)
    card = make_retrieval_setup(deck, "cirstest", device=cuda,
                                deck_file=thin)
    cpu = make_retrieval_setup(deck, "cirstest", device="cpu",
                               deck_file=thin)
    xa = torch.as_tensor(card.sv.xa, device=cuda)
    before = combine_pair.launches
    y = card.forward_fn(xa)
    torch.cuda.synchronize()
    assert combine_pair.launches - before == 7
    np.testing.assert_allclose(y.cpu().numpy(),
                               cpu.forward_fn(cpu.sv.xa).numpy(),
                               rtol=1e-10, atol=0)
    before = combine_pair_with_tangents.launches
    _, kk = forward_and_jacobian(card.forward_fn, xa)
    torch.cuda.synchronize()
    assert combine_pair_with_tangents.launches - before == 7
    v = torch.zeros(cpu.sv.nx, dtype=torch.float64)
    v[-1] = 1.0
    _, dy = torch.func.jvp(cpu.forward_fn, (torch.as_tensor(cpu.sv.xa),),
                           (v,))
    np.testing.assert_allclose(kk[:, -1].cpu().numpy(), dy.numpy(), rtol=0,
                               atol=1e-10 * float(dy.abs().max()))


# --- ERA5 extraction with the optional modules stubbed

class _Grib:
    """One GRIB message of the stub: a parameter on one level of the 2x2
    cell around the default location."""

    def __init__(self, name, values):
        self.name, self.values = name, values

    def latlons(self):
        return (np.array([[19.75, 19.75], [20.0, 20.0]]),
                np.array([[-155.5, -155.25], [-155.5, -155.25]]))


def _era5_modules(seed: int = 13) -> tuple:
    """``cdsapi`` and ``pygrib`` stand-ins serving a seeded 2x2-cell grid
    of temperature, specific humidity and ozone on the 37 ERA5 levels
    (with a message the extractor skips); the retrieve calls are kept."""
    import types

    rng = np.random.default_rng(seed)
    levels = ttel.ERA5_PRESS_LEVELS_HPA / 1000.0
    fields = {
        "Temperature": 190.0 + 100.0 * levels[:, None, None],
        "Specific humidity": 1.0e-2 * levels[:, None, None] ** 3,
        "Ozone mass mixing ratio": 1.0e-6 * np.exp(-levels[:, None, None]),
        "Geopotential": np.ones((levels.size, 1, 1)),
    }
    messages = [_Grib(name, v * rng.uniform(0.95, 1.05, (2, 2)))
                for name, stack in fields.items() for v in stack]
    calls = []
    cdsapi = types.ModuleType("cdsapi")

    class Client:
        def retrieve(self, dataset, request, target):
            calls.append((dataset, request))
            with open(target, "wb") as f:
                f.write(b"GRIB")

    cdsapi.Client = Client
    pygrib = types.ModuleType("pygrib")

    class _Open(list):
        closed = False

        def close(self):
            self.closed = True

    pygrib.open = lambda path: _Open(messages)
    return cdsapi, pygrib, calls


def test_era5_extraction_matches_jax(monkeypatch):
    """With ``cdsapi`` and ``pygrib`` stubbed, both packages request the
    same data and return the same atmosphere (rtol 1e-12); without them
    both raise ``NotImplementedError``."""
    import sys

    for name in ("cdsapi", "pygrib"):
        monkeypatch.setitem(sys.modules, name, None)
    for fn in (ttel.extract_atmosphere_era5, jtel.extract_atmosphere_era5):
        with pytest.raises(NotImplementedError, match="cdsapi"):
            fn()
    cdsapi, pygrib, calls = _era5_modules()
    monkeypatch.setitem(sys.modules, "cdsapi", cdsapi)
    monkeypatch.setitem(sys.modules, "pygrib", pygrib)
    args = ("02-03-2021", "06:00:00", 19.82067, -155.46806)
    got = ttel.extract_atmosphere_era5(*args)
    want = jtel.extract_atmosphere_era5(*args)
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0][1]["day"] == "02" and calls[0][1]["time"] == "06:00"
    assert (got.gas_id, got.iso_id, got.planet) == (want.gas_id, want.iso_id,
                                                    want.planet)
    for name in ("h", "p", "t", "vmr", "molwt", "radius", "latitude"):
        np.testing.assert_allclose(np64(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    assert got.p.shape[0] == ttel.ERA5_PRESS_LEVELS_HPA.size
