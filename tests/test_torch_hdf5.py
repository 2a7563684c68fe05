"""HDF5 run files and line-by-line tables of the PyTorch port against the
JAX package: ``io/ktables.py:read_lta``/``read_lls``,
``io/hdf5.py:load_deck_hdf5`` (every group of the Mars SO run file, a run
file the JAX package writes from a legacy deck, the Hapke and Oren-Nayar
surface blocks), the HDF5 CIA table and ``Stellar`` group, and the
``.npz`` export that the card reads without h5py."""

import os
import shutil
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu.io import ktables as jax_ktables
from archnemesis_tpu.io.cia import read_cia_h5 as jax_read_cia_h5
from archnemesis_tpu.io.cia import read_cia_tab as jax_read_cia_tab
from archnemesis_tpu.io.hdf5 import load_deck_hdf5 as jax_load_h5
from archnemesis_tpu.io.hdf5 import write_deck_hdf5 as jax_write_h5
from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
from archnemesis_tpu.io.stellar import read_stellar_hdf5 as jax_stellar_h5
from archnemesis_tpu_torch.io import ktables
from archnemesis_tpu_torch.io.cia import read_cia_h5
from archnemesis_tpu_torch.io.hdf5 import (
    export_deck_hdf5,
    load_deck_hdf5,
    read_run_groups,
)
from archnemesis_tpu_torch.io.stellar import read_stellar_hdf5
from port_cases import (
    CIA_TAB,
    DECK,
    SO_H5,
    assert_same_structure,
    np64,
)

PARTS = ("atmosphere", "layer_config", "geometry", "settings", "ktables",
         "cia", "aerosol", "surface", "stellar")
LTA = ["tests/fixtures/ltatables/lbltab_co_iso1.lta",
       "tests/fixtures/ltatables/lbltab_co_iso3.lta",
       "tests/fixtures/titan_fov/ch3cn_19-18.lta",
       "tests/fixtures/tablegen/co_ref.lta"]


def _same_table(got, want):
    for name in ("gas_id", "iso_id", "fwhm"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("wave", "g_ord", "del_g", "press", "temp", "k"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


@pytest.mark.parametrize("path", LTA, ids=os.path.basename)
def test_read_lta_matches_jax(path):
    """Every field equal, the whole table and a window; the grid from the
    header rounded to 7 decimals, as the JAX package builds it."""
    _same_table(ktables.read_lta(path), jax_ktables.read_lta(path))
    whole = jax_ktables.read_lta(path)
    lo, hi = whole.wave[whole.wave.size // 3], whole.wave[-5]
    _same_table(ktables.read_lta(path, lo, hi),
                jax_ktables.read_lta(path, lo, hi))
    with pytest.raises(ValueError, match="no table waves"):
        ktables.read_lta(path, 0.0, 1.0)


def test_read_lls_matches_jax():
    lls = "tests/fixtures/titan_fov/ch3cn.lls"
    got, want = ktables.read_lls(lls), jax_ktables.read_lls(lls)
    assert len(got) == len(want) == 1
    _same_table(got[0], want[0])


@pytest.fixture(scope="module")
def so_decks():
    return load_deck_hdf5(SO_H5), jax_load_h5(SO_H5)


@pytest.mark.parametrize("part", PARTS)
def test_so_run_file_matches_jax(so_decks, part):
    """The Mars SO run file, group by group (no CIA, no Stellar group)."""
    got, want = so_decks
    assert_same_structure(getattr(got, part), getattr(want, part), part)


def test_so_run_file_host_fields(so_decks):
    got, want = so_decks
    assert got.table_locations == want.table_locations
    assert got.cia_table == want.cia_table and got.apr_path is None
    assert got.ktables.k.shape == (3, 1300, 1, 12, 8)
    for t in (got.atmosphere.h, got.ktables.k, got.surface.vem):
        assert t.device.type == "cpu" and t.dtype == torch.float64


def test_export_reads_without_h5py(tmp_path, so_decks):
    """In a process where h5py does not import, as on the card's machine:
    the ``.h5`` raises and names the export, the committed export loads,
    and every tensor of it equals the ``.h5``'s."""
    out = tmp_path / "deck.npz"
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import numpy as np, torch\n"
        "from archnemesis_tpu_torch.io.hdf5 import load_deck_hdf5\n"
        f"try:\n    load_deck_hdf5({SO_H5!r})\n"
        "except ImportError as e:\n    assert 'export' in str(e), e\n"
        "else:\n    raise AssertionError('the .h5 loaded without h5py')\n"
        f"d = load_deck_hdf5({chip_smoke.SO_EXPORT!r}, "
        f"base_dir={chip_smoke.SO_DECK!r})\n"
        "flat = {}\n"
        f"for part in {PARTS!r}:\n"
        "    obj = getattr(d, part)\n"
        "    for k, v in (vars(obj).items() if obj is not None else ()):\n"
        "        if isinstance(v, torch.Tensor):\n"
        "            flat[part + '.' + k] = v.numpy()\n"
        f"np.savez({str(out)!r}, **flat)\n"
        "assert 'h5py' not in [m for m in sys.modules if sys.modules[m]]\n"
    )
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    got = np.load(out)
    h5 = so_decks[0]
    assert len(got.files) > 20
    for key in got.files:
        part, name = key.split(".")
        np.testing.assert_array_equal(got[key],
                                      np64(getattr(getattr(h5, part), name)),
                                      err_msg=key)


def test_committed_export_is_the_run_files(tmp_path):
    """The committed export is what ``export_deck_hdf5`` writes from the
    fixture today (``tests/port_cases.write_deck_export``): the same keys,
    types and values."""
    fresh = tmp_path / "fresh.npz"
    export_deck_hdf5(SO_H5, str(fresh))
    a, b = np.load(fresh), np.load(chip_smoke.SO_EXPORT)
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with h5py.File(SO_H5, "r") as f:
        n = []
        f.visititems(lambda name, o: n.append(name)
                     if isinstance(o, h5py.Dataset) else None)
    assert sorted(n) == sorted(a.files)
    groups = read_run_groups(str(fresh))
    assert groups["Spectroscopy"]["LOCATION"][0] == \
        b"../ltatables/lbltab_co_iso1.lta"


def test_jax_written_run_file_matches_jax(tmp_path):
    """A run file the JAX package writes from the legacy ``jupiter_nadir``
    deck (k-tables, the CIA group, the Stellar group, Scatter and Surface):
    both packages read it alike."""
    h5 = str(tmp_path / "cirstest.h5")
    jax_write_h5(h5, jax_load_deck(DECK, "cirstest"))
    got, want = load_deck_hdf5(h5), jax_load_h5(h5)
    for part in PARTS:
        assert_same_structure(getattr(got, part), getattr(want, part), part)
    assert got.cia_table == want.cia_table and got.cia is not None
    assert got.stellar is not None and got.settings.isol


def _edited(src, dst, edit):
    """A copy of the run file ``src`` edited by ``edit(h5py.File)``, its
    table locations made absolute (as tests/test_retrieval_transit.py
    retargets them)."""
    shutil.copy(src, dst)
    base = os.path.dirname(os.path.abspath(src))
    with h5py.File(dst, "a") as f:
        locs = [os.path.join(base, x.decode())
                for x in f["Spectroscopy/LOCATION"][()]]
        del f["Spectroscopy/LOCATION"]
        f["Spectroscopy/LOCATION"] = np.asarray([x.encode() for x in locs])
        edit(f)
    return str(dst)


@pytest.mark.parametrize("lowbc", [2, 3], ids=["hapke", "oren_nayar"])
def test_surface_blocks_match_jax(tmp_path, lowbc):
    """The Surface group's Hapke (LOWBC = 2) and Oren-Nayar (3) parameter
    blocks (reference Surface_0.read_hdf5:535-545)."""
    def edit(f):
        su = f["Surface"]
        su["LOWBC"][...] = lowbc
        n = su["VEM"].shape[0]
        keys = (("SGLALB", "K", "BS0", "hs", "BC0", "hc", "ROUGHNESS", "G1",
                 "G2", "F") if lowbc == 2 else ("ALBEDO", "ROUGHNESS"))
        for i, key in enumerate(keys):
            su[key] = np.linspace(0.1, 0.2, n) + 0.01 * i
    h5 = _edited(SO_H5, tmp_path / "surf.h5", edit)
    got, want = load_deck_hdf5(h5), jax_load_h5(h5)
    assert_same_structure(got.surface, want.surface, "surface")
    assert (got.surface.hapke is None) == (lowbc != 2)
    assert (got.surface.on_albedo is None) == (lowbc != 3)


def test_cia_and_stellar_hdf5_match_jax(tmp_path):
    """An HDF5 CIA table (written from the committed .tab) and a Stellar
    group, read by both packages; the deck's CIA group naming the .h5."""
    tab = jax_read_cia_tab(CIA_TAB, dnu=1.0, npara=0)
    cia_h5 = str(tmp_path / "iso.h5")
    with h5py.File(cia_h5, "w") as f:
        f["NPARA"] = 0
        f["IPAIRG1"] = np.asarray(tab.pair_gas1)
        f["IPAIRG2"] = np.asarray(tab.pair_gas2)
        f["INORMALT"] = np.asarray(tab.inormalt)
        f["WAVEN"] = np.asarray(tab.waven)
        f["TEMP"] = np.asarray(tab.temp)
        f["K_CIA"] = np.asarray(tab.k_cia)[:, 0]
    assert_same_structure(read_cia_h5(cia_h5, device="cpu"),
                          jax_read_cia_h5(cia_h5), "cia")

    def edit(f):
        g = f.create_group("Stellar")
        for key, value in chip_smoke.TRANSIT_STELLAR.items():
            g[key] = value
        c = f.create_group("CIA")
        c["CIATABLE"] = cia_h5.encode()
        c["INORMAL"] = 1
    h5 = _edited(SO_H5, tmp_path / "run.h5", edit)
    assert_same_structure(read_stellar_hdf5(h5), jax_stellar_h5(h5),
                          "stellar")
    got, want = load_deck_hdf5(h5), jax_load_h5(h5)
    for part in ("cia", "stellar", "settings"):
        assert_same_structure(getattr(got, part), getattr(want, part), part)
    assert read_stellar_hdf5(SO_H5) is None


def _add_telluric_group(f):
    """The telluric run's ``Telluric`` group (``chip_smoke.TELLURIC_EXPORT``)
    written into ``f``, its table locations made absolute."""
    z = np.load(chip_smoke.TELLURIC_EXPORT)
    for key in z.files:
        if not key.startswith("Telluric/"):
            continue
        v = z[key]
        if key.endswith("/LOCATION"):
            v = np.asarray([os.path.abspath(os.path.join(
                chip_smoke.PORT_DATA, x.decode())).encode() for x in v])
        f[key] = v


def test_telluric_group_raises(tmp_path):
    """A ``Telluric`` group (which raised before the telluric transmission
    was ported) loads in both packages alike, field by field: the Earth
    atmosphere, its tables, ALTITUDE and EMISS_ANG; the rest of the run
    as without it."""
    h5 = _edited(SO_H5, tmp_path / "tel.h5", _add_telluric_group)
    got, want = load_deck_hdf5(h5), jax_load_h5(h5)
    assert_same_structure(got.telluric, want.telluric, "telluric")
    assert (got.telluric.altitude, got.telluric.emiss_ang) == (
        chip_smoke.TELLURIC_ALTITUDE, chip_smoke.TELLURIC_EMISS_ANG)
    for part in PARTS:
        assert_same_structure(getattr(got, part), getattr(want, part), part)
    assert load_deck_hdf5(SO_H5).telluric is None
