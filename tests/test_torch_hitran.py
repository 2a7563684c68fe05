"""HITRAN ingestion in the PyTorch port (``io/hitran.py``, ``native/``)
against the JAX package: ``parse_par`` through the C++ and the numpy
decoders bit for bit equal to JAX's on 160- and 100-char files (JAX's
numpy decoder: its own tests hold its C++ decoder to it), the decoder's
edge cases, the RADTRAN->HITRAN/GEISA mappings, the TIPS tables read from
the committed ``.npz`` export against JAX's from the ``.h5``, line lists
for iso 0-3 and ``s_min``, and one list through the LBL synthesis at 256
waves (float64, rtol 1e-10)."""

import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu import native as jnative
from archnemesis_tpu.io import hitran as jhitran
from archnemesis_tpu.ops.lbl import build_blocks as jax_build_blocks
from archnemesis_tpu.ops.lbl import lbl_cross_section as jax_lbl
from archnemesis_tpu_torch import native
from archnemesis_tpu_torch.io import hitran
from archnemesis_tpu_torch.ops.lbl import build_blocks, lbl_cross_section
from archnemesis_tpu_torch.utils.datafiles import data_file, gas_info
from port_cases import (
    assert_same_linelist,
    one_torch_thread,  # noqa: F401 (a fixture)
    synth_par_lines,
    synthetic_par,
    write_par,
)

JAX_TIPS = jhitran.TIPS_PATH


@pytest.fixture
def jax_numpy_decoder(monkeypatch):
    """The JAX package's parse_par on its numpy decoder (no build of its
    library next to its sources)."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def _assert_same_columns(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].view(np.uint8),
                                      want[key].view(np.uint8), err_msg=key)


@pytest.mark.parametrize("width,nrec", [(160, 2000), (100, 64)])
@pytest.mark.parametrize("use_native", [None, False])
def test_parse_par_matches_jax(width, nrec, use_native):
    buf = synthetic_par(nrec=nrec, width=width)
    got = hitran.parse_par(buf, use_native=use_native)
    want = jhitran.parse_par(buf, use_native=False)
    _assert_same_columns(got, want)
    assert set(got["local_iso_id"]) >= {10, 11, 12}  # '0', 'A', 'B'


def test_parse_par_reads_a_file_and_crlf(tmp_path):
    buf = synthetic_par(nrec=50)
    path = tmp_path / "a.par"
    path.write_bytes(buf.replace(b"\n", b"\r\n")[:-2])  # no final newline
    _assert_same_columns(hitran.parse_par(str(path)),
                         jhitran.parse_par(str(path), use_native=False))


def test_chip_catalogue_decodes_alike():
    """``chip_smoke.ingest_par`` (phase 25's catalogue) at a small size:
    both decoders and JAX's equal, the CO records counted by iso."""
    co = {"1": 40, "2": 30, "3": 20}
    buf = chip_smoke.ingest_par(n=600, seed=3, co=co)
    got = hitran.parse_par(buf)
    _assert_same_columns(got, hitran.parse_par(buf, use_native=False))
    _assert_same_columns(got, jhitran.parse_par(buf, use_native=False))
    for iso, n in co.items():
        assert int(((got["mol_id"] == 5)
                    & (got["local_iso_id"] == int(iso))).sum()) == n
    assert (got["mol_id"] == 5).sum() == sum(co.values())


def test_native_rejects_garbage():
    rec = "not a hitran record at all, just text" + " " * 123
    with pytest.raises(ValueError):
        hitran.parse_par((rec + "\n").encode())


def test_fortran_d_exponent_and_blanks():
    cols = [("v", 0, 12, native.KIND_F64), ("n", 12, 16, native.KIND_I32)]
    buf = b"   1.250D-03  42\n" + b" " * 16 + b"\n"  # blank record: NaN / 0
    out = native.parse_fixed(buf, 17, cols)
    assert out["v"][0] == pytest.approx(1.25e-3)
    assert out["n"][0] == 42
    assert np.isnan(out["v"][1]) and out["n"][1] == 0
    with pytest.raises(ValueError, match="multiple of stride"):
        native.parse_fixed(buf[:-1], 17, cols)
    with pytest.raises(ValueError, match="spans bytes"):
        native.parse_fixed(buf, 17, [("v", 10, 20, native.KIND_F64)])


def test_mappings_match_jax():
    import json

    with open(data_file("assets", "db_mappings.json")) as f:
        raw = json.load(f)
    for name, fn, jfn in (
            ("radtran_to_hitran", hitran.radtran_to_hitran,
             jhitran.radtran_to_hitran),
            ("radtran_to_geisa", hitran.radtran_to_geisa,
             jhitran.radtran_to_geisa)):
        assert raw[name]
        for key, _ in raw[name]:
            assert fn(*key) == jfn(*key), (name, key)
        with pytest.raises(KeyError):
            fn(999, 1)


def _tips_pairs():
    """(gas_id, iso) of every isotopologue group under the TIPS file's
    ``partition_function/`` (its ``sources/TIPS2025/`` holds the same
    datasets again); every molecule there is in the gas catalogue."""
    ids = {v["name"]: int(k) for k, v in gas_info().items()}
    with np.load(hitran.TIPS_PATH) as f:
        groups = {tuple(k.split("/")[1:3]) for k in f.files
                  if k.startswith("partition_function/")}
    assert len(groups) == 156 and {mol for mol, _ in groups} <= ids.keys()
    return sorted((ids[mol], int(iso)) for mol, iso in groups)


def test_tips_export_matches_h5_for_every_isotopologue():
    pairs = _tips_pairs()
    for gas_id, iso in pairs:
        got = hitran.read_tips(hitran.TIPS_PATH, gas_id, iso)
        want = jhitran.read_tips(JAX_TIPS, gas_id, iso)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{gas_id}.{iso}")
    # the .h5 branch of the port's reader, and iso 0 (the principal's)
    for g, w in zip(hitran.read_tips(JAX_TIPS, 5, 0),
                    jhitran.read_tips(JAX_TIPS, 5, 0)):
        np.testing.assert_array_equal(g, w)


def test_tips_export_equals_a_fresh_export(tmp_path):
    """The committed ``data/tips2025.npz`` holds every dataset of the
    ``.h5`` under its path, equal bit for bit (strings as bytes)."""
    import h5py

    fresh = tmp_path / "tips.npz"
    hitran.export_tips(JAX_TIPS, str(fresh))
    with np.load(hitran.TIPS_PATH) as got, np.load(fresh) as new, \
            h5py.File(JAX_TIPS, "r") as h5:
        assert sorted(got.files) == sorted(new.files)
        assert len(got.files) == 1248
        for key in got.files:
            np.testing.assert_array_equal(got[key], new[key], err_msg=key)
            np.testing.assert_array_equal(got[key], np.asarray(h5[key][()]),
                                          err_msg=key)


@pytest.fixture(scope="module")
def par_file(tmp_path_factory):
    lines = synth_par_lines()
    path = write_par(tmp_path_factory.mktemp("hitran") / "co.par", lines)
    return path, lines


@pytest.mark.parametrize("iso_id,s_min", [(0, 0.0), (1, 0.0), (2, 0.0),
                                          (3, 0.0), (1, 1e-22), (0, 1e-22)])
def test_linelist_from_par_matches_jax(par_file, jax_numpy_decoder, iso_id,
                                       s_min):
    path, lines = par_file
    got = hitran.linelist_from_par(path, 5, iso_id, s_min=s_min)
    want = jhitran.linelist_from_par(path, 5, iso_id, s_min=s_min)
    assert_same_linelist(got, want, f"iso {iso_id}, s_min {s_min}")
    if iso_id == 0 and s_min == 0.0:
        assert got.n_lines == len(lines)
        assert np.all(got.broad[0] > 0)  # the self-width fallback


def test_linelist_from_par_raises_without_lines(par_file):
    with pytest.raises(ValueError, match="no lines"):
        hitran.linelist_from_par(par_file[0], 5, 1, s_min=1.0)


def test_par_list_through_lbl_matches_jax(par_file, jax_numpy_decoder,
                                          one_torch_thread):  # noqa: F811
    path, _ = par_file
    ll = hitran.linelist_from_par(path, 5, 1)
    jll = jhitran.linelist_from_par(path, 5, 1)
    wave = np.linspace(2050.0, 2180.0, 256)
    state = (np.array([180.0, 250.0]), np.array([1e-3, 1e-2]),
             np.array([0.9, 0.9]))
    got = lbl_cross_section(ll, build_blocks(wave, ll.nu), *state,
                            device="cpu")
    want = np.asarray(jax_lbl(jll, jax_build_blocks(wave, jll.nu), *state,
                              use_pallas=False))
    assert got.dtype == torch.float64 and got.shape == (256, 2)
    assert want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)
