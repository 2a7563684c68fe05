"""GEISA and ExoMol ingestion in the PyTorch port (``io/geisa.py``,
``io/exomol.py``) against the JAX package: the GEISA records written
byte for byte alike, parsed by both decoders and made into line lists
equal bit for bit; the ExoMol readers, partition function and line lists
(with and without ``.broad``, from plain and gzip'd files) equal bit for
bit; a ``.bz2`` name raising in both; and both lists through the LBL
synthesis against JAX's (float64, rtol 1e-10)."""

import bz2

import numpy as np
import pytest

import chip_smoke
from archnemesis_tpu import native as jnative
from archnemesis_tpu.io import exomol as jexomol
from archnemesis_tpu.io import geisa as jgeisa
from archnemesis_tpu.ops.lbl import build_blocks as jax_build_blocks
from archnemesis_tpu.ops.lbl import lbl_cross_section as jax_lbl
from archnemesis_tpu_torch.io import exomol, geisa
from archnemesis_tpu_torch.ops.lbl import build_blocks, lbl_cross_section
from port_cases import (
    assert_same_linelist,
    geisa_records,
    one_torch_thread,  # noqa: F401 (a fixture)
    write_exomol_small,
)


@pytest.fixture
def jax_numpy_decoder(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.fixture(scope="module", params=["fixture", "chip"])
def records(request):
    """The JAX test's 40 records, and 300 of phase 25's catalogue."""
    if request.param == "fixture":
        return geisa_records()
    return chip_smoke.ingest_geisa(n=300, seed=4)


def test_format_geisa_records_matches_jax(records):
    got = geisa.format_geisa_records(records)
    assert got == jgeisa.format_geisa_records(records)
    assert got.count(b"\n") == len(records["nu"])


@pytest.mark.parametrize("use_native", [None, False])
def test_parse_geisa_matches_jax(records, use_native):
    buf = geisa.format_geisa_records(records)
    got = geisa.parse_geisa(buf, use_native=use_native)
    want = jgeisa.parse_geisa(buf, use_native=False)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].view(np.uint8),
                                      want[key].view(np.uint8), err_msg=key)
    np.testing.assert_array_equal(got["iso_code"], records["iso_code"])


def test_parse_geisa_rejects_a_narrow_vintage(records):
    buf = geisa.format_geisa_records(records)
    wide = geisa.GEISA_COLS + [("n_self", 200, 204)]
    with pytest.raises(ValueError, match="wrong vintage"):
        geisa.parse_geisa(buf, fields=wide)


@pytest.mark.parametrize("iso_id,s_min", [(1, 0.0), (2, 0.0), (0, 0.0),
                                          (0, 1e-23)])
def test_linelist_from_geisa_matches_jax(records, tmp_path, jax_numpy_decoder,
                                         iso_id, s_min):
    path = tmp_path / "co.geisa"
    path.write_bytes(geisa.format_geisa_records(records))
    got = geisa.linelist_from_geisa(str(path), 5, iso_id, s_min=s_min)
    want = jgeisa.linelist_from_geisa(str(path), 5, iso_id, s_min=s_min)
    assert_same_linelist(got, want, f"iso {iso_id}")
    assert got.n_lines > 0


@pytest.fixture(scope="module")
def exomol_sets(tmp_path_factory):
    """(states, trans, broad) of the JAX test's four-state triple and of
    phase 25's generator at 300 states, 3,000 transitions (plain and
    gzip'd .trans)."""
    small = write_exomol_small(tmp_path_factory.mktemp("exomol_small"))
    sets = {"small": small}
    for gz in (False, True):
        out = tmp_path_factory.mktemp(f"exomol_gz{gz}")
        sets[f"chip_gz{gz}"] = chip_smoke.ingest_exomol(
            str(out), n_states=300, n_trans=3000, seed=5, gz=gz)
    return sets


@pytest.mark.parametrize("which", ["small", "chip_gzFalse", "chip_gzTrue"])
def test_exomol_readers_match_jax(exomol_sets, which):
    states, trans, broad = exomol_sets[which]
    for fn, jfn, path in ((exomol.read_states, jexomol.read_states, states),
                          (exomol.read_trans, jexomol.read_trans, trans),
                          (exomol.read_broad, jexomol.read_broad, broad)):
        for g, w in zip(fn(path), jfn(path)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    e, g, _ = exomol.read_states(states)
    temps = [10.0, 150.0, 296.0, 2000.0]
    np.testing.assert_array_equal(exomol.partition_function(e, g, temps),
                                  jexomol.partition_function(e, g, temps))


@pytest.mark.parametrize("which", ["small", "chip_gzFalse", "chip_gzTrue"])
@pytest.mark.parametrize("with_broad,s_min", [(True, 0.0), (False, 0.0),
                                              (True, 1e-22)])
def test_linelist_from_exomol_matches_jax(exomol_sets, which, with_broad,
                                          s_min):
    states, trans, broad = exomol_sets[which]
    kw = dict(broad_path=broad if with_broad else None, s_min=s_min)
    got = exomol.linelist_from_exomol(states, trans, 5, 1, **kw)
    want = jexomol.linelist_from_exomol(states, trans, 5, 1, **kw)
    assert_same_linelist(got, want, which)


def test_bz2_name_raises_in_both(tmp_path):
    """A ``.bz2`` file is handed to gzip in both packages and raises."""
    path = tmp_path / "co.states.bz2"
    path.write_bytes(bz2.compress(b"1 0.0 1.0 0.0\n"))
    for fn in (exomol.read_states, jexomol.read_states):
        with pytest.raises(OSError):
            fn(str(path))


def test_ingested_lists_through_lbl_match_jax(records, exomol_sets, tmp_path,
                                              jax_numpy_decoder,
                                              one_torch_thread):  # noqa: F811
    path = tmp_path / "co.geisa"
    path.write_bytes(geisa.format_geisa_records(records))
    states, trans, broad = exomol_sets["chip_gzTrue"]
    pairs = [(geisa.linelist_from_geisa(str(path), 5, 1),
              jgeisa.linelist_from_geisa(str(path), 5, 1)),
             (exomol.linelist_from_exomol(states, trans, 5, 1,
                                          broad_path=broad),
              jexomol.linelist_from_exomol(states, trans, 5, 1,
                                           broad_path=broad))]
    wave = np.linspace(2100.0, 2200.0, 256)
    state = (np.array([180.0, 250.0]), np.array([1e-3, 1e-2]),
             np.array([0.9, 0.9]))
    for ll, jll in pairs:
        got = lbl_cross_section(ll, build_blocks(wave, ll.nu), *state,
                                device="cpu").numpy()
        want = np.asarray(jax_lbl(jll, jax_build_blocks(wave, jll.nu),
                                  *state, use_pallas=False))
        assert want.max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
