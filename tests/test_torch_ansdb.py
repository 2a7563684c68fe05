"""The "ans" store in the PyTorch port (``io/ansdb.py``) and resource
fetching (``io/fetch.py``) against the JAX package: ``build_ans_from_par``
in both packages writes the same datasets and attributes; the
pseudo-continuum writer likewise; ``AnsDatabase`` fetches (full, windowed,
``s_min``, partition function, pseudo-continuum) equal to JAX's, from the
``.h5`` and from its ``.npz`` export; a ``file://`` download with its
cache, and the actionable ``FetchError``."""

import dataclasses

import numpy as np
import pytest

from archnemesis_tpu import native as jnative
from archnemesis_tpu.io import ansdb as jansdb
from archnemesis_tpu.io import fetch as jfetch
from archnemesis_tpu.ops.pseudo_continuum import PseudoContinuum as JPC
from archnemesis_tpu_torch.io import ansdb, fetch
from archnemesis_tpu_torch.io.linedata import export_ans_linedata
from archnemesis_tpu_torch.ops.pseudo_continuum import PseudoContinuum
from port_cases import assert_same_linelist, synth_par_lines, write_par


def _h5_contents(path) -> dict:
    """{path: value} of every dataset and {path@attr: value} of every
    attribute of an HDF5 file."""
    import h5py

    out = {}

    def visit(name, obj):
        for key, value in obj.attrs.items():
            out[f"{name}@{key}"] = value
        if isinstance(obj, h5py.Dataset):
            out[name] = obj[()]

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def _assert_same_h5(got_path, want_path):
    got, want = _h5_contents(got_path), _h5_contents(want_path)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(par path, the port's store, JAX's store) for CO isos 1 and 2, each
    written twice (two line sets and two partition tables an isotope)."""
    d = tmp_path_factory.mktemp("ansdb")
    par = write_par(d / "co.par", synth_par_lines())
    port, jax_ = str(d / "port.h5"), str(d / "jax.h5")
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "available", lambda: False)
    try:
        for _ in range(2):
            ansdb.build_ans_from_par(par, port, [(5, 1), (5, 2)])
            jansdb.build_ans_from_par(par, jax_, [(5, 1), (5, 2)])
        ansdb.build_ans_from_par(par, port, [(5, 3)], s_min=1e-22)
        jansdb.build_ans_from_par(par, jax_, [(5, 3)], s_min=1e-22)
    finally:
        mp.undo()
    return par, port, jax_


def test_build_ans_from_par_matches_jax(stores):
    _, port, jax_ = stores
    _assert_same_h5(port, jax_)
    assert "line_data/CO/1/line_set_0001/nu" in _h5_contents(port)


@pytest.fixture(scope="module")
def export(stores, tmp_path_factory):
    _, port, _ = stores
    path = str(tmp_path_factory.mktemp("export") / "co1.npz")
    export_ans_linedata(port, path, 5, 1)
    return path


@pytest.mark.parametrize("source", ["h5", "npz"])
def test_ans_database_fetches_match_jax(stores, export, source):
    _, port, jax_ = stores
    db = ansdb.AnsDatabase(port if source == "h5" else export)
    jdb = jansdb.AnsDatabase(jax_)
    full = db.fetch_line_data(5, 1)
    lo, hi = float(full.nu[3]), float(full.nu[-3])
    smed = float(np.median(full.sw))
    for kw in ({}, dict(wn_min=lo, wn_max=hi), dict(s_min=smed),
               dict(wn_min=lo, wn_max=hi, s_min=smed)):
        got, want = db.fetch_line_data(5, 1, **kw), jdb.fetch_line_data(
            5, 1, **kw)
        assert_same_linelist(got, want, str(kw))
        assert 0 < got.n_lines
    assert db.fetch_line_data(5, 1, s_min=smed).sw.min() >= smed
    for g, w in zip(db.fetch_partition_fn(5, 1),
                    jdb.fetch_partition_fn(5, 1)):
        np.testing.assert_array_equal(g, w)
    # the cache hands out slices of one read
    assert db.fetch_line_data(5, 1).nu is not full.nu
    assert len(db._cache) == 1


def _pseudo_continuum(cls, seed=3):
    rng = np.random.default_rng(seed)
    n = 12
    centre = np.linspace(2000.0, 2110.0, n)
    return cls(
        t_ref=296.0, p_ref=1.0, mass=27.99, abundance=0.98,
        wn_bin_center=centre, wn_bin_width=np.full(n, 10.0),
        strength_sum=10.0 ** rng.uniform(-24, -20, n),
        lsw_e_lower=rng.uniform(0.0, 2000.0, n),
        lsw_gamma_self=rng.uniform(0.05, 0.1, n),
        lsw_n_self=rng.uniform(0.5, 0.8, n),
        lsw_gamma_amb=rng.uniform(0.04, 0.09, n),
        lsw_n_amb=rng.uniform(0.5, 0.8, n),
        pf_temp=np.array([100.0, 300.0]), pf_q=np.array([40.0, 110.0]),
    )


def test_pseudo_continuum_writer_and_fetch_match_jax(stores, tmp_path):
    _, port_lines, jax_lines = stores
    port, jax_ = str(tmp_path / "pc_port.h5"), str(tmp_path / "pc_jax.h5")
    for s_max, t_ref in ((1e-22, 296.0), (1e-21, 200.0)):
        ansdb.write_ans_pseudo_continuum(
            port, 5, 1, dataclasses.replace(_pseudo_continuum(
                PseudoContinuum), t_ref=t_ref), s_max)
        jansdb.write_ans_pseudo_continuum(
            jax_, 5, 1, dataclasses.replace(_pseudo_continuum(JPC),
                                            t_ref=t_ref), s_max)
    _assert_same_h5(port, jax_)
    db = ansdb.AnsDatabase(port_lines, continuum_database=port)
    jdb = jansdb.AnsDatabase(jax_lines, continuum_database=jax_)
    for temperature in (None, 250.0):
        got = db.fetch_pseudo_continuum(5, 1, temperature=temperature)
        want = jdb.fetch_pseudo_continuum(5, 1, temperature=temperature)
        for field in dataclasses.fields(want):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, field.name)),
                np.asarray(getattr(want, field.name)), err_msg=field.name)


def test_download_file_url_and_cache(tmp_path):
    src = tmp_path / "src.bin"
    payload = bytes(range(256)) * 1000
    src.write_bytes(payload)
    url = src.as_uri()

    chunks = list(fetch.file_in_chunks(url, chunk_size=4096, encoding=None))
    assert b"".join(chunks) == payload
    assert max(len(c) for c in chunks) <= 4096
    text = src.with_suffix(".txt")
    text.write_text("a\nbb\n")
    assert list(fetch.file_in_chunks(text.as_uri(), chunk_size=None)) == \
        list(jfetch.file_in_chunks(text.as_uri(), chunk_size=None)) == \
        ["a\n", "bb\n"]

    dest = tmp_path / "cache" / "dst.bin"
    p1 = fetch.download(url, str(dest), chunk_size=4096)
    assert open(p1, "rb").read() == payload
    assert not (tmp_path / "cache" / "dst.bin.part").exists()
    # second call hits the local cache (no re-fetch even if the source dies)
    src.unlink()
    assert fetch.download(url, str(dest)) == p1
    with pytest.raises(fetch.FetchError):
        fetch.download(url, str(dest), overwrite=True)
    assert not (tmp_path / "cache" / "dst.bin.part").exists()


def test_fetch_error_is_actionable(tmp_path):
    url = (tmp_path / "missing.bin").as_uri()
    with pytest.raises(fetch.FetchError, match="network egress") as got:
        list(fetch.file_in_chunks(url, encoding=None))
    with pytest.raises(jfetch.FetchError) as want:
        list(jfetch.file_in_chunks(url, encoding=None))
    assert str(got.value) == str(want.value)
    assert issubclass(fetch.FetchError, RuntimeError)
