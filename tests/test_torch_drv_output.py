"""The write side of the PyTorch port against the JAX package: ``.drv``
path files (``io/legacy.py:read_drv``/``write_drv``, the port
writing and JAX reading and the reverse, on ``jupiter_layering``), HDF5 run
files (``io/hdf5.py:write_deck_hdf5``: a run file either package writes
loads alike in both), the ``/Retrieval`` output group
(``retrieval/output.py:write_output_hdf5``/``read_output_hdf5`` across both
packages), and ``retrieval_nemesis`` on a deck with an HDF5 run file, whose
``/Retrieval`` group the JAX reader reads back as the run's result."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from archnemesis_tpu.core.types import LayerConfig as JLayerConfig
from archnemesis_tpu.enums import PathCalc as JPathCalc
from archnemesis_tpu.io import legacy as jax_legacy
from archnemesis_tpu.io.hdf5 import load_deck_hdf5 as jax_load_h5
from archnemesis_tpu.io.hdf5 import write_deck_hdf5 as jax_write_h5
from archnemesis_tpu.retrieval import output as jax_out
from archnemesis_tpu.rt import build_layers as jax_build_layers
from archnemesis_tpu.rt.path import nadir_path as jax_nadir_path
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.core.types import Layers
from archnemesis_tpu_torch.io import legacy
from archnemesis_tpu_torch.io.hdf5 import (
    load_deck_hdf5,
    read_run_groups,
    write_deck_hdf5,
)
from archnemesis_tpu_torch.retrieval import output as out
from archnemesis_tpu_torch.rt.layer import build_layers
from archnemesis_tpu_torch.rt.path import Paths, nadir_path
import chip_smoke
from port_cases import (
    assert_same_structure,
    copy_deck,
    cuda,  # noqa: F401 (a fixture)
    flat,
    layering_atmosphere,
    np64,
    one_torch_thread,  # noqa: F401 (a fixture)
    thin_fdret,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DECKS = ("jupiter_nadir", "jupiter_limb", "jupiter_scatter")
PARTS = ("atmosphere", "layer_config", "geometry", "settings", "ktables",
         "cia", "aerosol", "surface", "stellar")


@pytest.fixture(scope="module")
def layering():
    """jupiter_layering's layers and a 30-degree nadir path, built by the
    JAX package and the same numbers as the port's structures, and the
    port's own layering of the converted atmosphere."""
    atm, d = layering_atmosphere()
    cfg = JLayerConfig(nlay=int(d["NLAY"]), laytyp=int(d["LAYTYP"]),
                       layint=int(d["LAYINT"]),
                       layht=max(float(d["LAYHT"]), float(d["H"][0])))
    jl = jax_build_layers(atm, cfg)
    jp = jax_nadir_path(jl, atm.radius, atm.h[-1], 30.0,
                        imod=JPathCalc.THERMAL_EMISSION)
    same = (convert._build(Layers, flat(jl), "cpu"),
            convert._build(Paths, flat(jp), "cpu"))
    patm = convert.atmosphere(flat(atm), device="cpu")
    pl = build_layers(patm, convert.layer_config(flat(cfg)))
    pp = nadir_path(pl, patm.radius, patm.h[-1], 30.0)
    ngas = atm.vmr.shape[1]
    ids = (list(range(1, ngas + 1)), [0] * ngas)
    return dict(jax=(jl, jp), same=same, port=(pl, pp), ids=ids)


def _same_drv(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_drv_write_is_jax_write(layering, tmp_path):
    """The same layers and path written by both packages: the same bytes;
    each package's reader reads either file into the same dict."""
    jl, jp = layering["jax"]
    pl, pp = layering["same"]
    gas_id, iso_id = layering["ids"]
    a, b = str(tmp_path / "port.drv"), str(tmp_path / "jax.drv")
    legacy.write_drv(a, "run", pl, pp, gas_id, iso_id)
    jax_legacy.write_drv(b, "run", jl, jp, gas_id, iso_id)
    assert open(a).read() == open(b).read()
    want = jax_legacy.read_drv(b)
    _same_drv(legacy.read_drv(a), want)
    _same_drv(legacy.read_drv(b), want)
    _same_drv(jax_legacy.read_drv(a), want)


def test_drv_port_layering_round_trip(layering, tmp_path):
    """The port's own layering written by the port and read by the JAX
    package: km, atm and cm^-2 at the file's 7 digits, LAYINC 0-based."""
    pl, pp = layering["port"]
    gas_id, iso_id = layering["ids"]
    path = str(tmp_path / "run.drv")
    legacy.write_drv(path, "run", pl, pp, gas_id, iso_id)
    got = jax_legacy.read_drv(path)
    nlay = pl.baseh.shape[0]
    assert (got["nlayer"], got["npath"], got["ngas"]) == (
        nlay, 1, len(gas_id))
    for key, x, scale in (("baseh", pl.baseh, 1e-3),
                          ("basep", pl.basep, 1 / 101325.0),
                          ("totam", pl.totam, 1e-4),
                          ("par_coldens", pl.amount, 1e-4),
                          ("temp", pl.temp, 1.0)):
        np.testing.assert_allclose(got[key], np64(x) * scale, rtol=1e-6,
                                   err_msg=key)
    nin = int(pp.mask[:, 0].sum())
    np.testing.assert_array_equal(got["layinc"][0, :nin],
                                  pp.layinc[:nin, 0].numpy())
    np.testing.assert_allclose(got["scale"][0, :nin],
                               np64(pp.scale[:nin, 0]), rtol=1e-6)
    np.testing.assert_allclose(got["emtemp"][0, :nin],
                               np64(pp.emtemp[:nin, 0]), rtol=1e-6)


@pytest.mark.parametrize("name", DECKS)
def test_write_deck_hdf5_loads_in_both(name, tmp_path_factory):
    """A legacy deck's run file written by the port: the same datasets as
    the JAX writer's, and both packages load it as they load the JAX
    writer's file, field by field."""
    from archnemesis_tpu.io.legacy import load_deck as jax_load_deck

    d = copy_deck(tmp_path_factory, name, deck=f"tests/fixtures/{name}")
    mine, theirs = os.path.join(d, "port.h5"), os.path.join(d, "jax.h5")
    write_deck_hdf5(mine, legacy.load_deck(d, "cirstest"))
    jax_write_h5(theirs, jax_load_deck(d, "cirstest"))
    a, b = read_run_groups(mine), read_run_groups(theirs)

    def same(x, y, path):
        assert sorted(x) == sorted(y), path
        for k in y:
            if isinstance(y[k], dict):
                same(x[k], y[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(x[k], y[k], f"{path}/{k}")

    same(a, b, "")
    want = jax_load_h5(theirs)
    for got in (load_deck_hdf5(mine), load_deck_hdf5(theirs)):
        for part in PARTS:
            assert_same_structure(getattr(got, part), getattr(want, part),
                                  part)
    jax_mine = jax_load_h5(mine)
    for part in PARTS:
        assert_same_structure(load_deck_hdf5(mine).__getattribute__(part),
                              getattr(jax_mine, part), part)


def _fake_result(nx=4, ny=6, seed=3):
    """A set-up and an OE result of seeded numbers with two models (one
    log-scaled), as the output writers take them."""
    from archnemesis_tpu_torch.models.base import ModelEntry, ProfileTarget

    rng = np.random.default_rng(seed)
    entries = (
        ModelEntry(varident=(0, 0, 2), model_id=2, ix=0, nx=1,
                   target=ProfileTarget.TEMPERATURE),
        ModelEntry(varident=(6, 0, 0), model_id=0, ix=1, nx=nx - 1,
                   target=ProfileTarget.GAS_VMR, target_idx=0),
    )
    a = rng.normal(size=(nx, nx))
    sv = SimpleNamespace(entries=entries, nx=nx, xa=rng.normal(size=nx),
                         sa=a @ a.T, lx=np.array([0] + [1] * (nx - 1)))
    setup = SimpleNamespace(
        sv=sv, y=rng.uniform(size=ny), se=np.diag(rng.uniform(size=ny)),
        deck=SimpleNamespace(settings=SimpleNamespace(niter=5,
                                                      philimit=0.1)))
    b = rng.normal(size=(nx, nx))
    res = SimpleNamespace(
        phi=1.5, chisq=0.7, yn=rng.uniform(size=ny),
        xn=rng.normal(size=nx), st=b @ b.T, kk=rng.normal(size=(ny, nx)),
        aa=rng.normal(size=(nx, nx)), dd=rng.normal(size=(nx, ny)))
    return setup, res


def test_output_hdf5_across_packages(tmp_path):
    """The port writes the /Retrieval group and the JAX package reads it,
    and the reverse: the same datasets either way."""
    setup, res = _fake_result()
    mine, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    out.write_output_hdf5(mine, setup, res)
    jax_out.write_output_hdf5(theirs, setup, res)
    want = jax_out.read_output_hdf5(theirs)
    for got in (jax_out.read_output_hdf5(mine), out.read_output_hdf5(mine),
                out.read_output_hdf5(theirs)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(want["retparam"][0, 1], np.exp(res.xn[1]))
    # a second write replaces the group
    out.write_output_hdf5(mine, setup, res, write_cov=False)
    assert "kk" not in out.read_output_hdf5(mine)


def test_retrieval_nemesis_writes_hdf5_group(tmp_path):
    """``retrieval_nemesis`` on a thinned ``jupiter_fdret`` beside its HDF5
    run file writes the run's result into the file's /Retrieval group,
    which the JAX package's reader reads: the state, spectrum, Jacobian and
    phi of the result, the measurement, and the parameters of the
    ``.mre``."""
    from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
    from archnemesis_tpu_torch.retrievals import retrieval_nemesis

    deck = thin_fdret(tmp_path, nchan=8, nlay=8)
    h5 = os.path.join(deck, "cirstest.h5")
    jax_write_h5(h5, jax_load_deck(deck, "cirstest"))
    res = retrieval_nemesis(deck, "cirstest", niter=1, device="cpu")
    got = jax_out.read_output_hdf5(h5)
    np.testing.assert_array_equal(got["xn"], res.xn)
    np.testing.assert_array_equal(got["yn"], res.yn)
    np.testing.assert_array_equal(got["kk"], res.kk)
    assert got["phi"] == res.phi and got["ny"] == 8
    mre = jax_out.read_mre(os.path.join(deck, "cirstest.mre"))
    # the .mre's radiances are in nW cm-2 sr-1 (cm-1)-1
    np.testing.assert_allclose(got["y"] * 1e9, mre["y"], rtol=1e-4)
    np.testing.assert_allclose(got["retparam"][:, 0], mre["xn"],
                               rtol=1e-4)
    # the run file still loads, with the result beside the inputs
    assert load_deck_hdf5(h5).settings.niter == \
        jax_load_h5(h5).settings.niter


@pytest.mark.cuda
def test_drv_of_card_layering_matches_cpu(cuda, tmp_path):
    """The golden deck (read by the port, ``chip_smoke.golden_deck``) on the
    card: its forward through kernel 1 (6 launches) equal to the plain
    combine's on the CPU within 1e-10, and the ``.drv`` of its layering
    and path the CPU run's file."""
    from archnemesis_tpu_torch.forward import forward_nadir
    from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair

    runs = {}
    for tag, device in (("cpu", "cpu"), ("card", cuda)):
        deck = chip_smoke.golden_deck(device)
        before = combine_pair.launches
        spec, diag = forward_nadir(*deck, emiss_ang=30.0,
                                   return_diagnostics=True, device=device)
        if tag == "card":
            torch.cuda.synchronize()
            assert combine_pair.launches - before == 6
        atm = deck[0]
        legacy.write_drv(str(tmp_path / f"{tag}.drv"), "run", diag["layers"],
                         diag["path"], atm.gas_id, atm.iso_id)
        runs[tag] = spec.cpu().numpy()
    np.testing.assert_allclose(runs["card"], runs["cpu"], rtol=1e-10,
                               atol=0)
    assert open(tmp_path / "cpu.drv").read() == \
        open(tmp_path / "card.drv").read()
