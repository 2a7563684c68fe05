"""The models of the PyTorch port that act outside the atmosphere's
profiles, against the JAX package and the reference goldens
(``tests/goldens/models_domain.npz``): surface temperature (999), tangent
height and pressure (777, 666), planet radius (555, 556), aerosol cross
sections (887), the spectral corrections (231, 232, 233, 667), the Doppler
shift (447), the size lookup (446) and the CIA basis (500) on the inputs
of ``tests/test_optics_models.py``; and ``convert.state_vector`` carrying
every new entry's static extras across from a JAX state vector."""

import dataclasses
import io

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu.core.spectra import AerosolOptics as JAerosol
from archnemesis_tpu.core.spectra import CIATables as JCIA
from archnemesis_tpu.enums import ParaH2Ratio as JParaH2
from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
from archnemesis_tpu.models import MODEL_REGISTRY as JAX_MODELS
from archnemesis_tpu.models.base import ModelEntry as JEntry
from archnemesis_tpu.models.base import ProfileTarget as JTarget
from archnemesis_tpu.retrieval import statevector as jax_sv
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.models import MODEL_REGISTRY
from archnemesis_tpu_torch.retrieval import statevector as port_sv
from port_cases import DECK, flat, flat_state_vector

FIX = chip_smoke.MODELS_FIXTURES


@pytest.fixture(scope="module")
def decks():
    jdeck = jax_load_deck(DECK, "cirstest")
    return jdeck, convert.deck(
        {k: flat(v) if dataclasses.is_dataclass(v) else v
         for k, v in ((f.name, getattr(jdeck, f.name))
                      for f in dataclasses.fields(jdeck))},
        device="cpu")


def _read_both(name, decks):
    jdeck, pdeck = decks
    path = f"{FIX}/{name}/test.apr"
    return (jax_sv.read_apr(path, jdeck.atmosphere),
            port_sv.read_apr(path, pdeck.atmosphere))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


@pytest.mark.parametrize("name", chip_smoke.DOMAIN_CASES)
def test_parse_matches_jax(name, decks):
    want, got = _read_both(name, decks)
    for field in ("xa", "sa", "lx", "inum"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert [(e.model_id, e.nx, e.extra) for e in got.entries] == [
        (e.model_id, e.nx, e.extra) for e in want.entries]


@pytest.mark.parametrize("name", chip_smoke.DOMAIN_CASES)
def test_golden(name):
    chip_smoke.model_golden_cases()[name]("cpu")


def _domain_fns(name, decks):
    """(JAX function, port function) of the state: the output each domain
    model changes, as a tuple of arrays."""
    jdeck, pdeck = decks
    jsv, psv = _read_both(name, decks)
    d = np.load(chip_smoke.MODELS_DOMAIN_GOLDEN)
    nconv = int(jdeck.geometry.nconv[0])
    if name == "m999_tsurf":
        return jsv, (
            lambda x: (jax_sv.apply_domain(jsv, x, "surface",
                                           jdeck.surface).tsurf,),
            lambda x: (port_sv.apply_domain(psv, x, "surface",
                                            pdeck.surface).tsurf,))
    if name == "m777_tanhe":
        return jsv, (
            lambda x: (jax_sv.apply_domain(
                jsv, x, "measurement", {})["tanhe_shift"],),
            lambda x: (port_sv.apply_domain(
                psv, x, "measurement", {})["tanhe_shift"],))
    if name == "m666_ptan":
        return jsv, (
            lambda x: (jax_sv.apply_state(jdeck.atmosphere, x, jsv,
                                          adjust_hydrostat=False).p,),
            lambda x: (port_sv.apply_state(pdeck.atmosphere, x, psv,
                                           adjust_hydrostat=False).p,))
    if name == "m887_xsc":
        return jsv, (
            lambda x: (jax_sv.apply_domain(jsv, x, "scatter",
                                           jdeck.aerosol).kext,),
            lambda x: (port_sv.apply_domain(psv, x, "scatter",
                                            pdeck.aerosol).kext,))
    if name in ("m231_poly", "m667_dilution"):
        vc, spec = d["VCONV"][:nconv, 0], d["SPECMOD_IN"][:nconv, 0]
    else:
        vc, spec = d[f"{name}_WAVEC"], d[f"{name}_SPEC_IN"]
    return jsv, (
        lambda x: (jax_sv.apply_spectrum_models(jsv, x, 0, vc,
                                                jnp.asarray(spec)),),
        lambda x: (port_sv.apply_spectrum_models(
            psv, x, 0, torch.as_tensor(vc), torch.as_tensor(spec)),))


@pytest.mark.parametrize("name", chip_smoke.DOMAIN_CASES)
def test_apply_and_jvp_match_jax(name, decks):
    """The changed output at the a priori and off it, at rtol 1e-10, and
    its tangent along a random direction within 1e-8 of the peak."""
    jsv, (jf, pf) = _domain_fns(name, decks)
    rng = np.random.default_rng(9)
    v = rng.standard_normal(jsv.nx)
    for x in (jsv.xa, jsv.xa + 0.01 * v):
        for a, b in zip(pf(torch.as_tensor(x)), jf(jnp.asarray(x))):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-10,
                                       atol=0)
    _, tj = jax.jvp(jf, (jnp.asarray(jsv.xa),), (jnp.asarray(v),))
    _, tp = torch.func.jvp(pf, (torch.as_tensor(jsv.xa),),
                           (torch.as_tensor(v),))
    for a, b in zip(tp, tj):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=0,
                                   atol=1e-8 * np.abs(b).max() + 1e-300)


def test_doppler_model_447(decks):
    jsv, psv = _read_both("m447_doppler", decks)
    np.testing.assert_array_equal(psv.xa, jsv.xa)
    v = port_sv.apply_domain(psv, torch.as_tensor(psv.xa), "measurement",
                             {"v_doppler": 0.0})["v_doppler"]
    assert float(v) == float(jax_sv.apply_domain(
        jsv, jnp.asarray(jsv.xa), "measurement",
        {"v_doppler": 0.0})["v_doppler"]) == 3.5
    chip_smoke.model_golden_cases()["m447_doppler"]("cpu")


@pytest.mark.parametrize("mid,text,x", [(555, "5.0 1.0\n", 5.0),
                                        (556, "1.01 0.005\n", 1.01)])
def test_radius_models_match_jax(mid, text, x, decks):
    jdeck, pdeck = decks
    want = JAX_MODELS[mid].from_apr(io.StringIO(text), [mid, 0, mid], 0, {})
    got = MODEL_REGISTRY[mid].from_apr(io.StringIO(text), [mid, 0, mid], 0,
                                       {})
    np.testing.assert_array_equal(got.x0, want.x0)
    ra = JAX_MODELS[mid].apply(want.entry, jdeck.atmosphere,
                               jnp.asarray([x])).planet_radius
    rp = MODEL_REGISTRY[mid].apply(got.entry, pdeck.atmosphere,
                                   torch.tensor([x], dtype=torch.float64))
    np.testing.assert_allclose(float(rp.planet_radius), float(ra),
                               rtol=1e-14)
    chip_smoke.model_golden_cases()["m555_m556_radius"]("cpu")


@pytest.mark.parametrize("radius", [0.73, 0.1, 2.0, 99.0])
def test_model446_matches_jax(radius):
    extra, aero_wave = chip_smoke.model446_lookup()
    ja = JAerosol(wave=aero_wave, kext=np.ones((40, 2)),
                  ksca=np.ones((40, 2)))
    je = JEntry(varident=(446, 1, 446), model_id=446, ix=0, nx=1,
                target=JTarget.NOT_ATMOSPHERIC, extra=extra)
    want = JAX_MODELS[446].apply_scatter(je, ja, jnp.asarray([radius]))
    pa = convert.aerosol_optics(flat(ja), device="cpu")
    pe = chip_smoke.model_entry(446, 1, extra)
    got = MODEL_REGISTRY[446].apply_scatter(
        pe, pa, torch.tensor([radius], dtype=torch.float64))
    for k in ("kext", "ksca"):
        np.testing.assert_allclose(_np(getattr(got, k)),
                                   np.asarray(getattr(want, k)),
                                   rtol=1e-12, atol=0, err_msg=k)
    _, tj = jax.jvp(lambda r: JAX_MODELS[446].apply_scatter(je, ja, r).kext,
                    (jnp.asarray([radius]),), (jnp.asarray([1.0]),))
    _, tp = torch.func.jvp(
        lambda r: MODEL_REGISTRY[446].apply_scatter(pe, pa, r).kext,
        (torch.tensor([radius], dtype=torch.float64),),
        (torch.tensor([1.0], dtype=torch.float64),))
    np.testing.assert_allclose(_np(tp), np.asarray(tj), rtol=1e-10,
                               atol=1e-12)


def test_model446_golden():
    chip_smoke.model_golden_cases()["m446_lookup"]("cpu")


@pytest.mark.parametrize("k_scale", [1.0, 2.0**134])
def test_model500_matches_jax(k_scale):
    pcia = chip_smoke.model500_cia("cpu")
    if k_scale != 1.0:
        pcia = pcia.prescale()
    jcia = JCIA(waven=pcia.waven.numpy(), temp=pcia.temp.numpy(),
                frac=pcia.frac.numpy(), k_cia=pcia.k_cia.numpy(),
                pair_gas1=(39, 39), pair_gas2=(39, 40),
                inormalt=(None, None), npara=0,
                inormal=JParaH2.EQUILIBRIUM, k_scale=pcia.k_scale)
    je = JEntry(varident=(500, 1, 500), model_id=500, ix=0, nx=5,
                target=JTarget.NOT_ATMOSPHERIC, extra=(1,))
    amps = np.array([2.0, 1.0, 3.0, 0.5, 1.5])
    want = JAX_MODELS[500].apply_cia(je, jcia, jnp.asarray(amps),
                                     wave_range=(400.0, 1600.0))
    pe = chip_smoke.model_entry(500, 5, (1,))
    got = MODEL_REGISTRY[500].apply_cia(pe, pcia, torch.as_tensor(amps),
                                        wave_range=(400.0, 1600.0),
                                        waven_host=pcia.waven.numpy())
    np.testing.assert_allclose(_np(got.k_cia), np.asarray(want.k_cia),
                               rtol=1e-12, atol=0)
    _, tp = torch.func.jvp(
        lambda a: MODEL_REGISTRY[500].apply_cia(
            pe, pcia, a, wave_range=(400.0, 1600.0)).k_cia,
        (torch.as_tensor(amps),), (torch.ones(5, dtype=torch.float64),))
    _, tj = jax.jvp(
        lambda a: JAX_MODELS[500].apply_cia(
            je, jcia, a, wave_range=(400.0, 1600.0)).k_cia,
        (jnp.asarray(amps),), (jnp.ones(5),))
    np.testing.assert_allclose(_np(tp), np.asarray(tj), rtol=1e-12, atol=0)


def test_model500_golden():
    chip_smoke.model_golden_cases()["m500_basis"]("cpu")


# --- convert.state_vector with every new entry's extras


def _write_mixed_apr(tmp_path):
    """A .apr of models whose entries carry static extras of every kind:
    floats (1, 20, 43, 666), a column (49), a window table (230), a
    (ngeom, ndeg) pair (231), (ngeom, wavenorm) (232), an index (887) and
    a size lookup of arrays (446, from an HDF5 file)."""
    import shutil

    shutil.copy(f"{FIX}/m231_poly/scal231.dat", tmp_path)
    shutil.copy(f"{FIX}/m232_angstrom/scal232.dat", tmp_path)
    extra, _ = chip_smoke.model446_lookup()
    _, _, _, wave_lu, reff, kext_lu, alb_lu = extra
    with h5py.File(tmp_path / "lookup.h5", "w") as h:
        h["WAVE"], h["REFF"] = wave_lu, reff
        h["KEXT"], h["SGLALB"] = kext_lu, alb_lu
    (tmp_path / "win230.dat").write_text(
        "2\n600.0 900.0\n900.0 1300.0\n"
        + "".join(f"{0.1 * i} 0.01\n" for i in range(14)))
    blocks = [chip_smoke._apr_block(n) for n in (
        "m1_knee", "m20_kneetrop", "m49_refgas", "m666_ptan", "m887_xsc",
        "m231_poly", "m232_angstrom", "m43_guillot")]
    blocks += ["230 0 230\nwin230.dat\n",
               "446 1 446\n1 1 1000.0\nlookup.h5\n0.7 0.1\n"]
    text = "header\n" + f"{len(blocks)}\n" + "".join(blocks)
    apr = tmp_path / "mixed.apr"
    apr.write_text(text)
    return apr


def _same_extra(a, b):
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same_extra(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def test_convert_state_vector_carries_extras(tmp_path, decks):
    jdeck, pdeck = decks
    apr = _write_mixed_apr(tmp_path)
    want = jax_sv.read_apr(str(apr), jdeck.atmosphere)
    own = port_sv.read_apr(str(apr), pdeck.atmosphere)
    carried = convert.state_vector(flat_state_vector(want),
                                   jdeck.atmosphere.nvmr)
    assert [e.model_id for e in carried.entries] == [
        1, 20, 49, 666, 887, 231, 232, 43, 230, 446]
    for c, o, w in zip(carried.entries, own.entries, want.entries):
        for e in (c, o):
            assert (e.varident, e.model_id, e.ix, e.nx, e.target.value,
                    e.target_idx) == (w.varident, w.model_id, w.ix, w.nx,
                                      w.target.value, w.target_idx)
            assert _same_extra(e.extra, w.extra), (e.model_id, e.extra)
    for field in ("xa", "sa", "lx", "inum", "iscale_mask"):
        np.testing.assert_array_equal(getattr(carried, field),
                                      getattr(own, field), err_msg=field)
    # a JSON-like form (lists, JAX arrays) comes back as the port holds it
    flat_w = flat_state_vector(want)
    for e in flat_w["entries"]:
        e["extra"] = [jnp.asarray(v) if isinstance(v, np.ndarray) else
                      (list(v) if isinstance(v, tuple) else v)
                      for v in e["extra"]]
    again = convert.state_vector(flat_w, jdeck.atmosphere.nvmr)
    for a, o in zip(again.entries, own.entries):
        assert _same_extra(a.extra, o.extra), (a.model_id, a.extra)
