"""Deck I/O of the PyTorch port vs the JAX package: ``load_deck`` field by
field on the two Jupiter nadir decks (exact for what is read from text,
rtol 1e-12 for what is computed on read), the carried-across deck of
``convert.deck``, and the branches that raise until their slices are
ported."""

import os

import numpy as np
import pytest
import torch

from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
from archnemesis_tpu.utils import path_redirect as jax_redirect
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.io import legacy
from archnemesis_tpu_torch.io.ktables import _resolve_path
from archnemesis_tpu_torch.utils import datafiles, path_redirect
from port_cases import (
    DECK,
    FDRET,
    assert_same_structure as _assert_same_structure,
    copy_deck,
    flat_deck,
)

@pytest.fixture(scope="module", params=[DECK, FDRET],
                ids=["jupiter_nadir", "jupiter_fdret"])
def decks(request):
    return (legacy.load_deck(request.param, "cirstest"),
            jax_load_deck(request.param, "cirstest"))


@pytest.mark.parametrize("part", ["atmosphere", "layer_config", "geometry",
                                  "settings", "ktables", "cia", "aerosol",
                                  "surface", "stellar"])
def test_load_deck_matches_jax(decks, part):
    got, want = decks
    assert getattr(want, part) is not None
    _assert_same_structure(getattr(got, part), getattr(want, part), part)


def test_load_deck_host_fields_and_placement(decks):
    got, want = decks
    assert got.apr_path == want.apr_path
    assert got.table_locations == want.table_locations
    assert got.cia_table == want.cia_table
    assert got.hgphase is None and want.hgphase is None
    assert got.fwh is None and got.telluric is None
    # host-only loader: float64 CPU tensors whatever cards exist
    for t in (got.atmosphere.h, got.ktables.k, got.cia.k_cia,
              got.stellar.solspec, got.surface.vem):
        assert t.device.type == "cpu" and t.dtype == torch.float64


def test_convert_deck_carries_the_jax_deck(decks):
    got, want = decks
    carried = convert.deck(flat_deck(want), device="cpu")
    for part in ("atmosphere", "geometry", "settings", "stellar", "ktables"):
        _assert_same_structure(getattr(carried, part), getattr(got, part),
                               part)
    assert type(carried.settings.iform) is type(got.settings.iform)


def test_single_readers_match_jax(tmp_path):
    from archnemesis_tpu.io import legacy as jl

    fil = tmp_path / "t.fil"
    fil.write_text("2\n600.0\n3\n599 0.1\n600 1.0\n601 0.2\n"
                   "700.0\n2\n699 0.5\n701 0.5\n")
    for g, w in zip(legacy.read_fil(str(fil)), jl.read_fil(str(fil))):
        np.testing.assert_array_equal(g, w)
    fwh = tmp_path / "t.fwh"
    fwh.write_text("2\n600.0 0.5\n700.0 0.7\n")
    for g, w in zip(legacy.read_fwh(str(fwh)), jl.read_fwh(str(fwh))):
        np.testing.assert_array_equal(g, w)
    for i in (1, 2):
        (tmp_path / f"hgphase{i}.dat").write_text(
            "600 0.5 0.6 -0.3\n700 0.4 0.7 -0.2\n")
    for g, w in zip(legacy.read_hgphase(2, str(tmp_path)),
                    jl.read_hgphase(2, str(tmp_path))):
        np.testing.assert_array_equal(g, w)
    assert legacy.read_inp(f"{DECK}/cirstest.inp") == \
        jl.read_inp(f"{DECK}/cirstest.inp")
    assert legacy.read_fla(f"{DECK}/cirstest.fla") == \
        jl.read_fla(f"{DECK}/cirstest.fla")
    assert legacy.read_set(f"{DECK}/cirstest.set") == \
        jl.read_set(f"{DECK}/cirstest.set")


def test_stellar_solar_flux_matches_jax(decks):
    from archnemesis_tpu.io import stellar as js
    from archnemesis_tpu_torch.io import stellar as ps

    got, want = decks
    np.testing.assert_allclose(ps.calc_solar_flux(got.stellar),
                               js.calc_solar_flux(want.stellar), rtol=1e-14)


def test_sur_and_vpf_blocks(tmp_path_factory):
    d = copy_deck(tmp_path_factory, "surdeck")
    with open(os.path.join(d, "cirstest.sur"), "w") as f:
        f.write("2\n100.0 0.9\n2000.0 0.8\n")
    with open(os.path.join(d, "cirstest.vpf"), "w") as f:
        f.write("1\n11 0 1.0 1\n")
    got, want = legacy.load_deck(d, "cirstest"), jax_load_deck(d, "cirstest")
    np.testing.assert_array_equal(got.surface.emissivity.numpy(),
                                  np.asarray(want.surface.emissivity))
    assert got.atmosphere.svp == want.atmosphere.svp == ((11, 0, 1.0, 1),)


def test_unported_branches_raise(tmp_path_factory):
    """A ``.lls`` of ``.lta`` tables (ILBL = 2, which raised before item 4
    was ported): the Titan deck's line-by-line table read as the JAX
    package reads it, every field of the deck. Under ILBL = 1 the same
    kind of file is read as a runtime ``.lls`` and, having no WAVE line,
    refused as the JAX package refuses it. The ``.drv`` reader and writer
    (unported before item 9) are there; ``tests/test_torch_drv_output.py``
    holds them to the JAX package's."""
    got = legacy.load_deck("tests/fixtures/titan_fov", "ch3cn")
    want = jax_load_deck("tests/fixtures/titan_fov", "ch3cn")
    assert int(got.settings.ilbl) == 2 and got.ktables.k.shape[2] == 1
    for part in ("atmosphere", "layer_config", "geometry", "settings",
                 "ktables", "cia", "aerosol", "surface"):
        _assert_same_structure(getattr(got, part), getattr(want, part), part)
    assert got.table_locations == want.table_locations
    assert got.ktables.k.device.type == "cpu"

    d = copy_deck(tmp_path_factory, "lbldeck")
    inp = os.path.join(d, "cirstest.inp")
    lines = open(inp).read().splitlines()
    first = lines[0].split()
    first[2] = "1"
    lines[0] = " ".join(first)
    open(inp, "w").write("\n".join(lines) + "\n")
    open(os.path.join(d, "cirstest.lls"), "w").write("x.lta\n")
    with pytest.raises(ValueError, match="must define WAVE"):
        legacy.load_deck(d, "cirstest")
    assert callable(legacy.read_drv) and callable(legacy.write_drv)


def test_path_redirects_match_jax():
    reds = (("/old/tables", "/new/t"), ("/old", "/other"))
    try:
        for mod in (path_redirect, jax_redirect):
            mod.set_path_redirects(reds)
        for p in ("/old/tables/a.kta", "/old/b.kta", "rel/c.kta", "/x/d.kta"):
            assert path_redirect.resolve_path(p, "/deck") == \
                jax_redirect.resolve_path(p, "/deck")
            assert _resolve_path(p, "/deck") == \
                jax_redirect.resolve_path(p, "/deck")
        lst = path_redirect.PathRedirectList(["/old/a"], reds)
        assert list(lst) == list(jax_redirect.PathRedirectList(["/old/a"],
                                                               reds))
    finally:
        for mod in (path_redirect, jax_redirect):
            mod.set_path_redirects(())
    assert _resolve_path("/a/b.kta", "/deck", (("/a", "/z"),)) == "/z/b.kta"


def test_data_assets_match_jax():
    from archnemesis_tpu import data as jd
    from archnemesis_tpu.data import datadir

    assert datafiles.planet_info() == jd.planet_info()
    assert datafiles.svp_coefficients() == jd.svp_coefficients()
    for g, s in ((39, 0), (6, 2), (11, 99)):
        assert datafiles.molecular_weight(g, s) == jd.molecular_weight(g, s)
    assert datafiles.data_path("cia") == datadir.data_path("cia")
    assert datafiles.find_table("isotest.tab", "cia", "/nowhere") == \
        datadir.find_table("isotest.tab", "cia", "/nowhere")
