"""``retrieval_nemesis`` of the PyTorch port end to end on the CPU:
``retrieval_nemesis`` on a temporary copy of the reduced Jupiter deck
against the reference's own LM trajectory (``jupiter_retrieval.npz``, at
tests/test_retrieval_full.py's tolerances), the legacy output files read
back with the JAX package's readers, LIN chaining, resume, and the flags
that raise until their slices are ported."""

import os
import shutil

import numpy as np
import pytest
import torch

from archnemesis_tpu.retrieval import output as jax_out
from archnemesis_tpu_torch.retrieval import output as port_out
from archnemesis_tpu_torch.retrievals import (
    retrieval_nemesis,
    run_retrieval,
)
from port_cases import copy_deck

GOLDEN = "tests/goldens/jupiter_retrieval.npz"


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    d = np.load(GOLDEN)
    deck = copy_deck(tmp_path_factory, "fullret")
    res = retrieval_nemesis(deck, "cirstest", niter=int(d["niter"]),
                            philimit=float(d["philimit"]),
                            write_outputs=True, device="cpu")
    return d, res, deck


def test_final_spectrum_matches_reference(result):
    d, res, _ = result
    yn_ref = np.asarray(d["YN"])
    np.testing.assert_allclose(
        res.yn, yn_ref, rtol=5e-3, atol=np.median(np.abs(yn_ref)) * 1e-4)


def test_final_state_matches_reference(result):
    d, res, _ = result
    xn_ref = np.asarray(d["XN"])
    np.testing.assert_allclose(res.xn, xn_ref, rtol=1e-3,
                               atol=1e-3 * np.abs(xn_ref).max())


def test_cost_trajectory_matches_reference(result):
    d, res, _ = result
    phi_ref = np.asarray(d["PHI_HIST"], dtype=float)
    phi_got = np.asarray(res.phi_history, dtype=float)
    n = min(len(phi_ref), len(phi_got))
    assert n >= 2
    np.testing.assert_allclose(phi_got[:n], phi_ref[:n], rtol=1e-3)


def test_posterior_covariance_matches_reference(result):
    d, res, _ = result
    st_ref = np.asarray(d["ST"])
    scale = np.abs(np.diagonal(st_ref)).max()
    np.testing.assert_allclose(res.st, st_ref, rtol=2e-2, atol=scale * 5e-3)
    np.testing.assert_allclose(
        np.diagonal(res.st), np.diagonal(st_ref), rtol=2e-2)


def test_outputs_are_read_by_the_jax_readers(result):
    """.mre/.cov/.raw/.itr written by the port, parsed by the JAX package's
    readers and by the port's own (the same text format both ways)."""
    _, res, deck = result
    base = os.path.join(deck, "cirstest")
    for reader in (jax_out, port_out):
        mre = reader.read_mre(base + ".mre")
        assert (mre["nx"], mre["ny"]) == (res.xn.size, res.yn.size)
        np.testing.assert_allclose(mre["yn"], res.yn * 1.0e9, rtol=1e-6)
        np.testing.assert_allclose(mre["xn"], res.xn, rtol=1e-4)
        cov = reader.read_cov(base + ".cov")
        np.testing.assert_allclose(cov["st"], res.st, rtol=1e-6)
        np.testing.assert_allclose(
            cov["kk"], res.kk, rtol=0, atol=1e-6 * np.abs(res.kk).max())
        np.testing.assert_allclose(
            cov["aa"], res.aa, rtol=0, atol=1e-6 * np.abs(res.aa).max())
        raw = reader.read_raw(base + ".raw")
        np.testing.assert_allclose(raw["xn"], res.xn, rtol=1e-7)
        np.testing.assert_allclose(raw["st"], res.st, rtol=1e-6)
        assert raw["varidents"] == [(0, 0, 0)]
        itr = reader.read_itr(base + ".itr")
        assert itr["n_records"] == len(res.itr_records)
        np.testing.assert_allclose(itr["xn1"], res.itr_records[-1]["xn1"],
                                   rtol=1e-3)
    for name in ("progress.txt", "phi_chisq.txt"):
        assert os.path.exists(os.path.join(deck, name))


def test_jax_written_raw_is_read_by_the_port(result, tmp_path):
    """The other direction: a .raw written by the JAX package's writer from
    the same result reads back the same through the port."""
    _, res, deck = result
    from archnemesis_tpu.retrievals import make_retrieval_setup as jax_setup

    setup = jax_setup(deck, "cirstest")
    path = str(tmp_path / "jax.raw")
    jax_out.write_raw(path, setup, res, setup.deck.atmosphere)
    want = open(os.path.join(deck, "cirstest.raw")).read()
    assert open(path).read() == want


@pytest.fixture(scope="module")
def chained(result, tmp_path_factory):
    """A second deck with the first run's .raw as its .pre."""
    _, res, deck = result
    d2 = copy_deck(tmp_path_factory, "chain")
    shutil.copy(os.path.join(deck, "cirstest.raw"),
                os.path.join(d2, "cirstest.pre"))
    return res, d2


def test_lin2_chaining_reproduces_xn(chained):
    """LIN=2: the previous posterior becomes the new a priori, so with no
    iteration the state is the previous one (to the .raw's 9 digits)."""
    res, deck = chained
    res2 = retrieval_nemesis(deck, "cirstest", lin=2, niter=0,
                             write_outputs=False, device="cpu")
    np.testing.assert_allclose(res2.xn, res.xn, rtol=1e-8)
    assert res2.n_iter == 0


def test_lin1_bakes_previous_state_and_adds_forward_model_error(chained):
    """LIN=1: SE grows by K_prev ST K_prev^T and the previous state is baked
    into the base atmosphere; the JAX package gives the same first spectrum
    and cost."""
    from archnemesis_tpu.retrievals import retrieval_nemesis as jax_nemesis

    _, deck = chained
    got = retrieval_nemesis(deck, "cirstest", lin=1, niter=0,
                            write_outputs=False, device="cpu")
    want = jax_nemesis(deck, "cirstest", lin=1, niter=0, write_outputs=False)
    np.testing.assert_allclose(got.yn, want.yn, rtol=1e-7)
    np.testing.assert_allclose(got.phi, want.phi, rtol=1e-6)


def test_resume_starts_from_the_last_itr_record(result):
    _, res, deck = result
    again = retrieval_nemesis(deck, "cirstest", niter=0, resume=True,
                              write_outputs=False, device="cpu")
    # the .itr stores 5 significant digits
    np.testing.assert_allclose(again.xn, res.itr_records[-1]["xn1"],
                               rtol=1e-3)


def test_run_retrieval(result):
    _, _, deck = result
    setup, res = run_retrieval(deck, "cirstest", niter=0, device="cpu")
    assert res.kk.shape == (setup.y.shape[0], setup.sv.nx)
    assert setup.deck.settings.niter == -1 and res.n_iter == 0


class _Dispatched(Exception):
    pass


@pytest.mark.parametrize("kw,target", [
    (dict(nemesis_so=True), "make_retrieval_setup_so"),
    (dict(nemesis_pt=True), "make_retrieval_setup_transit"),
])
def test_unported_setups_raise(monkeypatch, kw, target):
    """``nemesis_so`` and ``nemesis_pt`` (which raised before item 5b was
    ported) reach the SO and transit set-ups, as the JAX package dispatches
    them (retrievals.py:1295-1297), with the device, the dtype and the run
    file (``deck_file``); the set-ups run in
    tests/test_torch_{so,transit}.py."""
    from archnemesis_tpu_torch import retrievals

    seen = {}

    def stop(*args, **kwargs):
        seen.update(kwargs)
        raise _Dispatched

    monkeypatch.setattr(retrievals, target, stop)
    with pytest.raises(_Dispatched):
        retrieval_nemesis("tests/fixtures/mars_so", "mars_solocc",
                          device="cpu", dtype=torch.float32,
                          write_outputs=False, deck_file="run.npz", **kw)
    assert seen == dict(device="cpu", dtype=torch.float32,
                        deck_file="run.npz")




@pytest.mark.parametrize("kw,target", [
    (dict(nemesis_l=True), "make_retrieval_setup_limb"),
    (dict(nemesis_disc=True), "make_retrieval_setup_disc"),
    (dict(nemesis_c=True), "make_retrieval_setup_c"),
    (dict(retrieval_method=1), "run_setup_ns"),
])
def test_geometry_flags_and_nested_sampling_dispatch(monkeypatch, kw,
                                                     target):
    """Each flag reaches its set-up (and method 1 the sampler) with the
    device and dtype given to ``retrieval_nemesis``, as the JAX package
    dispatches them
    (retrievals.py:1295-1301, :1363); the set-ups and the sampler run in
    tests/test_torch_{limb,limb_setups,disc,retrieval_c,nested}.py."""
    from archnemesis_tpu_torch import retrievals
    from archnemesis_tpu_torch.retrieval import nested

    seen = {}

    def stop(*args, **kwargs):
        seen.update(kwargs)
        raise _Dispatched

    module = nested if target == "run_setup_ns" else retrievals
    monkeypatch.setattr(module, target, stop)
    with pytest.raises(_Dispatched):
        retrieval_nemesis("tests/fixtures/jupiter_fdret", "cirstest",
                          device="cpu", write_outputs=False,
                          ns_kwargs=dict(seed=7), **kw)
    if target == "run_setup_ns":
        assert seen["seed"] == 7
    else:
        assert seen["device"] == "cpu"


def test_itr_writer_format(tmp_path):
    """.itr layout on synthetic records, as tests/test_retrieval_e2e.py
    checks the JAX writer: both writers give the same bytes."""
    from types import SimpleNamespace

    nx, ny = 3, 4
    rng = np.random.default_rng(0)
    setup = SimpleNamespace(
        sv=SimpleNamespace(nx=nx, xa=rng.normal(size=nx)),
        y=rng.normal(size=ny), se=np.diag(rng.uniform(1, 2, ny)))
    rec = dict(chisq=1.5, phi=2.5, xn1=rng.normal(size=nx),
               yn1=rng.normal(size=ny), yn=rng.normal(size=ny),
               kk=rng.normal(size=(ny, nx)))
    port_out.write_itr(str(tmp_path / "p.itr"), setup, [rec])
    jax_out.write_itr(str(tmp_path / "j.itr"), setup, [rec])
    assert (tmp_path / "p.itr").read_text() == (tmp_path / "j.itr").read_text()
    back = port_out.read_itr(str(tmp_path / "p.itr"))
    np.testing.assert_allclose(back["kk"], rec["kk"], rtol=1e-4)
