"""Plotting in the PyTorch port (``plotting.py``) against the JAX package
on the ``jupiter_nadir`` deck (Agg): for each ``plot_*``, every axes'
line data (rtol 1e-12), filled areas, images and bars, its labels, scales,
legend and artist counts equal to the JAX package's figure; the port's
inputs given as numpy arrays, as CPU tensors and as tensors that require
grad. The JAX package's deck and figures are made once."""

import dataclasses

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from archnemesis_tpu import plotting as jplotting  # noqa: E402
from archnemesis_tpu.enums import InstrumentLineshape as JShape  # noqa: E402
from archnemesis_tpu.ops.convolution import (  # noqa: E402
    ils_weights_lbl as jax_ils_weights,
)
from archnemesis_tpu_torch import plotting  # noqa: E402
from archnemesis_tpu_torch.enums import InstrumentLineshape  # noqa: E402
from archnemesis_tpu_torch.ops.convolution import (  # noqa: E402
    ils_weights_lbl,
)
from port_cases import DECK, jax_load_deck, port_load_deck  # noqa: E402

KINDS = ("numpy", "tensor", "grad")


def _as(kind, x):
    """``x`` as a numpy array, a CPU tensor, or a tensor that requires
    grad."""
    x = np.array(x.detach() if isinstance(x, torch.Tensor) else x,
                 dtype=np.float64)
    if kind == "numpy":
        return x
    return torch.tensor(x, requires_grad=kind == "grad")


def _paths(collection):
    return [p.vertices for p in collection.get_paths()]


def _record(fig) -> list:
    """Every axes of ``fig``: its labels, scales, limits' orientation,
    legend, artist counts and colours, and the data of its lines, filled
    areas, meshes, images and bars."""
    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append(dict(
            visible=ax.get_visible(),
            labels=(ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
            scales=(ax.get_xscale(), ax.get_yscale()),
            inverted=(ax.xaxis_inverted(), ax.yaxis_inverted()),
            legend=None if legend is None else [
                t.get_text() for t in legend.get_texts()],
            counts=(len(ax.lines), len(ax.collections), len(ax.patches),
                    len(ax.images)),
            lines=[(ln.get_label(), ln.get_color(), ln.get_linewidth(),
                    ln.get_marker(), ln.get_xydata()) for ln in ax.lines],
            collections=[
                (type(c).__name__, np.asarray(c.get_array())
                 if c.get_array() is not None else _paths(c))
                for c in ax.collections],
            patches=[(p.get_x(), p.get_height()) for p in ax.patches
                     if hasattr(p, "get_height")],
            images=[(np.asarray(im.get_array()), im.get_cmap().name)
                    for im in ax.images],
        ))
    return out


def _assert_same(got, want, rtol=1e-12):
    assert len(got) == len(want)
    for g_ax, w_ax in zip(got, want):
        for key in ("visible", "labels", "scales", "inverted", "legend",
                    "counts"):
            assert g_ax[key] == w_ax[key], key
        for g, w in zip(g_ax["lines"], w_ax["lines"]):
            assert g[:4] == w[:4]
            np.testing.assert_allclose(g[4], w[4], rtol=rtol, atol=0)
        for (gt, g), (wt, w) in zip(g_ax["collections"],
                                    w_ax["collections"]):
            assert gt == wt
            for gp, wp in zip(g if isinstance(g, list) else [g],
                              w if isinstance(w, list) else [w]):
                np.testing.assert_allclose(gp, wp, rtol=rtol, atol=0)
        np.testing.assert_allclose(np.asarray(g_ax["patches"]),
                                   np.asarray(w_ax["patches"]), rtol=rtol)
        for (g, gc), (w, wc) in zip(g_ax["images"], w_ax["images"]):
            assert gc == wc
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def decks():
    return port_load_deck(DECK, "cirstest"), jax_load_deck(DECK, "cirstest")


@pytest.fixture(scope="module")
def jax_records():
    """The JAX package's figure records by case, each drawn once."""
    return {}


def _drawn(fn, args) -> list:
    fig = fn(*args)
    try:
        return _record(fig)
    finally:
        plt.close(fig)


def _both(fn, jfn, got_args, want_args, cache, key):
    """The records of the port's and JAX's figures (JAX's drawn once per
    ``key``)."""
    if key not in cache:
        cache[key] = _drawn(jfn, want_args)
    return _drawn(fn, got_args), cache[key]


@pytest.mark.parametrize("kind", KINDS)
def test_plot_atmosphere_matches_jax(decks, kind, jax_records):
    deck, jdeck = decks
    atm = deck.atmosphere
    if kind != "numpy":
        atm = atm.replace(**{n: _as(kind, getattr(atm, n))
                             for n in ("p", "t", "vmr", "dust")})
    for names in (None, [f"gas {i}" for i in range(atm.vmr.shape[1])]):
        got, want = _both(plotting.plot_atmosphere, jplotting.plot_atmosphere,
                          (atm, names), (jdeck.atmosphere, names),
                          jax_records, ("atmosphere", names is None))
        _assert_same(got, want)
    assert want[1]["counts"][0] == atm.vmr.shape[1]


@pytest.mark.parametrize("kind", KINDS)
def test_plot_spectrum_matches_jax(decks, kind, jax_records):
    deck, jdeck = decks
    geom = deck.geometry
    if kind != "numpy":
        geom = dataclasses.replace(geom, **{
            n: _as(kind, getattr(geom, n))
            for n in ("vconv", "meas", "errmeas")})
    got, want = _both(plotting.plot_spectrum, jplotting.plot_spectrum,
                      (geom,), (jdeck.geometry,), jax_records, "spectrum")
    _assert_same(got, want)


class _Obj:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _fit_case(deck, kind):
    """(setup, result) of a fit on the deck's measurement, seeded."""
    geom = deck.geometry
    rng = np.random.default_rng(0)
    nc = int(geom.nconv[0])
    y = geom.meas[:nc, 0]
    nx = 6
    setup = _Obj(y=_as(kind, y),
                 se=_as(kind, np.diag(geom.errmeas[:nc, 0] ** 2)),
                 vconv_list=[_as(kind, geom.vconv[:nc, 0])])
    res = _Obj(yn=_as(kind, y * (1.0 + rng.normal(0, 0.02, nc))),
               aa=_as(kind, rng.uniform(0, 1, (nx, nx))),
               phi_history=[100.0, 10.0, 5.0])
    return setup, res


@pytest.mark.parametrize("kind", KINDS)
def test_plot_bestfit_kernels_phi_match_jax(decks, kind, jax_records):
    setup, res = _fit_case(decks[0], kind)
    jsetup, jres = _fit_case(decks[0], "numpy")
    for name in ("plot_bestfit", "plot_averaging_kernel", "plot_phi_history"):
        args = (setup, res) if name == "plot_bestfit" else (res,)
        jargs = (jsetup, jres) if name == "plot_bestfit" else (jres,)
        got, want = _both(getattr(plotting, name), getattr(jplotting, name),
                          args, jargs, jax_records, name)
        _assert_same(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_plot_ils_matches_jax(kind, jax_records):
    wave = np.linspace(990.0, 1010.0, 800)
    vconv = np.linspace(995.0, 1005.0, 11)
    w = ils_weights_lbl(wave, vconv, 0.8, InstrumentLineshape.Gaussian)
    jw = np.asarray(jax_ils_weights(wave, vconv, 0.8, JShape.Gaussian))
    np.testing.assert_allclose(np.asarray(w), jw, rtol=1e-12)
    for channels in ((0, None, -1), (3,)):
        got, want = _both(
            plotting.plot_ils, jplotting.plot_ils,
            (_as(kind, wave), _as(kind, w), _as(kind, vconv), channels),
            (wave, jw, vconv, channels), jax_records, ("ils", channels))
        _assert_same(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_plot_corner_matches_jax(kind, jax_records):
    rng = np.random.default_rng(1)
    s = rng.multivariate_normal([0, 1, -1], np.eye(3) * 0.1, size=400)
    weights = rng.uniform(0.5, 1.0, 400)
    for names, wts in ((["a", "b", "c"], None), (None, weights)):
        got, want = _both(
            plotting.plot_corner, jplotting.plot_corner,
            (_as(kind, s), names, None if wts is None else _as(kind, wts)),
            (s, names, wts), jax_records, ("corner", names is None))
        _assert_same(got, want)
        assert sum(not ax["visible"] for ax in got) == 3


def test_plots_take_a_given_figure(decks):
    deck, jdeck = decks
    fig, jfig = plt.figure(), plt.figure()
    try:
        plotting.plot_atmosphere(deck.atmosphere, fig=fig)
        jplotting.plot_atmosphere(jdeck.atmosphere, fig=jfig)
        _assert_same(_record(fig), _record(jfig))
    finally:
        plt.close(fig)
        plt.close(jfig)
