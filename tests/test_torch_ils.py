"""The port's instrument-function weight matrices (``ops/convolution.py``)
against the JAX package's on the grids of ``tests/goldens/ils_models.npz``
(a 4,000-point calc grid at 0.0075 cm-1 and its 40 channels): the
line-by-line ILS of every shape, tabulated filters, the k-table spline
quadrature with a fixed and a tabulated FWHM, and the filter integration.
The nadir decks have FWHM = 0, so no retrieval test reaches these. Both
packages build the weights with the same host numpy (and scipy)
arithmetic: rtol 1e-13, and the weighted spectra at rtol 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.enums import InstrumentLineshape as JaxShape
from archnemesis_tpu.ops import convolution as jconv
from archnemesis_tpu_torch.enums import InstrumentLineshape
from archnemesis_tpu_torch.ops import convolution as conv

GOLDEN = "tests/goldens/ils_models.npz"


@pytest.fixture(scope="module")
def grid():
    d = np.load(GOLDEN)
    return d["WAVE"], d["SPEC"], d["VCONV"], d["VCONV228"]


def _filters(vconv, seed=7):
    """Per-channel tabulated filters (.fil layout): Gaussian-shaped, of
    varying width and knot count, two channels reaching past the grid."""
    rng = np.random.default_rng(seed)
    nfil = rng.integers(9, 31, vconv.size)
    half = rng.uniform(0.1, 0.6, vconv.size)
    half[0] = half[-1] = 8.0  # past both ends of the calc grid
    vfil = np.zeros((nfil.max(), vconv.size))
    afil = np.zeros_like(vfil)
    for j in range(vconv.size):
        x = np.linspace(vconv[j] - half[j], vconv[j] + half[j], nfil[j])
        vfil[:nfil[j], j] = x
        afil[:nfil[j], j] = np.exp(-((x - vconv[j]) / (0.5 * half[j])) ** 2)
    return nfil.astype(np.int32), vfil, afil


def _same(got, want, spec):
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
    got_y = conv.apply_ils(got, torch.as_tensor(spec)).numpy()
    want_y = np.asarray(jconv.apply_ils(want, jnp.asarray(spec)))
    np.testing.assert_allclose(got_y, want_y, rtol=1e-12, atol=0)


@pytest.mark.parametrize("shape", ["Square", "Triangular", "Gaussian",
                                   "Hamming"])
@pytest.mark.parametrize("fwhm", [0.05, 0.5])
def test_ils_weights_lbl_matches_jax(grid, shape, fwhm):
    wave, spec, vconv, _ = grid
    got = conv.ils_weights_lbl(wave, vconv, fwhm, InstrumentLineshape[shape])
    want = jconv.ils_weights_lbl(wave, vconv, fwhm, JaxShape[shape])
    assert got.shape == (vconv.size, wave.size)
    _same(got, want, spec)


def test_hanning_raises_in_both(grid):
    wave, _, vconv, _ = grid
    for fn, shape in ((conv.ils_weights_lbl, InstrumentLineshape.Hanning),
                      (jconv.ils_weights_lbl, JaxShape.Hanning)):
        with pytest.raises(NotImplementedError):
            fn(wave, vconv, 0.5, shape)


@pytest.mark.parametrize("weights", ["ils_weights_filter",
                                     "integrate_filter_weights"])
def test_filter_weights_match_jax(grid, weights):
    wave, spec, vconv, _ = grid
    nfil, vfil, afil = _filters(vconv)
    got = getattr(conv, weights)(wave, vconv, nfil, vfil, afil)
    want = getattr(jconv, weights)(wave, vconv, nfil, vfil, afil)
    _same(got, want, spec)


@pytest.mark.parametrize("fwh_table", [False, True])
def test_conv_quad_weights_match_jax(grid, fwh_table):
    """The spline quadrature at a fixed FWHM, and with a per-channel FWHM
    from a .fwh table whose widths reach past the grid's ends (the edge
    extension), on the model-228 channel set."""
    wave, spec, _, vconv = grid
    kw = {}
    if fwh_table:
        kw = dict(vfwhm=np.array([2370.0, 2390.0, 2410.0]),
                  xfwhm=np.array([12.0, 0.2, 15.0]))
    got = conv.conv_quad_weights(wave, vconv, 0.4, **kw)
    want = jconv.conv_quad_weights(wave, vconv, 0.4, **kw)
    _same(got, want, spec)
