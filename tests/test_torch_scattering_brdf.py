"""The port's surfaces in the scattering forwards: the four BRDF cases of
``jupiter_brdf_fm.npz`` (multiple scattering over Lambert and Hapke,
single scattering over Hapke and Oren-Nayar) at the JAX test's bound
(``tests/test_forward_brdf.py``) and against the JAX package's forwards at
rtol 1e-10; the ``.hap`` reader; the aerosol spline on a full-width
table."""

import dataclasses

import numpy as np
import pytest
import torch

from archnemesis_tpu.io.legacy import read_hap as jax_read_hap
from archnemesis_tpu_torch.core.spectra import HapkeParams
from archnemesis_tpu_torch.enums import LowerBoundaryCondition
from archnemesis_tpu_torch.io import legacy
from port_cases import (  # noqa: F401
    SCAT_DECK,
    brdf_surfaces,
    copy_deck,
    one_torch_thread,
    scatter_decks,
    scatter_forwards,
    speconv,
)

BRDF_GOLDEN = "tests/goldens/jupiter_brdf_fm.npz"
BRDF_CASES = [
    ("ms_lambert", 1, False),
    ("ms_hapke", 2, False),
    ("ss_hapke", 2, True),
    ("ss_orennayar", 3, True),
]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def decks():
    return scatter_decks()


@pytest.mark.parametrize("key,lowbc,single", BRDF_CASES)
def test_brdf_forward(decks, key, lowbc, single):
    d = np.load(BRDF_GOLDEN)
    tsurf, jsurf = brdf_surfaces(decks, d, lowbc)
    tspec, _, jspec = scatter_forwards(decks, single, tsurf, jsurf, gasgiant=False)
    got, nconv = speconv(d, tspec)
    want = d[key][:nconv, 0]
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=np.abs(want).max() * 1e-8)
    np.testing.assert_allclose(tspec.numpy(), jspec, rtol=1e-10, atol=0)


def test_hap_reader_and_deck(tmp_path_factory):
    """``read_hap`` equals the JAX reader; a LOWBC=2 deck with a ``.hap``
    loads its Hapke block instead of raising."""
    deck = copy_deck(tmp_path_factory, "hapdeck", deck=SCAT_DECK)
    rows = np.array([[100.0, 0.5, 1.1, 0.8, 0.06, 0.3, 0.1, 20.0, 0.4,
                      -0.3, 0.6],
                     [900.0, 0.7, 1.2, 0.9, 0.05, 0.2, 0.2, 25.0, 0.5,
                      -0.4, 0.7]])
    hap = f"{deck}/cirstest.hap"
    with open(hap, "w") as fh:
        fh.write("2\n" + "\n".join(" ".join(f"{v:g}" for v in r)
                                   for r in rows) + "\n")
    got, want = legacy.read_hap(hap), jax_read_hap(hap)
    for f in dataclasses.fields(HapkeParams):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)))
    sett = f"{deck}/cirstest.set"
    lines = open(sett).read().split("\n")
    for i, ln in enumerate(lines):
        if "Lower boundary cond" in ln:
            lines[i] = ln.rsplit(":", 1)[0] + ":  2"
        if "Surface temperature" in ln:
            lines[i] = ln.rsplit(":", 1)[0] + ":  150.0"
    open(sett, "w").write("\n".join(lines))
    surf = legacy.load_deck(deck, "cirstest").surface
    assert surf.lowbc == LowerBoundaryCondition.HAPKE
    np.testing.assert_array_equal(surf.hapke.sglalb.numpy(), rows[:, 1])
    moved = surf.to("cpu")
    assert isinstance(moved.hapke, HapkeParams)


def test_dust_spline_matches_scipy_on_a_full_table():
    """The not-a-knot spline of the aerosol cross sections on a table as
    wide as the scattering headline's (2048 points), assembled without a
    per-point loop, against scipy's CubicSpline."""
    from scipy.interpolate import CubicSpline

    from archnemesis_tpu_torch.ops.dust import _cubic_spline_eval

    rng = np.random.default_rng(4)
    xs = np.sort(rng.uniform(5.0, 1500.0, 2048))
    ys = np.stack([1e-4 * (xs / xs[0]) ** -0.5,
                   rng.uniform(1e-5, 2e-4, 2048)], axis=1)
    xq = rng.uniform(0.0, 1510.0, 500)
    got = _cubic_spline_eval(torch.as_tensor(xs), torch.as_tensor(ys),
                             torch.as_tensor(xq)).numpy()
    want = CubicSpline(xs, ys, axis=0, bc_type="not-a-knot")(xq)
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-10 * np.abs(want).max())
