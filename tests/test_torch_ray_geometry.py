"""Float32 along straight rays: the port's layering and path geometry
(``rt/layer.py:ray_length`` and ``ray_altitude``, used by the layer
averages, the equal-path-length split and the path scale factors) against
the reference's forms, and what float32 keeps of the Jacobian through them.

The reference's forms, sqrt((radius + alt)^2 - (z0 sin)^2) - z0 cos and
sqrt(s^2 + z0^2 + 2 s z0 cos) - radius, subtract numbers of the planet's
size: float32 keeps ~8 m of Jupiter's radius, so they moved every profile
interpolated along the path by up to 8 m and left nadir scale factors up to
1.6e-3 off one. That lost float32 Jacobian columns against PERF.md's gate
of 1e-3 of each column's peak: on ``jupiter_scatter`` the columns of
temperature level 18 and of model 47's cloud (3.2e-3, chip_smoke phase 17),
on ``models_ils`` model 0's bottom level (1.5e-3, phase 18).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.core.spectra import cast_deck
from archnemesis_tpu_torch.core.types import LayerConfig
from archnemesis_tpu_torch.retrievals import make_retrieval_setup
from archnemesis_tpu_torch.rt.layer import (
    build_layers,
    ray_altitude,
    ray_length,
)
from archnemesis_tpu_torch.rt.path import nadir_path
from port_cases import flat, layering_atmosphere, torch_threads

RADIUS = 7.1492e7  # Jupiter's equatorial radius, m
BASE = -1.0e5


def reference_length(alt, base, radius, ang):
    z0 = radius + base
    under = (radius + alt) ** 2 - (z0 * math.sin(ang)) ** 2
    return math.sqrt(max(under, 0.0)) - z0 * math.cos(ang)


def reference_altitude(s, base, radius, ang):
    z0 = radius + base
    return math.sqrt(s * s + z0 * z0 + 2 * s * z0 * math.cos(ang)) - radius


@pytest.mark.parametrize("deg", [0.0, 30.0, 60.0, 89.0])
def test_ray_forms_equal_the_reference_in_float64(deg):
    """The same function as the reference's forms, in float64, at rtol
    1e-12 (plus 1e-12 of the largest, where the reference's own rounding
    of the radius is ~1e-8 m)."""
    ang = torch.tensor(math.radians(deg), dtype=torch.float64)
    alt = torch.tensor([BASE, BASE + 1.0, BASE + 1.0e3, 0.0, 3.0e5],
                       dtype=torch.float64)
    got = ray_length(alt, torch.tensor(BASE, dtype=torch.float64), RADIUS,
                     ang).numpy()
    want = np.array([reference_length(float(a), BASE, RADIUS, float(ang))
                     for a in alt])
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    s = torch.tensor([0.0, 1.0, 1.0e3, 1.0e5, 2.0e6], dtype=torch.float64)
    got = ray_altitude(s, torch.tensor(BASE, dtype=torch.float64), RADIUS,
                       ang).numpy()
    want = np.array([reference_altitude(float(x), BASE, RADIUS, float(ang))
                     for x in s])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * 2.0e6)


def test_rays_are_exact_at_nadir_in_float32():
    """At nadir the length is alt - base and the altitude base + s, to the
    bit, with their tangents; the reference's forms are off by metres."""
    zero = torch.tensor(0.0)
    base = torch.tensor(BASE)
    alt = torch.linspace(BASE, 3.0e5, 97)
    radius = torch.tensor(RADIUS)
    torch.testing.assert_close(ray_length(alt, base, radius, zero),
                               alt - base, rtol=0, atol=0)
    s = alt - base
    torch.testing.assert_close(ray_altitude(s, base, radius, zero), base + s,
                               rtol=0, atol=0)
    _, ds = torch.func.jvp(lambda a: ray_length(a, base, radius, zero),
                           (alt,), (torch.ones_like(alt),))
    torch.testing.assert_close(ds, torch.ones_like(alt), rtol=0, atol=0)
    ref = torch.sqrt((radius + alt) ** 2) - (radius + base)
    assert (ref - (alt - base)).abs().max().item() >= 1.0


def test_float32_layers_and_nadir_path_hold_float64():
    """The Jupiter layering golden's atmosphere in float32: every nadir
    scale factor within 1e-5 of one (the rounding of each layer's two path
    lengths against its thickness; the reference's forms leave it 1.6e-3
    off), the layers' temperatures and pressures within 2e-6 of
    float64."""
    jatm, dl = layering_atmosphere()
    cfg = LayerConfig(nlay=int(dl["NLAY"]), laytyp=int(dl["LAYTYP"]),
                      layint=int(dl["LAYINT"]),
                      layht=max(float(dl["LAYHT"]), float(dl["H"][0])))
    atm64 = convert.atmosphere(flat(jatm), device="cpu")
    out = {}
    for dtype in (torch.float64, torch.float32):
        atm = cast_deck(atm64, dtype)
        layers = build_layers(atm, cfg)
        path = nadir_path(layers, atm.radius, atm.h[-1], 0.0)
        out[dtype] = (layers, path)
    l64, p64 = out[torch.float64]
    l32, p32 = out[torch.float32]
    assert (p32.scale.double() - 1.0).abs().max().item() <= 1e-5
    assert (p64.scale - 1.0).abs().max().item() <= 1e-13
    # the reference's form of the same scale factors, in float32
    r = atm.radius
    h_up = torch.cat([l32.baseh[1:], atm.h[-1:]])
    z0 = r + l32.baseh[0]
    ref = ((torch.sqrt((r + h_up) ** 2) - z0)
           - (torch.sqrt((r + l32.baseh) ** 2) - z0)) / (h_up - l32.baseh)
    assert (ref.double() - 1.0).abs().max().item() > 1e-3
    for name in ("temp", "press"):
        a, b = getattr(l32, name).double(), getattr(l64, name)
        assert ((a - b).abs() / b.abs()).max().item() <= 2e-6, name


def _column_errors(deck, cols):
    """Errors of the float32 Jacobian columns ``cols`` against float64,
    each over its float64 column's peak (a ``vmap`` of ``jvp`` each)."""
    k = {}
    for dtype in (torch.float64, torch.float32):
        setup = make_retrieval_setup(deck, "cirstest", device="cpu",
                                     dtype=dtype)
        x = torch.as_tensor(setup.sv.xa, dtype=dtype)
        basis = torch.zeros(len(cols), setup.sv.nx, dtype=dtype)
        basis[torch.arange(len(cols)), torch.as_tensor(cols)] = 1.0
        with torch_threads(2):
            _, dy = torch.func.vmap(
                lambda v: torch.func.jvp(setup.forward_fn, (x,), (v,)),
                out_dims=(None, 0))(basis)
        k[dtype] = dy.double().numpy()
    k64, k32 = k[torch.float64], k[torch.float32]
    return np.abs(k32 - k64).max(axis=1) / np.abs(k64).max(axis=1)


def test_float32_scattering_jacobian_columns_hold_the_gate():
    """``jupiter_scatter``: the columns that missed (temperature level 18,
    model 47's reference pressure and width: 3.2e-3, 3.1e-3 and 1.6e-3 of
    their peaks) within ``chip_smoke.JAC_F32_BOUND``."""
    err = _column_errors(chip_smoke.SCAT_DECK, [18, 82, 83])
    assert err.max() < chip_smoke.JAC_F32_BOUND, err


def test_float32_bottom_level_column_holds_the_gate(tmp_path):
    """``models_ils`` (chip_smoke.models_ils_deck): model 0's bottom level,
    whose peak lies 13 orders under the largest column's (1.5e-3 of its
    peak before), within ``chip_smoke.JAC_F32_BOUND``."""
    deck = chip_smoke.models_ils_deck(str(tmp_path))
    err = _column_errors(deck, [0])
    assert err.max() < chip_smoke.JAC_F32_BOUND, err
