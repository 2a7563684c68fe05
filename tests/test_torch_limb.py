"""The limb geometry of the PyTorch port against the JAX package on the
same inputs: ``rt/path.py:limb_paths``, ``forward.py:so_geometry`` (both
brackets), the layering at 90 degrees, ``forward_limb_batch``,
``forward_limb``, ``make_retrieval_setup_limb`` on ``jupiter_limb``
against the reference golden (``jupiter_limb_fm.npz``, at
``tests/test_forward_limb.py``'s tolerances) and the JAX set-up (its JVP
columns: ``tests/test_torch_limb_jvp.py``; the limb FOV points of the
nadir set-up and ``retrieval_nemesis(nemesis_l=True)``:
``tests/test_torch_limb_setups.py``).

Float32 along the limb: ``rt/layer.py:ray_length`` subtracted numbers of
the planet's size; at 90 degrees its terms z0 (1 - cos) and (z0 sin)^2 /
(root + r) are each of Jupiter's radius and cancel, and cos(float32(pi/2))
is -4.4e-8, not 0. The port's scale factors now take no such difference
(``ray_segment``), and hold float64 within 1e-6 on every layer.

The JAX forwards are jitted where they run more than once.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu import forward as jfwd
from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
from archnemesis_tpu.retrieval.statevector import apply_state as jax_apply
from archnemesis_tpu.retrievals import (
    make_retrieval_setup_limb as jax_setup_limb,
)
from archnemesis_tpu.rt.layer import build_layers as jax_build_layers
from archnemesis_tpu.rt.path import limb_paths as jax_limb_paths
from archnemesis_tpu_torch import forward as tfwd
from archnemesis_tpu_torch.core.types import Layers
from archnemesis_tpu_torch.io.legacy import load_deck
from archnemesis_tpu_torch.retrieval.statevector import apply_state
from archnemesis_tpu_torch.retrievals import make_retrieval_setup_limb
from archnemesis_tpu_torch.rt.layer import build_layers, ray_length
from archnemesis_tpu_torch.rt.path import limb_paths
from port_cases import np64, one_torch_thread  # noqa: F401

DECK = chip_smoke.LIMB_DECK
GOLDEN = chip_smoke.LIMB_GOLDEN

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def decks():
    return load_deck(DECK, "cirstest"), jax_load_deck(DECK, "cirstest")


def _port_layers(jl) -> Layers:
    return Layers(**{k: torch.as_tensor(np.asarray(getattr(jl, k)))
                     for k in Layers.__dataclass_fields__})


def test_layering_at_90_degrees_matches_jax(decks):
    deck, jdeck = decks
    got = build_layers(deck.atmosphere, deck.layer_config, layang=90.0)
    want = jax_build_layers(jdeck.atmosphere, jdeck.layer_config,
                            layang=90.0)
    for name in ("baseh", "height", "press", "temp", "totam", "amount",
                 "laysf"):
        np.testing.assert_allclose(np64(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-10, err_msg=name)


def _long_double_scale(baseh, radius, h_top, itanhe, layinc, mask):
    """The reference's limb scale factors (AtmCalc_0.py:380-400 at 90
    degrees) evaluated in numpy's long double, as float64."""
    baseh = np.asarray(baseh).astype(np.longdouble)
    radius, h_top = np.longdouble(radius), np.longdouble(h_top)
    h_up = np.concatenate([baseh[1:], [h_top]])
    out = np.zeros(layinc.shape)
    for ip, b in enumerate(itanhe):
        z0 = radius + baseh[b]

        def s(h):
            return np.sqrt(np.maximum((radius + h) ** 2 - z0**2, 0.0))

        sf = (s(h_up) - s(baseh)) / (h_up - baseh)
        out[:, ip] = (sf[layinc[:, ip]] * mask[:, ip]).astype(np.float64)
    return out


def test_limb_paths_match_jax(decks):
    """layinc and mask equal to JAX's; the scale factors within 1e-14 of
    the reference's form evaluated in long double, and within 1e-11 of
    JAX's, whose difference of two path lengths keeps 2.3e-12 of that
    reference on the upper layers (the port's quotient form 1.1e-15); the
    padding's temperatures real layers' (no zeros)."""
    _, jdeck = decks
    jl = jax_build_layers(jdeck.atmosphere, jdeck.layer_config, layang=90.0)
    geo = jfwd.so_geometry(jdeck.atmosphere, jdeck.layer_config,
                           jdeck.geometry.tanhe[:, 0], lfm_bracket=True)
    atm = jdeck.atmosphere
    want = jax_limb_paths(jl, atm.radius, atm.h[-1], geo["itanhe"])
    got = limb_paths(_port_layers(jl), torch.as_tensor(np.asarray(atm.radius)),
                     torch.as_tensor(np.asarray(atm.h[-1])), geo["itanhe"])
    np.testing.assert_array_equal(got.layinc.numpy(), np.asarray(want.layinc))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    exact = _long_double_scale(jl.baseh, atm.radius, atm.h[-1],
                               geo["itanhe"], got.layinc.numpy(),
                               got.mask.numpy())
    np.testing.assert_allclose(got.scale.numpy(), exact, rtol=1e-14)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-11)
    np.testing.assert_array_equal(got.emtemp.numpy(),
                                  np.asarray(want.emtemp))
    assert got.emtemp.min() > 0 and not got.surface_visible
    assert got.layinc.shape == (126, 6)


@pytest.mark.parametrize("lfm_bracket", [True, False])
def test_so_geometry_matches_jax(decks, lfm_bracket):
    deck, jdeck = decks
    tanhe = deck.geometry.tanhe[:, 0]
    got = tfwd.so_geometry(deck.atmosphere, deck.layer_config, tanhe,
                           lfm_bracket=lfm_bracket)
    want = jfwd.so_geometry(jdeck.atmosphere, jdeck.layer_config, tanhe,
                            lfm_bracket=lfm_bracket)
    for k in ("itanhe", "lo", "hi"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("wlo", "whi", "baseh_tan", "tanhe_km"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    np.testing.assert_array_equal(got["itanhe"], [8, 9, 20, 21, 35, 36])
    if lfm_bracket:
        # nemesisLfm's double /1e3: the third tangent height takes the
        # clamp branch (its bracket would be past the last path)
        np.testing.assert_array_equal(got["lo"], [0, 3, 5])
        np.testing.assert_array_equal(got["hi"], [1, 4, 5])
        assert got["wlo"][2] == 1.0 and got["whi"][2] == 0.0


def test_ray_length_at_the_limb():
    """At 90 degrees in float64 the reference's form, the tangent point
    exactly 0, and float32 within 1e-6 of float64 where the old form read
    metres off."""
    radius, base = 7.1492e7, -5.0e3
    alt = np.array([base, base + 1.0, base + 1.0e3, 6.0e4, 5.0e5])
    for dtype in (torch.float64, torch.float32):
        ang = torch.deg2rad(torch.tensor(90.0, dtype=dtype))
        got = ray_length(torch.tensor(alt, dtype=dtype),
                         torch.tensor(base, dtype=dtype),
                         torch.tensor(radius, dtype=dtype), ang)
        assert got[0].item() == 0.0
        z0 = radius + base
        want = np.sqrt(np.maximum((radius + alt) ** 2 - z0**2, 0.0))
        np.testing.assert_allclose(got.double().numpy(), want,
                                   rtol=1e-12 if dtype == torch.float64
                                   else 1e-6)


def _reference_scale(baseh, radius, h_top, base):
    """The reference's scale factors at 90 degrees (AtmCalc_0.py:380-400),
    in the inputs' own type."""
    ang = torch.deg2rad(torch.tensor(90.0, dtype=baseh.dtype))
    h_up = torch.cat([baseh[1:], h_top.reshape(1)])
    z0 = radius + base

    def s(h):
        under = (radius + h) ** 2 - (z0 * torch.sin(ang)) ** 2
        return torch.sqrt(under.clamp_min(0.0)) - z0 * torch.cos(ang)

    return (s(h_up) - s(baseh)) / (h_up - baseh)


def test_float32_limb_scale_factors_hold_float64(decks):
    """On every layer of every tangent path of ``jupiter_limb`` at 90
    degrees, from the same (float32) layer bases and radius: the float32
    scale factors within 1e-6 of float64 (the reference's form, 3e-4 to
    1.6e-3 off)."""
    deck, _ = decks
    atm = deck.atmosphere
    layers = build_layers(atm, deck.layer_config, layang=90.0)
    geo = tfwd.so_geometry(atm, deck.layer_config,
                           deck.geometry.tanhe[:, 0])
    f32 = [x.float() for x in (layers.baseh, atm.radius, atm.h[-1])]
    paths = {}
    for dtype in (torch.float32, torch.float64):
        baseh, radius, h_top = (x.to(dtype) for x in f32)
        paths[dtype] = limb_paths(layers.replace(baseh=baseh), radius, h_top,
                                  geo["itanhe"])
    m = paths[torch.float64].mask.bool()
    s64 = paths[torch.float64].scale[m]
    err = ((paths[torch.float32].scale.double()[m] - s64).abs()
           / s64.abs()).max().item()
    assert err < 1e-6, err
    worst = 0.0
    for b in geo["itanhe"]:
        ref = [_reference_scale(*(x.to(dt) for x in f32), f32[0].to(dt)[b])
               for dt in (torch.float32, torch.float64)]
        rel = (ref[0].double() - ref[1]).abs() / ref[1].abs()
        worst = max(worst, rel[b:].max().item())
    assert worst > 1e-4, worst


@pytest.fixture(scope="module")
def limb_setups():
    port = make_retrieval_setup_limb(DECK, "cirstest", device="cpu")
    jx = jax_setup_limb(DECK, "cirstest")
    return port, jx, jax.jit(jx.forward_fn)


def test_setup_matches_reference_golden(limb_setups):
    port, _, _ = limb_setups
    d = np.load(GOLDEN)
    golden = np.asarray(d["SPECONV"])  # (NCONV, NGEOM)
    got = port.forward_fn(port.sv.xa).numpy().reshape(len(d["TANHE"]), -1).T
    np.testing.assert_allclose(got, golden, rtol=2e-5,
                               atol=np.median(np.abs(golden)) * 1e-6)
    np.testing.assert_allclose(port.y, golden.T.ravel(), rtol=2e-5)


def test_setup_matches_jax(limb_setups):
    """Against the JAX set-up evaluated eagerly: its jitted forward
    differs from its eager one by 1.8e-9 at the 60 km tangent height (the
    plain difference of two transmissions near 1, rounded differently once
    XLA fuses it), the port from the eager one by 1.7e-13."""
    port, jx, _ = limb_setups
    np.testing.assert_array_equal(port.y, jx.y)
    np.testing.assert_array_equal(port.sv.xa, jx.sv.xa)
    got = port.forward_fn(port.sv.xa).numpy()
    want = np.asarray(jx.forward_fn(jnp.asarray(jx.sv.xa)))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_forward_limb_batch_and_forward_limb_match_jax(decks, limb_setups):
    """Both forwards on the a priori atmosphere and the deck's tables cut
    to 600-620 cm-1, in both packages: the batch over every tangent
    height, and the single-tangent forward re-layered at 60 km."""
    port, jx, _ = limb_setups
    deck, jdeck = decks
    tanhe = deck.geometry.tanhe[:, 0]
    atm = apply_state(port.deck.atmosphere, torch.as_tensor(port.sv.xa),
                      port.sv, adjust_hydrostat=False)
    jatm = jax_apply(jdeck.atmosphere, jnp.asarray(jx.sv.xa), jx.sv,
                     adjust_hydrostat=False)
    geo = tfwd.so_geometry(deck.atmosphere, deck.layer_config, tanhe,
                           lfm_bracket=True)
    jgeo = jfwd.so_geometry(jdeck.atmosphere, jdeck.layer_config, tanhe,
                            lfm_bracket=True)
    from archnemesis_tpu import retrievals as jret
    from archnemesis_tpu_torch import retrievals as tret

    # a narrow window of the set-up's tables (the two packages' eager
    # forwards cost the same per wave; the set-up's whole grid is held to
    # JAX in test_setup_matches_jax)
    lo, hi = 600.0, 620.0
    ktw = tret._windowed_ktab(deck, lo, hi)
    jktw = jret._windowed_ktab(jdeck, lo, hi)
    cfg = tfwd.make_forward_config(atm, ktw, deck.cia, iray=deck.settings.iray,
                                   ispace=deck.settings.ispace)
    jcfg = jfwd.make_forward_config(jatm, jktw, jdeck.cia,
                                    iray=jdeck.settings.iray,
                                    ispace=jdeck.settings.ispace)
    args = (deck.layer_config, ktw, deck.cia, deck.aerosol, cfg)
    jargs = (jdeck.layer_config, jktw, jdeck.cia, jdeck.aerosol, jcfg)
    got = tfwd.forward_limb_batch(atm, *args, geo, device="cpu").numpy()
    # eager, as in test_setup_matches_jax
    want = np.asarray(jfwd.forward_limb_batch(jatm, *jargs, jgeo))
    assert got.shape == (ktw.wave.shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    got1 = tfwd.forward_limb(atm, *args, tanhe_km=60.0, device="cpu").numpy()
    want1 = np.asarray(jfwd.forward_limb(jatm, *jargs, tanhe_km=60.0))
    np.testing.assert_allclose(got1, want1, rtol=1e-10)


@pytest.mark.parametrize("shift", [None, -7.0, 1.5, 20.0])
def test_tangent_stencil_matches_jax(decks, shift):
    """The stencil from the tangent paths to the measured tangent heights:
    the static one of ``so_geometry``, and with a shift (model 777) the
    differentiable search of the JAX forward (forward.py:636-644), clamped
    at both ends; the shift's derivative too."""
    deck, _ = decks
    geo = tfwd.so_geometry(deck.atmosphere, deck.layer_config,
                           deck.geometry.tanhe[:, 0], lfm_bracket=True)
    spec = np.random.default_rng(0).uniform(1.0, 2.0, (9, 6))
    if shift is None:
        want = (spec[:, geo["lo"]] * geo["wlo"]
                + spec[:, geo["hi"]] * geo["whi"])
        got = tfwd.tangent_stencil(torch.as_tensor(spec), geo)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)
        return

    def jstencil(dh):
        bt = jnp.asarray(geo["baseh_tan"])
        th = jnp.asarray(geo["tanhe_km"]) + dh
        idx = jnp.clip(jnp.searchsorted(bt, th) - 1, 0, bt.shape[0] - 2)
        w = jnp.clip((th - bt[idx]) / (bt[idx + 1] - bt[idx]), 0.0, 1.0)
        return spec[:, idx] * (1.0 - w)[None, :] + spec[:, idx + 1] * w[None]

    want, dwant = jax.jvp(jstencil, (jnp.asarray(shift),),
                          (jnp.asarray(1.0),))
    got, dgot = torch.func.jvp(
        lambda dh: tfwd.tangent_stencil(torch.as_tensor(spec), geo, dh),
        (torch.tensor(shift, dtype=torch.float64),),
        (torch.tensor(1.0, dtype=torch.float64),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)
    np.testing.assert_allclose(dgot.numpy(), np.asarray(dwant), rtol=1e-12,
                               atol=1e-15)


def test_ray_length_is_exact_at_nadir_and_zero_tangent():
    """The repair keeps nadir bit for bit (alt - base) in both types."""
    for dtype in (torch.float32, torch.float64):
        alt = torch.linspace(-1.0e5, 3.0e5, 33, dtype=dtype)
        base = torch.tensor(-1.0e5, dtype=dtype)
        got = ray_length(alt, base, torch.tensor(7.1492e7, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype))
        torch.testing.assert_close(got, alt - base, rtol=0, atol=0)
    assert math.isclose(
        ray_length(torch.tensor(0.0), torch.tensor(0.0),
                   torch.tensor(7.1492e7),
                   torch.deg2rad(torch.tensor(90.0))).item(), 0.0,
        abs_tol=0.0)
