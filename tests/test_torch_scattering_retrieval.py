"""The scattering retrieval set-up of the port (ISCAT=1, multiple
scattering, and ISCAT=3, plane-parallel single scattering, through
``archnemesis_tpu_torch.retrievals.make_retrieval_setup``) on the Jupiter
scattering deck (.apr models 0, 47 and 444), against the JAX package's
set-up on the same deck: the forward at the a priori, one JVP through
scattering, Mie and model 47, and ``torch.func.jacfwd`` of the port held to
that JVP. The JAX forward is jitted (its eager Mie scans are slow); its full
``jacfwd`` is slow-marked in ``tests/test_retrieval_scattering.py``, and the
port's full Jacobian runs on the card (``chip_smoke.py`` phase 17)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.retrievals import make_retrieval_setup as jax_setup
from archnemesis_tpu_torch import retrievals
from archnemesis_tpu_torch.enums import SpectraUnit
from archnemesis_tpu_torch.retrievals import make_retrieval_setup
from port_cases import copy_deck, one_torch_thread  # noqa: F401

DECK = "tests/fixtures/jupiter_scatter"

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setups():
    port = make_retrieval_setup(DECK, "cirstest", device="cpu")
    jx = jax_setup(DECK, "cirstest")
    return port, jx, jax.jit(jx.forward_fn)


def _tangent(sv):
    """One direction through the three models: a temperature level (model
    0), the cloud's optical depth (model 47) and the first imaginary index
    of the haze (model 444)."""
    cols = [next(e for e in sv.entries if e.model_id == m).ix
            for m in (0, 47, 444)]
    cols[0] += 40
    cols[2] += 2
    v = np.zeros(sv.nx)
    v[cols] = 1.0
    return v, cols


def test_forward_matches_jax(setups):
    port, jx, jfwd = setups
    np.testing.assert_array_equal(port.y, jx.y)
    np.testing.assert_array_equal(port.sv.xa, jx.sv.xa)
    got = port.forward_fn(port.sv.xa)
    want = np.asarray(jfwd(jnp.asarray(jx.sv.xa)))
    assert got.shape == port.y.shape and torch.all(got > 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)


@pytest.fixture(scope="module")
def jvp_column(setups):
    port, jx, jfwd = setups
    v, cols = _tangent(port.sv)
    _, dy = torch.func.jvp(port.forward_fn,
                           (torch.as_tensor(port.sv.xa),),
                           (torch.as_tensor(v),))
    _, dj = jax.jvp(jfwd, (jnp.asarray(jx.sv.xa),), (jnp.asarray(v),))
    return dy, np.asarray(dj), cols


def test_jvp_through_scattering_mie_and_model47_matches_jax(jvp_column):
    dy, dj, _ = jvp_column
    assert torch.all(torch.isfinite(dy)) and dy.abs().max() > 0.0
    np.testing.assert_allclose(dy.numpy(), dj, rtol=1e-8,
                               atol=1e-12 * np.abs(dj).max())


def test_jacfwd_matches_its_jvp(setups, jvp_column):
    """``torch.func.jacfwd`` through the whole forward (scattering, Mie,
    models 0/47/444) on the three state elements of the JVP: each column
    finite and nonzero, their sum the JVP."""
    port, _, _ = setups
    dy, _, cols = jvp_column
    xa = torch.as_tensor(port.sv.xa)
    basis = torch.zeros(port.sv.nx, 3, dtype=xa.dtype)
    basis[cols, range(3)] = 1.0
    kk = torch.func.jacfwd(lambda z: port.forward_fn(xa + basis @ z))(
        torch.zeros(3, dtype=xa.dtype))
    assert kk.shape == (port.y.shape[0], 3)
    assert torch.all(torch.isfinite(kk))
    assert torch.all(kk.abs().max(dim=0).values > 0.0)
    torch.testing.assert_close(kk.sum(dim=1), dy, rtol=1e-10,
                               atol=1e-14 * dy.abs().max().item())


def test_single_scattering_setup_matches_jax(tmp_path_factory):
    """ISCAT=3 on a copy of the deck: the plane-parallel single-scattering
    forward through the same state vector."""
    deck = copy_deck(tmp_path_factory, "iscat3", deck=DECK)
    inp = f"{deck}/cirstest.inp"
    lines = open(inp).read().split("\n")
    first = lines[0].split()
    first[1] = "3"
    lines[0] = " ".join(first)
    open(inp, "w").write("\n".join(lines))
    port = make_retrieval_setup(deck, "cirstest", device="cpu")
    jx = jax_setup(deck, "cirstest")
    got = port.forward_fn(port.sv.xa)
    want = np.asarray(jax.jit(jx.forward_fn)(jnp.asarray(jx.sv.xa)))
    assert torch.all(torch.isfinite(got))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)


def test_flux_units_of_multiple_scattering(setups, monkeypatch):
    """IFORM Integrated_spectral_power scales the multiple-scattering
    spectrum by the JAX package's ``_iform_xfac`` (the deliberate deviation
    of PARITY.md); FluxRatio's factor on the calc grid equals JAX's."""
    from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
    from archnemesis_tpu.retrievals import _iform_xfac as jax_xfac

    port, _, _ = setups
    orig = retrievals.load_deck

    def loader(d, r):
        dk = orig(d, r)
        return dataclasses.replace(dk, settings=dataclasses.replace(
            dk.settings, iform=SpectraUnit.Integrated_spectral_power))

    monkeypatch.setattr(retrievals, "load_deck", loader)
    power = make_retrieval_setup(DECK, "cirstest", device="cpu")
    jdeck = jax_load_deck(DECK, "cirstest")
    scale = jax_xfac(SpectraUnit.Integrated_spectral_power,
                     jdeck.atmosphere, jdeck.stellar, None)
    torch.testing.assert_close(power.forward_fn(power.sv.xa),
                               port.forward_fn(port.sv.xa) * scale,
                               rtol=1e-10, atol=0)
    wave = np.asarray(jdeck.ktables.wave)
    np.testing.assert_allclose(
        retrievals._iform_xfac(SpectraUnit.FluxRatio, port.deck.atmosphere,
                               port.deck.stellar, wave),
        np.asarray(jax_xfac(SpectraUnit.FluxRatio, jdeck.atmosphere,
                            jdeck.stellar, wave)), rtol=1e-12)


def test_float32_setup_within_float64(setups):
    """The float32 set-up (cast deck; Kramers-Kronig and Mie of model 444
    in float64, their float32 series overflows) within 5e-4 of float64."""
    port, _, _ = setups
    s32 = make_retrieval_setup(DECK, "cirstest", device="cpu",
                               dtype=torch.float32)
    y32 = s32.forward_fn(s32.sv.xa)
    assert y32.dtype == torch.float32 and torch.all(torch.isfinite(y32))
    y64 = port.forward_fn(port.sv.xa)
    assert ((y32.double() - y64).abs() / y64.abs()).max() < 5e-4
