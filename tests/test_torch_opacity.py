"""Opacity sources of the PyTorch port vs the JAX package: the k-table and
CIA readers, k-table interpolation (raw-k and host-log branches), CIA (raw
and prescaled tables, analytic NIR bands), Rayleigh, dust and the Planck
function."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.enums import ParaH2Ratio, WaveUnit
from archnemesis_tpu.io.cia import read_cia_tab as jax_read_cia_tab
from archnemesis_tpu.io.ktables import read_kls as jax_read_kls
from archnemesis_tpu.ops.cia import cia_tau as jax_cia_tau
from archnemesis_tpu.ops.dust import dust_tau as jax_dust_tau
from archnemesis_tpu.ops.ktab import host_log_ktable as jax_host_log_ktable
from archnemesis_tpu.ops.ktab import interp_ktables as jax_interp_ktables
from archnemesis_tpu.ops.planck import planck as jax_planck
from archnemesis_tpu.ops.rayleigh import rayleigh_tau as jax_rayleigh_tau
from archnemesis_tpu.rt.layer import build_layers as jax_build_layers
from archnemesis_tpu_torch.core.spectra import cast_deck
from archnemesis_tpu_torch.io.cia import read_cia_tab
from archnemesis_tpu_torch.io.ktables import read_kls
from archnemesis_tpu_torch.ops.cia import cia_tau
from archnemesis_tpu_torch.ops.dust import dust_tau
from archnemesis_tpu_torch.ops.ktab import host_log_ktable, interp_ktables
from archnemesis_tpu_torch.ops.planck import planck
from archnemesis_tpu_torch.ops.rayleigh import rayleigh_tau
from port_cases import CIA_TAB, DECK, jax_golden_deck, np64

KLS = f"{DECK}/cirstest.kls"


def t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def layers():
    """The deck's layers (JAX float64) as a dict of numpy arrays."""
    atm, laycfg = jax_golden_deck()[:2]
    lay = jax_build_layers(atm, laycfg)
    out = {n: np.asarray(getattr(lay, n))
           for n in ("press", "temp", "totam", "delh", "frac", "pp")}
    out["q"] = out["pp"] / out["press"][:, None]
    return out


@pytest.fixture(scope="module")
def ktable():
    """A small k-table with all-zero, mixed-sign-corner and positive regions,
    and layer points inside and outside its (P, T) grid."""
    rng = np.random.default_rng(1)
    press = np.logspace(-4, 1, 6)
    temp = np.linspace(80.0, 300.0, 5)
    k = np.exp(rng.uniform(-60, -45, (2, 7, 4, 6, 5)))
    k[0, :2] = 0.0
    k[1, 3, :, 2, 1] = 0.0
    p_lay = np.array([1e-5, 3e-4, 2e-2, 0.7, 5.0, 30.0])
    t_lay = np.array([60.0, 85.0, 140.0, 222.0, 299.0, 350.0])
    return k, press, temp, p_lay, t_lay


def test_interp_ktables_raw_k_matches_jax(ktable):
    k, press, temp, p_lay, t_lay = ktable
    want = np.asarray(jax_interp_ktables(k, press, temp, jnp.asarray(p_lay),
                                         jnp.asarray(t_lay)))
    got = interp_ktables(t(k), t(press), t(temp), t(p_lay), t(t_lay))
    assert got.shape == want.shape == (7, 4, 6, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_interp_ktables_host_log_matches_jax(ktable):
    k, press, temp, p_lay, t_lay = ktable
    logk = host_log_ktable(k)
    np.testing.assert_array_equal(logk, jax_host_log_ktable(k))
    f32 = np.float32
    want = np.asarray(jax_interp_ktables(
        k.astype(f32), press.astype(f32), temp.astype(f32),
        jnp.asarray(p_lay, dtype=f32), jnp.asarray(t_lay, dtype=f32),
        logk=logk))
    got = interp_ktables(t(k, torch.float32), t(press, torch.float32),
                         t(temp, torch.float32), t(p_lay, torch.float32),
                         t(t_lay, torch.float32), logk=torch.as_tensor(logk))
    assert got.dtype == torch.float32
    # float32 exp/log of two libraries: a few ulp
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)


@pytest.fixture(scope="module")
def cia_pair():
    jcia = jax_read_cia_tab(CIA_TAB, dnu=1.0, npara=0,
                            inormal=ParaH2Ratio.NORMAL)
    cia = read_cia_tab(CIA_TAB, dnu=1.0, npara=0, inormal=ParaH2Ratio.NORMAL,
                       device="cpu")
    return jcia, cia


def test_read_cia_tab_matches_jax(cia_pair):
    jcia, cia = cia_pair
    for name in ("waven", "temp", "frac", "k_cia"):
        np.testing.assert_array_equal(np64(getattr(cia, name)),
                                      np.asarray(getattr(jcia, name)))
    assert (cia.pair_gas1, cia.pair_gas2, cia.inormalt, cia.npara) == (
        jcia.pair_gas1, jcia.pair_gas2, jcia.inormalt, jcia.npara)


# (ispace, analytic NIR bands on): the wave grids reach the NIR bands
@pytest.mark.parametrize("prescale", [False, True])
@pytest.mark.parametrize("ispace,bands", [(0, False), (0, True), (1, True)])
def test_cia_tau_matches_jax(layers, cia_pair, prescale, ispace, bands):
    jcia, cia = cia_pair
    if prescale:
        jcia, cia = jcia.prescale(), cia.prescale()
    wave = (np.linspace(20.0, 12000.0, 301) if ispace == 0
            else np.linspace(0.8, 50.0, 301))
    npair = len(cia.pair_gas1)
    q1, q2 = tuple(range(npair)), tuple((2 * i) % 11 for i in range(npair))
    active = tuple(int(i % 4 != 3) for i in range(npair))
    cols = dict(ico2=4, in2=5, ih2=0) if bands else {}
    lay = layers
    want = np.asarray(jax_cia_tau(
        jcia, jnp.asarray(wave), lay["temp"], lay["frac"], lay["q"],
        lay["totam"], lay["delh"], jnp.asarray(q1), jnp.asarray(q2),
        np.asarray(active, dtype=np.float64), ispace=WaveUnit(ispace),
        **cols))
    got = cia_tau(cia, t(wave), t(lay["temp"]), t(lay["frac"]), t(lay["q"]),
                  t(lay["totam"]), t(lay["delh"]), q1, q2, active,
                  ispace=WaveUnit(ispace), **cols)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=1e-13 * np.abs(want).max())


def test_cia_tau_float32_prescaled_matches_float64(layers, cia_pair):
    _, cia = cia_pair
    lay = layers
    wave = np.linspace(20.0, 1500.0, 200)
    args = [lay["temp"], lay["frac"], lay["q"], lay["totam"], lay["delh"]]
    q = (tuple(range(9)), (1,) * 9, (1,) * 9)
    want = cia_tau(cia, t(wave), *map(t, args), *q).numpy()
    got = cia_tau(cast_deck(cia, torch.float32), t(wave, torch.float32),
                  *(t(a, torch.float32) for a in args), *q)
    assert got.dtype == torch.float32 and np.abs(want).max() > 0
    np.testing.assert_allclose(got.double().numpy(), want, rtol=2e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("ispace", [0, 1])
@pytest.mark.parametrize("mode", [0, 1, 2, 4])
def test_rayleigh_tau_matches_jax(layers, mode, ispace):
    wave = (np.linspace(100.0, 20000.0, 50) if ispace == 0
            else np.linspace(0.3, 5.0, 50))
    gas_idx = {"h2": 0, "he": 1, "ch4": 2, "nh3": 6}
    want = np.asarray(jax_rayleigh_tau(mode, jnp.asarray(wave),
                                       layers["totam"], vmr_lay=layers["q"],
                                       gas_idx=gas_idx, ispace=ispace))
    got = rayleigh_tau(mode, t(wave), t(layers["totam"]),
                       vmr_lay=t(layers["q"]), gas_idx=gas_idx, ispace=ispace)
    assert got.shape == want.shape == (50, layers["totam"].shape[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("nx", [2, 6])
def test_dust_tau_matches_jax(nx):
    rng = np.random.default_rng(nx)
    xsc_wave = np.sort(rng.uniform(0.0, 2000.0, nx))
    kext = rng.uniform(0.0, 1e-8, (nx, 3))
    ksca = 0.5 * kext
    wavec = np.linspace(100.0, 1900.0, 40)
    cont = rng.uniform(0.0, 1e10, (7, 3))
    want = jax_dust_tau(xsc_wave, kext, ksca, jnp.asarray(wavec),
                        jnp.asarray(cont))
    got = dust_tau(t(xsc_wave), t(kext), t(ksca), t(wavec), t(cont))
    for w, g in zip(want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-12 * np.abs(w).max())


@pytest.mark.parametrize("ispace", [0, 1])
def test_planck_matches_jax(ispace):
    wave = (np.linspace(10.0, 3000.0, 30) if ispace == 0
            else np.linspace(1.0, 100.0, 30))
    temp = np.linspace(50.0, 400.0, 8)
    want = np.asarray(jax_planck(jnp.asarray(wave)[:, None],
                                 jnp.asarray(temp)[None, :], ispace))
    got = planck(t(wave)[:, None], t(temp)[None, :], ispace)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0)


def test_read_kls_matches_jax():
    jtabs = jax_read_kls(KLS, wavemin=600.0, wavemax=700.0)
    tabs = read_kls(KLS, wavemin=600.0, wavemax=700.0)
    assert len(tabs) == len(jtabs) == 7
    for a, b in zip(tabs, jtabs):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), err_msg=f.name)


def test_read_kls_applies_redirects(tmp_path):
    """A .kls listing absolute locations under a moved prefix reads the same
    tables once the prefix is redirected."""
    fixture = os.path.abspath("tests/fixtures/ktables")
    names = [ln.strip().split("/")[-1] for ln in open(KLS) if ln.strip()]
    moved = tmp_path / "moved.kls"
    moved.write_text("".join(f"/old/tables/{n}\n" for n in names))
    tabs = read_kls(str(moved), wavemin=600.0, wavemax=620.0,
                    redirects=[("/old", "/elsewhere"),
                               ("/old/tables", fixture)])
    want = read_kls(KLS, wavemin=600.0, wavemax=620.0)
    for a, b in zip(tabs, want):
        np.testing.assert_array_equal(a.k, b.k)
