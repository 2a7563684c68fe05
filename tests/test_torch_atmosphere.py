"""Atmosphere physics of the PyTorch port vs the JAX package: gravity,
molecular weight, VMR renormalisation, the SVP cap, the hydrostatic
rebalances and the JVP through the hydrostatic loop. Same numpy inputs to
both, float64, rtol 1e-10 (the operations run in the same order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.rt import atmosphere as jax_atm
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.rt import atmosphere as port_atm
from port_cases import flat, layering_atmosphere

RTOL = 1e-10


@pytest.fixture(scope="module")
def atms():
    atm, _ = layering_atmosphere()
    return atm, convert.atmosphere(flat(atm), device="cpu")


def test_gas_molwt_per_column_and_assets(atms):
    atm, _ = atms
    np.testing.assert_array_equal(
        port_atm.gas_molwt_per_column(atm.gas_id, atm.iso_id),
        jax_atm.gas_molwt_per_column(atm.gas_id, atm.iso_id))


@pytest.mark.parametrize("latitude", [0.0, -35.0, 72.5])
@pytest.mark.parametrize("planet", [3, 5, 6])
def test_calc_grav(atms, latitude, planet):
    atm, patm = atms
    g, r = jax_atm.calc_grav(jnp.asarray(atm.h), latitude, planet)
    pg, pr = port_atm.calc_grav(patm.h, latitude, planet)
    np.testing.assert_allclose(pg.numpy(), np.asarray(g), rtol=RTOL)
    np.testing.assert_allclose(float(pr), float(r), rtol=RTOL)


def test_calc_grav_radius_override(atms):
    atm, patm = atms
    g, r = jax_atm.calc_grav(jnp.asarray(atm.h), 10.0, 5,
                             radius_override=jnp.asarray(6.9e7))
    pg, pr = port_atm.calc_grav(patm.h, 10.0, 5,
                                radius_override=torch.tensor(
                                    6.9e7, dtype=torch.float64))
    np.testing.assert_allclose(pg.numpy(), np.asarray(g), rtol=RTOL)
    np.testing.assert_allclose(float(pr), float(r), rtol=RTOL)


def test_calc_molwt_and_adjust_vmr(atms):
    atm, patm = atms
    masses = jax_atm.gas_molwt_per_column(atm.gas_id, atm.iso_id)
    np.testing.assert_allclose(
        port_atm.calc_molwt(patm.vmr, masses).numpy(),
        np.asarray(jax_atm.calc_molwt(jnp.asarray(atm.vmr), masses)),
        rtol=RTOL)
    iscale = np.ones(atm.nvmr, dtype=int)
    iscale[[1, 4]] = 0
    vmr = np.asarray(atm.vmr) * 1.07
    np.testing.assert_allclose(
        port_atm.adjust_vmr(torch.as_tensor(vmr), iscale).numpy(),
        np.asarray(jax_atm.adjust_vmr(jnp.asarray(vmr), iscale)), rtol=RTOL)


def test_apply_svp_cap(atms):
    atm, patm = atms
    # cap NH3 (gas 11) and CH4 (gas 6) where they are in the atmosphere
    svp = tuple((g, s, 1.0, 1) for g, s in zip(atm.gas_id, atm.iso_id)
                if g in (11, 6))
    assert svp
    want = jax_atm.apply_svp_cap(atm.replace(svp=svp))
    got = port_atm.apply_svp_cap(patm.replace(svp=svp))
    np.testing.assert_allclose(got.vmr.numpy(), np.asarray(want.vmr),
                               rtol=RTOL)
    assert not np.array_equal(np.asarray(want.vmr), np.asarray(atm.vmr))
    assert port_atm.apply_svp_cap(patm) is patm


def test_adjust_hydrostat_h_and_p(atms):
    atm, patm = atms
    warm = np.asarray(atm.t) * 1.2  # far enough to need several iterations
    want = jax_atm.adjust_hydrostat_h(atm.replace(t=jnp.asarray(warm)))
    got = port_atm.adjust_hydrostat_h(patm.replace(t=torch.as_tensor(warm)))
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(float(got.radius), float(want.radius),
                               rtol=RTOL)
    htan, ptan = float(atm.h[7]) + 1500.0, float(atm.p[7]) * 0.8
    want_p = jax_atm.adjust_hydrostat_p(atm, htan, ptan)
    got_p = port_atm.adjust_hydrostat_p(patm, htan, ptan)
    np.testing.assert_allclose(got_p.p.numpy(), np.asarray(want_p.p),
                               rtol=RTOL)


def test_hydrostat_loop_iterates_as_often_as_jax(atms, monkeypatch):
    """The host loop must stop where the JAX while_loop stops: count the
    passes of both on the same inputs."""
    atm, patm = atms
    for factor in (1.0, 1.05, 1.5):
        t = np.asarray(atm.t) * factor
        # the JAX loop, unrolled on the host with the same stopping rule
        h = np.asarray(atm.h)
        ialt = int(np.argmin(np.abs(h)))
        n_jax, xdepth = 0, 100.0
        while xdepth > 1.0:
            h_new = np.asarray(jax_atm._hydrostat_h_once(
                jnp.asarray(h), atm.p, jnp.asarray(t), atm.molwt,
                atm.latitude, atm.planet, ialt))
            xdepth = 100.0 * abs(((h_new[-1] - h_new[0]) - (h[-1] - h[0]))
                                 / (h[-1] - h[0]))
            h, n_jax = h_new, n_jax + 1
        calls = []
        real = port_atm._hydrostat_h_once
        monkeypatch.setattr(port_atm, "_hydrostat_h_once",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        got = port_atm.adjust_hydrostat_h(patm.replace(t=torch.as_tensor(t)))
        monkeypatch.setattr(port_atm, "_hydrostat_h_once", real)
        assert len(calls) == n_jax
        want = jax_atm.adjust_hydrostat_h(atm.replace(t=jnp.asarray(t)))
        np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h),
                                   rtol=RTOL, atol=1e-6)


def test_jvp_through_hydrostat_loop(atms):
    """d h / d T along one direction, and the full jacfwd (batched
    tangents share the primal the stopping test reads)."""
    atm, patm = atms
    rng = np.random.default_rng(0)
    t0 = np.asarray(atm.t) * 1.1
    v = rng.normal(size=t0.shape)

    def f_jax(t):
        return jax_atm.adjust_hydrostat_h(atm.replace(t=t)).h

    def f(t):
        return port_atm.adjust_hydrostat_h(patm.replace(t=t)).h

    want_h, want_dh = jax.jvp(f_jax, (jnp.asarray(t0),), (jnp.asarray(v),))
    got_h, got_dh = torch.func.jvp(f, (torch.as_tensor(t0),),
                                   (torch.as_tensor(v),))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=RTOL,
                               atol=1e-6)
    want_dh = np.asarray(want_dh)
    np.testing.assert_allclose(got_dh.numpy(), want_dh, rtol=RTOL,
                               atol=RTOL * np.abs(want_dh).max())
    jac = torch.func.jacfwd(f)(torch.as_tensor(t0)).numpy()
    np.testing.assert_allclose(jac @ v, want_dh, rtol=1e-9,
                               atol=1e-9 * np.abs(want_dh).max())
