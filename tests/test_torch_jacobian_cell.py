"""The correlated-k Jacobian at a cut width on the CPU: the factored
forward-mode rule of the k interpolation (``ops/ktab.py:
interp_ktables_factored``) against ``interp_ktables`` under ``jacfwd``, the
benchmark's Jacobian cell ``jupiter_ck_oe.jac_iter`` (the port against
the plain reference, the reference against central differences, planted
faults and the bfloat16 control not correct), and the tangent combine's
least bytes against the card script's bound.

Cut sizes: ``jupiter_ck_oe`` at 256 waves, NG = 8, 11 levels, 8 layers,
NX = 11 + 5."""

import copy
import time

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import chip_smoke
from archnemesis_tpu_torch.ops.ktab import (
    host_log_ktable,
    interp_ktables,
    interp_ktables_factored,
)
from archnemesis_tpu_torch.ops.overlap import mix_gas_k
from archnemesis_tpu_torch.utils.host import has_tangent
from nembench.control_jac import run_control
from nembench.harness import loop
from nembench.harness import manifest as mf
from nembench.harness import tangent_bounds
from nembench.harness import traffic as tf
from port_cases import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CELL = "jupiter_ck_oe.jac_iter"
SEED = 2**31 + 11


def cut(dtype: str) -> dict:
    """``jupiter_ck_oe`` at a width a CPU test holds."""
    spec = copy.deepcopy(mf.config("jupiter_ck_oe")[0])
    spec.update(nwave=256, ng=8, nlevel=11, nlay=8, nint=11, dtype=dtype)
    spec["state_vector"]["temperature_levels"] = 11
    return spec


def _table(seed: int, ngas=3, nwave=6, ng=4, np_=5, nt=4):
    """A seeded k-table with rows of zeros, of mixed signs and of positive
    values, its (p, T) grids and layer points inside and outside them."""
    rng = np.random.default_rng(seed)
    k = np.exp(rng.normal(-50.0, 2.0, (ngas, nwave, ng, np_, nt)))
    k[0, 0] = 0.0  # all four corners zero: the plain blend
    k[1, 1, :, ::2] = 0.0  # corners of mixed sign: 0
    press = np.logspace(-4, 1, np_)
    temp = np.linspace(100.0, 300.0, nt)
    return (torch.as_tensor(k), torch.as_tensor(press),
            torch.as_tensor(temp))


@pytest.mark.parametrize("with_logk", [False, True])
def test_factored_tangent_equals_interp_ktables(with_logk):
    """jacfwd through the factored k and the per-gas combines equals
    jacfwd through ``interp_ktables`` and the same combines, float64, at
    rtol 1e-10, with the same spectrum-sized primal bit for bit."""
    k, pgrid, tgrid = _table(3)
    logk = (torch.as_tensor(host_log_ktable(k.numpy()), dtype=torch.float64)
            if with_logk else None)
    del_g = 0.5 * np.polynomial.legendre.leggauss(k.shape[2])[1]
    nlay = 7
    x0 = torch.cat([torch.linspace(-5.0, 2.0, nlay),  # ln p [atm]
                    torch.linspace(80.0, 320.0, nlay),  # beyond both ends
                    torch.ones(k.shape[0])]).double()

    def tau(x, interp):
        press, temp = torch.exp(x[:nlay]), x[nlay:2 * nlay]
        amounts = 1e20 * x[2 * nlay:, None] * torch.linspace(
            1.0, 2.0, nlay, dtype=x.dtype)[None, :] * (temp / 200.0)
        kk = interp(k, pgrid, tgrid, press, temp, logk=logk)
        return mix_gas_k(del_g, kk, amounts)

    plain = torch.func.jacfwd(lambda x: tau(x, interp_ktables))(x0)
    factored = torch.func.jacfwd(
        lambda x: tau(x, interp_ktables_factored))(x0)
    assert plain.abs().max() > 0
    np.testing.assert_allclose(factored.numpy(), plain.numpy(), rtol=1e-10,
                               atol=1e-10 * plain.abs().max().item())
    assert torch.equal(tau(x0, interp_ktables),
                       tau(x0, interp_ktables_factored))


def test_has_tangent_sees_forward_mode_only():
    x = torch.tensor([1.0, 2.0])
    seen = []

    def f(z):
        seen.append(has_tangent(z))
        return z * 2

    torch.func.jacfwd(f)(x)
    torch.func.jvp(f, (x,), (x,))
    torch.func.vmap(f)(x[:, None])
    f(x)
    with fwAD.dual_level():
        f(fwAD.make_dual(x, x))
    # a vmap inside jacfwd (the multi-location forward's), and outside it
    torch.func.jacfwd(lambda y: torch.func.vmap(f)(y.expand(3, 2)))(x)
    torch.func.vmap(torch.func.jacfwd(f))(x.expand(3, 2))
    torch.func.vmap(torch.func.vmap(f))(x.expand(1, 3, 2))
    assert seen == [True, True, False, False, True, True, True, False]


def _run(spec, program=None, trace=False, calls=4):
    return loop.run_cell(mf.load(), CELL, SEED, 0.0, trace, "cpu",
                         time.perf_counter(), spec=spec, program=program,
                         min_calls=calls)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cell_on_the_cpu(dtype):
    """In float64 the port's spectrum and K are the reference's (to 1e-8 of
    each column's peak: the combine's sort order differs); in float32 the
    run is correct under the cell's limits. Either way the result line
    holds the cell's end-to-end metrics."""
    result = _run(cut(dtype))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"fwd_waves_per_s", "setup_s"}
    if dtype == "float64":
        assert result["checks"]["jac_rel_err"]["value"] < 1e-8
        assert result["checks"]["spec_rel_err"]["value"] < 1e-10


def broken(fault):
    """A program factory: the port with ``fault`` planted in its
    Jacobian."""

    def factory(spec, seed, device):
        _, module = mf.config("jupiter_ck_oe")
        program = module.Program(spec, seed, device)

        class Broken:
            def jacobian(self, t, mult):
                y, kk = program.jacobian(t, mult)
                if fault == "column_dropped":
                    kk = kk.clone()
                    kk[:, spec["nlevel"] + 2] = 0.0
                elif fault == "temperature_doubled":
                    kk = torch.cat([kk[:, :spec["nlevel"]] * 2.0,
                                    kk[:, spec["nlevel"]:]], dim=1)
                elif fault == "state_unchanged":
                    kk = torch.ones_like(kk) * kk.abs().max()
                return y, kk

        return Broken()

    return factory


@pytest.mark.parametrize("case, floored, want", [
    ("held", 0, 1e-3), ("float32_subnormal", 1, 1e-3),
    ("garbage_under_float32", 1, 1e-8 / torch.finfo(torch.float32).tiny)])
def test_jac_rel_err_holds_every_column(case, floored, want):
    """A column whose float64 peak float32 cannot hold is still compared,
    against float32's smallest normal number: values float32 rounds near
    it pass, garbage there fails."""
    from nembench.calls.jacobian import jac_rel_err

    k_ref = torch.tensor([[1.0, 2e-40], [-3.0, 1e-40]], dtype=torch.float64)
    kk = k_ref.clone()
    kk[1, 0] += 1e-3 * 3.0
    if case == "held":
        k_ref[:, 1] *= 1e30
        kk[:, 1] = k_ref[:, 1]
    elif case == "float32_subnormal":
        kk[:, 1] = k_ref[:, 1].float().double()
    else:
        kk[:, 1] = 1e-8
    err, n = jac_rel_err(kk, k_ref)
    assert n == floored
    assert err == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("fault", ["column_dropped", "temperature_doubled",
                                   "state_unchanged"])
def test_planted_fault_is_not_correct(fault):
    result = _run(cut("float32"), program=broken(fault), calls=2)
    assert not result["correct"], result["checks"]
    assert result["checks"]["spec_rel_err"]["value"] < 1e-4


def test_control_is_not_correct():
    result = run_control(mf.load(), CELL, 20261018, "cpu",
                         spec=cut("float32"))
    assert not result["correct"], result["checks"]
    limit = result["checks"]["jac_rel_err"]["limit"]
    assert result["checks"]["jac_rel_err"]["value"] > limit


@pytest.mark.parametrize("column", [3, 11 + 2])
def test_reference_jacobian_against_central_difference(column):
    """One temperature column and one gas-scale column of the reference's
    jacfwd against a central difference of the reference in float64 (its
    derivative through the overlap's sort shown right on its own)."""
    spec = cut("float64")
    _, module = mf.config("jupiter_ck_oe")
    ref = module.Reference(spec, 5, "cpu")
    t, mult = tf.states(dict(mf.traffic("jac_iter"), states=1),
                        module.profiles(spec)["t"], 5, 9, "cpu")
    waves = np.arange(0, spec["nwave"], 3)
    _, kk = ref.jacobian(t[0], mult[0], waves)
    nl = spec["nlevel"]
    h = 1e-3 if column < nl else 1e-5

    def spectrum(step):
        tt, mm = t[0].clone(), mult[0].clone()
        if column < nl:
            tt[column] += step
        else:
            mm[:, column - nl] *= 1.0 + step
        return ref.forward(tt, mm, waves)

    fd = (spectrum(h) - spectrum(-h)) / (2 * h)
    peak = kk[:, column].abs().max()
    assert peak > 0
    assert (fd - kk[:, column]).abs().max() < 1e-6 * peak


@pytest.mark.parametrize("itemsize, want_ms", [(4, 0.2332), (8, 0.4663)])
def test_tangent_combine_bound_equals_the_card_script(itemsize, want_ms):
    """The Jacobian cell's bound of one combine with T tangents is the card
    script's bound of kernel 1t (T = 81, R = 39,689, NG = 20)."""
    rows, ng, n_tan = 39689, 20, 81
    ms = tangent_bounds.fused_combine_bound_ms(rows, ng, n_tan, itemsize)
    assert ms == chip_smoke.fused_bound_ms(rows, ng, n_tan, itemsize,
                                           True)[0]
    assert round(ms, 4) == want_ms
    assert tangent_bounds.tangent_ops_per_row(ng) == \
        chip_smoke.tangent_ops_per_row(ng)
    assert tangent_bounds.fused_combine_bytes(rows, ng, n_tan, itemsize) \
        / 3.35e12 * 1e3 == ms


def test_manifest_holds_the_jacobian_cell():
    book = mf.load()
    cell = mf.cell(book, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "jupiter_ck_oe", "jac_iter", 1)
    names = [m["name"] for m in mf.metrics_of(book, "per_layer", CELL)]
    assert names == ["overlap_roofline_pct.jac", "overlap_ms.jac",
                     "kinterp_ms.jac", "layering_ms.jac", "emission_ms.jac",
                     "peak_mem_gib.jac", "device_idle_pct.jac",
                     "device_ms_per_call.jac", "launches_per_call.jac",
                     "host_ms_per_call.jac", "emission_fused_pct.jac"]
    for name in names[-5:-2]:
        fwd = mf.metric(name.replace(".jac", ".fwd"))
        trace = type("Trace", (), {"busy_s": 0.6, "window_s": 0.8,
                                   "kernels": lambda self: [0] * 30})()
        ctx = type("Ctx", (), {"trace": trace, "traced_calls": 3})()
        assert mf.metric(name).read(ctx) == fwd.read(ctx) is not None
    for name in names:
        mf.metric(name)
    sizes, _ = mf.config("jupiter_ck_oe")
    base, _ = mf.config("jupiter_ck")
    for key, value in base.items():
        if key not in ("name", "source", "assumed", "limits"):
            assert sizes[key] == value, key
    assert set(sizes["limits"]) == {"spec_rel_err", "jac_rel_err"}
