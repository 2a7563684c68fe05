"""Multi-location forwards in the PyTorch port (``core.types.
stack_atmospheres``, ``multiloc.py``, model 1002) against the JAX package,
on ``tests/test_multiloc.py``'s problem (``__graft_entry__._tiny_problem``:
3 perturbed locations at 0, 30 and 55 degrees): ``forward_nadir_multiloc``
at rtol 1e-10 of JAX's and 2e-12 of per-location forwards, one combine
call per gas pair whatever NLOCATIONS is, the FOV weighting, model 1002's
``from_apr`` (a priori and correlated covariance at rtol 1e-10) and its
Jacobian through the vmapped forward against JAX's ``jacfwd``, column by
column."""

import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu.core.types import stack_atmospheres as jax_stack
from archnemesis_tpu.models import MODEL_REGISTRY as JAX_MODELS
from archnemesis_tpu.multiloc import forward_nadir_multiloc as jax_multiloc
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.core.types import stack_atmospheres
from archnemesis_tpu_torch.forward import forward_nadir
from archnemesis_tpu_torch.models import MODEL_REGISTRY
from archnemesis_tpu_torch.multiloc import (
    forward_nadir_multiloc,
    fov_weighted_spectrum,
    select_location,
)
from archnemesis_tpu_torch.ops import overlap_cuda
from port_cases import (
    assert_same_structure,
    cuda,  # noqa: F401 (a fixture)
    flat,
    one_torch_thread,  # noqa: F401 (a fixture)
    to_port,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EMISS = np.array([0.0, 30.0, 55.0])
LOCS = ("3 40.0\n10.0 20.0 1.0 0.1\n-20.0 35.0 1.1 0.2\n"
        "15.0 80.0 0.9 0.15\n")


def _jax_problem():
    sys.path.insert(0, ".")
    import __graft_entry__ as ge

    return ge._tiny_problem(nwave=48, ng=8, nlay=9, npro=12,
                            dtype=np.float64)


def _jax_locations(atm):
    """tests/test_multiloc.py's three locations."""
    return [
        atm,
        atm.replace(t=np.asarray(atm.t) * 1.05,
                    latitude=np.asarray(10.0, float)),
        atm.replace(t=np.asarray(atm.t) * 0.95,
                    vmr=np.asarray(atm.vmr) * 1.1,
                    latitude=np.asarray(-20.0, float)),
    ]


@pytest.fixture(scope="module")
def case():
    atm, laycfg, ktab, surf, cfg = _jax_problem()
    jmulti = jax_stack(_jax_locations(atm))
    tatm, tlay, tkt, _, _, tsurf, tcfg = to_port(
        (atm, laycfg, ktab, None, None, surf, cfg))
    tmulti = convert.stacked_atmosphere(flat(jmulti), device="cpu")
    return dict(jax=(jmulti, laycfg, ktab, surf, cfg),
                port=(tmulti, tlay, tkt, tsurf, tcfg), jatm=atm)


def test_stack_and_select_match_jax(case):
    """The port's ``stack_atmospheres`` of the three converted locations
    equals the converted JAX stack; ``select_location`` slices it back."""
    jmulti = case["jax"][0]
    tmulti = case["port"][0]
    singles = [convert.atmosphere(flat(a), device="cpu")
               for a in _jax_locations(case["jatm"])]
    assert_same_structure(stack_atmospheres(singles), jmulti, "stacked")
    assert_same_structure(tmulti, jmulti, "converted")
    for i, a in enumerate(singles):
        assert_same_structure(select_location(tmulti, i),
                              _jax_locations(case["jatm"])[i], f"loc {i}")
    with pytest.raises(ValueError, match="static metadata"):
        stack_atmospheres([singles[0],
                           singles[1].replace(gas_id=(39, 7))])
    with pytest.raises(ValueError, match="not a stacked"):
        convert.stacked_atmosphere(flat(case["jatm"]), device="cpu")


def test_multiloc_matches_jax_and_per_location(case, monkeypatch):
    """rtol 1e-10 of JAX's jitted ``forward_nadir_multiloc``, 2e-12 of
    each location's own forward (``tests/test_multiloc.py``'s bound), and
    the combine called once per gas pair for all locations (its ``vmap``
    rule folds them into the rows)."""
    jmulti, jlay, jkt, jsurf, jcfg = case["jax"]
    tmulti, tlay, tkt, tsurf, tcfg = case["port"]
    want = np.asarray(jax.jit(lambda m: jax_multiloc(
        m, jlay, jkt, None, None, jsurf, jcfg, emiss_ang=EMISS))(jmulti))
    calls = []
    plain = overlap_cuda.combine_pair_plain
    monkeypatch.setattr(overlap_cuda, "combine_pair_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    got = forward_nadir_multiloc(tmulti, tlay, tkt, None, None, tsurf, tcfg,
                                 emiss_ang=EMISS, device="cpu").numpy()
    assert got.shape == (48, 3)
    assert len(calls) == tkt.ngas - 1
    assert calls[0][0] == 3 * 48 * tlay.nlay  # every location's rows
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    for i in range(3):
        one = forward_nadir(select_location(tmulti, i), tlay, tkt, None,
                            None, tsurf, tcfg, emiss_ang=float(EMISS[i]),
                            device="cpu")[:, 0].numpy()
        np.testing.assert_allclose(got[:, i], one, rtol=2e-12, atol=0)
    w = np.array([0.5, 0.3, 0.2])
    np.testing.assert_allclose(
        fov_weighted_spectrum(torch.as_tensor(got), w).numpy(),
        got @ (w / w.sum()), rtol=1e-14)


def test_multiloc_angles_broadcast(case):
    """One angle for every location equals the same angle given per
    location; sol_ang and azi_ang default to 180 and 0."""
    tmulti, tlay, tkt, tsurf, tcfg = case["port"]
    args = (tmulti, tlay, tkt, None, None, tsurf, tcfg)
    a = forward_nadir_multiloc(*args, emiss_ang=30.0, device="cpu")
    b = forward_nadir_multiloc(*args, emiss_ang=np.full(3, 30.0),
                               sol_ang=np.full(3, 180.0),
                               azi_ang=np.zeros(3), device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def m1002(case, tmp_path_factory):
    """Model 1002's parse in both packages on a three-location file, for
    the temperature (varident 0 0 1002) and a gas (6 0 1002)."""
    d = tmp_path_factory.mktemp("m1002")
    (d / "locs.dat").write_text(LOCS)
    atm = case["jatm"]
    ctx = dict(npro=12, gas_id=atm.gas_id, iso_id=atm.iso_id, ndust=0)
    out = {}
    for varident in ([0, 0, 1002], [6, 0, 1002]):
        text = f"{d / 'locs.dat'}\n"
        out[varident[0]] = (
            MODEL_REGISTRY[1002].from_apr(io.StringIO(text), varident, 0,
                                          ctx),
            JAX_MODELS[1002].from_apr(io.StringIO(text), varident, 0, ctx))
    return out


def test_model_1002_from_apr_matches_jax(m1002):
    for got, want in m1002.values():
        assert got.entry.nx == want.entry.nx == 3
        assert (got.entry.target.value, got.entry.target_idx,
                got.entry.extra) == (want.entry.target.value,
                                     want.entry.target_idx, want.entry.extra)
        for name in ("x0", "sx_diag", "lx", "inum", "corr"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), rtol=1e-10,
                                       atol=0, err_msg=name)
        corr = got.corr
        assert np.all(corr == corr.T) and corr[0, 1] != 0.0


@pytest.mark.parametrize("target", [0, 6], ids=["temperature", "gas"])
def test_model_1002_jacobian_matches_jax(case, m1002, target):
    """jacfwd of the multi-location forward through model 1002's three
    scales against JAX's jitted jacfwd, each column within 1e-10 of its
    peak; a scale moves only its own location's spectrum."""
    got_p, want_p = m1002[target]
    jmulti, jlay, jkt, jsurf, jcfg = case["jax"]
    tmulti, tlay, tkt, tsurf, tcfg = case["port"]
    x0 = np.array([1.0, 1.1, 0.9])

    def port_f(x):
        m = MODEL_REGISTRY[1002].apply(got_p.entry, tmulti, x)
        return forward_nadir_multiloc(m, tlay, tkt, None, None, tsurf, tcfg,
                                      emiss_ang=EMISS, device="cpu")

    def jax_f(x):
        m = JAX_MODELS[1002].apply(want_p.entry, jmulti, x)
        return jax_multiloc(m, jlay, jkt, None, None, jsurf, jcfg,
                            emiss_ang=EMISS)

    got = torch.func.jacfwd(port_f)(torch.as_tensor(x0)).numpy()
    want = np.asarray(jax.jit(jax.jacfwd(jax_f))(jnp.asarray(x0)))
    assert got.shape == want.shape == (48, 3, 3)
    for j in range(3):
        peak = np.abs(want[:, :, j]).max()
        assert peak > 0
        np.testing.assert_allclose(got[:, :, j], want[:, :, j], rtol=0,
                                   atol=1e-10 * peak)
        others = [i for i in range(3) if i != j]
        assert np.all(got[:, others, j] == 0.0)


@pytest.mark.cuda
def test_multiloc_on_card_matches_plain(cuda):
    """On the card, the synthetic headline at phase 24's three locations
    (64 waves): kernel 1 launched once per gas pair (6) for all locations,
    the spectra equal to the plain combine's on the CPU within 1e-10, and
    a Jacobian of three per-location temperature scales through kernel 1t
    once per pair."""
    from archnemesis_tpu_torch.ops.overlap_cuda import (
        combine_pair,
        combine_pair_with_tangents,
    )

    def run(device):
        multi, laycfg, ktab, surf, cfg = chip_smoke.multiloc_case(
            64, torch.float64, device)
        args = (laycfg, ktab, None, None, surf, cfg)
        return multi, lambda m: forward_nadir_multiloc(
            m, *args, emiss_ang=chip_smoke.MULTILOC_EMISS, device=device)

    multi, f = run(cuda)
    multi_cpu, f_cpu = run("cpu")
    before = combine_pair.launches
    got = f(multi)
    torch.cuda.synchronize()
    assert combine_pair.launches - before == 6
    np.testing.assert_allclose(got.cpu().numpy(), f_cpu(multi_cpu).numpy(),
                               rtol=1e-10, atol=0)
    before = combine_pair_with_tangents.launches
    jac = torch.func.jacfwd(
        lambda x: f(multi.replace(t=multi.t * x[:, None])))(
            torch.ones(3, dtype=torch.float64, device=cuda))
    torch.cuda.synchronize()
    assert combine_pair_with_tangents.launches - before == 6
    assert torch.isfinite(jac).all()
