"""Retrieval set-up of the PyTorch port vs the JAX package and the
reference goldens: the forward function and its full ``jacfwd`` Jacobian on
the reduced deck (``jupiter_fdret``, NX 41 x NY 200) against ``jax.jacfwd``,
and on the full deck (``jupiter_nadir``, NX 81 x NY 698) the spectrum and
one JVP column against the reference goldens at the JAX tests' own bounds.
The JAX 81-tangent Jacobian of the full deck is not taken here (minutes of
CPU compile)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.retrievals import make_retrieval_setup as jax_setup
from archnemesis_tpu_torch.ops.overlap_cuda import (
    combine_pair,
    combine_pair_with_tangents,
)
from archnemesis_tpu_torch.retrievals import make_retrieval_setup
from port_cases import DECK, FDRET

OE_GOLDEN = "tests/goldens/jupiter_oe.npz"
FD_GOLDEN = "tests/goldens/jupiter_fd_jac.npz"


@pytest.fixture(scope="module")
def fdret():
    want = jax_setup(FDRET, "cirstest")
    got = make_retrieval_setup(FDRET, "cirstest", device="cpu")
    return want, got


@pytest.fixture(scope="module")
def fdret_jacobians(fdret):
    want, got = fdret
    xa = np.asarray(want.sv.xa)
    kk_jax = np.asarray(jax.jit(jax.jacfwd(want.forward_fn))(jnp.asarray(xa)))
    fused, primal = combine_pair_with_tangents.calls, combine_pair.launches
    kk = torch.func.jacfwd(got.forward_fn)(torch.as_tensor(xa))
    counts = (combine_pair_with_tangents.calls - fused,
              combine_pair.launches - primal)
    return kk_jax, kk.numpy(), counts


def test_setup_matches_jax(fdret):
    want, got = fdret
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.se, want.se)
    np.testing.assert_array_equal(got.sv.xa, want.sv.xa)
    np.testing.assert_array_equal(got.sv.sa, want.sv.sa)
    for g, w in zip(got.vconv_list, want.vconv_list):
        np.testing.assert_array_equal(g, w)
    assert got.device.type == "cpu" and got.dtype == torch.float64


def test_forward_fn_matches_jax(fdret):
    """rtol 1e-8: the two packages' sorts and reductions differ in order."""
    want, got = fdret
    rng = np.random.default_rng(0)
    for xn in (want.sv.xa, want.sv.xa + rng.normal(size=want.sv.nx) * 3.0):
        y_jax = np.asarray(want.forward_fn(jnp.asarray(xn)))
        y = got.forward_fn(torch.as_tensor(xn)).numpy()
        np.testing.assert_allclose(y, y_jax, rtol=1e-8, atol=0)
    # a host array is taken as well as a tensor
    np.testing.assert_array_equal(got.forward_fn(want.sv.xa).numpy(),
                                  got.forward_fn(
                                      torch.as_tensor(want.sv.xa)).numpy())


def test_jacfwd_matches_jax(fdret_jacobians):
    kk_jax, kk, _ = fdret_jacobians
    assert kk.shape == kk_jax.shape == (200, 41)
    np.testing.assert_allclose(kk, kk_jax, rtol=1e-6,
                               atol=1e-8 * np.abs(kk_jax).max())


def test_jacfwd_makes_one_fused_call_per_pair_combine(fdret, fdret_jacobians):
    """6 fused calls (NGAS - 1) for all 41 tangents, not 6 x 41, and no
    kernel launch from CPU tensors."""
    want, _ = fdret
    _, _, (fused_calls, primal_launches) = fdret_jacobians
    assert len(want.deck.ktables.gas_id) == 7
    assert fused_calls == 6
    assert primal_launches == 0


def test_jvp_is_a_jacobian_column(fdret, fdret_jacobians):
    _, got = fdret
    _, kk, _ = fdret_jacobians
    j = 17
    v = torch.zeros(got.sv.nx, dtype=torch.float64)
    v[j] = 1.0
    _, dy = torch.func.jvp(got.forward_fn, (torch.as_tensor(got.sv.xa),),
                           (v,))
    np.testing.assert_allclose(dy.numpy(), kk[:, j], rtol=1e-10,
                               atol=1e-12 * np.abs(kk).max())


@pytest.fixture(scope="module")
def nadir():
    return np.load(OE_GOLDEN), make_retrieval_setup(DECK, "cirstest",
                                                    device="cpu")


def test_nadir_apriori_and_measurement_vector(nadir):
    d, s = nadir
    np.testing.assert_allclose(s.sv.xa, d["XA"], rtol=1e-10)
    np.testing.assert_allclose(s.sv.sa, d["SA"], rtol=1e-8)
    np.testing.assert_allclose(s.y, d["Y"], rtol=1e-10)
    np.testing.assert_allclose(np.diag(s.se), np.diag(d["SE"]), rtol=1e-10)
    assert s.sv.nx == 81 and s.y.shape == (698,)


def test_nadir_forward_and_jvp_match_reference(nadir):
    """forward_fn(XN) within 5e-5 of peak of the reference spectrum, and the
    tangent along state element J within 3e-5 of peak of a central
    difference of the REFERENCE forward model (tests/test_retrieval_e2e.py's
    bounds): the whole differentiation chain, hydrostatic loop included."""
    d, s = nadir
    fd = np.load(FD_GOLDEN)
    tangent = torch.zeros(s.sv.nx, dtype=torch.float64)
    tangent[int(fd["J"])] = 1.0
    yn, dy = torch.func.jvp(s.forward_fn, (torch.as_tensor(d["XN"]),),
                            (tangent,))
    np.testing.assert_allclose(yn.numpy(), d["YN"], rtol=0,
                               atol=5e-5 * np.abs(d["YN"]).max())
    np.testing.assert_allclose(dy.numpy(), fd["COL"], rtol=0,
                               atol=3e-5 * np.abs(fd["COL"]).max())


def test_float32_setup_attaches_logk_and_prescales_cia():
    """The float32 path: host log-k table attached, CIA prescaled by 2**134
    before anything is truncated, every component float32, and the spectrum
    within 1e-4 of the float64 one relative to its peak."""
    s32 = make_retrieval_setup(FDRET, "cirstest", device="cpu",
                               dtype=torch.float32)
    deck = s32.deck
    assert deck.ktables.logk is not None
    assert deck.ktables.logk.dtype == torch.float32
    assert deck.cia.k_scale == 2.0**134
    assert float(deck.cia.k_cia.abs().max()) > 1e-10  # out of the subnormals
    for t in (deck.atmosphere.t, deck.ktables.k, deck.cia.k_cia,
              deck.aerosol.kext, deck.surface.vem, deck.stellar.solspec):
        assert t.dtype == torch.float32
    y32 = s32.forward_fn(s32.sv.xa)
    assert y32.dtype == torch.float32
    y64 = make_retrieval_setup(FDRET, "cirstest",
                               device="cpu").forward_fn(s32.sv.xa)
    err = (y32.double() - y64).abs().max() / y64.abs().max()
    assert float(err) < 1e-4


def test_float32_jacobian_holds_for_every_column(fdret_jacobians):
    """Every column of the float32 Jacobian within 1e-3 of that column's own
    peak, the columns of the upper levels included, whose peaks are 12
    orders below the largest: they live on layers with tau < 6e-8, which a
    plain difference of transmissions loses in float32 (rt/emission.py forms
    it with expm1). Before that, those columns came out at -0.2 to -0.3
    times their float64 values (error 1.3 of peak)."""
    _, kk64, _ = fdret_jacobians
    s32 = make_retrieval_setup(FDRET, "cirstest", device="cpu",
                               dtype=torch.float32)
    kk32 = torch.func.jacfwd(s32.forward_fn)(
        torch.as_tensor(s32.sv.xa, dtype=torch.float32)).double().numpy()
    peak = np.abs(kk64).max(axis=0)
    assert peak.min() < 1e-11 * peak.max()
    err = np.abs(kk32 - kk64).max(axis=0) / peak
    assert err.max() < 1e-3, err


def test_unported_branches_raise(tmp_path_factory):
    import os

    from port_cases import copy_deck

    d = copy_deck(tmp_path_factory, "transitdeck")
    inp = os.path.join(d, "cirstest.inp")
    lines = open(inp).read().splitlines()
    lines[7] = "2"  # IFORM = TransitDepth, a unit of the transit set-up
    open(inp, "w").write("\n".join(lines) + "\n")
    with pytest.raises(NotImplementedError,
                       match="make_retrieval_setup_transit"):
        make_retrieval_setup(d, "cirstest", device="cpu")


def test_limb_fov_point_runs(tmp_path_factory):
    """A limb FOV point (EMISS_ANG < 0; it raised before limb paths were ported)
    goes through ``forward_limb`` at its tangent height SOL_ANG: finite,
    positive radiances, and the JAX set-up's on the same copy in
    tests/test_torch_limb_setups.py."""
    import os

    from port_cases import copy_deck

    d = copy_deck(tmp_path_factory, "limbdeck")
    spx = os.path.join(d, "cirstest.spx")
    toks = open(spx).read().split("\n")
    geo = toks[3].split()
    geo[2], geo[3] = "30.0", "-1.0"  # a limb FOV point at 30 km
    toks[3] = " ".join(geo)
    open(spx, "w").write("\n".join(toks))
    s = make_retrieval_setup(d, "cirstest", device="cpu")
    y = s.forward_fn(s.sv.xa)
    assert y.shape == s.y.shape and torch.all(torch.isfinite(y))
    assert torch.all(y > 0)
