"""Line-by-line at run time (ILBL = 1) through the limb, SO and transit
set-ups of the PyTorch port against the JAX package.

The decks are ``chip_smoke.lbl_tangent_deck``'s copies of
``tests/fixtures/co_runtime`` (CO, 10 layers; its grid cut to
``chip_smoke.LBL_TANGENT_WAVE``, 2138-2156 cm-1) with a tangent geometry, an ``.apr`` of the temperature and the CO profile (NX =
30) and, for the transit deck, IFORM = TransitDepth and an inline ``.sol``:
limb (3 tangent heights, FWHM = 0), SO (5 tangent heights, a 0.5 cm-1
Gaussian ILS and a 1.5 km/s Doppler shift), transit (every layer base, a
0.25 cm-1 Gaussian ILS). Both packages read the ``.h5`` line data; a copy
on the ``.npz`` export gives the port the same result.

The JAX package's transit Jacobian on this deck is NaN in every column: at
90 degrees the ray's path length at the lowest layer base is the square
root of an exact zero (``archnemesis_tpu/rt/layer.py:108``,
``rt/path.py:62``), whose tangent is 0 x inf once the hydrostatic
rebalance moves the layer bases. The port writes those lengths without the
root of a difference (``rt/layer.py:ray_length``). The transit columns are
held to JAX with those two modules' square roots given a zero tangent at
zero, which is the exact derivative there (the root is zero for every
state)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import archnemesis_tpu.rt.layer as jax_layer
import archnemesis_tpu.rt.path as jax_path
import chip_smoke
from archnemesis_tpu import retrievals as jax_retrievals
from archnemesis_tpu_torch.io.linedata import RuntimeLBL
from archnemesis_tpu_torch.ops import lbl_cuda
from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian
from port_cases import cuda, one_torch_thread  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KINDS = tuple(chip_smoke.LBL_TANGENT_DECKS)
JAX_SETUPS = {"limb": jax_retrievals.make_retrieval_setup_limb,
              "so": jax_retrievals.make_retrieval_setup_so,
              "transit": jax_retrievals.make_retrieval_setup_transit}


@jax.custom_jvp
def _root(x):
    return jnp.sqrt(x)


@_root.defjvp
def _root_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = jnp.sqrt(x)
    return y, jnp.where(y > 0, 0.5 * dx / jnp.where(y > 0, y, 1.0), 0.0)


class _NumpyWithRoot:
    """``jax.numpy`` whose ``sqrt`` has a zero tangent at zero."""

    sqrt = staticmethod(_root)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """kind -> (the deck on the .h5 line data, the deck on the .npz)."""
    base = tmp_path_factory.mktemp("lbl_tangent")
    return {kind: tuple(chip_smoke.lbl_tangent_deck(str(base / sub), kind,
                                                    data)
                        for sub, data in (("h5", chip_smoke.LINEDATA_H5),
                                          ("npz", chip_smoke.LINEDATA_NPZ)))
            for kind in KINDS}


@pytest.fixture(scope="module")
def runs(decks):
    """kind -> computed once on first use: the JAX set-up's spectrum and
    ``jacfwd`` Jacobian at the a priori (eager, the spectrum as auxiliary
    output), the port's, and the port's primal syntheses in its
    evaluation."""
    cache = {}

    def get(kind):
        if kind not in cache:
            deck = decks[kind][0]
            with pytest.MonkeyPatch.context() as mp:
                if kind == "transit":
                    for module in (jax_layer, jax_path):
                        mp.setattr(module, "jnp", _NumpyWithRoot())
                want = JAX_SETUPS[kind](deck, "cirstest")
                xa = jnp.asarray(want.sv.xa)
                kk_jax, yn_jax = jax.jacfwd(
                    lambda x: (want.forward_fn(x),) * 2, has_aux=True)(xa)
                kk_jax, yn_jax = np.asarray(kk_jax), np.asarray(yn_jax)
            got = chip_smoke.lbl_tangent_setups()[kind](deck, "cirstest",
                                                        device="cpu")
            calls = lbl_cuda.lbl_cross_section.calls
            yn, kk = forward_and_jacobian(got.forward_fn,
                                          torch.as_tensor(want.sv.xa))
            calls = lbl_cuda.lbl_cross_section.calls - calls
            cache[kind] = dict(setup=got, want=(yn_jax, kk_jax),
                               got=(yn.numpy(), kk.numpy()), calls=calls,
                               y=want.y, xa=np.asarray(want.sv.xa))
        return cache[kind]

    return get


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(runs, kind):
    """The set-up's float64 spectrum at the a priori at rtol 1e-10."""
    run = runs(kind)
    assert isinstance(run["setup"].deck.ktables, RuntimeLBL)
    np.testing.assert_array_equal(run["setup"].y, run["y"])
    np.testing.assert_array_equal(run["setup"].sv.xa, run["xa"])
    assert run["got"][0].shape == run["y"].shape
    np.testing.assert_allclose(run["got"][0], run["want"][0], rtol=1e-10,
                               atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_jacobian_matches_jax(runs, kind):
    """Every ``jacfwd`` column (temperature and CO, 15 levels each) within
    1e-10 of its peak, every peak nonzero."""
    run = runs(kind)
    (_, kk_jax), (_, kk) = run["want"], run["got"]
    assert kk.shape == kk_jax.shape == (run["y"].shape[0], 30)
    assert np.isfinite(kk_jax).all()
    assert (np.abs(kk_jax).max(axis=0) > 0).all()
    err = chip_smoke.jacobian_column_errors(kk, kk_jax)
    assert err.max() < 1e-10, err


@pytest.mark.parametrize("kind", KINDS)
def test_one_primal_synthesis_per_evaluation(runs, kind):
    """The 30 tangents ride the plain version's jvp; the primal synthesis
    (kernel 2 on the card) runs once per gas per evaluation."""
    run = runs(kind)
    assert run["calls"] == run["setup"].deck.ktables.ngas == 1


@pytest.mark.parametrize("kind", KINDS)
def test_float32_setup_within_float64(decks, kind):
    """The float32 set-up's spectrum within ``LBL_F32_BOUNDS`` (5e-5 max,
    2e-5 median relative error) of the float64 set-up's, on the same
    float64 calc grid and line window."""
    make = chip_smoke.lbl_tangent_setups()[kind]
    s64 = make(decks[kind][1], "cirstest", device="cpu")
    s32 = make(decks[kind][1], "cirstest", device="cpu", dtype=torch.float32)
    rt32, rt64 = s32.deck.ktables, s64.deck.ktables
    np.testing.assert_array_equal(rt32.wave, rt64.wave)
    np.testing.assert_array_equal(rt32.line_lists[0].nu, rt64.line_lists[0].nu)
    x = torch.as_tensor(s64.sv.xa)
    y64 = s64.forward_fn(x).numpy()
    y32 = s32.forward_fn(x.float())
    assert y32.dtype == torch.float32
    r = chip_smoke.rel_err(y32.double().numpy(), y64)
    bound = chip_smoke.LBL_F32_BOUNDS
    assert r.max() < bound[0] and np.median(r) < bound[1], (r.max(),
                                                            np.median(r))


@pytest.mark.parametrize("kind", KINDS)
def test_npz_deck_equals_h5_deck(decks, kind):
    """The deck whose ``.lls`` names the ``.npz`` export (the card's
    machine has no h5py) gives the port the ``.h5`` deck's spectrum bit for
    bit."""
    make = chip_smoke.lbl_tangent_setups()[kind]
    h5, npz = (make(d, "cirstest", device="cpu") for d in decks[kind])
    x = torch.as_tensor(h5.sv.xa)
    torch.testing.assert_close(npz.forward_fn(x), h5.forward_fn(x), rtol=0,
                               atol=0)


def test_decks_have_the_asked_geometry(decks):
    """Limb: 3 tangent heights and FWHM = 0; SO: 5 tangent heights, a
    Gaussian ILS (FWHM > 0) and a Doppler shift; transit: IFORM =
    TransitDepth with the stellar radius of the inline ``.sol``."""
    from archnemesis_tpu_torch.enums import SpectraUnit
    from archnemesis_tpu_torch.io.legacy import load_deck
    from archnemesis_tpu_torch.retrieval.statevector import read_apr

    got = {kind: load_deck(decks[kind][1], "cirstest") for kind in KINDS}
    limb, so, transit = (got[k] for k in ("limb", "so", "transit"))
    assert limb.geometry.tanhe.shape[0] == 3 and limb.geometry.fwhm == 0.0
    assert so.geometry.tanhe.shape[0] == 5 and so.geometry.fwhm > 0.0
    assert so.settings.ishape == 2 and so.settings.v_doppler != 0.0
    assert transit.settings.iform == SpectraUnit.TransitDepth
    assert float(transit.stellar.radius) == chip_smoke.LBL_GEOM_STELLAR_KM
    for deck in got.values():
        assert isinstance(deck.ktables, RuntimeLBL)
        sv = read_apr(deck.apr_path, deck.atmosphere)
        assert [(e.varident, e.model_id) for e in sv.entries] == [
            ((0, 0, 0), 0), ((5, 1, 0), 0)]


def test_plain_tangent_timer_restores_the_rule(decks):
    """``chip_smoke.plain_tangent_ms`` times kernel 2's forward-mode rule
    once per evaluation and puts the rule back."""
    rule = lbl_cuda._LblCrossSection.jvp
    setup = chip_smoke.lbl_tangent_setups()["so"](decks["so"][1],
                                                  "cirstest", device="cpu")
    ms, calls, total = chip_smoke.plain_tangent_ms(
        setup, torch.as_tensor(setup.sv.xa))
    assert calls == 1 and 0 < ms < total
    assert lbl_cuda._LblCrossSection.jvp is rule


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_deck_on_card_matches_cpu(decks, kind, cuda):
    """On the card: the float64 forward and every Jacobian column within
    1e-10 of the CPU's, one kernel-2 launch per forward and per evaluation,
    no launch of kernels 1 and 1t."""
    make = chip_smoke.lbl_tangent_setups()[kind]
    cpu = make(decks[kind][1], "cirstest", device="cpu")
    card = make(decks[kind][1], "cirstest", device=cuda)
    y_cpu, k_cpu = forward_and_jacobian(cpu.forward_fn,
                                        torch.as_tensor(cpu.sv.xa))
    x = torch.as_tensor(card.sv.xa, device=cuda)
    y, n_fwd, n_comb = chip_smoke._lbl_geometry_launches(
        lambda: card.forward_fn(x))
    (_, kk), n_eval, m_comb = chip_smoke._lbl_geometry_launches(
        lambda: forward_and_jacobian(card.forward_fn, x))
    assert (n_fwd, n_eval, n_comb, m_comb) == (1, 1, 0, 0)
    np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(), rtol=1e-10,
                               atol=0)
    err = chip_smoke.jacobian_column_errors(kk.cpu().numpy(), k_cpu.numpy())
    assert err.max() < 1e-10, err
