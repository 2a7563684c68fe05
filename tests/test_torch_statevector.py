"""State vector of the PyTorch port vs the JAX package: ``read_apr`` (a
priori, covariance, log flags) against the JAX reader and the reference
golden, ``apply_state`` on the same atmosphere and state at rtol 1e-10, and
the three ported models' ``from_apr`` + ``apply``."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
from archnemesis_tpu.models import MODEL_REGISTRY as JAX_MODELS
from archnemesis_tpu.retrieval import statevector as jax_sv
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.io.legacy import load_deck
from archnemesis_tpu_torch.models import MODEL_REGISTRY
from archnemesis_tpu_torch.retrieval import statevector as port_sv
from port_cases import DECK, FDRET, flat, flat_state_vector

OE_GOLDEN = "tests/goldens/jupiter_oe.npz"


@pytest.fixture(scope="module", params=[DECK, FDRET],
                ids=["jupiter_nadir", "jupiter_fdret"])
def svs(request):
    jdeck = jax_load_deck(request.param, "cirstest")
    pdeck = load_deck(request.param, "cirstest")
    return (request.param, jdeck, pdeck,
            jax_sv.read_apr(jdeck.apr_path, jdeck.atmosphere),
            port_sv.read_apr(pdeck.apr_path, pdeck.atmosphere))


@pytest.fixture(scope="module")
def nadir():
    jdeck = jax_load_deck(DECK, "cirstest")
    pdeck = load_deck(DECK, "cirstest")
    return jdeck, pdeck, port_sv.read_apr(pdeck.apr_path, pdeck.atmosphere)


def test_read_apr_matches_jax(svs):
    _, _, _, want, got = svs
    assert got.nx == want.nx
    for name in ("xa", "sa", "lx", "fix", "inum", "iscale_mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    for g, w in zip(got.entries, want.entries):
        assert (g.varident, g.model_id, g.ix, g.nx, g.target.value,
                g.target_idx, g.extra) == (
            w.varident, w.model_id, w.ix, w.nx, w.target.value,
            w.target_idx, w.extra)


def test_read_apr_matches_reference_golden(nadir):
    _, _, got = nadir
    d = np.load(OE_GOLDEN)
    np.testing.assert_allclose(got.xa, d["XA"], rtol=1e-10)
    np.testing.assert_allclose(got.sa, d["SA"], rtol=1e-8)
    np.testing.assert_array_equal(got.lx, d["LX"])


def test_convert_state_vector(svs):
    _, jdeck, _, want, got = svs
    carried = convert.state_vector(flat_state_vector(want),
                                   jdeck.atmosphere.nvmr)
    assert carried.entries == got.entries
    np.testing.assert_array_equal(carried.sa, got.sa)
    np.testing.assert_array_equal(carried.iscale_mask, got.iscale_mask)


@pytest.mark.parametrize("hydrostat", [True, False])
def test_apply_state_matches_jax(svs, hydrostat):
    _, jdeck, _, jsv, psv = svs
    rng = np.random.default_rng(1)
    xn = jsv.xa + rng.normal(size=jsv.nx) * 2.0
    want = jax_sv.apply_state(jdeck.atmosphere, jnp.asarray(xn), jsv,
                              adjust_hydrostat=hydrostat)
    patm = convert.atmosphere(flat(jdeck.atmosphere), device="cpu")
    got = port_sv.apply_state(patm, torch.as_tensor(xn), psv,
                              adjust_hydrostat=hydrostat)
    for name in ("h", "p", "t", "vmr", "molwt", "radius"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-10, atol=1e-6 if name == "h" else 0, err_msg=name)
    # a host array is taken as well as a tensor
    again = port_sv.apply_state(patm, xn, psv, adjust_hydrostat=hydrostat)
    torch.testing.assert_close(again.h, got.h, rtol=0, atol=0)


APR_BLOCKS = {
    0: "prof.dat\n",
    2: "1.25 0.3 ! scale, error\n",
    3: "0.8 0.2 ! scale, error\n",
}


@pytest.mark.parametrize("varident", [(0, 0, 0), (11, 0, 0), (-1, 0, 0),
                                      (28, 0, 2), (0, 0, 2), (11, 0, 3),
                                      (-1, 0, 3)])
def test_models_from_apr_and_apply(nadir, varident, tmp_path, monkeypatch):
    jdeck, pdeck, _ = nadir
    model_id = varident[2]
    npro = jdeck.atmosphere.np_
    rng = np.random.default_rng(model_id)
    p = np.asarray(jdeck.atmosphere.p) / 101325.0
    ref = rng.uniform(0.5, 2.0, npro) * (100.0 if varident[0] == 0 else 1e-4)
    with open(tmp_path / "prof.dat", "w") as f:
        f.write(f"{npro} 1.5\n")
        for i in range(npro):
            f.write(f"{p[i]:.8e} {ref[i]:.8e} {0.1 * ref[i]:.8e}\n")
    monkeypatch.chdir(tmp_path)
    ctx = dict(npro=npro, gas_id=jdeck.atmosphere.gas_id,
               iso_id=jdeck.atmosphere.iso_id, ndust=jdeck.atmosphere.ndust)
    want = JAX_MODELS[model_id].from_apr(io.StringIO(APR_BLOCKS[model_id]),
                                         list(varident), 3, ctx)
    got = MODEL_REGISTRY[model_id].from_apr(io.StringIO(APR_BLOCKS[model_id]),
                                            list(varident), 3, ctx)
    for name in ("x0", "sx_diag", "lx", "inum"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    if want.corr is None:
        assert got.corr is None
    else:
        np.testing.assert_array_equal(got.corr, want.corr)
    assert got.entry.target.value == want.entry.target.value
    assert got.entry.target_idx == want.entry.target_idx

    x = np.where(want.lx == 1, np.exp(want.x0), want.x0) * 1.1
    a_want = JAX_MODELS[model_id].apply(want.entry, jdeck.atmosphere,
                                        jnp.asarray(x))
    a_got = MODEL_REGISTRY[model_id].apply(got.entry, pdeck.atmosphere,
                                           torch.as_tensor(x))
    for name in ("t", "vmr", "dust"):
        np.testing.assert_allclose(getattr(a_got, name).numpy(),
                                   np.asarray(getattr(a_want, name)),
                                   rtol=1e-14, err_msg=name)


def test_unported_model_id_raises(tmp_path):
    """Ids 202 (telluric VMR scale) and 1002 (per-location scales, with its
    locations file), which raised before item 9 was ported, parse as the
    JAX package parses them: the same entries, a priori and covariance
    (1002's exponential angular-distance correlation). An id neither
    package knows raises."""
    pdeck = load_deck(DECK, "cirstest")
    jdeck = jax_load_deck(DECK, "cirstest")
    (tmp_path / "locs.dat").write_text(
        "3 40.0\n10.0 20.0 1.0 0.1\n15.0 35.0 1.1 0.2\n-30.0 90.0 0.9 0.3\n")
    apr = tmp_path / "t.apr"
    apr.write_text("header\n3\n1 0 202\n1.05 0.1\n0 0 1002\nlocs.dat\n"
                   "11 0 1002\nlocs.dat\n")
    got = port_sv.read_apr(str(apr), pdeck.atmosphere)
    want = jax_sv.read_apr(str(apr), jdeck.atmosphere)
    assert [e.model_id for e in got.entries] == [202, 1002, 1002]
    for g, w in zip(got.entries, want.entries):
        assert (g.varident, g.ix, g.nx, g.target.value, g.target_idx,
                g.extra) == (w.varident, w.ix, w.nx, w.target.value,
                             w.target_idx, w.extra)
    for name in ("xa", "sa", "lx", "inum"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-10, atol=0, err_msg=name)
    # correlated within a block of locations, not across blocks
    assert got.sa[1, 2] != 0.0 and got.sa[1, 4] == 0.0
    apr.write_text("header\n1\n0 0 12345\n")
    with pytest.raises(NotImplementedError, match="model id 12345"):
        port_sv.read_apr(str(apr), pdeck.atmosphere)


def test_domain_dispatchers_pass_through(svs):
    _, _, pdeck, _, psv = svs
    x = torch.as_tensor(psv.xa)
    assert port_sv.apply_domain(psv, x, "surface", pdeck.surface) \
        is pdeck.surface
    assert not port_sv.ils_models_present(psv)
    assert port_sv.apply_ils_models(psv, x, 0, None) is None
    spec = torch.ones(4)
    assert port_sv.apply_spectrum_models(psv, x, 0, None, spec) is spec
