"""The atmospheric profile models of the PyTorch port against the JAX
package and the reference goldens (``tests/goldens/models_apply.npz`` and
``models_exo_venus.npz``).

Every profile id the JAX package registers but 1002 (held to it in
``tests/test_torch_multiloc.py``): the .apr parse
(XA/SA/LX equal to the JAX reader's), ``apply_state`` (or the model's own
``apply`` where the golden comes from a direct call) on the jupiter_nadir
atmosphere against JAX at rtol 1e-10 and its JVP through the whole state at
rtol 1e-8 of the JVP's peak, and the golden at the JAX tests' tolerances
(``chip_smoke.model_golden_cases``, which the card runs too). The closed
forms of the two level recurrences (``_knee_profile`` and model 9) are held
to the JAX scans at rtol 1e-12, on the fixtures and on cases where the
floor of 1e-36 binds or the pressures are not monotonic, and their
operation count is shown not to grow with the number of levels."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from archnemesis_tpu.core.types import Atmosphere as JAtmosphere
from archnemesis_tpu.io.legacy import load_deck as jax_load_deck
from archnemesis_tpu.models import MODEL_REGISTRY as JAX_MODELS
from archnemesis_tpu.models import profile_models as jpm
from archnemesis_tpu.retrieval import statevector as jax_sv
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.models import MODEL_REGISTRY
from archnemesis_tpu_torch.models import profile_models as ppm
from archnemesis_tpu_torch.retrieval import statevector as port_sv
from port_cases import DECK, flat, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIX = chip_smoke.MODELS_FIXTURES
PROFILE = chip_smoke.PROFILE_CASES + ("m9_cloud", "m49_refgas")
DIRECT = {"m9_cloud": 9, "m49_refgas": 49}
EXO = ("m43_guillot", "m62_madhu", "m110_venus", "m111_venus")


@pytest.fixture(scope="module")
def atms():
    jatm = jax_load_deck(DECK, "cirstest").atmosphere
    return jatm, convert.atmosphere(flat(jatm), device="cpu")


def _profiles(atm):
    return {k: np.asarray(getattr(atm, k)) if not isinstance(
        getattr(atm, k), torch.Tensor) else getattr(atm, k).numpy()
        for k in ("t", "vmr", "dust", "h", "p")}


def _close(got, want, rtol, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=1e-300, err_msg=f"{what} {k}")


def _read_both(name, atms):
    jatm, patm = atms
    path = f"{FIX}/{name}/test.apr"
    return jax_sv.read_apr(path, jatm), port_sv.read_apr(path, patm)


@pytest.mark.parametrize("name", PROFILE)
def test_parse_matches_jax(name, atms):
    want, got = _read_both(name, atms)
    for field in ("xa", "sa", "lx", "inum", "iscale_mask"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    for g, w in zip(got.entries, want.entries):
        assert (g.varident, g.model_id, g.ix, g.nx, g.target.value,
                g.target_idx, g.extra) == (
            w.varident, w.model_id, w.ix, w.nx, w.target.value,
            w.target_idx, w.extra)


@pytest.mark.parametrize("name", PROFILE)
def test_golden(name):
    chip_smoke.model_golden_cases()[name]("cpu")


def _apply_pair(name, atms):
    """(JAX function, port function) of the unlogged-free state: the whole
    ``apply_state`` or, for the goldens of direct calls, the model's
    ``apply`` on the unlogged state."""
    jatm, patm = atms
    jsv, psv = _read_both(name, atms)
    if name in DIRECT:
        mid = DIRECT[name]
        lx = np.asarray(jsv.lx)

        def jf(x):
            return JAX_MODELS[mid].apply(
                jsv.entries[0], jatm, jnp.where(lx == 1, jnp.exp(x), x))

        def pf(x):
            return MODEL_REGISTRY[mid].apply(
                psv.entries[0], patm,
                torch.where(torch.as_tensor(lx == 1), torch.exp(x), x))
    else:
        def jf(x):
            return jax_sv.apply_state(jatm, x, jsv)

        def pf(x):
            return port_sv.apply_state(patm, x, psv)
    return jsv, jf, pf


@pytest.mark.parametrize("name", PROFILE)
def test_apply_matches_jax(name, atms):
    jsv, jf, pf = _apply_pair(name, atms)
    rng = np.random.default_rng(3)
    for x in (jsv.xa, jsv.xa + 0.05 * rng.standard_normal(jsv.nx)):
        _close(_profiles(pf(torch.as_tensor(x))),
               _profiles(jf(jnp.asarray(x))), 1e-10, name)


@pytest.mark.parametrize("name", PROFILE)
def test_apply_jvp_matches_jax(name, atms):
    """The tangent of every profile along a random direction of the whole
    state, within 1e-8 of its peak."""
    jsv, jf, pf = _apply_pair(name, atms)
    v = np.random.default_rng(5).standard_normal(jsv.nx)
    keys = ("t", "vmr", "dust", "h")
    _, tj = jax.jvp(lambda x: tuple(getattr(jf(x), k) for k in keys),
                    (jnp.asarray(jsv.xa),), (jnp.asarray(v),))
    _, tp = torch.func.jvp(lambda x: tuple(getattr(pf(x), k) for k in keys),
                           (torch.as_tensor(jsv.xa),), (torch.as_tensor(v),))
    for k, a, b in zip(keys, tp, tj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-8 * np.abs(b).max() + 1e-300,
                                   err_msg=k)


def _exo_pair(name, atms):
    """(JAX atmosphere, port atmosphere, entry of each, state) of the
    exoplanet and Venus cases of tests/test_models_exo_venus.py."""
    jatm, patm = atms
    if name == "m43_guillot":
        text = ("0.3 0.05\n0.8 0.1\n1.0e-3 2e-4\n0.2 0.05\n2.0 0.4\n"
                "5700.0 6.96e8 7.78e11 150.0\n")
        ctx = dict(npro=jatm.np_, gas_id=jatm.gas_id, iso_id=jatm.iso_id,
                   ndust=jatm.ndust)
        je = JAX_MODELS[43].from_apr(io.StringIO(text), [0, 0, 43], 0,
                                     ctx).entry
        pe = MODEL_REGISTRY[43].from_apr(io.StringIO(text), [0, 0, 43], 0,
                                         ctx).entry
        return jatm, patm, je, pe, np.array([0.3, 0.8, 1.0e-3, 0.2, 2.0])
    if name == "m62_madhu":
        jsv, psv = _read_both(name, atms)
        x = np.where(jsv.lx == 1, np.exp(jsv.xa), jsv.xa)
        return jatm, patm, jsv.entries[0], psv.entries[0], x
    venus = chip_smoke.venus_atmosphere("cpu")
    jvenus = JAtmosphere(
        **{k: getattr(venus, k).numpy() for k in (
            "h", "p", "t", "vmr", "dust", "parah2", "molwt", "radius",
            "latitude")},
        gas_id=(2, 9), iso_id=(0, 0), planet=2)
    from archnemesis_tpu.models.base import ModelEntry as JEntry
    from archnemesis_tpu.models.base import ProfileTarget as JTarget
    from archnemesis_tpu_torch.models.base import ModelEntry, ProfileTarget

    mid = int(name[1:4])
    kw = dict(varident=(-1, 0, mid), model_id=mid, ix=0,
              nx=1 if mid == 110 else 3, target_idx=0,
              extra=() if mid == 110 else (1,))
    x = np.array([2.5] if mid == 110 else [-1.5, 1.0e-4, 5.0e-6])
    return (jvenus, venus, JEntry(target=JTarget.AEROSOL, **kw),
            ModelEntry(target=ProfileTarget.AEROSOL, **kw), x)


@pytest.mark.parametrize("name", EXO)
def test_exo_and_venus_models_match_jax(name, atms):
    jatm, patm, je, pe, x = _exo_pair(name, atms)
    mid = pe.model_id
    want = JAX_MODELS[mid].apply(je, jatm, jnp.asarray(x))
    got = MODEL_REGISTRY[mid].apply(pe, patm, torch.as_tensor(x))
    _close(_profiles(got), _profiles(want), 1e-10, name)
    v = np.linspace(0.5, 1.5, x.size) * x
    _, tj = jax.jvp(lambda z: (JAX_MODELS[mid].apply(je, jatm, z).t,
                               JAX_MODELS[mid].apply(je, jatm, z).dust),
                    (jnp.asarray(x),), (jnp.asarray(v),))
    _, tp = torch.func.jvp(
        lambda z: (MODEL_REGISTRY[mid].apply(pe, patm, z).t,
                   MODEL_REGISTRY[mid].apply(pe, patm, z).dust),
        (torch.as_tensor(x),), (torch.as_tensor(v),))
    for a, b in zip(tp, tj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-8 * np.abs(b).max() + 1e-300)
    chip_smoke.model_golden_cases()[name]("cpu")


# --- the closed forms of the two level recurrences against the JAX scans

KNEE_CASES = {
    # (abu_deep, fsh, pknee [atm]): the fixtures' a priori of 1, 4 and 20
    "m1_knee": (1.9e-4, 0.3, 0.5),
    "m4_kneevar": (1.8e-4, 0.35, 0.6),
    # a steep decay whose floor of 1e-36 binds over the upper levels
    "floor": (2.0e-3, 0.02, 2.0),
    # the knee above the top level: every level takes abu_deep
    "all_deep": (1.0e-4, 0.3, 1.0e-12),
    # the knee below the bottom level: no level below it, prev = 0, the
    # floor from the first level up
    "all_above": (1.0e-4, 0.3, 1.0e6),
    # fsh > 1: the profile grows upward from the knee
    "growth": (1.0e-6, 1.6, 0.3),
}


def _unsorted(jatm, patm):
    """The atmosphere with two levels' pressures swapped across the knee
    of the "unsorted" case: a level below the knee after some above it."""
    p = np.asarray(jatm.p).copy()
    p[40], p[44] = p[44], p[40]
    return (jatm.replace(p=p),
            patm.replace(p=torch.as_tensor(p)))


@pytest.mark.parametrize("case", list(KNEE_CASES) + ["unsorted"])
def test_knee_closed_form_matches_jax_scan(case, atms):
    jatm, patm = atms
    if case == "unsorted":
        jatm, patm = _unsorted(jatm, patm)
        abu, fsh, pknee = 1.9e-4, 0.1, float(np.asarray(jatm.p)[42]) / 101325
    else:
        abu, fsh, pknee = KNEE_CASES[case]
    x = np.array([abu, fsh, pknee])
    want = np.asarray(jpm._knee_profile(jatm, *jnp.asarray(x)))
    got = ppm._knee_profile(patm, *torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    if case == "floor":
        assert np.sum(want == 1.0e-36) > 10
    # and its tangent in all three parameters
    v = np.array([0.3 * abu, 0.1 * fsh, 0.2 * pknee])
    _, tj = jax.jvp(lambda z: jpm._knee_profile(jatm, z[0], z[1], z[2]),
                    (jnp.asarray(x),), (jnp.asarray(v),))
    _, tp = torch.func.jvp(
        lambda z: ppm._knee_profile(patm, z[0], z[1], z[2]),
        (torch.as_tensor(x),), (torch.as_tensor(v),))
    tj = np.asarray(tj)
    np.testing.assert_allclose(tp.numpy(), tj, rtol=1e-10,
                               atol=1e-10 * np.abs(tj).max() + 1e-300)


@pytest.mark.parametrize("case", list(KNEE_CASES) + ["unsorted"])
def test_knee_level_loop_matches_closed_form(case, atms):
    """``chip_smoke.knee_profile_loop``, the level loop whose operations
    the card counts beside the closed form, gives the closed form's
    profile."""
    jatm, patm = atms
    if case == "unsorted":
        jatm, patm = _unsorted(jatm, patm)
        x = torch.tensor([1.9e-4, 0.1, float(patm.p[42]) / 101325],
                         dtype=torch.float64)
    else:
        x = torch.tensor(KNEE_CASES[case], dtype=torch.float64)
    torch.testing.assert_close(chip_smoke.knee_profile_loop(patm, *x),
                               ppm._knee_profile(patm, *x), rtol=1e-12,
                               atol=0)


MODEL9_CASES = {
    # (tau, fsh, base [km]): the fixture's a priori (base below the grid)
    "fixture": (4.0, 0.25, -20.0),
    "mid_base": (2.0, 0.4, 30.0),
    "thin": (0.5, 0.05, 10.0),
}


@pytest.mark.parametrize("case", list(MODEL9_CASES) + ["broken"])
def test_model9_closed_form_matches_jax_scan(case, atms):
    jatm, patm = atms
    if case == "broken":
        # a level below the base after the first above it: the run stops
        h = np.asarray(jatm.h).copy()
        h[45] = h[20]
        jatm, patm = jatm.replace(h=h), patm.replace(h=torch.as_tensor(h))
        x = np.array([2.0, 0.4, float(h[30]) / 1e3 + 1.0])
    else:
        x = np.array(MODEL9_CASES[case])
    jsv, psv = _read_both("m9_cloud", atms)
    want = np.asarray(JAX_MODELS[9].apply(jsv.entries[0], jatm,
                                          jnp.asarray(x)).dust)
    got = MODEL_REGISTRY[9].apply(psv.entries[0], patm,
                                  torch.as_tensor(x)).dust.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # the level loop of chip_smoke gives the same cloud
    loop = chip_smoke.model9_loop(patm, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(loop, got[:, 0], rtol=1e-12, atol=0)


class _CountOps(TorchDispatchMode):
    """Counts the tensor operations dispatched inside the mode."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(fn) -> int:
    with _CountOps() as c:
        fn()
    return c.n


def _cut(patm, n):
    return patm.replace(h=patm.h[:n], p=patm.p[:n], t=patm.t[:n],
                        vmr=patm.vmr[:n], dust=patm.dust[:n],
                        parah2=patm.parah2[:n], molwt=patm.molwt[:n])


def test_recurrences_make_no_per_level_operations(atms):
    """The knee profile and model 9 dispatch as many operations on 81
    levels as on 41 (both odd: the Simpson rule of model 9 branches on the
    parity): neither loops over the levels."""
    _, patm = atms
    _, psv = _read_both("m9_cloud", atms)
    x = torch.tensor([1.9e-4, 0.3, 0.5], dtype=torch.float64)
    x9 = torch.tensor([4.0, 0.25, -20.0], dtype=torch.float64)
    counts = {}
    for n in (81, 41):
        atm = _cut(patm, n)
        counts[n] = (
            _ops(lambda: ppm._knee_profile(atm, x[0], x[1], x[2])),
            _ops(lambda: MODEL_REGISTRY[9].apply(psv.entries[0], atm, x9)))
    assert counts[81] == counts[41], counts


def test_registry_holds_all_but_two_ids():
    """Every id of the JAX package, 202 and 1002 included since item 9."""
    assert set(MODEL_REGISTRY) == set(JAX_MODELS)
    assert len(MODEL_REGISTRY) == 37
    for mid, cls in MODEL_REGISTRY.items():
        assert cls.id == mid
        domain = getattr(cls, "domain", "atmosphere")
        hook = "apply" if domain == "atmosphere" else f"apply_{domain}"
        assert callable(getattr(cls, hook)), (mid, hook)
        assert getattr(JAX_MODELS[mid], "domain", "atmosphere") == domain
