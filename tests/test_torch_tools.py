"""The port's counterparts of the JAX package's measurement tools against the
tools themselves: the float32 FMA-peak probe (``tools/bench_vpu_peak.py``)
and the combine's A/B variants (``tools/bench_overlap_variants.py``), whose
Pallas kernels run here in interpret mode. The CUDA kernels are held
against the plain versions on the card only (``cuda`` marker; skipped
here)."""

import importlib.util
import pathlib
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke

from archnemesis_tpu_torch.ops import fma_peak
from archnemesis_tpu_torch.ops import overlap_variants as ov
from archnemesis_tpu_torch.ops.overlap_cuda import combine_pair
from port_cases import gauss_del_g, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _tool(name):
    """A module of ``tools/`` imported by path."""
    spec = importlib.util.spec_from_file_location(f"_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def vpu_tool():
    return _tool("bench_vpu_peak")


@pytest.fixture(scope="module")
def variants_tool():
    return _tool("bench_overlap_variants")


# --- kernel 4: the FMA-peak probe

def _fma_exact(a, b, c) -> np.float32:
    """float32 a * b + c rounded once to nearest, ties to even, from the
    exact rational value."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    guess = np.float32(float(exact))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]
    dist = [abs(Fraction(float(x)) - exact) for x in cands]
    best = min(dist)
    ties = [x for x, d in zip(cands, dist) if d == best]
    if len(ties) > 1:
        ties = [x for x in ties
                if not np.frombuffer(x.tobytes(), np.uint32)[0] & 1]
    return ties[0]


def test_fma32_rounds_once():
    """``fma32`` is the correctly rounded float32 multiply-add (the card's
    FFMA) on random operands of mixed scales, where a float64 sum rounded
    again to float32 would sometimes differ."""
    rng = np.random.default_rng(0)
    n = 400

    def draw(lo, scale):
        x = rng.uniform(lo, 2.0, n) * 2.0 ** rng.integers(-scale, scale, n)
        return x.astype(np.float32)

    a, b, c = draw(0.5, 30), draw(0.5, 30), draw(-2.0, 60)
    # exact halfway products: a * b lands on a float32 midpoint, c nudges it
    a[:4] = np.float32(1.0 + 2.0**-12)
    b[:4] = np.float32(1.0 + 2.0**-12)
    c[:4] = np.float32([0.0, 2.0**-60, -(2.0**-60), 2.0**-40])
    got = fma_peak.fma32(torch.as_tensor(a), torch.as_tensor(b),
                         torch.as_tensor(c)).numpy()
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)


def test_fma_chain_plain_matches_jax_tool(vpu_tool):
    """Bit for bit against the TPU kernel on one (256, 512) tile in
    interpret mode: XLA contracts its ``y * c + x`` into a fused
    multiply-add, as the plain version and the card do."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0.5, 2.0, (vpu_tool.ROWS, vpu_tool.COLS))
    x = x.astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(vpu_tool.run(jnp.asarray(x)))
    got = fma_peak.fma_chain_plain(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 2 * vpu_tool.NITER == fma_peak.FLOPS_PER_ELEMENT


def test_fma_chain_never_falls_back():
    x = torch.ones(8)
    fma_peak.fma_chain.launches = 0
    with pytest.raises(ValueError, match="CUDA card"):
        fma_peak.fma_chain(x)
    with pytest.raises(TypeError):
        fma_peak.fma_chain_plain(x.double())
    assert fma_peak.fma_chain.launches == 0


# --- kernel 3: the combine's A/B variants

def _variant_inputs(rows, ng, seed):
    """(rows, NG) float32 rows sorted along g, log-normal as the tool makes
    them, with all-zero rows, zero rows in one input only, and a tied row
    (values rounded to one decimal)."""
    rng = np.random.default_rng(seed)
    a, b = (np.sort(np.exp(rng.normal(-2, 2, (rows, ng))), axis=1)
            for _ in range(2))
    a[:3] = 0.0
    b[2:5] = 0.0
    a[5], b[5] = np.round(a[5], 1), np.round(b[5], 1)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("mode", ov.MODES)
@pytest.mark.parametrize("ng", [4, 20])
def test_combine_lean_plain_matches_jax_tool(variants_tool, mode, ng):
    """``sortonly`` and ``rollonly`` bit for bit; ``full`` and ``edges``
    within rtol 2e-5 (the JAX package's float32 Pallas-vs-XLA bound, and
    ``chip_smoke.py``'s for the combine) plus 1e-6 of the row's peak: the
    plain version sums in another order (a stable sort, a serial cumsum,
    tensor reductions) than the bitonic network and its lane scan."""
    del_g = gauss_del_g(ng)
    key = tuple(float(v) for v in del_g)
    a, b = _variant_inputs(16, ng, seed=ng)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(variants_tool.combine_lean(
            jnp.asarray(a), jnp.asarray(b), key, mode, 8))
    got = ov.combine_lean(torch.as_tensor(a), torch.as_tensor(b), del_g,
                          mode).numpy()
    assert got.shape == want.shape == (16, ng)
    if mode in ("sortonly", "rollonly"):
        np.testing.assert_array_equal(got, want)
    else:
        peak = np.abs(want).max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want)
                      <= 2e-5 * np.abs(want) + 1e-6 * peak)


def test_rollonly_shift_is_the_network_stride_sum():
    """The rotation of ``rollonly``: the 45 stage strides of the 512-element
    network sum to 1013 = 501 mod 512 at NG = 20; 26 = 10 mod 16 at
    NG = 4."""
    assert (ov.ref_pad(20), ov.roll_shift(20)) == (512, 501)
    assert (ov.ref_pad(4), ov.roll_shift(4)) == (16, 10)
    assert (ov.ref_pad(1), ov.roll_shift(1)) == (1, 0)
    assert ov.ref_pad(32) == 1024


def test_combine_lean_wrapper_on_cpu():
    """A CPU tensor runs the plain version and launches nothing; float64
    and an unknown mode raise."""
    del_g = gauss_del_g(6)
    a, b = (torch.as_tensor(x) for x in _variant_inputs(9, 6, seed=3))
    before = dict(ov.combine_lean.launches)
    for mode in ov.MODES:
        torch.testing.assert_close(ov.combine_lean(a, b, del_g, mode),
                                   ov.combine_lean_plain(a, b, del_g, mode),
                                   rtol=0, atol=0)
    assert ov.combine_lean.launches == before
    with pytest.raises(TypeError, match="float32"):
        ov.combine_lean(a.double(), b.double(), del_g)
    with pytest.raises(ValueError, match="mode"):
        ov.combine_lean_plain(a, b, del_g, "bogus")


# --- the kernels, on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is built with nvcc "
                    "and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fma_kernel_matches_plain_on_card(cuda):
    """Bit for bit, with a ragged tail of 3 elements; one launch."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.uniform(0.5, 2.0, 4096 * 4 + 3),
                        dtype=torch.float32, device=cuda)
    before = fma_peak.fma_chain.launches
    got = fma_peak.fma_chain(x)
    torch.cuda.synchronize()
    assert fma_peak.fma_chain.launches == before + 1
    torch.testing.assert_close(got, fma_peak.fma_chain_plain(x), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ov.MODES)
@pytest.mark.parametrize("ng", [4, 20, 32])
def test_variant_kernel_matches_plain_on_card(cuda, mode, ng):
    """``sortonly``/``rollonly`` bit for bit; ``full``/``edges`` within
    ``chip_smoke.variant_f32_tol`` of each row's peak of the float64 plain
    version, and within three times it of the float32 plain version (whose
    serial cumsum is the less accurate); ``full`` bit for bit at every row
    tile and equal to the combine kernel (``combine_pair``, whose row code
    it runs) bit for bit."""
    del_g = gauss_del_g(ng)
    a, b = (torch.as_tensor(x, device=cuda)
            for x in _variant_inputs(4096, ng, seed=ng))
    got = ov.combine_lean(a, b, del_g, mode)
    want = ov.combine_lean_plain(a, b, del_g, mode)
    torch.cuda.synchronize()
    if mode in ("sortonly", "rollonly"):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        ref = ov.combine_lean_plain(a.double(), b.double(), del_g, mode)
        peak = ref.abs().max(dim=1, keepdim=True).values.clamp_min(1e-300)
        tol = chip_smoke.variant_f32_tol(del_g, mode)
        assert ((got.double() - ref).abs() / peak).max().item() <= tol
        assert ((got - want).double().abs() / peak).max().item() <= 3 * tol
    if mode == "full":
        for tile in ov.ROW_TILES[:-1]:
            torch.testing.assert_close(
                ov.combine_lean(a, b, del_g, mode, tile), got, rtol=0, atol=0)
        torch.testing.assert_close(combine_pair(a, b, del_g), got, rtol=0,
                                   atol=0)
