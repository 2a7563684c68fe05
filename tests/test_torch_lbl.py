"""Runtime line-by-line synthesis of the PyTorch port against the JAX package
and the reference goldens: the line data readers, the six lineshapes, the
cross-section's plain version (``ops.lbl.lbl_cross_section_plain``, which
the CPU runs) and its forward-mode derivative through the kernel wrapper's
``autograd.Function``. The CUDA kernel itself is held to the plain version
on the card only (``cuda`` marker; skipped here).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.io.linedata import read_ans_linedata as jax_read_ans
from archnemesis_tpu.io.linedata import read_lls_runtime as jax_read_lls
from archnemesis_tpu.ops import voigt as jax_voigt
from archnemesis_tpu.ops.lbl import build_blocks as jax_build_blocks
from archnemesis_tpu.ops.lbl import lbl_cross_section as jax_lbl
from archnemesis_tpu_torch import convert
from archnemesis_tpu_torch.io.linedata import (
    read_ans_linedata,
    read_lls_runtime,
)
from archnemesis_tpu_torch.ops import lbl_cuda
from archnemesis_tpu_torch.ops import voigt as port_voigt
from archnemesis_tpu_torch.ops.lbl import (
    build_blocks,
    lbl_cross_section,
    lbl_cross_section_plain,
)
from port_cases import (
    CO_LBL_GOLDEN,
    LINE_H5,
    LINEDATA_NPZ,
    LLS,
    lbl_voigt_grid,
    one_torch_thread,  # noqa: F401 (a fixture)
    write_linedata_export,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LINE_FIELDS = ("gas_id", "iso_id", "mol_name", "t_ref", "p_ref", "mass",
               "abundance", "nu", "sw", "elower", "stim_ref", "broad",
               "pf_temp", "pf_q")
BLOCK_FIELDS = ("block_width", "n_blocks", "max_lines_per_block", "line_idx",
                "line_mask", "wn_pad", "n_wave")
# float32 against float64: the JAX package's co_runtime_voigt bound
# (tests/test_f32_parity.py:23), max / median relative error
F32_BOUNDS = (5.0e-5, 2.0e-5)


def assert_same_fields(got, want, names):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


def flush_atol(dtype, alpha) -> float:
    """XLA on the CPU flushes subnormal results to zero: an intermediate
    below the smallest normal number (the Gaussian's exp far out) reads 0
    there and up to tiny / (sigma sqrt(2 pi)) after the profile's
    normalisation divides it here."""
    sigma = np.min(alpha) / np.sqrt(2.0 * np.log(2.0))
    return float(np.finfo(dtype).tiny / (sigma * np.sqrt(2.0 * np.pi)))


def rel_err(a, b):
    """|a - b| / max(|b|, 1e-3 max|b|) (tools/f32_parity.py)."""
    scale = np.abs(b).max()
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3 * scale)


@pytest.fixture(scope="module")
def lines():
    return read_ans_linedata(LINE_H5, gas_id=5, iso_id=1), \
        jax_read_ans(LINE_H5, gas_id=5, iso_id=1)


# --- line data

def test_line_list_equals_jax(lines):
    ll, jll = lines
    assert ll.n_lines > 1000 and np.all(np.diff(ll.nu) >= 0)
    assert_same_fields(ll, jll, LINE_FIELDS)


def test_npz_export_equals_h5(lines, tmp_path):
    """The committed export and a fresh one read back bit for bit as the
    HDF5 file does."""
    fresh = tmp_path / "export.npz"
    write_linedata_export(str(fresh))
    for path in (LINEDATA_NPZ, str(fresh)):
        assert_same_fields(read_ans_linedata(path, gas_id=5, iso_id=1),
                           lines[0], LINE_FIELDS)
    with np.load(LINEDATA_NPZ) as a, np.load(fresh) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_lls_runtime_and_windowed_equal_jax():
    rt, jrt = read_lls_runtime(LLS), jax_read_lls(LLS)
    for name in ("gas_id", "iso_id", "lineshape", "wn_calc_window",
                 "wn_approx_window", "s_floor", "include_pressure_shift",
                 "include_lines", "include_continuum", "pseudo_continuum",
                 "ilbl"):
        assert getattr(rt, name) == getattr(jrt, name), name
    np.testing.assert_array_equal(rt.wave, jrt.wave)
    np.testing.assert_array_equal(rt.del_g, jrt.del_g)
    assert_same_fields(rt.line_lists[0], jrt.line_lists[0], LINE_FIELDS)
    w, jw = rt.windowed(2120.0, 2180.0), jrt.windowed(2120.0, 2180.0)
    assert_same_fields(w.line_lists[0], jw.line_lists[0], LINE_FIELDS)
    blocks = w.blocks[0]
    assert_same_fields(blocks, jw.blocks[0], BLOCK_FIELDS)
    # each block's exact line range is its gather indices' run
    np.testing.assert_array_equal(blocks.counts, blocks.line_mask.sum(1))
    live = blocks.counts > 0
    np.testing.assert_array_equal(blocks.starts[live],
                                  blocks.line_idx[live, 0])
    # the JAX structure carried across equals the port's own
    carried = convert.runtime_lbl(jw)
    assert carried.lineshape == w.lineshape and carried.ilbl == w.ilbl
    assert_same_fields(carried.line_lists[0], w.line_lists[0], LINE_FIELDS)
    assert_same_fields(carried.blocks[0], blocks,
                       BLOCK_FIELDS + ("counts",))
    np.testing.assert_array_equal(carried.blocks[0].starts[live],
                                  blocks.starts[live])


# --- lineshapes

@pytest.fixture(scope="module")
def voigt_grid():
    return lbl_voigt_grid()


@pytest.mark.parametrize("shape", sorted(port_voigt.LINESHAPES))
def test_lineshape_f64_matches_jax(voigt_grid, shape):
    """rtol 1e-12 on |z| from 0 to 1e3; atol ``flush_atol``."""
    delta, alpha, gamma, _ = voigt_grid
    want = np.asarray(jax_voigt.LINESHAPES[shape](
        jnp.asarray(delta), jnp.asarray(alpha), jnp.asarray(gamma)))
    got = port_voigt.LINESHAPES[shape](
        *(torch.as_tensor(x) for x in (delta, alpha, gamma)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=flush_atol(np.float64, alpha))


@pytest.mark.parametrize("shape", sorted(port_voigt.LINESHAPES))
def test_lineshape_f32_matches_jax(voigt_grid, shape):
    """float32 against the JAX package's float32 (x64 off, as on the TPU):
    rtol 1e-6 outside 1 <= |z| <= 7. Inside it the float32 Weideman
    expansion is itself accurate to ~1e-5 only (it cancels towards a small
    Re w near the Doppler core's edge, x ~ 3, y << 1), and XLA's evaluation
    order differs from eager PyTorch's: there both packages are held to
    2e-5 of the float64 value instead. atol ``flush_atol``."""
    delta, alpha, gamma, z = voigt_grid
    args32 = [x.astype(np.float32) for x in (delta, alpha, gamma)]
    with jax.enable_x64(False):
        want = np.asarray(jax_voigt.LINESHAPES[shape](
            *(jnp.asarray(x) for x in args32)))
    fn = port_voigt.LINESHAPES[shape]
    got = fn(*(torch.as_tensor(x) for x in args32))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.numpy()
    tiny = flush_atol(np.float32, alpha)
    near = (z >= 1.0) & (z <= 7.0)
    np.testing.assert_allclose(got[~near], want[~near], rtol=1e-6, atol=tiny)
    ref = fn(*(torch.as_tensor(x.astype(np.float64)) for x in args32)).numpy()
    for vals in (got, want):
        np.testing.assert_allclose(vals[near], ref[near], rtol=2e-5,
                                   atol=tiny)


def test_far_wing_takes_the_continued_fraction(voigt_grid):
    """Where |z|^2 > 49 the float32 Re w(z) is the continued fraction's, bit
    for bit, and at |z| >= 100 the float32 Voigt agrees with float64 to
    1e-6 (the float32 Weideman expansion alone is off by up to ~18% at
    |z| ~ 1e3, JAX ops/voigt.py:67); float64 keeps the expansion."""
    delta, alpha, gamma, z = voigt_grid
    far = z >= 100.0
    d32, a32, g32 = (torch.as_tensor(x[far].astype(np.float32))
                     for x in (delta, alpha, gamma))
    scale = port_voigt.SQRT_LOG2 / a32
    x, y = d32 * scale, g32 * scale
    asym = x * x + y * y > port_voigt._ASYM_R2
    assert asym.all()
    w_re, _ = port_voigt.complex_err_fn_weideman24(x, y)
    cf_re, _ = port_voigt._cpf_continued_fraction(x, y)
    torch.testing.assert_close(w_re, cf_re, rtol=0, atol=0)
    v32 = port_voigt.voigt(d32, a32, g32).double()
    v64 = port_voigt.voigt(d32.double(), a32.double(), g32.double())
    np.testing.assert_allclose(v32.numpy(), v64.numpy(), rtol=1e-6)
    w64, _ = port_voigt.complex_err_fn_weideman24(x.double(), y.double())
    cf64, _ = port_voigt._cpf_continued_fraction(x.double(), y.double())
    assert not torch.equal(w64, cf64)


# --- the cross-section's plain version

@pytest.fixture(scope="module")
def golden_case(lines):
    d = np.load(CO_LBL_GOLDEN)
    return d, build_blocks(d["WAVE"], lines[0].nu)


def test_lbl_cross_section_matches_reference(lines, golden_case):
    """tests/test_lbl.py: the reference oracle at rtol 1e-12."""
    d, blocks = golden_case
    cases = d["CASES"]
    k = lbl_cross_section(lines[0], blocks, cases[:, 0], cases[:, 1],
                          cases[:, 2], device="cpu")
    assert k.shape == d["K"].shape and k.dtype == torch.float64
    np.testing.assert_allclose(k.numpy(), d["K"], rtol=1e-12, atol=0)


def test_block_width_invariance(lines, golden_case):
    d, _ = golden_case
    wave = d["WAVE"][:1000]
    ks = [lbl_cross_section(lines[0], build_blocks(wave, lines[0].nu,
                                                   block_width=w),
                            [200.0], [0.3], [0.9], device="cpu").numpy()
          for w in (128, 200)]
    np.testing.assert_allclose(ks[0], ks[1], rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def pallas_case(lines):
    """tests/test_lbl_pallas.py's grid and layers, iso_id 0 (the abundance
    factor)."""
    ll, jll = (dataclasses.replace(x, iso_id=0) for x in lines)
    wave = np.linspace(2050.0, 2250.0, 700)
    t = np.array([120.0, 200.0, 290.0])
    p = np.array([1.0e-3, 0.3, 1.2])
    amb = np.array([0.99, 0.9, 0.5])
    return ll, jll, build_blocks(wave, ll.nu), jax_build_blocks(wave, jll.nu), \
        (t, p, amb)


@pytest.mark.parametrize("shape", sorted(port_voigt.LINESHAPES))
def test_lbl_cross_section_matches_jax(pallas_case, shape):
    """float64, rtol 1e-10 (the JAX package's Pallas-vs-XLA bound): every
    lineshape, s_floor > 0, no pressure shift, the iso-0 factor; atol the
    smallest normal float64 (XLA flushes the Gaussian's subnormal far
    tail)."""
    ll, jll, blocks, jblocks, state = pallas_case
    kw = dict(lineshape=shape, s_floor=1.0e-22, include_pressure_shift=False)
    want = np.asarray(jax_lbl(jll, jblocks, *state, use_pallas=False, **kw))
    got = lbl_cross_section(ll, blocks, *state, device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=np.finfo(np.float64).tiny)


def test_f32_within_bound_of_f64(pallas_case):
    """The float32 synthesis (two-float delta, continued-fraction far wing)
    against float64 at the JAX package's own float32 bound."""
    ll, _, blocks, _, state = pallas_case
    k64 = lbl_cross_section(ll, blocks, *state, device="cpu").numpy()
    k32 = lbl_cross_section(ll, blocks,
                            *(x.astype(np.float32) for x in state),
                            device="cpu")
    assert k32.dtype == torch.float32
    r = rel_err(k32.double().numpy(), k64)
    assert r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]


# --- forward-mode derivative through the kernel wrapper

def test_jacfwd_through_the_wrapper(lines, pallas_case):
    """tests/test_lbl_pallas.py:42-58: jacfwd through the Function (CPU:
    plain primal, plain tangent) equals jacfwd of the plain version at rtol
    1e-10 and JAX's jacfwd at rtol 1e-8, with one primal synthesis for all
    tangents."""
    ll, jll = lines
    _, _, blocks, jblocks, _ = pallas_case
    p, amb = torch.tensor([0.3, 0.1]), torch.tensor([0.9, 0.8])
    t = torch.tensor([200.0, 180.0], dtype=torch.float64)
    p, amb = p.double(), amb.double()

    def wrapped(tv):
        return lbl_cuda.lbl_cross_section(ll, blocks, tv, p, amb).sum(dim=1)

    def plain(tv):
        return lbl_cross_section_plain(ll, blocks, tv, p, amb).sum(dim=1)

    calls = lbl_cuda.lbl_cross_section.calls
    j_wrapped = torch.func.jacfwd(wrapped)(t)
    assert lbl_cuda.lbl_cross_section.calls == calls + 1
    assert lbl_cuda.lbl_cross_section.launches == 0
    j_plain = torch.func.jacfwd(plain)(t)
    np.testing.assert_allclose(j_wrapped.numpy(), j_plain.numpy(),
                               rtol=1e-10, atol=0)
    j_jax = np.asarray(jax.jacfwd(lambda tv: jax_lbl(
        jll, jblocks, tv, p.numpy(), amb.numpy(),
        use_pallas=False).sum(axis=1))(jnp.asarray(t.numpy())))
    np.testing.assert_allclose(j_wrapped.numpy(), j_jax, rtol=1e-8,
                               atol=1e-8 * np.abs(j_jax).max())


def test_vmap_folds_a_batch_into_layers(lines, pallas_case):
    """Batched layer states go through one primal synthesis."""
    ll = lines[0]
    blocks = pallas_case[2]
    t = torch.tensor([[200.0, 250.0], [150.0, 180.0]], dtype=torch.float64)
    p = torch.tensor([0.3, 0.2], dtype=torch.float64)
    amb = torch.tensor([0.9, 0.8], dtype=torch.float64)
    calls = lbl_cuda.lbl_cross_section.calls
    k = torch.vmap(
        lambda tv: lbl_cuda.lbl_cross_section(ll, blocks, tv, p, amb))(t)
    assert lbl_cuda.lbl_cross_section.calls == calls + 1
    for i in range(2):
        np.testing.assert_allclose(
            k[i].numpy(),
            lbl_cross_section_plain(ll, blocks, t[i], p, amb).numpy(),
            rtol=1e-13, atol=0)


# --- the kernel, on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is built with nvcc "
                    "and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(cuda, pallas_case, dtype):
    """float64: rtol 1e-10 of the plain version; float32: the float32
    bound against the float64 plain version; one launch."""
    ll, _, blocks, _, state = pallas_case
    t, p, amb = (torch.as_tensor(x, device=cuda) for x in state)
    want = lbl_cross_section_plain(ll, blocks, t, p, amb)
    before = lbl_cuda.lbl_cross_section.launches
    got = lbl_cuda.lbl_cross_section(ll, blocks, t.to(dtype), p.to(dtype),
                                     amb.to(dtype))
    torch.cuda.synchronize()
    assert lbl_cuda.lbl_cross_section.launches == before + 1
    assert got.dtype == dtype and got.device.type == "cuda"
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-10, atol=0)
    else:
        r = rel_err(got.double().cpu().numpy(), want.cpu().numpy())
        assert r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]


def test_lls_archnemesis_path(tmp_path, monkeypatch):
    """``ARCHNEMESIS_PATH`` in a database path is replaced by that
    environment variable, as in the JAX package; unset, it raises."""
    with open(LLS) as f:
        text = f.read()
    linedata = os.path.abspath(os.path.dirname(LINE_H5))
    lls = tmp_path / "cirstest.lls"
    lls.write_text(text.replace("../linedata", "ARCHNEMESIS_PATH/linedata"))
    monkeypatch.setenv("ARCHNEMESIS_PATH", os.path.dirname(linedata))
    rt, jrt = read_lls_runtime(str(lls)), jax_read_lls(str(lls))
    assert_same_fields(rt.line_lists[0], jrt.line_lists[0], LINE_FIELDS)
    monkeypatch.delenv("ARCHNEMESIS_PATH")
    with pytest.raises(ValueError, match="ARCHNEMESIS_PATH"):
        read_lls_runtime(str(lls))
