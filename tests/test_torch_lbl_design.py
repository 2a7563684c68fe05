"""The line-by-line kernel's design (``csrc/lbl_cross_section.cu``) held on
the CPU where it can be: the float32 continued fraction in the ratio form
the kernel evaluates, against the JAX package's float64 Weideman-24 value;
the host's copy of the pair pass's (block, line) class rule
(``chip_smoke.block_line_classes``) against a test of every (line, wave)
pair; the plain float32 version against float64 in the pressure-shift
case; a runtime deck's packing of the kernel's static inputs once per
(gas, dtype, device). The kernel itself is held to the plain version on
the card (``cuda`` marker; skipped here): at block widths 1, 200 and 512,
in the pressure-shift case, two launches bit for bit, and the packed entry
against the unsharded one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from archnemesis_tpu.ops import voigt as jax_voigt
from archnemesis_tpu_torch.io.linedata import read_ans_linedata
from archnemesis_tpu_torch.ops import lbl_cuda
from archnemesis_tpu_torch.ops import voigt as port_voigt
from archnemesis_tpu_torch.ops.lbl import (
    build_blocks,
    layer_line_params,
    lbl_cross_section_plain,
    two_float,
)
from archnemesis_tpu_torch.ops.voigt import LINESHAPES
from chip_smoke import (
    SHIFT_CASE_STATE,
    block_line_classes,
    class_changes,
    rel_err,
    shifted_lines,
)
from port_cases import (
    CO_LBL_GOLDEN,
    CO_RUNTIME,
    LINEDATA_NPZ,
    one_torch_thread,  # noqa: F401 (a fixture)
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# float32 against float64: max / median relative error, the phase-7 bound
# of chip_smoke.py (LBL_F32_BOUNDS)
F32_BOUNDS = (5.0e-5, 2.0e-5)


def far_z(y_lo: float, y_hi: float, n: int = 50_000, seed: int = 0):
    """float64 (x, y) with |z|^2 > 49: x log-uniform from 1e-2 to 1e4 and a
    dense run of x from 0 to 8 (where |z| crosses 7), y log-uniform in
    [y_lo, y_hi]."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([10.0 ** rng.uniform(-2.0, 4.0, n),
                        np.linspace(0.0, 8.0, n // 10)])
    y = 10.0 ** rng.uniform(np.log10(y_lo), np.log10(y_hi), x.size)
    far = x * x + y * y > port_voigt._ASYM_R2
    return x[far], y[far]


def test_cf_ratio_is_the_nested_fraction():
    """In float64 the ratio form equals the nested continued fraction of
    the plain version to rounding: the same 6th convergent."""
    x, y = (torch.as_tensor(v) for v in far_z(1e-4, 1e3))
    nested, _ = port_voigt._cpf_continued_fraction(x, y)
    torch.testing.assert_close(port_voigt.cf_ratio_re(x, y), nested,
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("y_range", [(1e-4, 1e-2), (1e-2, 1.0), (1.0, 1e3)])
def test_cf_ratio_f32_within_bound_of_weideman_f64(y_range):
    """The kernel's float32 ratio form against the JAX package's float64
    Weideman-24 Re w over |z|^2 > 49, x up to 1e4: within the phase-7
    float32 bound (the 6th convergent itself is off by up to ~2.6e-5 near
    |z| = 7 with y << 1)."""
    x, y = far_z(*y_range)
    want, _ = jax_voigt.complex_err_fn_weideman24(jnp.asarray(x),
                                                  jnp.asarray(y))
    want = np.asarray(want)
    assert want.dtype == np.float64
    got = port_voigt.cf_ratio_re(
        *(torch.as_tensor(v, dtype=torch.float32) for v in (x, y)))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    r = np.abs(got.double().numpy() - want) / want
    assert r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]


# --- the pair pass's (block, line) classes (the host's copy of the rule)

def pair_deltas(spec, t, p, amb):
    """(NLAY, NB, M, W) delta of every (block line, wave) pair in the
    kernel's arithmetic and ``t``'s type, and the (NLAY, NB, M) weighted
    strengths."""
    ll, blocks = spec.ll, spec.blocks
    s, _, _, shift = layer_line_params(ll, t, p, amb)
    idx = torch.as_tensor(blocks.line_idx, dtype=torch.long)
    nb, w = blocks.n_blocks, blocks.block_width
    sh = shift[:, idx][..., None]
    if t.dtype == torch.float32:
        nu_hi, nu_lo = (torch.as_tensor(x)[idx][None, :, :, None]
                        for x in two_float(ll.nu))
        wn_hi, wn_lo = (torch.as_tensor(x).reshape(1, nb, 1, w)
                        for x in two_float(blocks.wn_pad))
        d = ((wn_hi - nu_hi) + (wn_lo - nu_lo)) - sh
    else:
        wn = torch.as_tensor(blocks.wn_pad).reshape(1, nb, 1, w)
        d = wn - (torch.as_tensor(ll.nu)[idx][None, :, :, None] + sh)
    return d, s[:, idx]


def edge_lines(ll, wave, width, windows=(25.0, 75.0)):
    """The line list re-centred so that the core and window edges of some
    lines fall on a block's first or last wave, and a few float32 ulps
    either side (the strongest line's other parameters for every line)."""
    eps = np.array([-3e-4, -2e-5, -2e-6, 0.0, 2e-6, 2e-5, 3e-4])
    firsts = wave[width:-width:width]
    ends = np.concatenate([firsts, firsts + (width - 1) * (wave[1] - wave[0])])
    edges = np.concatenate([ends - o for o in windows]
                           + [ends + o for o in windows])
    nu = np.sort((edges[:, None] + eps[None, :]).reshape(-1))
    n, i = nu.size, int(np.argmax(ll.sw))
    return dataclasses.replace(
        ll, nu=nu, sw=np.full(n, ll.sw[i]), elower=np.full(n, ll.elower[i]),
        stim_ref=np.full(n, ll.stim_ref[i]),
        broad=np.repeat(ll.broad[:, i:i + 1], n, axis=1))


@pytest.fixture(scope="module")
def co_lines():
    """The CO list from its ``.npz`` export (equal to the HDF5 file bit for
    bit, ``test_torch_lbl.py``), so that the card's tests need no h5py."""
    return read_ans_linedata(LINEDATA_NPZ, gas_id=5, iso_id=1)


CLASS_CASES = {
    # lines whose window edges sit on a block's end waves, no shift
    "edges": lambda ll: (
        edge_lines(ll, 2100.0 + 0.001 * np.arange(4096), 128),
        2100.0 + 0.001 * np.arange(4096), 128,
        ((200.0, 0.5, 0.0), (250.0, 1.0, 0.0))),
    # co_lbl's grid and lines with the shift case of chip_smoke phase 7
    "shift": lambda ll: (
        shifted_lines(ll), np.load(CO_LBL_GOLDEN)["WAVE"][:3000], 128,
        SHIFT_CASE_STATE),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CLASS_CASES))
def test_line_classes_match_every_pair(co_lines, case, dtype):
    """Each (block, line) class from the block's end waves says what the
    per-pair tests say for every wave of the block: skip -> outside the
    window, core -> inside wn_calc, wing -> between wn_calc and
    wn_approx; and every class occurs."""
    ll, wave, width, state = CLASS_CASES[case](co_lines)
    blocks = build_blocks(wave, ll.nu, block_width=width)
    spec = lbl_cuda.make_spec(ll, blocks)
    t, p, amb = (torch.tensor(v, dtype=dtype) for v in zip(*state))
    cls = block_line_classes(spec, t, p, amb)
    d, s = pair_deltas(spec, t, p, amb)
    wc, wa = spec.wn_calc_window, spec.wn_approx_window
    inside = (d >= -wa) & (d < wa)
    core = inside & (d >= -wc) & (d < wc)
    live = (s > 0) & torch.as_tensor(blocks.line_mask > 0)
    assert cls.shape == s.shape
    assert torch.equal(cls[~live], torch.full_like(cls[~live],
                                                   chip_smoke.SKIP))
    for name, pairs in (("SKIP", ~inside), ("CORE", core),
                        ("WING", inside & ~core)):
        sel = (cls == getattr(chip_smoke, name)) & live
        assert sel.any(), name
        assert pairs[sel].all(), name
    assert ((cls == chip_smoke.STRADDLE) & live).any()
    if case == "shift":
        counts, changed = class_changes(spec, t, p, amb)
        assert changed > 0 and counts.sum() == cls.numel()


# --- float32 in the pressure-shift case

@pytest.mark.parametrize("lineshape", LINESHAPES)
def test_shift_case_plain_float32_against_float64(co_lines, lineshape):
    """The plain float32 version against float64 in the shift case of
    phase 7 (co_lbl's grid): within the float32 bound for every lineshape
    but the Gaussian, whose far core reads ~1.7e-4 relative, since the
    ~1.7 cm-1 shift is itself off by ~1e-7 cm-1 in float32. Phase 7 holds
    the float32 kernel to the plain float32 version there, and against
    float64 to no more than this error plus the bound."""
    ll = shifted_lines(co_lines)
    blocks = build_blocks(np.load(CO_LBL_GOLDEN)["WAVE"], ll.nu)
    t, p, amb = (torch.tensor(v, dtype=torch.float64)
                 for v in zip(*SHIFT_CASE_STATE))
    k64 = lbl_cross_section_plain(ll, blocks, t, p, amb, lineshape=lineshape)
    k32 = lbl_cross_section_plain(ll, blocks, t.float(), p.float(),
                                  amb.float(), lineshape=lineshape)
    r = rel_err(k32.double().numpy(), k64.numpy())
    assert np.median(r) < F32_BOUNDS[1]
    if lineshape == "gaussian":
        assert 1.5e-4 < r.max() < 2.0e-4
    else:
        assert r.max() < F32_BOUNDS[0]


# --- packing once

def test_static_inputs_packed_once_per_lines_and_blocks():
    """A launch keeps its static kernel inputs in the dict a windowed
    runtime deck hands it per gas: packed at the first call for a (dtype,
    device), the same tensors after; another type packs anew, a newly
    windowed copy starts empty, and a spec without a dict packs every
    time."""
    from archnemesis_tpu_torch.io.legacy import load_deck

    rt = load_deck(CO_RUNTIME, "cirstest").ktables.windowed(2120.0, 2180.0)
    cpu = torch.device("cpu")
    spec = lbl_cuda.make_spec(rt.line_lists[0], rt.blocks[0],
                              packed=rt.packed_inputs(0))
    before = lbl_cuda.kernel_inputs.calls
    first = lbl_cuda.static_inputs(spec, torch.float32, cpu)
    assert lbl_cuda.static_inputs(spec, torch.float32, "cpu") is first
    assert rt.packed_inputs(0) == {(torch.float32, cpu): first}
    assert lbl_cuda.kernel_inputs.calls == before + 1
    assert first["cols"].dtype == torch.float32 and first["twofloat"]
    want = lbl_cuda.kernel_inputs(dataclasses.replace(spec, packed=None),
                                  torch.float32, cpu)
    for key in ("cols", "wn", "ranges"):
        assert torch.equal(first[key], want[key]), key
    assert lbl_cuda.static_inputs(spec, torch.float64, cpu) is not first
    assert lbl_cuda.kernel_inputs.calls == before + 3
    assert len(rt.packed_inputs(0)) == 2
    assert not rt.windowed(2120.0, 2180.0).packed
    bare = dataclasses.replace(spec, packed=None)
    assert (lbl_cuda.static_inputs(bare, torch.float32, cpu)
            is not lbl_cuda.static_inputs(bare, torch.float32, cpu))
    shard = dataclasses.replace(spec, sharded=True)
    with pytest.raises(ValueError, match="shard's inputs were packed"):
        lbl_cuda.static_inputs(shard, torch.float32, torch.device("meta"))


# --- the kernel, on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is built with nvcc "
                    "and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 200, 512])
@pytest.mark.parametrize("shift", [False, True])
def test_kernel_matches_plain_at_widths(cuda, co_lines, width, shift):
    """float64 within rtol 1e-10 of the plain version, float32 within the
    float32 bound of the plain float32 version (in the shift case float32
    itself moves a narrow Gaussian's far core by ~1.7e-4 against float64,
    in both versions alike), at block widths that are not multiples of the
    waves per thread, with and without the shift case."""
    ll = shifted_lines(co_lines) if shift else co_lines
    wave = np.load(CO_LBL_GOLDEN)["WAVE"][:3000]
    blocks = build_blocks(wave, ll.nu, block_width=width)
    t, p, amb = (torch.tensor(v, dtype=torch.float64, device=cuda)
                 for v in zip(*SHIFT_CASE_STATE))
    want = lbl_cross_section_plain(ll, blocks, t, p, amb)
    got = lbl_cuda.lbl_cross_section(ll, blocks, t, p, amb)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0)
    t32, p32, amb32 = t.float(), p.float(), amb.float()
    k32 = lbl_cuda.lbl_cross_section(ll, blocks, t32, p32, amb32)
    want32 = lbl_cross_section_plain(ll, blocks, t32, p32, amb32)
    r = rel_err(k32.double().cpu().numpy(), want32.double().cpu().numpy())
    assert r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]


@pytest.mark.cuda
def test_two_launches_equal_bits_and_packed_equals_unsharded(cuda, co_lines):
    """Two float32 launches on inputs packed once give the same bits, and
    the unsharded entry without packed inputs and the packed (wave-shard)
    entry give them too."""
    wave = np.load(CO_LBL_GOLDEN)["WAVE"]
    blocks = build_blocks(wave, co_lines.nu)
    t, p, amb = (torch.tensor(v, dtype=torch.float32, device=cuda)
                 for v in zip(*SHIFT_CASE_STATE))
    kept = {}
    before = lbl_cuda.kernel_inputs.calls
    a, b = (lbl_cuda.lbl_cross_section(co_lines, blocks, t, p, amb,
                                       packed=kept) for _ in range(2))
    assert lbl_cuda.kernel_inputs.calls == before + 1
    assert torch.equal(a, b)
    assert torch.equal(lbl_cuda.lbl_cross_section(co_lines, blocks, t, p,
                                                  amb), a)
    spec = lbl_cuda.make_spec(co_lines, blocks)
    packed = dataclasses.replace(spec, packed=kept)
    launches = lbl_cuda.lbl_kernel_packed.launches
    assert torch.equal(lbl_cuda.lbl_kernel_packed(packed, t, p, amb), a)
    assert lbl_cuda.lbl_kernel_packed.launches == launches + 1
