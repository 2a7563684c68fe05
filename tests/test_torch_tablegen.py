"""Table generation of the PyTorch port (``ops/tablegen.py``,
``io/ktables.py:write_kta``/``write_lta``) against the JAX package and the
reference's tables ``tests/fixtures/tablegen/co_ref.{lta,kta}``.

On the CPU the synthesis runs kernel 2's plain version; the kernel itself
at the table-generation shape (the 200 (P, T) pairs of the production grid
as its layers) is held to the plain version on the card only (``cuda``
marker; skipped here).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from archnemesis_tpu.io import ktables as jax_ktables
from archnemesis_tpu.io.linedata import read_ans_linedata as jax_read_ans
from archnemesis_tpu.ops import tablegen as jax_tablegen
from archnemesis_tpu_torch.io import ktables
from archnemesis_tpu_torch.io.linedata import read_ans_linedata
from archnemesis_tpu_torch.ops import lbl_cuda, tablegen
from archnemesis_tpu_torch.ops.lbl import lbl_cross_section_plain
from port_cases import LINE_H5, LINEDATA_NPZ, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIX = chip_smoke.TABLEGEN_FIX
# the k-table's windows, as tests/test_tablegen.py takes them
KTA_KW = dict(amb_frac=0.9, wn_calc_window=5.0, wn_approx_window=10.0)


@pytest.fixture(scope="module")
def lines():
    return (read_ans_linedata(LINE_H5, 5, 1), jax_read_ans(LINE_H5, 5, 1))


@pytest.fixture(scope="module")
def ref_kta():
    return jax_ktables.read_kta(f"{FIX}/co_ref.kta")


def test_generate_lbltable_matches_jax(lines):
    """Every (P, T) pair of co_ref's grid in one synthesis: the JAX
    package's table within 1e-10 (the same arithmetic)."""
    ll, jll = lines
    ref = jax_ktables.read_lta(f"{FIX}/co_ref.lta")
    got = tablegen.generate_lbltable(ll, ref.press, ref.temp, ref.wave,
                                     amb_frac=0.9, device="cpu")
    want = np.asarray(jax_tablegen.generate_lbltable(
        jll, ref.press, ref.temp, ref.wave, amb_frac=0.9))
    assert got.shape == (ref.wave.size, ref.press.size, ref.temp.size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)


def test_generate_ktable_matches_jax(lines, ref_kta):
    """One synthesis per (P, T) pair, sorted and interpolated per bin on
    the device: the JAX package's numpy rebin within 1e-8 (the
    interpolation's formula differs from ``np.interp``'s)."""
    ll, jll = lines
    ref = ref_kta
    got, g_ord, del_g = tablegen.generate_ktable(
        ll, ref.press, ref.temp, ref.wave, ng=ref.g_ord.size, device="cpu",
        **KTA_KW)
    want, jg, jdg = jax_tablegen.generate_ktable(
        jll, ref.press, ref.temp, ref.wave, ng=ref.g_ord.size, **KTA_KW)
    np.testing.assert_array_equal(g_ord, jg)
    np.testing.assert_array_equal(del_g, jdg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=0)


def test_generate_ktable_chunked_matches_jax(lines, ref_kta):
    """The (P, T)-batched pipeline, one chunk: the JAX package's within
    1e-8 (its rebin in numpy, the port's on the synthesis's device)."""
    ll, jll = lines
    ref = ref_kta
    kw = dict(ng=ref.g_ord.size, n_chunks=1, **KTA_KW)
    got, _, _ = tablegen.generate_ktable_chunked(
        ll, ref.press, ref.temp, ref.wave, device="cpu", **kw)
    want, _, _ = jax_tablegen.generate_ktable_chunked(
        jll, ref.press, ref.temp, ref.wave, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=0)


@pytest.mark.parametrize("name", sorted(chip_smoke.tablegen_golden_cases()))
def test_reference_tables(name):
    """co_ref.lta at rtol 3e-7 and co_ref.kta in log k within 2e-3 (2e-2
    chunked, 1 and 3 chunks), tests/test_tablegen.py's bounds; the lines
    from the ``.npz`` export, as on the card."""
    ll = read_ans_linedata(LINEDATA_NPZ, 5, 1)
    chip_smoke.tablegen_golden_cases()[name](ll, "cpu")


def test_chunks_keep_their_numbers(lines, ref_kta):
    """Three chunks dispatched one ahead of the rebin equal each chunk
    generated alone (the pipeline's order changes no number)."""
    ll, _ = lines
    ref = ref_kta
    kw = dict(ng=ref.g_ord.size, device="cpu", **KTA_KW)
    whole, _, _ = tablegen.generate_ktable_chunked(
        ll, ref.press, ref.temp, ref.wave, n_chunks=3, **kw)
    parts = [tablegen.generate_ktable_chunked(
        ll, ref.press, ref.temp, ref.wave[idx], n_chunks=1, **kw)[0]
        for idx in np.array_split(np.arange(ref.wave.size), 3)]
    torch.testing.assert_close(whole, torch.cat(parts), rtol=0, atol=0)


def test_writers_give_the_jax_bytes(tmp_path):
    """write_kta (uniform and explicit wave grids) and write_lta write the
    JAX writers' bytes, from a host array or a tensor, and read back."""
    rng = np.random.default_rng(0)
    g_ord, del_g = tablegen.gauss_legendre_g(6)
    press = np.logspace(-4, -1, 3)
    temp = np.array([150.0, 250.0])
    for i, wave in enumerate((np.arange(2140.0, 2144.0, 0.5),
                              np.array([2140.0, 2140.3, 2141.0, 2142.5]))):
        k = 10 ** rng.uniform(-25, -20, (wave.size, 6, 3, 2))
        ours, theirs = str(tmp_path / f"p{i}.kta"), str(tmp_path / f"j{i}.kta")
        ktables.write_kta(ours, 5, 1, g_ord, del_g, press, temp, wave,
                          torch.as_tensor(k))
        jax_ktables.write_kta(theirs, 5, 1, g_ord, del_g, press, temp, wave,
                              k)
        assert open(ours, "rb").read() == open(theirs, "rb").read()
        back = ktables.read_kta(ours)
        np.testing.assert_allclose(back.k, k, rtol=3e-7)
    k = 10 ** rng.uniform(-25, -20, (8, 3, 2))
    ktables.write_lta(str(tmp_path / "p"), 5, 1, press, temp, 2140.0, 0.5, k)
    jax_ktables.write_lta(str(tmp_path / "j"), 5, 1, press, temp, 2140.0, 0.5,
                          k)
    assert (tmp_path / "p.lta").read_bytes() == (tmp_path / "j.lta").read_bytes()
    back = ktables.read_lta(str(tmp_path / "p.lta"))
    np.testing.assert_allclose(back.k[:, 0], k, rtol=3e-7)


def test_table_shape_of_the_card_run():
    """The production grid of chip_smoke's phase 22 gives kernel 2 200
    (P, T) columns over 50,000 waves, and its k-table four chunks of
    fine grids as fine as the finest (P, T) point's own, to one point."""
    ll = read_ans_linedata(LINEDATA_NPZ, 5, 1)
    lines_t, blocks, cols = chip_smoke.table_kernel_case(ll, "cpu",
                                                         torch.float64)
    assert blocks.n_wave == 50_000 and all(c.shape == (200,) for c in cols)
    assert np.all(lines_t.nu >= 2000.0) and np.all(lines_t.nu <= 2250.0)
    for idx in np.array_split(np.arange(chip_smoke.TABLE_BINS.size),
                              chip_smoke.TABLE_CHUNKS):
        ll_c, wavecalc, pcol, tcol, delwave, *_ = tablegen.chunk_grid(
            ll, chip_smoke.TABLE_PRESS, chip_smoke.TABLE_TEMP,
            chip_smoke.TABLE_BINS[idx], 1.0, 75.0, 2_000_000)
        finest = min(tablegen._min_hwhm(ll_c, p, t, 1.0)
                     for p, t in zip(pcol, tcol)) / 5.0
        # int() of the point count leaves the step at most one point's
        # share above the finest HWHM / 5
        assert wavecalc[1] - wavecalc[0] <= finest * (1 + 2 / wavecalc.size)
        assert delwave == 1.0 and pcol.size == 200


# --- the kernel at the table-generation shape, on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is built with nvcc "
                    "and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_at_table_shape_matches_plain_on_card(cuda):
    """Kernel 2 with NP x NT = 200 (P, T) columns as its layers (a 2,000
    wave slice of the production grid): float64 within phase 22's gates
    of the plain version (``chip_smoke.table_f64_check``), one launch."""
    ll = read_ans_linedata(LINEDATA_NPZ, 5, 1)
    lines_t, blocks, cols = chip_smoke.table_kernel_case(ll, cuda,
                                                         torch.float64)
    from archnemesis_tpu_torch.ops.lbl import build_blocks

    wave = blocks.wn_pad[:2000]
    blocks = build_blocks(wave, lines_t.nu)
    before = lbl_cuda.lbl_cross_section.launches
    got = lbl_cuda.lbl_cross_section(lines_t, blocks, *cols)
    torch.cuda.synchronize()
    assert lbl_cuda.lbl_cross_section.launches == before + 1
    want = lbl_cross_section_plain(lines_t, blocks, *cols)
    assert got.shape == (2000, 200)
    chip_smoke.table_f64_check(got, want, "table shape")
