"""The runtime line-by-line (ILBL=1) forward of the PyTorch port: the
``.lls`` deck read with the port's ``load_deck`` and run through
``forward_nadir`` against the reference golden (as
``tests/test_forward_runtime.py`` runs the JAX package), float32 against
float64, the weak-line pseudo-continuum against the JAX package's, the
full-width configuration's inputs against ``bench.py``'s, and the retrieval
entry point end to end."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archnemesis_tpu.io.linedata import read_lls_runtime as jax_read_lls
from archnemesis_tpu.ops.pseudo_continuum import (
    PseudoContinuum as JaxPseudoContinuum,
)
from archnemesis_tpu.ops.pseudo_continuum import (
    pseudo_continuum_k as jax_pseudo_continuum_k,
)
from archnemesis_tpu_torch import convert, synthetic
from archnemesis_tpu_torch.forward import forward_nadir, make_forward_config
from archnemesis_tpu_torch.io.legacy import load_deck
from archnemesis_tpu_torch.ops import lbl_cuda
from archnemesis_tpu_torch.ops.convolution import conv_channel_interp
from archnemesis_tpu_torch.ops.pseudo_continuum import pseudo_continuum_k
from archnemesis_tpu_torch.retrieval.output import read_mre
from archnemesis_tpu_torch.retrieval.statevector import apply_state, read_apr
from archnemesis_tpu_torch.retrievals import retrieval_nemesis
from port_cases import (
    CO_RUNTIME,
    CO_RUNTIME_GOLDEN,
    LLS,
    copy_runtime_deck,
    one_torch_thread,  # noqa: F401 (a fixture)
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_BOUNDS = (5.0e-5, 2.0e-5)  # tests/test_f32_parity.py:23


def rel_err(a, b):
    """|a - b| / max(|b|, 1e-3 max|b|) (tools/f32_parity.py)."""
    scale = np.abs(b).max()
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3 * scale)


def runtime_forward(deck_dir, dtype, rt_transform=None):
    """(diagnostics, SPECONV, synthesis calls, rt) of the runtime deck with the
    a-priori state applied and the lines windowed to the channel range
    (tests/test_forward_runtime.py:22-48), on the CPU in ``dtype``."""
    from archnemesis_tpu_torch.core.spectra import cast_deck

    deck = load_deck(deck_dir, "cirstest")
    sv = read_apr(os.path.join(deck_dir, "cirstest.apr"), deck.atmosphere)
    atm = apply_state(deck.atmosphere, torch.as_tensor(sv.xa), sv)
    nconv = int(deck.geometry.nconv[0])
    vconv = deck.geometry.vconv[:nconv, 0]
    rt = deck.ktables.windowed(vconv.min(), vconv.max())
    if rt_transform is not None:
        rt = rt_transform(rt)
    cfg = make_forward_config(atm, rt, None, iray=deck.settings.iray,
                              ispace=deck.settings.ispace, gasgiant=True)
    calls = lbl_cuda.lbl_cross_section.calls
    spec, diag = forward_nadir(
        cast_deck(atm, dtype), deck.layer_config, rt, None, None,
        cast_deck(deck.surface, dtype), cfg, emiss_ang=0.0,
        return_diagnostics=True, device="cpu")
    calls = lbl_cuda.lbl_cross_section.calls - calls
    conv = conv_channel_interp(spec.new_tensor(rt.wave), spec[:, 0],
                               spec.new_tensor(vconv))
    return diag, conv, calls, rt


@pytest.fixture(scope="module")
def runs():
    return {dtype: runtime_forward(CO_RUNTIME, dtype)
            for dtype in (torch.float64, torch.float32)}


def test_layer_taugas(runs):
    want = np.load(CO_RUNTIME_GOLDEN)["TAUGAS"]
    diag, _, calls, _ = runs[torch.float64]
    assert calls == 1  # one synthesis per gas per forward
    np.testing.assert_allclose(diag["taugas"].numpy(), want, rtol=1e-7,
                               atol=1e-10 * np.abs(want).max())


def test_convolved_spectrum(runs):
    d = np.load(CO_RUNTIME_GOLDEN)
    nconv = int(d["NCONV"][0])
    _, conv, _, _ = runs[torch.float64]
    np.testing.assert_allclose(conv.numpy(), d["SPECONV"][:nconv, 0],
                               rtol=1e-6, atol=0)


def test_f32_within_bound_of_f64(runs):
    """The float32 deck (two-float delta: its line centres stay float64)
    within the JAX package's co_runtime_voigt bound of float64."""
    conv64, conv32 = runs[torch.float64][1], runs[torch.float32][1]
    assert conv32.dtype == torch.float32
    r = rel_err(conv32.double().numpy(), conv64.numpy())
    assert r.max() < F32_BOUNDS[0] and np.median(r) < F32_BOUNDS[1]


def test_npz_deck_equals_h5_deck(runs, tmp_path_factory):
    """The deck copy that reads the line data's .npz export (as on the card)
    gives the same optical depths as the .h5 fixture, bit for bit."""
    deck = copy_runtime_deck(tmp_path_factory, "npzdeck")
    diag, _, _, _ = runtime_forward(deck, torch.float64)
    torch.testing.assert_close(diag["taugas"], runs[torch.float64][0]["taugas"],
                               rtol=0, atol=0)


# --- the weak-line pseudo-continuum

def seeded_pseudo_continuum(lo, hi, n_bins=120, seed=0):
    """A made-up pre-binned weak-line set on [lo, hi] cm-1 (float64)."""
    rng = np.random.default_rng(seed)
    edges = np.linspace(lo, hi, n_bins + 1)
    return dict(
        t_ref=296.0, p_ref=1.0, mass=28.0, abundance=0.98,
        wn_bin_center=0.5 * (edges[1:] + edges[:-1]),
        wn_bin_width=np.diff(edges),
        strength_sum=10.0 ** rng.uniform(-24.0, -20.0, n_bins),
        lsw_e_lower=rng.uniform(0.0, 3000.0, n_bins),
        lsw_gamma_self=rng.uniform(0.05, 0.09, n_bins),
        lsw_n_self=rng.uniform(0.6, 0.8, n_bins),
        lsw_gamma_amb=rng.uniform(0.04, 0.08, n_bins),
        lsw_n_amb=rng.uniform(0.6, 0.8, n_bins),
        pf_temp=np.linspace(50.0, 400.0, 36),
        pf_q=np.linspace(20.0, 160.0, 36) ** 1.05,
    )


@pytest.mark.parametrize("bins", [(2108.0, 2168.0), (2105.0, 2230.0),
                                  (2150.0, 2230.0)],
                         ids=["inside", "straddle_high", "starts_above_grid"])
@pytest.mark.parametrize("lineshape", ["voigt", "lorentz"])
def test_pseudo_continuum_matches_jax(bins, lineshape):
    """rtol 1e-10: the per-bin scatter adds in another order. A bin set
    that starts above the grid's first wave spreads nothing (the
    reference's first-index scan, replicated by both packages)."""
    fields = seeded_pseudo_continuum(*bins)
    wave = np.arange(2110.0, 2190.0, 0.05)
    t = np.array([140.0, 210.0, 300.0])
    p = np.array([1.0e-3, 0.05, 2.0])
    amb = np.array([0.99, 0.9, 0.5])
    want = np.asarray(jax_pseudo_continuum_k(
        JaxPseudoContinuum(**fields), wave, jnp.asarray(t), jnp.asarray(p),
        jnp.asarray(amb), lineshape=lineshape))
    got = pseudo_continuum_k(convert.pseudo_continuum(fields), wave,
                             *(torch.as_tensor(x) for x in (t, p, amb)),
                             lineshape=lineshape)
    assert got.shape == want.shape == (wave.size, 3)
    assert (np.abs(want).max() > 0) == (bins[0] <= wave[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("temperature", [None, 180.0, 400.0])
def test_pseudo_continuum_file_matches_jax(tmp_path, temperature):
    """``read_ans_pseudo_continuum`` reads the same PseudoContinuum as the
    JAX reader from an "ans" HDF5 file of two leaves (t_cont 150 K and
    296 K, one with an AIR broadener): the leaf choice by temperature and
    the broadener fallback."""
    import h5py

    from archnemesis_tpu.io.linedata import (
        read_ans_pseudo_continuum as jax_read_pc,
    )
    from archnemesis_tpu_torch.io.linedata import read_ans_pseudo_continuum

    path = str(tmp_path / "pc.h5")
    with h5py.File(path, "w") as f:
        for i, (t_cont, amb) in enumerate(((150.0, False), (296.0, True))):
            fields = seeded_pseudo_continuum(2100.0, 2200.0, seed=i)
            g = f.create_group(f"pseudo_continuum/CO/1/pc_data_{i:04d}")
            g.attrs.update(t_cont=t_cont, s_max=1e-22, p_ref=1.0)
            for name, key in (("wn_bin_center", "wn_bin_center"),
                              ("wn_bin_width", "wn_bin_width"),
                              ("line_strength_sum", "strength_sum"),
                              ("line_strength_weighted_mean_lower_energy_"
                               "state", "lsw_e_lower"),
                              ("line_strength_weighted_gamma_self",
                               "lsw_gamma_self"),
                              ("line_strength_weighted_n_self",
                               "lsw_n_self")):
                g[name] = fields[key]
            if amb:
                g["broadeners/AIR/line_strength_weighted_gamma_amb"] = \
                    fields["lsw_gamma_amb"]
                g["broadeners/AIR/line_strength_weighted_n_amb"] = \
                    fields["lsw_n_amb"]
    pf = (np.linspace(50.0, 400.0, 8), np.linspace(20.0, 160.0, 8))
    want = jax_read_pc(path, 5, 1, temperature=temperature,
                       pf_temp=pf[0], pf_q=pf[1])
    got = read_ans_pseudo_continuum(path, 5, 1, temperature=temperature,
                                    pf_temp=pf[0], pf_q=pf[1])
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


def test_forward_adds_the_continuum(runs):
    """With a pseudo-continuum attached (INCLUDE_CONTINUUM), the gas optical
    depth gains that continuum at the layers' state times the gas's
    amounts (JAX forward.py:289-304)."""
    from archnemesis_tpu_torch.forward import (
        ATM_TO_PA,
        SQ_CM_TO_SQ_M,
        runtime_ambient_fraction,
    )

    pc = convert.pseudo_continuum(seeded_pseudo_continuum(2100.0, 2200.0))
    diag_c, _, _, rt = runtime_forward(
        CO_RUNTIME, torch.float64,
        lambda rt: dataclasses.replace(rt, pseudo_continuum=(pc,),
                                       include_continuum=(True,)))
    diag_l, _, _, _ = runs[torch.float64]
    layers = diag_c["layers"]
    cfg = make_forward_config(load_deck(CO_RUNTIME, "cirstest").atmosphere,
                              rt, None, iray=0)
    k_pc = pseudo_continuum_k(pc, rt.wave, layers.temp,
                              layers.press / ATM_TO_PA,
                              runtime_ambient_fraction(cfg, layers, 0))
    amount = layers.amount[:, cfg.spec_gas_idx[0]] * SQ_CM_TO_SQ_M
    extra = (diag_c["taugas"] - diag_l["taugas"])[:, 0, :]
    assert extra.abs().max() > 0
    np.testing.assert_allclose(extra.numpy(), (k_pc * amount).numpy(),
                               rtol=1e-9, atol=1e-12 * extra.abs().max())


# --- the full-width configuration


def test_lbl_headline_inputs_match_bench():
    """``synthetic.lbl_headline`` (line data from the .npz export) builds
    ``bench.py:68-137``'s inputs: the CO list tiled 60x with
    default_rng(1) jitter, 80,000 waves, windowed to 2100-2200 cm-1, 41
    levels; here cut to 512 waves."""
    nwave = 512
    jrt = jax_read_lls(LLS)
    ll = jrt.line_lists[0]
    rng = np.random.default_rng(1)
    reps = 60
    nu = np.concatenate([ll.nu + rng.uniform(-20.0, 20.0)
                         for _ in range(reps)])
    order = np.argsort(nu)

    def tile(a):
        return np.concatenate([a] * reps)[order]

    want = dataclasses.replace(
        ll, nu=nu[order], sw=tile(ll.sw) / reps, elower=tile(ll.elower),
        stim_ref=tile(ll.stim_ref),
        broad=np.stack([tile(ll.broad[i]) for i in range(6)]))
    wave = np.arange(2110.0, 2190.0, 0.001)[:nwave]
    jrt = dataclasses.replace(jrt, wave=wave, line_lists=(want,)).windowed(
        2100.0, 2200.0)
    atm, laycfg, rt, surf, cfg = synthetic.lbl_headline(
        nwave, dtype=torch.float64, device="cpu")
    got, jll = rt.line_lists[0], jrt.line_lists[0]
    assert got.n_lines == 5092
    for name in ("nu", "sw", "elower", "stim_ref", "broad"):
        np.testing.assert_array_equal(getattr(got, name), getattr(jll, name))
    np.testing.assert_array_equal(rt.wave, jrt.wave)
    np.testing.assert_array_equal(rt.blocks[0].line_idx,
                                  jrt.blocks[0].line_idx)
    assert (rt.lineshape, rt.wn_calc_window, rt.wn_approx_window,
            rt.s_floor, rt.include_pressure_shift) == (
        jrt.lineshape, jrt.wn_calc_window, jrt.wn_approx_window,
        jrt.s_floor, jrt.include_pressure_shift)
    h = np.linspace(0.0, 8.0e4, 41)
    np.testing.assert_array_equal(atm.p.numpy(), 700.0 * np.exp(-h / 1.1e4))
    np.testing.assert_array_equal(atm.t.numpy(), 210.0 - 60.0 * (h / 8.0e4))
    assert (atm.gas_id, atm.iso_id, laycfg.nlay) == ((5, 2), (1, 0), 40)
    assert cfg.amb_self_cols == ((0,),)


def test_lbl_headline_full_width_shape():
    """At full width: 5,092 lines on 625 blocks of 128 waves, each block's
    range holding every line."""
    _, _, rt, _, _ = synthetic.lbl_headline(dtype=torch.float32,
                                            device="cpu")
    blocks = rt.blocks[0]
    assert (rt.wave.size, rt.line_lists[0].n_lines) == (80_000, 5092)
    assert (blocks.n_blocks, blocks.block_width) == (625, 128)
    assert int(blocks.counts.max()) == 5092
    assert rt.line_lists[0].nu.dtype == np.float64


# --- the retrieval entry point, end to end

def test_retrieval_nemesis_runs(tmp_path_factory):
    """``retrieval_nemesis(niter=2)`` on a copy of the runtime deck: phi
    falls and the .mre holds the retrieved state."""
    deck = copy_runtime_deck(tmp_path_factory, "runtime_ret")
    res = retrieval_nemesis(deck, "cirstest", niter=2, device="cpu")
    assert res.n_iter >= 1
    assert np.isfinite(res.xn).all()
    assert res.phi_history[-1] < res.phi_history[0]
    mre = read_mre(os.path.join(deck, "cirstest.mre"))
    assert mre is not None
    for ext in (".mre", ".cov", ".raw", ".itr"):
        assert os.path.exists(os.path.join(deck, "cirstest" + ext)), ext
