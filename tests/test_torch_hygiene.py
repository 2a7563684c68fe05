"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points run on the CUDA card unless asked for the CPU,
and its kernel module imports where there is no CUDA compiler."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from archnemesis_tpu_torch import convert, synthetic
from archnemesis_tpu_torch.core.spectra import KTables
from archnemesis_tpu_torch.forward import forward_nadir
from archnemesis_tpu_torch.io.cia import read_cia_tab
from archnemesis_tpu_torch.io.ktables import read_kls
from archnemesis_tpu_torch.utils.device import resolve_device
from port_cases import CIA_TAB

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "archnemesis_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "archnemesis_tpu"}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(source):
    """Top-level names of every module that ``source`` imports."""
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    # exact names: archnemesis_tpu_torch shares the JAX package's prefix
    assert not _imported_roots(path.read_text()) & FORBIDDEN


def _module_level_roots(source):
    """Top-level names imported outside any function body."""
    roots = set()

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                roots.update(a.name.split(".")[0] for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                roots.add(child.module.split(".")[0])
            visit(child)

    visit(ast.parse(source))
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_h5py_only_inside_functions(path):
    """The card's machine has no h5py: the port imports it only inside the
    functions that read a ``.h5`` file."""
    assert "h5py" not in _module_level_roots(path.read_text())


def test_scan_sees_forbidden_imports():
    src = ("import jax.numpy\nfrom archnemesis_tpu.ops import x\n"
           "import archnemesis_tpu_torch.ops\n")
    assert _imported_roots(src) & FORBIDDEN == {"jax", "archnemesis_tpu"}


def test_import_leaves_no_jax_in_sys_modules():
    """Import every module of the port and chip_smoke in a fresh process."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import archnemesis_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'archnemesis_tpu'))\n"
        "print('loaded', len([n for n in sys.modules"
        " if n.startswith('archnemesis_tpu_torch.')]))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 43


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    tables = read_kls("tests/fixtures/jupiter_nadir/cirstest.kls",
                      wavemin=600.0, wavemax=610.0)
    with pytest.raises(RuntimeError):
        KTables.from_tables(tables)
    with pytest.raises(RuntimeError):
        read_cia_tab(CIA_TAB, dnu=1.0, npara=0)
    with pytest.raises(RuntimeError):
        convert.atmosphere(dict(h=np.zeros(3)))
    with pytest.raises(RuntimeError):
        synthetic.headline_deck(8)
    # asked for the CPU, each of them builds on the CPU
    assert KTables.from_tables(tables, device="cpu").k.device.type == "cpu"
    assert read_cia_tab(CIA_TAB, dnu=1.0, npara=0,
                        device="cpu").k_cia.device.type == "cpu"


def test_retrieval_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """The retrieval's entry points run on the card unless asked for the
    CPU; ``load_deck`` is host-only and builds CPU tensors either way."""
    from archnemesis_tpu_torch.io.legacy import load_deck
    from archnemesis_tpu_torch.retrieval.oe import coreret_oe
    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup,
        retrieval_nemesis,
        run_retrieval,
    )

    deck = "tests/fixtures/jupiter_fdret"
    for entry in (make_retrieval_setup, run_retrieval, retrieval_nemesis):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(deck, "cirstest")
    eye = np.eye(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        coreret_oe(lambda x: x, np.zeros(2), eye, np.ones(2), eye,
                   np.zeros(2, dtype=int), niter=0)
    res = coreret_oe(lambda x: 2.0 * x, np.zeros(2), eye, np.ones(2), eye,
                     np.zeros(2, dtype=int), niter=1, device="cpu")
    np.testing.assert_allclose(res.kk, 2.0 * eye)
    assert load_deck(deck, "cirstest").ktables.k.device.type == "cpu"
    setup = make_retrieval_setup(deck, "cirstest", device="cpu")
    assert setup.device.type == "cpu"
    assert setup.deck.ktables.k.device.type == "cpu"


def test_slice_entry_points_raise_without_cuda(no_cuda):
    """The SO and transit set-ups and table generation run on the card
    unless asked for the CPU; the HDF5 loader is host-only."""
    import chip_smoke
    from archnemesis_tpu_torch.io.hdf5 import load_deck_hdf5
    from archnemesis_tpu_torch.io.linedata import read_ans_linedata
    from archnemesis_tpu_torch.ops.tablegen import (
        generate_ktable,
        generate_ktable_chunked,
        generate_lbltable,
    )
    from archnemesis_tpu_torch.retrievals import (
        make_retrieval_setup_so,
        make_retrieval_setup_transit,
    )

    deck, run = chip_smoke.SO_DECK, chip_smoke.SO_RUN
    for entry in (make_retrieval_setup_so, make_retrieval_setup_transit):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(deck, run, deck_file=chip_smoke.SO_EXPORT)
    ll = read_ans_linedata(chip_smoke.LINEDATA_NPZ, 5, 1)
    grid = (np.array([0.1]), np.array([200.0]), np.arange(2140.0, 2141.0,
                                                          0.5))
    for entry, kw in ((generate_lbltable, {}), (generate_ktable, {"ng": 2}),
                      (generate_ktable_chunked, {"ng": 2})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(ll, *grid, **kw)
    loaded = load_deck_hdf5(chip_smoke.SO_EXPORT, base_dir=deck)
    assert loaded.ktables.k.device.type == "cpu"


def test_emission_telluric_multiloc_entry_points_raise_without_cuda(
        no_cuda, tmp_path):
    """The emission forward, the multi-location forward and the telluric
    set-up run on the card unless asked for the CPU; the table, run-file
    and ``.drv`` readers are host-only."""
    import chip_smoke
    from archnemesis_tpu_torch.core.types import stack_atmospheres
    from archnemesis_tpu_torch.io.emissions import read_emission_tables
    from archnemesis_tpu_torch.io.hdf5 import load_deck_hdf5
    from archnemesis_tpu_torch.multiloc import forward_nadir_multiloc
    from archnemesis_tpu_torch.ops.emissions import locate_emission_gases
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    em = read_emission_tables(list(chip_smoke.EMISS_EXPORTS))
    assert em.k.device.type == "cpu"
    atm, laycfg, ktab, surf, cfg = synthetic.headline_deck(8, torch.float64,
                                                           "cpu")
    cols = locate_emission_gases(em.replace(gas_id=(atm.gas_id[0],) * 2,
                                            iso_id=(atm.iso_id[0],) * 2),
                                 atm.gas_id[:1], atm.iso_id[:1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forward_nadir(atm, laycfg, ktab, None, None, surf, cfg,
                      emiss_ang=0.0, emis=em, emis_gas_cols=cols)
    multi = stack_atmospheres([atm, atm])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forward_nadir_multiloc(multi, laycfg, ktab, None, None, surf, cfg,
                               emiss_ang=0.0)
    deck = chip_smoke.telluric_deck(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_retrieval_setup(deck, "cirstest",
                             deck_file=chip_smoke.TELLURIC_EXPORT)
    run = load_deck_hdf5(chip_smoke.TELLURIC_EXPORT, base_dir=deck)
    assert run.telluric.ktables.k.device.type == "cpu"
    got = forward_nadir_multiloc(multi, laycfg, ktab, None, None, surf, cfg,
                                 emiss_ang=0.0, device="cpu")
    assert got.shape == (8, 2) and got.device.type == "cpu"


def test_forward_nadir_on_numpy_inputs(no_cuda):
    """Structures holding numpy arrays run where ``device`` says: on the
    card by default (so here it raises), on the CPU when asked."""
    atm, laycfg, ktab, surf, cfg = synthetic.headline_deck(8, torch.float64,
                                                           "cpu")
    atm_np = atm.replace(h=atm.h.numpy(), p=atm.p.numpy(), t=atm.t.numpy(),
                         vmr=atm.vmr.numpy())
    ktab_np = ktab.replace(k=ktab.k.numpy(), wave=ktab.wave.numpy())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forward_nadir(atm_np, laycfg, ktab_np, None, None, surf, cfg,
                      emiss_ang=0.0)
    got = forward_nadir(atm_np, laycfg, ktab_np, None, None, surf, cfg,
                        emiss_ang=0.0, device="cpu")
    want = forward_nadir(atm, laycfg, ktab, None, None, surf, cfg,
                         emiss_ang=0.0, device="cpu")
    assert got.device.type == "cpu"
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_overlap_cuda_imports_without_nvcc(tmp_path):
    """The kernel module imports and its wrapper serves CPU tensors where
    no CUDA compiler exists; building the kernel there raises."""
    code = (
        "import numpy as np, torch\n"
        "from archnemesis_tpu_torch.ops import overlap_cuda as m\n"
        "a = torch.zeros((3, 4), dtype=torch.float64)\n"
        "out = m.combine_pair(a, a, np.full(4, 0.25))\n"
        "assert out.shape == (3, 4) and m.combine_pair.launches == 0\n"
        "try:\n"
        "    m.build()\n"
        "except (OSError, RuntimeError) as e:\n"
        "    print('build raised', type(e).__name__)\n"
    )
    env = dict(os.environ, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "build raised" in out.stdout


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_lbl_cuda_imports_without_nvcc(tmp_path):
    """The LBL kernel module imports and its wrapper serves CPU tensors
    where no CUDA compiler exists; building the kernel there raises."""
    code = (
        "import numpy as np, torch\n"
        "from archnemesis_tpu_torch.ops import lbl_cuda as m\n"
        "from archnemesis_tpu_torch.io.linedata import read_ans_linedata\n"
        "from archnemesis_tpu_torch.ops.lbl import build_blocks\n"
        "from archnemesis_tpu_torch.synthetic import LBL_LINEDATA\n"
        "ll = read_ans_linedata(LBL_LINEDATA, 5, 1)\n"
        "b = build_blocks(np.linspace(2100.0, 2110.0, 300), ll.nu)\n"
        "x = torch.tensor([200.0], dtype=torch.float64)\n"
        "k = m.lbl_cross_section(ll, b, x, x * 0 + 0.1, x * 0 + 0.9)\n"
        "assert k.shape == (300, 1) and m.lbl_cross_section.launches == 0\n"
        "try:\n"
        "    m.build()\n"
        "except (OSError, RuntimeError) as e:\n"
        "    print('build raised', type(e).__name__)\n"
    )
    env = dict(os.environ, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "build raised" in out.stdout


def test_lbl_entry_points_raise_without_cuda(no_cuda):
    """``lbl_cross_section`` and the runtime headline run on the card unless
    asked for the CPU."""
    from archnemesis_tpu_torch.io.linedata import read_ans_linedata
    from archnemesis_tpu_torch.ops.lbl import build_blocks, lbl_cross_section

    ll = read_ans_linedata(synthetic.LBL_LINEDATA, 5, 1)
    blocks = build_blocks(np.linspace(2100.0, 2110.0, 300), ll.nu)
    state = ([200.0], [0.1], [0.9])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lbl_cross_section(ll, blocks, *state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.lbl_headline(256)
    k = lbl_cross_section(ll, blocks, *state, device="cpu")
    assert k.device.type == "cpu" and k.shape == (300, 1)


def test_float32_runtime_deck_keeps_float64_line_centres():
    """The float32 retrieval set-up casts the atmosphere but not the
    RuntimeLBL: its line centres stay float64 on the host, so the float32
    synthesis takes the two-float delta (plain version and kernel
    inputs)."""
    from archnemesis_tpu_torch.ops.lbl import uses_two_float
    from archnemesis_tpu_torch.ops.lbl_cuda import LblSpec, kernel_inputs
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    setup = make_retrieval_setup("tests/fixtures/co_runtime", "cirstest",
                                 device="cpu", dtype=torch.float32)
    assert setup.deck.atmosphere.t.dtype == torch.float32
    rt = setup.deck.ktables.windowed(2120.0, 2180.0)
    ll = rt.line_lists[0]
    assert isinstance(ll.nu, np.ndarray) and ll.nu.dtype == np.float64
    assert uses_two_float(ll, torch.float32)
    assert not uses_two_float(ll, torch.float64)
    spec = LblSpec(ll=ll, blocks=rt.blocks[0], lineshape="voigt",
                   s_floor=0.0, wn_calc_window=25.0, wn_approx_window=75.0,
                   include_pressure_shift=True, factor=1.0)
    packed = kernel_inputs(spec, torch.float32, torch.device("cpu"))
    assert packed["twofloat"]
    # hi + lo carry 48 of the float64 centre's 53 bits; hi alone 24
    hi, lo = packed["cols"][0].double(), packed["cols"][1].double()
    np.testing.assert_allclose((hi + lo).numpy(), ll.nu, rtol=2.0**-46)
    assert np.abs(hi.numpy() - ll.nu).max() > 2.0**-46 * ll.nu.max()


def test_probe_and_variant_modules_import_without_nvcc(tmp_path):
    """The FMA-peak and variant kernel modules import where no CUDA compiler
    exists: the variants serve CPU tensors with their plain versions, the
    probe has no CPU path and raises; building either kernel raises."""
    code = (
        "import numpy as np, torch\n"
        "from archnemesis_tpu_torch.ops import fma_peak, overlap_variants\n"
        "a = torch.zeros((3, 4))\n"
        "out = overlap_variants.combine_lean(a, a, np.full(4, 0.25))\n"
        "assert out.shape == (3, 4)\n"
        "assert sum(overlap_variants.combine_lean.launches.values()) == 0\n"
        "try:\n"
        "    fma_peak.fma_chain(torch.ones(4))\n"
        "except ValueError:\n"
        "    print('probe raised')\n"
        "for m in (fma_peak, overlap_variants):\n"
        "    try:\n"
        "        m.build()\n"
        "    except (OSError, RuntimeError) as e:\n"
        "        print('build raised', type(e).__name__)\n"
    )
    env = dict(os.environ, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("build raised") == 2
    assert "probe raised" in out.stdout


def test_build_key_covers_included_headers(tmp_path):
    """The build key (``ops/cuda_build.source_digest``, computed without
    nvcc) covers the local headers a source includes: an edit of the row
    header both combine sources include gives both a new key, so neither
    loads a library built from the old header; an edit elsewhere does
    not."""
    from archnemesis_tpu_torch.ops import cuda_build

    names = ("overlap_combine", "overlap_variants")
    for name in names:
        got = cuda_build.local_sources(cuda_build.source_path(name))
        assert [os.path.basename(p) for p in got] == [f"{name}.cu",
                                                       "overlap_row.cuh"]
    csrc = tmp_path / "csrc"
    shutil.copytree(PORT / "csrc", csrc)
    keys = {n: cuda_build.source_digest(str(csrc / f"{n}.cu"))
            for n in (*names, "lbl_cross_section")}
    assert keys["overlap_combine"] == cuda_build.source_digest(
        cuda_build.source_path("overlap_combine"))
    header = csrc / "overlap_row.cuh"
    header.write_text(header.read_text() + "// an edit\n")
    for name in names:
        assert cuda_build.source_digest(str(csrc / f"{name}.cu")) != keys[name]
    assert cuda_build.source_digest(
        str(csrc / "lbl_cross_section.cu")) == keys["lbl_cross_section"]


def test_sharding_and_tools_need_a_card(no_cuda):
    """The sharded synthesis packs its kernel inputs on the card unless asked
    for the CPU; the measurement tools refuse to run without a card; a
    retrieval set-up names its device."""
    from archnemesis_tpu_torch.io.linedata import read_ans_linedata
    from archnemesis_tpu_torch.io.linedata import RuntimeLBL
    from archnemesis_tpu_torch.parallel.mesh import make_mesh
    from archnemesis_tpu_torch.parallel.sharded import shard_runtime_lbl
    from archnemesis_tpu_torch.retrievals import RetrievalSetup
    from archnemesis_tpu_torch.tools import common

    ll = read_ans_linedata(synthetic.LBL_LINEDATA, 5, 1)
    rt = RuntimeLBL(
        wave=np.linspace(2100.0, 2110.0, 300), gas_id=(5,), iso_id=(1,),
        line_lists=(ll,), lineshape=("voigt",), wn_calc_window=(25.0,),
        wn_approx_window=(75.0,), s_floor=(0.0,),
        include_pressure_shift=(True,)).windowed(2000.0, 2200.0)
    mesh = make_mesh(n_wave=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shard_runtime_lbl(rt, mesh)
    sharded = shard_runtime_lbl(rt, mesh, device="cpu")
    assert sharded.shard_data[0].packed[0]["cols"].device.type == "cpu"
    with pytest.raises(SystemExit):
        common.require_cuda()
    with pytest.raises(TypeError, match="device"):
        RetrievalSetup(deck=None, sv=None, forward_fn=None, y=None, se=None,
                       vconv_list=[])


def test_scattering_entry_points_raise_without_cuda(no_cuda):
    """The scattering forwards, the scattering headline, the ISCAT=1 set-up
    and Mie on host inputs run on the card unless asked for the CPU."""
    from archnemesis_tpu_torch.forward import (
        forward_scattering_nadir,
        forward_singlescat_nadir,
    )
    from archnemesis_tpu_torch.ops import mie
    from archnemesis_tpu_torch.retrievals import make_retrieval_setup

    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.scattering_headline(nwave=4)
    case = synthetic.scattering_headline(torch.float64, "cpu", nwave=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forward_scattering_nadir(**case)
    single = {k: v for k, v in case.items() if k != "quad"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forward_singlescat_nadir(**single)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_retrieval_setup("tests/fixtures/jupiter_scatter", "cirstest")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mie.makephase([1.0], 6, [0.5, 0.6, -0.3], (0.1, 1.0, 0.1),
                      [[1.3, 0.01]], [0.0, 90.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mie.kk_new_sub([1.0, 2.0], [0.1, 0.1], 1.5, 1.3)
    spec = forward_scattering_nadir(**case, device="cpu")
    assert spec.shape == (4, 1) and spec.device.type == "cpu"
    assert torch.isfinite(forward_singlescat_nadir(**single,
                                                   device="cpu")).all()


# --- the ingestion and utility slice: libraries the card's machine lacks,
# the host decoder's build, and completeness against the JAX package

@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_matplotlib_only_inside_functions(path):
    """The card's machine has no matplotlib: the port imports it only
    inside the plotting functions."""
    assert "matplotlib" not in _module_level_roots(path.read_text())


def test_plotting_import_leaves_matplotlib_out():
    code = ("import sys\n"
            "import archnemesis_tpu_torch.plotting\n"
            "import archnemesis_tpu_torch.io.ansdb\n"
            "import archnemesis_tpu_torch.io.hitran\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
            " ('matplotlib', 'h5py'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_native_build_writes_under_build(monkeypatch, tmp_path):
    """The decoder is compiled from ``native/src`` into ``build/native/<key>``
    (here a temporary root), once per key, and nothing is written beside
    the JAX package's sources."""
    from archnemesis_tpu_torch import native

    assert native.BUILD_ROOT == str(REPO / "build" / "native")
    assert native.SOURCE == str(REPO / "native" / "src" / "fixed_width.cpp")
    commands = []
    real_run = native._run

    def run(cmd):
        commands.append(list(cmd))
        return real_run(cmd)

    root = tmp_path / "build" / "native"
    monkeypatch.setattr(native, "_run", run)
    monkeypatch.setattr(native, "BUILD_ROOT", str(root))
    jax_native = REPO / "archnemesis_tpu" / "native"
    before = sorted(p.name for p in jax_native.iterdir())
    built = native.build()
    assert built["seconds"] > 0 and built["compiler"]
    outs = [cmd[cmd.index("-o") + 1] for cmd in commands if "-o" in cmd]
    assert len(outs) == 1 and outs[0].startswith(str(root))
    assert pathlib.Path(built["path"]).parent.parent == root
    assert set(cmd[0] for cmd in commands) == {native.compiler()}
    assert "-march=native" in commands[-1] and "-O3" in commands[-1]
    assert native.build() == dict(built, seconds=0.0)  # built once
    assert sorted(p.name for p in jax_native.iterdir()) == before


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No silent fallback: a decoder that does not build raises with the
    compiler's output where the numpy decoder was not asked for."""
    from archnemesis_tpu_torch import native
    from archnemesis_tpu_torch.io.hitran import parse_par
    from port_cases import synthetic_par

    bad = tmp_path / "fixed_width.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    buf = synthetic_par(nrec=8)
    with pytest.raises(RuntimeError, match="not C\\+\\+|error"):
        parse_par(buf)
    with pytest.raises(RuntimeError):
        native.available()
    assert parse_par(buf, use_native=False)["nu"].shape == (8,)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()


def test_profiling_needs_a_card(no_cuda, tmp_path):
    from archnemesis_tpu_torch.utils.profiling import (
        device_memory_report,
        trace,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        with trace(str(tmp_path / "t")):
            pass
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_memory_report()
    assert device_memory_report(device="cpu") == {}


JAX = REPO / "archnemesis_tpu"
# JAX modules whose names the port keeps in another module
COUNTERPART = {
    "data/__init__.py": "utils/datafiles.py",
    "data/datadir.py": "utils/datafiles.py",
}
# What the port does not carry, by design:
JAX_ONLY_MODULES = {
    # the Pallas kernels; their CUDA counterparts are csrc/overlap_combine.cu
    # (ops/overlap_cuda.py) and csrc/lbl_cross_section.cu (ops/lbl_cuda.py)
    "ops/overlap_pallas.py",
    "ops/lbl_pallas.py",
}
JAX_ONLY_NAMES = {
    # a jax.sharding.NamedSharding helper; the port shards with WaveSlice
    ("parallel/mesh.py", "shard_spec"),
    # JAX pytree registration; the port's dataclasses are tensor_dataclass
    ("utils/pytree.py", "pytree_dataclass"),
    # a second copy of core/emissions.py's class, which the port keeps once
    ("core/spectra.py", "EmissionTables"),
    # the float32 "rows" scattering core, shaped for the TPU's register
    # tile; the port's float32 runs the AoS core (ROADMAP, Queue 1)
    ("rt/scattering.py", "ROWS_NMU_MAX"),
}


def _public_names(path: pathlib.Path) -> set:
    """Functions, classes and assigned names at a module's top level that
    do not start with an underscore."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def test_port_has_every_public_name_of_the_jax_package():
    missing = []
    for path in sorted(JAX.rglob("*.py")):
        rel = str(path.relative_to(JAX))
        if rel in JAX_ONLY_MODULES:
            continue
        port = PORT / COUNTERPART.get(rel, rel)
        have = _public_names(port) if port.exists() else set()
        missing += [(rel, name) for name in sorted(_public_names(path))
                    if name not in have and (rel, name) not in JAX_ONLY_NAMES]
    assert not missing, missing
    # the lists name only what exists
    for rel in JAX_ONLY_MODULES:
        assert (JAX / rel).exists() and not (PORT / rel).exists()
    for rel, name in JAX_ONLY_NAMES:
        assert name in _public_names(JAX / rel)
    # the scan sees a missing name
    assert "plot_bestfit" in _public_names(JAX / "plotting.py")


# Parameters of the JAX package that the port does not take, by design:
JAX_ONLY_PARAMETERS = {
    # the Pallas kernels' switches and the XLA path's split-delta inputs;
    # the port's wrappers choose the CUDA kernel or the plain version by
    # the tensors' device
    "use_pallas", "pallas_interpret", "nu_lo", "wn_lo",
    # the TPU combine's straddle and bin-edge arguments
    "nstraddle", "g_edges",
    # the TPU scattering loop's fixed trip count
    "static_trip_count",
    # the JAX profiler's Perfetto link
    "create_perfetto_link",
    # JAX device lists; the port runs where ``device`` says
    "devices",
    # the multihost mesh arguments of jax.distributed and its named axes
    "coordinator_address", "num_processes", "process_id", "data_axis",
    "wave_axis", "global_batch",
}
# JAX's name -> the port's (torch's own names)
RENAMED_PARAMETERS = {"cast_dtype": "dtype", "axis": "dim"}
# Parameters only the port takes: where to run and in which type, the HDF5
# run file's name and directory, path redirects, the LBL kernel's packed
# inputs, the disc's ray chunk, host copies of static grids read inside
# torch.func transforms, and torch.distributed's arguments
PORT_ONLY_PARAMETERS = {
    "device", "dtype", "deck_file", "base_dir", "redirects", "packed",
    "ray_chunk", "vconv_host", "waven_host", "wave_host", "**kw", "**_kw",
    "init_method", "world_size", "rank", "backend", "n_shards",
    "local_batch",
}
# default values written with the other package's names
RENAMED_DEFAULTS = {"np.float32": "torch.float32"}


def _signatures(path: pathlib.Path) -> dict:
    """name -> [(parameter, default text or None)] of the public functions
    and public classes' public methods at a module's top level."""
    def params(fn):
        a = fn.args
        pos = a.posonlyargs + a.args
        defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
        out = [(p.arg, d) for p, d in zip(pos, defaults)]
        if a.vararg:
            out.append(("*" + a.vararg.arg, None))
        out += list(zip((p.arg for p in a.kwonlyargs), a.kw_defaults))
        if a.kwarg:
            out.append(("**" + a.kwarg.arg, None))
        return [(n, None if d is None else ast.unparse(d)) for n, d in out]

    sigs = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            sigs[node.name] = params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            sigs.update((f"{node.name}.{m.name}", params(m))
                        for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_"))
    return sigs


def _comparable(jax_params, port_params):
    """(JAX's parameters without its own and under the port's names, the
    port's without its own), each a list of (name, default). A renamed
    parameter's default is not compared: it follows torch (JAX's
    ``cast_dtype=None`` runs in float64, the port's ``dtype`` says
    ``torch.float64``)."""
    port_names = {n for n, _ in port_params}
    renamed = {RENAMED_PARAMETERS[n] for n, _ in jax_params
               if n in RENAMED_PARAMETERS and n not in port_names}
    want = [(n, RENAMED_DEFAULTS.get(d, d)) if n in port_names
            else (RENAMED_PARAMETERS.get(n, n), None)
            for n, d in jax_params if n not in JAX_ONLY_PARAMETERS]
    shared = {n for n, _ in want}
    got = [(n, None if n in renamed else d) for n, d in port_params
           if n in shared or n not in PORT_ONLY_PARAMETERS]
    return want, got


def test_public_functions_take_the_jax_parameters():
    """Every public function (and public method) of the JAX package that
    the port has takes the same parameters in the same order with the same
    defaults, apart from the listed JAX-only and port-only parameters and
    renames."""
    differ = []
    for path in sorted(JAX.rglob("*.py")):
        rel = str(path.relative_to(JAX))
        port = PORT / COUNTERPART.get(rel, rel)
        if rel in JAX_ONLY_MODULES or not port.exists():
            continue
        have = _signatures(port)
        for name, params in _signatures(path).items():
            if name in have:
                want, got = _comparable(params, have[name])
                if got != want:
                    differ.append((rel, name, want, got))
    assert not differ, differ
    # the scan sees a parameter out of JAX's order (fault F1's signature)
    old = [("gasgiant", None), ("ispace", "0"), ("emission_path", "None")]
    new = [("gasgiant", None), ("emission_path", "None"), ("ispace", "0")]
    assert _comparable(new, old)[0] != _comparable(new, old)[1]
