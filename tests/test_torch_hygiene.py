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
    assert int(out.stdout.split()[-1]) >= 33


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
