"""What the benchmark runs loads neither JAX nor the JAX package, and the
reference loads nothing of the program."""

import os
import subprocess
import sys

from nembench.run import forbidden_modules
from .nembench_cases import ROOT



def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    return set(out.stdout.split())


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules({"archnemesis_tpu_torch": 0,
                              "archnemesis_tpu_torch.forward": 0,
                              "jaxtyping": 0, "numpy": 0}) == []
    assert forbidden_modules({"jax.numpy": 0, "archnemesis_tpu.ops": 0,
                              "flax": 0, "jaxlib": 0}) == [
        "archnemesis_tpu", "flax", "jax", "jaxlib"]


def test_harness_and_program_side_load_no_jax():
    top = _loaded_after(
        "from nembench import run, control\n"
        "from nembench.harness import loop, manifest as mf\n"
        "for c in ('jupiter_ck', 'co_lbl'):\n"
        "    mf.config(c)\n"
        "import archnemesis_tpu_torch.forward, "
        "archnemesis_tpu_torch.retrieval.oe, archnemesis_tpu_torch.ops.lbl_cuda, "
        "archnemesis_tpu_torch.ops.overlap_cuda, archnemesis_tpu_torch.io.linedata\n"
        "for m in mf.load()['per_layer']:\n"
        "    mf.metric(m['name'])\n")
    assert forbidden_modules(dict.fromkeys(top)) == []
    assert "archnemesis_tpu_torch" in top


def test_reference_loads_nothing_of_the_program():
    top = _loaded_after("import nembench.reference.nadir, "
                        "nembench.reference.ktables, nembench.reference.lbl")
    assert "archnemesis_tpu_torch" not in top
    assert forbidden_modules(dict.fromkeys(top)) == []
