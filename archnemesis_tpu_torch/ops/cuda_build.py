"""Build a CUDA source of the port into a shared library with a plain C
interface, once per source content.

``nvcc`` compiles for ``sm_90a`` (no fast-math: the kernels' divisions,
``exp`` and ``pow`` stay IEEE) into ``build/<name>/<hash>/lib<name>.so`` at
the repository root; the hash covers the source and the flags, so an edited
source builds anew and an unchanged one is built once. The libraries are
loaded with ``ctypes`` by the kernel modules (``ops/overlap_cuda.py``,
``ops/lbl_cuda.py``), which call ``build`` at their first launch.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_ROOT = os.path.join(os.path.dirname(PACKAGE_DIR), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def source_path(name: str) -> str:
    """Path of ``csrc/<name>.cu`` in the package."""
    return os.path.join(PACKAGE_DIR, "csrc", f"{name}.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` (once per source content) and return
    ``{"path", "seconds", "ptxas"}``; ``seconds`` is 0 when it was built
    before. Raises if nvcc is missing or fails."""
    source = source_path(name)
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out_dir = os.path.join(BUILD_ROOT, name, digest.hexdigest()[:16])
    lib = os.path.join(out_dir, f"lib{name}.so")
    log = os.path.join(out_dir, "ptxas.txt")
    if os.path.exists(lib):
        with open(log) as f:
            return {"path": lib, "seconds": 0.0, "ptxas": f.read()}
    nvcc = _nvcc()
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"no nvcc at {nvcc}: the kernel is built with the "
                           "CUDA toolkit (set CUDA_HOME or PATH)")
    os.makedirs(out_dir, exist_ok=True)
    # each building process writes its own file and renames it into place
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stderr}"
        )
    with open(log, "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, lib)
    return {"path": lib, "seconds": seconds, "ptxas": proc.stderr}
