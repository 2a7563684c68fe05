"""Build a CUDA source of the port into a shared library with a plain C
interface, once per source content.

``nvcc`` compiles for ``sm_90a`` (no fast-math: the kernels' divisions,
``exp`` and ``pow`` stay IEEE) into ``build/<name>/<hash>/lib<name>.so`` at
the repository root; the hash covers the source, every local header it
includes (``#include "..."``, found beside the including file, recursively)
and the flags, so an edited source or header builds anew and an unchanged
one is built once. The libraries are
loaded with ``ctypes`` by the kernel modules (``ops/overlap_cuda.py``,
``ops/lbl_cuda.py``), which call ``build`` at their first launch.
"""

from __future__ import annotations

import hashlib
import os
import re
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


_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def local_sources(path: str) -> list:
    """``path`` and every file it includes with ``#include "..."`` that
    lies beside the including file, recursively, each once, in the order
    first met."""
    order, todo = [], [os.path.abspath(path)]
    while todo:
        current = todo.pop(0)
        if current in order:
            continue
        order.append(current)
        with open(current) as f:
            text = f.read()
        here = os.path.dirname(current)
        for name in _LOCAL_INCLUDE.findall(text):
            found = os.path.join(here, name)
            if os.path.isfile(found):
                todo.append(os.path.abspath(found))
    return order


def source_digest(path: str) -> str:
    """The build's key: a hash of the source, its local headers
    (``local_sources``) and the flags. Needs no nvcc."""
    digest = hashlib.sha256()
    for source in local_sources(path):
        with open(source, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` (once per content of the source and its
    headers) and return
    ``{"path", "seconds", "ptxas"}``; ``seconds`` is 0 when it was built
    before. Raises if nvcc is missing or fails."""
    source = source_path(name)
    out_dir = os.path.join(BUILD_ROOT, name, source_digest(source))
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
