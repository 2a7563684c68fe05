"""ctypes bindings for the fixed-width catalogue decoder (host C++).

Port of the JAX package's ``native/__init__.py``. The decoder is the
repository's ``native/src/fixed_width.cpp``: a multithreaded columnar
decode of fixed-width records behind a plain C interface, loaded with
``ctypes``. It is host code, not a CUDA kernel: it turns a catalogue file
into the line columns that kernel 2 (``ops/lbl_cuda.py``) consumes.

The library is built at the first call that needs it, with the JAX
package's flags (``g++ -O3 -march=native -std=c++17 -fPIC -shared
-pthread``; ``$CXX`` names another compiler), into
``build/native/<hash>/libansio.so`` at the repository root. The hash
covers the source, the compiler's version, the flags and the target
macros that ``-march=native`` gives on this host (a library built for
another processor is never loaded). A failed build raises with the
compiler's output: no caller falls back to numpy unless it asks for it
(``use_native=False`` in ``io/hitran.py`` and ``io/geisa.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "src", "fixed_width.cpp")
BUILD_ROOT = os.path.join(_REPO, "build", "native")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-pthread")
_ABI_VERSION = 1

# field kinds understood by ans_parse_fixed
KIND_F64 = 0
KIND_I32 = 1
KIND_ISO_CHAR = 2

_lock = threading.Lock()
_lib = None


def compiler() -> str:
    """The host C++ compiler: ``$CXX`` if set, else ``g++``; raises if it
    is not on the PATH."""
    name = os.environ.get("CXX", "g++")
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"no C++ compiler {name!r} on the PATH: the "
                           "fixed-width decoder is built with one (set CXX)")
    return found


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300)


def _output(cmd) -> str:
    """The standard output of a compiler query; raises if it fails."""
    proc = _run(cmd)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    return proc.stdout


def build() -> dict:
    """Compile the decoder once per key (a hash of the source, the flags,
    the compiler's version and the macros ``-march=native`` defines here)
    and return ``{"path", "seconds", "compiler"}`` (``seconds`` 0 when it
    was built before); raises with the compiler's output when the build
    fails."""
    cxx = compiler()
    version = _output([cxx, "--version"])
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    for part in (" ".join(CXX_FLAGS), version, _output(
            [cxx, "-march=native", "-dM", "-E", "-x", "c++", os.devnull])):
        digest.update(part.encode())
    out_dir = os.path.join(BUILD_ROOT, digest.hexdigest()[:16])
    lib = os.path.join(out_dir, "libansio.so")
    built = {"path": lib, "seconds": 0.0,
             "compiler": version.splitlines()[0]}
    if os.path.exists(lib):
        return built
    os.makedirs(out_dir, exist_ok=True)
    # each building process writes its own file and renames it into place
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = _run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE])
    built["seconds"] = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return built


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path = build()["path"]
            lib = ctypes.CDLL(path)
            lib.ans_abi_version.restype = ctypes.c_int32
            lib.ans_abi_version.argtypes = []
            if lib.ans_abi_version() != _ABI_VERSION:
                raise RuntimeError(
                    f"{path} has ABI {lib.ans_abi_version()}, "
                    f"this binding {_ABI_VERSION}")
            lib.ans_parse_fixed.restype = ctypes.c_int64
            lib.ans_parse_fixed.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ]
            _lib = lib
        return _lib


def available() -> bool:
    """True when the decoder loads, building it if needed; a failed build
    raises (with the compiler's output) rather than returning False."""
    return _load() is not None


def parse_fixed(buf: bytes, stride: int, cols, nthreads: int = 0):
    """Decode fixed-width records with the C++ engine.

    buf    : raw bytes, nlines * stride long (records + newline padding)
    stride : record width including the newline
    cols   : list of (name, start, stop, kind) with kind in
             {KIND_F64, KIND_I32, KIND_ISO_CHAR}
    Returns {name: (nlines,) ndarray}; raises RuntimeError when the library
    does not build, ValueError on malformed numeric fields.
    """
    lib = _load()
    nlines = len(buf) // stride
    if nlines * stride != len(buf):
        raise ValueError(
            f"buffer length {len(buf)} not a multiple of stride {stride}"
        )
    for name, start, stop, _ in cols:
        if not 0 <= start < stop <= stride:
            raise ValueError(f"field {name} spans bytes {start}:{stop} of "
                             f"a {stride}-byte record")

    nf = len(cols)
    starts = np.array([c[1] for c in cols], dtype=np.int32)
    widths = np.array([c[2] - c[1] for c in cols], dtype=np.int32)
    kinds = np.array([c[3] for c in cols], dtype=np.int32)
    outs = {}
    ptrs = (ctypes.c_void_p * nf)()
    for i, (name, _, _, kind) in enumerate(cols):
        arr = np.empty(
            nlines, dtype=np.float64 if kind == KIND_F64 else np.int32
        )
        outs[name] = arr
        ptrs[i] = arr.ctypes.data_as(ctypes.c_void_p).value

    errs = lib.ans_parse_fixed(
        ctypes.c_char_p(buf), stride, nlines, nf,
        starts.ctypes.data_as(ctypes.c_void_p),
        widths.ctypes.data_as(ctypes.c_void_p),
        kinds.ctypes.data_as(ctypes.c_void_p),
        ptrs, nthreads,
    )
    if errs:
        raise ValueError(f"{errs} malformed fields in fixed-width decode")
    return outs
