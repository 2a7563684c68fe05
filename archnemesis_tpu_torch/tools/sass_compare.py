"""Compare the SASS of the kernels of two CUDA sources, instantiation by
instantiation.

    python -m archnemesis_tpu_torch.tools.sass_compare OLD.cu NEW.cu \\
        KERNEL [KERNEL ...]

Compiles both sources with the port's flags (``ops/cuda_build.NVCC_FLAGS``)
into ``build/sass_compare/``, disassembles them with ``cuobjdump -sass`` and
prints, for every instantiation of each named kernel, its instruction count
in both and whether the two opcode sequences are equal. Exits 1 where an
instantiation is missing from one side or differs. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

from archnemesis_tpu_torch.ops import cuda_build
from archnemesis_tpu_torch.tools.common import SASS_LINE, cuobjdump

OUT_DIR = os.path.join(cuda_build.BUILD_ROOT, "sass_compare")
_FUNCTION = re.compile(r"Function : (\S+)")


def compile_source(source: str, out: str) -> str:
    """``nvcc`` of ``source`` into the shared library ``out``."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           out, source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return out


def kernel_opcodes(lib: str, kernels) -> dict:
    """{instantiation: [opcode, ...]} of the named kernels in ``lib``. An
    instantiation is named from the kernel's name on in its mangled name
    (template arguments and parameters), which leaves out the enclosing
    namespaces, the anonymous one's file hash among them."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("no cuobjdump in the CUDA toolkit")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    found, current = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            current = None
            for kernel in kernels:
                at = name.find(kernel)
                if at >= 0:
                    current = name[at:]
                    found[current] = []
            continue
        m = SASS_LINE.match(line)
        if current is not None and m:
            found[current].append(m.group(1))
    return found


def compare(old_source: str, new_source: str, kernels) -> list:
    """[(instantiation, old count or None, new count or None, equal)] for
    every instantiation of the named kernels in either build."""
    libs = [compile_source(src, os.path.join(OUT_DIR, f"{tag}.so"))
            for tag, src in (("old", old_source), ("new", new_source))]
    old, new = (kernel_opcodes(lib, kernels) for lib in libs)
    rows = []
    for key in sorted(set(old) | set(new)):
        a, b = old.get(key), new.get(key)
        rows.append((key, None if a is None else len(a),
                     None if b is None else len(b), a == b))
    return rows


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 3:
        raise SystemExit(__doc__)
    old_source, new_source, kernels = args[0], args[1], args[2:]
    rows = compare(old_source, new_source, kernels)
    for key, a, b, equal in rows:
        print(f"{key}: {a} / {b} instructions (old / new), opcode sequence "
              f"{'equal' if equal else 'DIFFERS'}", flush=True)
    same = bool(rows) and all(equal for *_, equal in rows)
    print(f"{len(rows)} instantiations of {', '.join(kernels)}: "
          f"{'all equal' if same else 'not all equal'}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
