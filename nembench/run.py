"""Run one cell of the benchmark and print its result line.

    python3 -m nembench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Needs a CUDA card (exits 2 without one) and
the program ``archnemesis_tpu_torch`` beside ``nembench/``; exits 3 if the
process has loaded JAX or the JAX package by the end of the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "archnemesis_tpu"})


def forbidden_modules(modules=None) -> list:
    """Top-level names of ``modules`` (default ``sys.modules``) that are
    JAX or the JAX package, compared whole: ``archnemesis_tpu_torch`` is
    not ``archnemesis_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from nembench.harness import loop
    from nembench.harness import manifest as mf

    book = mf.load()
    cell = mf.cell(book, args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"nembench: {args.workload} needs {cell['chips']} CUDA "
              "card(s); none found", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    result = loop.run_cell(book, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"nembench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
