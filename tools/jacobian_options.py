"""Time and peak memory of the ways to take the Jacobian of the benchmark's
``jupiter_ck`` deck at its full widths on the card.

    python tools/jacobian_options.py [--evals N] [names ...]

The state is ``nembench/configs/jupiter_ck_oe.json``'s: the 81 level
temperatures and one scale factor for each of the 5 scaled gases (NX =
86), over 8,192 waves x 20 g x 71 layers x 7 gases in float32. Each name
is one way to the Jacobian, through ``retrieval/oe.py:
forward_and_jacobian`` but for the chunks:

- ``factored``: the port's path, k in factored form
  (``ops/ktab.py:interp_ktables_factored``), each gas's tangent formed
  where its combine takes it, all 86 tangents in one pass;
- ``chunk43``, ``chunk22``: the same in 2 or 4 chunks of tangents
  (``torch.func.vmap`` over ``jvp`` with ``chunk_size``), each chunk a
  forward pass of its own, primal included;
- ``pergas``: k interpolated gas by gas where the combine takes it, the
  tangent by ``interp_ktables``'s own rule (the factored form left out);
- ``whole``: ``interp_ktables`` over every gas at once under the
  tangents, as before the factored form (expected to run out of memory).

Prints one JSON line per name: the mean wall ms of an evaluation (ended
when the spectrum and K are on the host) over ``--evals`` after one
warm-up, the allocator's peak GiB over them, and the largest difference
of K from ``factored``'s relative to each column's peak; or how it
failed. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NAMES = ("factored", "chunk43", "chunk22", "pergas", "whole")


def _pergas_interp(k, press_grid, temp_grid, press, temp, logk=None):
    """A ``LayerK`` whose gases are interpolated one at a time by
    ``interp_ktables`` (tangent by its own rule)."""
    from archnemesis_tpu_torch.ops.ktab import LayerK, interp_ktables

    class PerGas(LayerK):
        def tau(self, i, amount):
            one = interp_ktables(k[i:i + 1], press_grid, temp_grid, press,
                                 temp, None if logk is None
                                 else logk[i:i + 1])[..., 0]
            return (one.permute(0, 2, 1) * amount[None, :, None]).contiguous()

    shape = (k.shape[0], k.shape[1], press.shape[0], k.shape[2])
    empty = torch.empty(shape, dtype=k.dtype, device="meta")
    return PerGas(k=empty, dk_dv=empty, dk_du=empty, v=None, u=None)


def _chunked(fn, x, chunk):
    """(fn(x), its Jacobian) with the tangents pushed through ``chunk`` at
    a time."""
    basis = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    yns, cols = torch.func.vmap(lambda v: torch.func.jvp(fn, (x,), (v,)),
                                chunk_size=chunk)(basis)
    return yns[0], cols.movedim(0, -1)


def evaluate(name, fn, x):
    """(spectrum, K) of one evaluation on the host by way ``name``."""
    from archnemesis_tpu_torch import forward
    from archnemesis_tpu_torch.retrieval.oe import forward_and_jacobian

    chunk = {"chunk43": 43, "chunk22": 22}.get(name)
    saved = forward.interp_ktables_factored, forward.has_tangent
    if name == "pergas":
        forward.interp_ktables_factored = _pergas_interp
    if name == "whole":
        forward.has_tangent = lambda *ts: False
    try:
        y, kk = (forward_and_jacobian(fn, x) if chunk is None
                 else _chunked(fn, x, chunk))
        return y.cpu(), kk.cpu()
    finally:
        forward.interp_ktables_factored, forward.has_tangent = saved


def main(argv=None) -> int:
    from archnemesis_tpu_torch.tools.common import card_line, require_cuda
    from nembench.harness import manifest as mf
    from nembench.harness import traffic as tf

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--evals", type=int, default=3)
    parser.add_argument("names", nargs="*", default=list(NAMES))
    args = parser.parse_args(argv)
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": card_line(), "torch": torch.__version__}),
          flush=True)
    spec, module = mf.config("jupiter_ck_oe")
    program = module.Program(spec, 20261018, "cuda")
    t, mult = tf.states(dict(mf.traffic("jac_iter"), states=1),
                        module.profiles(spec)["t"],
                        len(spec["scaled_gases"]), 7, "cuda")
    dtype = getattr(torch, spec["dtype"])
    x, fn = program.state_function(t[0].to(dtype), mult[0].to(dtype))
    base = None
    for name in args.names:
        line = {"name": name}
        try:
            evaluate(name, fn, x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(args.evals):
                y, kk = evaluate(name, fn, x)
            line["ms"] = (time.perf_counter() - t0) * 1e3 / args.evals
            line["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            base = kk if base is None else base
            peak = base.abs().max(dim=0).values
            line["k_diff"] = float(((kk - base).abs().max(dim=0).values
                                    / peak.double()).nan_to_num().max())
        except torch.cuda.OutOfMemoryError as err:
            line["failed"] = str(err).splitlines()[0]
            line["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
