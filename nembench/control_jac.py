"""The control of a Jacobian cell's comparison: the plain reference's
spectrum and Jacobian computed in bfloat16 (the precision below the
float32 the configurations state) in the program's place, run through the
rest of a run. Its readings set the upper end of each limit; the
benchmark's own runs never run it.

    python3 -m nembench.control_jac --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed with the numbers compared and their limits.
(``nembench/control.py`` is the forward cells' control: its program writes
the compared waves into its output in place, which ``jacfwd`` refuses, so
this one takes the reference's own ``jacobian`` and places its rows after
it.)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from nembench.harness import loop
from nembench.harness import manifest as mf
from nembench.harness import traffic as tf


def control_program(module, mix: dict):
    """A program factory whose ``jacobian`` is the configuration's
    reference in bfloat16 at the waves the comparison reads (zero rows
    elsewhere: they are not compared)."""

    class Control:
        def __init__(self, spec, seed, device):
            self.ref = module.Reference(spec, seed, device, torch.bfloat16)
            self.waves = tf.check_waves(mix, spec["nwave"], seed)
            self.nwave = spec["nwave"]

        def jacobian(self, t, mult):
            y, kk = self.ref.jacobian(t.to(torch.float64),
                                      mult.to(torch.float64), self.waves)
            rows = torch.as_tensor(self.waves, device=y.device)
            y_out = y.new_zeros(self.nwave, dtype=torch.float32)
            k_out = kk.new_zeros((self.nwave, kk.shape[1]),
                                 dtype=torch.float32)
            y_out[rows] = y.float()
            k_out[rows] = kk.float()
            return y_out, k_out

    return Control


def run_control(book, cell_name: str, seed: int, device, spec=None,
                seconds: float = 0.0) -> dict:
    """One control run: the result object of ``loop.run_cell`` with the
    control in the program's place, comparing as many calls as a run."""
    cell = mf.cell(book, cell_name)
    _, module = mf.config(cell["config"])
    mix = mf.traffic(cell["traffic"])
    return loop.run_cell(book, cell_name, seed, seconds, False, device,
                         time.perf_counter(), spec=spec,
                         program=control_program(module, mix),
                         min_calls=mix["check"]["calls"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("nembench.control_jac: needs a CUDA card", file=sys.stderr)
        return 2
    book = mf.load()
    for seed in args.seeds:
        r = run_control(book, args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
