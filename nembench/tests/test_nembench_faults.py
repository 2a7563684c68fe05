"""A run with the timed path broken underneath comes out not correct, and
so does the control (the reference in bfloat16 in the program's place),
at a cut width on the CPU; the sound program comes out correct."""

import time

import pytest
import torch

from nembench.control import run_control
from nembench.harness import loop
from nembench.harness import manifest as mf
from .nembench_cases import book, cut_spec, few_threads  # noqa: F401

CELLS = {"jupiter_ck": "jupiter_ck.fwd_stream", "co_lbl": "co_lbl.fwd_stream"}


def broken(fault):
    """A program factory: the port with ``fault`` planted where each
    answer is produced."""

    def factory(spec, seed, device):
        _, module = mf.config(spec["name"])
        program = module.Program(spec, seed, device)
        first = []

        class Broken:
            def forward(self, t, mult):
                y = program.forward(t, mult)
                if fault == "state_unchanged":
                    first.append(y) if not first else None
                    return first[0]
                if fault == "answer_altered":
                    return y * torch.where(
                        torch.arange(y.shape[0]) == y.shape[0] // 3,
                        1.1, 1.0).to(y.dtype)
                if fault == "half_left_out":
                    return torch.cat([y[: y.shape[0] // 2],
                                      torch.zeros_like(y[y.shape[0] // 2:])])
                raise ValueError(fault)

        return Broken()

    return factory


def _run(book, spec, program=None, seconds=0.0):
    return loop.run_cell(book, CELLS[spec["name"]], 20261018, seconds, False,
                         "cpu", time.perf_counter(), spec=spec,
                         program=program, min_calls=4)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_program_is_correct(book, cut_spec, name):
    assert _run(book, cut_spec(name))["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "half_left_out"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_planted_fault_is_not_correct(book, cut_spec, name, fault):
    result = _run(book, cut_spec(name), program=broken(fault))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_is_not_correct(book, cut_spec, name):
    result = run_control(book, CELLS[name], 20261018, "cpu",
                         spec=cut_spec(name))
    assert not result["correct"], result["checks"]
