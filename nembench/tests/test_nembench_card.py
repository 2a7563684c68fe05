"""Each cell for a second on the card, correct; and the control there
not correct."""

import time

import pytest
import torch

from nembench.control import run_control
from nembench.harness import loop
from .nembench_cases import book  # noqa: F401


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["jupiter_ck.fwd_stream",
                                  "co_lbl.fwd_stream"])
def test_cell_on_the_card(book, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    result = loop.run_cell(book, cell, 7, 1.0, False, "cuda",
                           time.perf_counter())
    assert result["correct"], result["checks"]
    assert not run_control(book, cell, 7, "cuda")["correct"]
