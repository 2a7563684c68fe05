"""Fixtures of the benchmark's tests: the manifest, cut sizes of the
configurations that a CPU test can hold, few CPU threads."""

import copy
import os

import pytest
import torch

from nembench.harness import manifest as mf

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def book():
    return mf.load()


def cut(name: str, dtype: str = "float32") -> dict:
    """The configuration ``name`` at a width a CPU test holds: 64 waves of
    jupiter_ck, 512 waves and 2 copies of the lines of co_lbl; every
    other size as the cell runs it."""
    spec = copy.deepcopy(mf.config(name)[0])
    spec["dtype"] = dtype
    if name == "jupiter_ck":
        spec["nwave"] = 64
    else:
        spec["nwave"] = 512
        spec["wave_start"] = 2140.0
        spec["lines"]["copies"] = 2
    return spec


@pytest.fixture
def cut_spec():
    return cut
