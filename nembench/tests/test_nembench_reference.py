"""The plain reference against the port on the CPU at a cut width: in
float64 they compute the same spectrum; and the reference's Voigt profile
against an independent Faddeeva function."""

import numpy as np
import pytest
import torch

from nembench.harness import manifest as mf
from nembench.harness import traffic as tf
from nembench.reference import lbl
from .nembench_cases import cut_spec, few_threads  # noqa: F401


@pytest.mark.parametrize("name", ["jupiter_ck", "co_lbl"])
def test_reference_matches_port_in_float64(name, cut_spec):
    spec = cut_spec(name, "float64")
    _, module = mf.config(name)
    mix = mf.traffic("fwd_stream")
    t, mult = tf.states(dict(mix, states=3), module.profiles(spec)["t"],
                        len(spec["scaled_gases"]), 99, "cpu")
    program = module.Program(spec, 5, "cpu")
    ref = module.Reference(spec, 5, "cpu")
    waves = np.arange(spec["nwave"])
    for i in range(3):
        y = program.forward(t[i], mult[i])
        y_ref = ref.forward(t[i], mult[i], waves)
        rel = ((y - y_ref).abs() / y_ref.abs()).max().item()
        assert rel < 1e-10, (i, rel)


def test_reference_voigt_against_faddeeva():
    special = pytest.importorskip("scipy.special")
    x = np.concatenate([np.linspace(-30, 30, 601), np.geomspace(30, 3e4, 60)])
    for y in (1e-4, 1e-2, 0.3, 1.0, 5.0, 40.0):
        ours = lbl.faddeeva_re(torch.as_tensor(x), torch.full((x.size,), y,
                               dtype=torch.float64)).numpy()
        exact = special.wofz(x + 1j * y).real
        # Weideman's 24 terms: the reference's own approximation, within
        # 2e-6 of its peak and 5e-5 of each value in the wings used here
        assert np.abs(ours - exact).max() < 2e-6 * np.abs(exact).max()
