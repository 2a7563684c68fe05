"""The frozen bound counts equal the port's card script's for the same
shapes and inputs."""

import numpy as np
import pytest
import torch

import chip_smoke
from nembench.harness import bounds
from nembench.harness import manifest as mf
from nembench.reference import lbl
from .nembench_cases import cut_spec, few_threads  # noqa: F401


@pytest.mark.parametrize("ng", [1, 2, 10, 20, 32])
@pytest.mark.parametrize("presorted", [True, False])
def test_combine_counts_equal_the_card_script(ng, presorted):
    assert bounds.combine_ops_per_row(ng, presorted) == \
        chip_smoke.combine_ops_per_row(ng, presorted)
    rows = 8192 * 71
    for itemsize in (4, 8):
        assert bounds.combine_bound_ms(rows, ng, itemsize, presorted) == \
            chip_smoke.combine_bound_ms(rows, ng, itemsize, presorted)[0]


def test_lbl_counts_equal_the_card_script(cut_spec):
    from archnemesis_tpu_torch.ops.lbl import layer_line_params

    spec = cut_spec("co_lbl")
    _, module = mf.config("co_lbl")
    program = module.Program(spec, 0, "cpu")
    ref = module.Reference(spec, 0, "cpu")
    ll, blocks = program.rt.line_lists[0], program.rt.blocks[0]
    assert np.array_equal(ll.nu, ref.lines.nu)
    t = torch.linspace(150.0, 250.0, 5, dtype=torch.float64)
    p = torch.logspace(-4, 0, 5, dtype=torch.float64)
    amb = torch.full((5,), 0.9, dtype=torch.float64)
    ours = [x.numpy() for x in lbl.line_parameters(ref.lines, t, p, amb)]
    theirs = [x.numpy() for x in layer_line_params(ll, t, p, amb)]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=0)
    ln = spec["lines"]
    counts = bounds.lbl_pair_counts(ll.nu, *theirs, ref.wave, ln["wn_calc"],
                                    ln["wn_approx"])
    assert counts == chip_smoke.lbl_pair_counts(ll, blocks, t.numpy(),
                                                p.numpy(), amb.numpy())
    for itemsize in (4, 8):
        ms = bounds.lbl_bound_ms(ll.nu, *theirs, ref.wave, ln["wn_calc"],
                                 ln["wn_approx"], itemsize)
        want = chip_smoke.lbl_bound_ms(ll, blocks, t.numpy(), p.numpy(),
                                       amb.numpy(), itemsize)[0]
        assert ms == pytest.approx(want, rel=1e-12)
