"""The call ``forward``: one forward of the configuration's program on a
state, ended when its spectrum is on the host."""

import torch

# the check's numbers: relative error of the spectrum at the compared waves
CHECKS = ("spec_rel_err",)


def call(program, t, mult):
    """The timed call: the spectrum, copied to the host."""
    return program.forward(t, mult).cpu()


def finite(output) -> bool:
    return bool(torch.isfinite(output).all())


def end_to_end(spec, n_done: int, elapsed: float) -> dict:
    """End-to-end metrics of the window other than ``setup_s``."""
    return {"fwd_waves_per_s": n_done * spec["nwave"] / elapsed}


def compare(reference, output, t, mult, waves) -> dict:
    """The check's numbers for one call: ``output`` the program's, ``t``,
    ``mult`` its state in float64."""
    y_ref = reference.forward(t, mult, waves).cpu()
    y = output[waves].to(torch.float64)
    return {"spec_rel_err": ((y - y_ref).abs() / y_ref.abs()).max().item()}
