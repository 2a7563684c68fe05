"""The call ``jacobian``: one forward-plus-Jacobian evaluation of the
configuration's program on a state (an optimal-estimation iteration's
work), ended when the spectrum and the Jacobian are on the host."""

import sys

import torch

# the check's numbers: relative error of the spectrum at the compared
# waves, and of each Jacobian column there against its peak
CHECKS = ("spec_rel_err", "jac_rel_err")


def call(program, t, mult):
    """The timed call: (spectrum (NWAVE,), K (NWAVE, NX)), copied to the
    host."""
    y, kk = program.jacobian(t, mult)
    return y.cpu(), kk.cpu()


def finite(output) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in output)


def end_to_end(spec, n_done: int, elapsed: float) -> dict:
    """End-to-end metrics of the window other than ``setup_s``: the
    spectral points of the evaluations completed, per second."""
    return {"fwd_waves_per_s": n_done * spec["nwave"] / elapsed}


def jac_rel_err(kk, k_ref):
    """(error, floored columns): the largest over the columns j of
    max_i |K_ij - K^ref_ij| / max(max_i |K^ref_ij|, float32's smallest
    normal number). A column whose float64 peak lies under that number
    (float32 holds none of its values) is still held to it: the program's
    values there have to be near 0, within the limit times 1.2e-38."""
    peak = k_ref.abs().max(dim=0).values
    tiny = torch.finfo(torch.float32).tiny
    err = (kk - k_ref).abs().max(dim=0).values / peak.clamp_min(tiny)
    return err.max().item(), int((peak < tiny).sum())


def compare(reference, output, t, mult, waves) -> dict:
    """The check's numbers for one call: ``output`` the program's, ``t``,
    ``mult`` its state in float64."""
    y_ref, k_ref = (x.cpu() for x in reference.jacobian(t, mult, waves))
    y, kk = (x[waves].to(torch.float64) for x in output)
    err, floored = jac_rel_err(kk, k_ref)
    print(f"jac_rel_err: {floored} of {k_ref.shape[1]} columns' float64 "
          "peaks under 1.2e-38, held to it", file=sys.stderr)
    return {"spec_rel_err": ((y - y_ref).abs() / y_ref.abs()).max().item(),
            "jac_rel_err": err}
