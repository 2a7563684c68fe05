"""Small host-side maths helpers (port of the JAX package's
``utils/maths.py``; reference ``helpers/maths_helper.py``)."""

from __future__ import annotations

import numpy as np


def is_diagonal(a: np.ndarray) -> bool:
    """True when the off-diagonal of a square matrix is all zero
    (reference maths_helper.is_diagonal:14; used for the OE fast paths on
    diagonal SE/SA). Non-mutating."""
    a = np.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        return False
    off = a.copy()
    np.fill_diagonal(off, 0)
    return bool(np.all(off == 0))


def is_monotonically_increasing(a: np.ndarray, axis: int = -1) -> bool:
    """Strict monotonicity along an axis (reference
    maths_helper.is_monotonically_increasing:38)."""
    a = np.asarray(a)
    return bool(np.all(np.diff(a, axis=axis) > 0))


def ngauss(x: np.ndarray, amp, mean, fwhm) -> np.ndarray:
    """Sum of N gaussians parameterised by amplitude/centre/FWHM
    (reference maths_helper.ngauss:45; basis of the model-500 CIA
    parameterisation and .fil instrument shapes)."""
    x = np.asarray(x, dtype=float)
    amp = np.atleast_1d(np.asarray(amp, dtype=float))
    mean = np.atleast_1d(np.asarray(mean, dtype=float))
    fwhm = np.atleast_1d(np.asarray(fwhm, dtype=float))
    sigma = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    return np.sum(
        amp[:, None]
        * np.exp(-0.5 * ((x[None, :] - mean[:, None]) / sigma[:, None]) ** 2),
        axis=0,
    )
