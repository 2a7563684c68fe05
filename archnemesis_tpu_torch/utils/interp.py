"""1D interpolation and quadrature primitives on tensors.

Numerics match the reference's linear interpolation with extrapolation
(``Layer_0.py:627`` interp, scipy interp1d fill_value='extrapolate'), as
the JAX package's ``utils/interp.py`` does.
"""

import numpy as np
import torch


def _search(xp, x, right):
    """``searchsorted`` of an x of any shape (0-d included) into 1-D xp."""
    x = torch.as_tensor(x, dtype=xp.dtype, device=xp.device)
    j = torch.searchsorted(xp, x.reshape(-1).contiguous(), right=right)
    return j.reshape(x.shape), x


def interp1d_extrap(xp, fp, x):
    """Linear interpolation of ``fp(xp)`` at ``x`` with linear extrapolation
    beyond both ends (edge segments are extended).

    xp must be strictly increasing. x may have any shape; fp may have
    trailing feature dims (interpolated along axis 0).
    """
    j, x = _search(xp, x, right=True)
    shape = x.shape
    # gather with a 1-D index: a 0-d one is read back to the host
    j = j.reshape(-1).clamp(1, xp.shape[0] - 1)
    x = x.reshape(-1)
    x0 = xp[j - 1]
    x1 = xp[j]
    f = (x - x0) / (x1 - x0)
    y0 = fp[j - 1]
    y1 = fp[j]
    if fp.ndim > 1:
        f = f.reshape(f.shape + (1,) * (fp.ndim - 1))
    return ((1.0 - f) * y0 + f * y1).reshape(shape + fp.shape[1:])


def interp1d_extrap_with_weights(xp, x):
    """Return (j, f) such that y = (1-f)*fp[j-1] + f*fp[j] reproduces
    interp1d_extrap."""
    j, x = _search(xp, x, right=True)
    j = j.clamp(1, xp.shape[0] - 1)
    f = (x - xp[j - 1]) / (xp[j] - xp[j - 1])
    return j, f


def interp(x, xp, fp, left=None, right=None):
    """``numpy.interp`` with constant ``left``/``right`` fill values (the
    arithmetic of ``jnp.interp``); as there, they default to the end
    values of ``fp``."""
    left = fp[0] if left is None else left
    right = fp[-1] if right is None else right
    i, x = _search(xp, x, right=True)
    i = i.clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(torch.finfo(xp.dtype).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(
        dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df
    )
    f = torch.where(x < xp[0], left, f)
    return torch.where(x > xp[-1], right, f)


def linspace(start, stop, num: int):
    """``jnp.linspace(start, stop, num)`` for 0-d tensor endpoints:
    ``start*(1-s) + stop*s`` with s = i/(num-1), and ``stop`` appended."""
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def simpson_weights(n: int, dtype=np.float64) -> np.ndarray:
    """Composite-Simpson quadrature weights for n evenly spaced samples with
    unit spacing (matches scipy.integrate.simpson for odd n; for even n,
    Simpson on the first n-1 points + trapezoid on the last step).

    Multiply by the actual sample spacing h. Host numpy: n is static.
    """
    if n < 2:
        raise ValueError("need at least 2 samples")
    if n == 2:
        return np.array([0.5, 0.5], dtype=dtype)
    w = np.zeros(n, dtype=np.float64)
    if n % 2 == 1:
        w[0] = 1.0
        w[-1] = 1.0
        w[1:-1:2] = 4.0
        w[2:-1:2] = 2.0
        w /= 3.0
    else:
        w[: n - 1] = simpson_weights(n - 1)
        w[-2] += 0.5
        w[-1] += 0.5
    return w.astype(dtype)


def simpson(y, x0_spacing, dim=-1):
    """Integrate samples y along ``dim`` with uniform spacing
    ``x0_spacing`` using composite Simpson weights."""
    n = y.shape[dim]
    w = torch.as_tensor(simpson_weights(n), dtype=y.dtype, device=y.device)
    shape = [1] * y.ndim
    shape[dim] = n
    return torch.sum(y * w.reshape(shape), dim=dim) * x0_spacing
