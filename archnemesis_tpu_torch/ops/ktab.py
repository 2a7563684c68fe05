"""Correlated-k / LBL table interpolation to layer (P, T) points.

Port of the JAX package's ``ops/ktab.py`` (reference ``Spectroscopy_0.py:2147``
calc_kg): a searchsorted bracket over all layers at once and one
log-bilinear blend over the (gas, wave, g, layer) block.

Reference semantics preserved exactly:
- bilinear in (ln P, T) of ln k where all 4 surrounding table values are > 0;
- bilinear of raw k where all 4 are <= 0 (all-zero regions);
- zero where the 4 corners are mixed sign;
- out-of-range P/T clamp to the table edges (v,u in [0,1]).

Under forward-mode derivatives (``torch.func.jvp``/``jacfwd``) of a
correlated-k forward, ``interp_ktables_factored`` takes its place: k
depends on the state only through each layer's bracket fractions (v in
ln P, u in T), so the tangent of gas i's k is ``dk_dv[i] dv + dk_du[i]
du``, two primal-sized factors times (NLAY,) tangents. ``LayerK.tau``
forms one gas's tangent at a time, where the random overlap takes it,
and the (NX, NGAS, NWAVE, NG, NLAY) tangent of the whole table never
exists.
"""

from dataclasses import dataclass

import numpy as np
import torch

LOG_POS_THRESH = -8.0e8  # sentinel cut: host logk stores -1e9 where k <= 0


def _bracket(grid, x):
    """Indices (lo, hi) and clamped fraction for linear interpolation with
    edge clamping (the reference's argmin-based bracketing)."""
    hi = torch.searchsorted(grid, x.contiguous(), right=False)
    hi = hi.clamp(1, grid.shape[0] - 1)
    lo = hi - 1
    f = (x - grid[lo]) / (grid[hi] - grid[lo])
    return lo, hi, f.clamp(0.0, 1.0)


def host_log_ktable(k64):
    """Host-side float64 log of a k-table for the float32 path (numpy in,
    float32 numpy out).

    The table is static, so its logs are taken once on the host in float64
    and stored: no float32 device ``log`` of table values is needed. k <= 0
    entries get a -1e9 sentinel (the positivity mask survives the encoding);
    0 < k < float32-tiny clamps to log(tiny).
    """
    k64 = np.asarray(k64, np.float64)
    tiny = float(np.finfo(np.float32).tiny)
    out = np.where(k64 > 0.0, np.log(np.maximum(k64, tiny)), -1.0e9)
    return out.astype(np.float32)


def interp_ktables(k, press_grid, temp_grid, press, temp, logk=None):
    """Interpolate k-tables to layer pressure/temperature points.

    Parameters
    ----------
    k : (NGAS, NWAVE, NG, NP, NT) table k-coefficients [cm^2]
    press_grid : (NP,) table pressures [atm]
    temp_grid : (NT,) table temperatures [K]
    press : (NLAY,) layer pressures [atm]
    temp : (NLAY,) layer temperatures [K]
    logk : optional (NGAS, NWAVE, NG, NP, NT) ``host_log_ktable`` values.
        When given, the corner gathers read the log table and no device
        ``log`` is evaluated; regions where all 4 corners are <= 0 then
        return exactly 0 instead of the raw bilinear value.

    Returns
    -------
    kgood : (NWAVE, NG, NLAY, NGAS) (a view of a gas-major tensor)
    """
    lgrid = torch.log(press_grid)
    ipl, iphi, v = _bracket(lgrid, torch.log(press))  # (NLAY,)
    itl, ithi, u = _bracket(temp_grid, temp)  # (NLAY,)

    w11 = (1.0 - v) * (1.0 - u)
    w21 = v * (1.0 - u)
    w22 = v * u
    w12 = (1.0 - v) * u

    if logk is not None:
        l11 = logk[:, :, :, ipl, itl]
        l12 = logk[:, :, :, ipl, ithi]
        l21 = logk[:, :, :, iphi, itl]
        l22 = logk[:, :, :, iphi, ithi]
        loglin = w11 * l11 + w21 * l21 + w22 * l22 + w12 * l12
        all_pos = (
            (l11 > LOG_POS_THRESH) & (l12 > LOG_POS_THRESH)
            & (l21 > LOG_POS_THRESH) & (l22 > LOG_POS_THRESH)
        )
        out = torch.where(all_pos, torch.exp(loglin), 0.0)
        return out.movedim(0, -1)

    # corner gathers -> (NGAS, NWAVE, NG, NLAY)
    klo1 = k[:, :, :, ipl, itl]
    klo2 = k[:, :, :, ipl, ithi]
    khi1 = k[:, :, :, iphi, itl]
    khi2 = k[:, :, :, iphi, ithi]

    tiny = torch.finfo(k.dtype).tiny
    loglin = (
        w11 * torch.log(klo1.clamp_min(tiny))
        + w21 * torch.log(khi1.clamp_min(tiny))
        + w22 * torch.log(khi2.clamp_min(tiny))
        + w12 * torch.log(klo2.clamp_min(tiny))
    )
    lin = w11 * klo1 + w21 * khi1 + w22 * khi2 + w12 * klo2

    all_pos = (klo1 > 0.0) & (klo2 > 0.0) & (khi1 > 0.0) & (khi2 > 0.0)
    all_nonpos = (
        (klo1 <= 0.0) & (klo2 <= 0.0) & (khi1 <= 0.0) & (khi2 <= 0.0)
    )
    out = torch.where(
        all_pos, torch.exp(loglin), torch.where(all_nonpos, lin, 0.0)
    )
    return out.movedim(0, -1)


def interp_ktables_factored(k, press_grid, temp_grid, press, temp, logk=None):
    """``interp_ktables`` for forward-mode derivatives: the same k, bit for
    bit, with its derivatives in the bracket fractions, as a ``LayerK``.

    The factors are taken at the primal (the fractions detached); the
    tangents of ``press`` and ``temp`` ride the fractions kept in the
    ``LayerK``. Where the four corners are positive, k = exp(sum w l) and
    dk/dv = k (sum dw/dv l); where all are <= 0 (``logk`` None only), k is
    the plain bilinear blend and dk/dv its own slope; elsewhere k and its
    slopes are 0. Inputs as ``interp_ktables``'s.
    """
    lgrid = torch.log(press_grid)
    ipl, iphi, v = _bracket(lgrid, torch.log(press))  # (NLAY,)
    itl, ithi, u = _bracket(temp_grid, temp)  # (NLAY,)
    v0, u0 = v.detach(), u.detach()

    w11 = (1.0 - v0) * (1.0 - u0)
    w21 = v0 * (1.0 - u0)
    w22 = v0 * u0
    w12 = (1.0 - v0) * u0

    def slopes(c11, c12, c21, c22):
        """(d/dv, d/du) of the bilinear blend of the corner values."""
        return ((1.0 - u0) * (c21 - c11) + u0 * (c22 - c12),
                (1.0 - v0) * (c12 - c11) + v0 * (c22 - c21))

    if logk is not None:
        l11 = logk[:, :, :, ipl, itl]
        l12 = logk[:, :, :, ipl, ithi]
        l21 = logk[:, :, :, iphi, itl]
        l22 = logk[:, :, :, iphi, ithi]
        loglin = w11 * l11 + w21 * l21 + w22 * l22 + w12 * l12
        all_pos = (
            (l11 > LOG_POS_THRESH) & (l12 > LOG_POS_THRESH)
            & (l21 > LOG_POS_THRESH) & (l22 > LOG_POS_THRESH)
        )
        kk = torch.where(all_pos, torch.exp(loglin), 0.0)
        dv, du = slopes(l11, l12, l21, l22)
        dk_dv = torch.where(all_pos, kk * dv, 0.0)
        dk_du = torch.where(all_pos, kk * du, 0.0)
    else:
        klo1 = k[:, :, :, ipl, itl]
        klo2 = k[:, :, :, ipl, ithi]
        khi1 = k[:, :, :, iphi, itl]
        khi2 = k[:, :, :, iphi, ithi]
        tiny = torch.finfo(k.dtype).tiny
        g11, g12, g21, g22 = (torch.log(c.clamp_min(tiny))
                              for c in (klo1, klo2, khi1, khi2))
        loglin = w11 * g11 + w21 * g21 + w22 * g22 + w12 * g12
        lin = w11 * klo1 + w21 * khi1 + w22 * khi2 + w12 * klo2
        all_pos = (klo1 > 0.0) & (klo2 > 0.0) & (khi1 > 0.0) & (khi2 > 0.0)
        all_nonpos = (
            (klo1 <= 0.0) & (klo2 <= 0.0) & (khi1 <= 0.0) & (khi2 <= 0.0)
        )
        explin = torch.exp(loglin)
        kk = torch.where(all_pos, explin, torch.where(all_nonpos, lin, 0.0))
        dv, du = slopes(g11, g12, g21, g22)
        lv, lu = slopes(klo1, klo2, khi1, khi2)
        dk_dv = torch.where(all_pos, explin * dv,
                            torch.where(all_nonpos, lv, 0.0))
        dk_du = torch.where(all_pos, explin * du,
                            torch.where(all_nonpos, lu, 0.0))

    def wlg(x):  # (NGAS, NWAVE, NG, NLAY) -> (NGAS, NWAVE, NLAY, NG)
        return x.transpose(-1, -2).contiguous()

    return LayerK(k=wlg(kk), dk_dv=wlg(dk_dv), dk_du=wlg(dk_du), v=v, u=u)


@dataclass
class LayerK:
    """k of each gas at the layers in factored form
    (``interp_ktables_factored``): ``k``, ``dk_dv``, ``dk_du`` (NGAS,
    NWAVE, NLAY, NG), g the fast axis as the random overlap reads it, with
    no tangents; ``v``, ``u`` (NLAY,) the layers' bracket fractions in ln P
    and T, which carry the state's tangents."""

    k: torch.Tensor
    dk_dv: torch.Tensor
    dk_du: torch.Tensor
    v: torch.Tensor
    u: torch.Tensor

    @property
    def ngas(self) -> int:
        return self.k.shape[0]

    def tau(self, i: int, amount):
        """(NWAVE, NLAY, NG) optical depth of gas ``i``, k times its
        (NLAY,) ``amount`` [cm-2] (the same bits as the plain product); its
        tangent is formed here, for this gas alone."""
        return _GasTau.apply(self.v, self.u, amount, self.k[i],
                             self.dk_dv[i], self.dk_du[i])


class _GasTau(torch.autograd.Function):
    """(v, u, amount, k, dk_dv, dk_du) -> k * amount, with the forward-mode
    rule d(k amount) = amount (dk_dv dv + dk_du du) + k d(amount); the
    factors carry no tangent."""

    generate_vmap_rule = True

    @staticmethod
    def forward(v, u, amount, k, dk_dv, dk_du):
        return k * amount[None, :, None]

    @staticmethod
    def setup_context(ctx, inputs, output):
        v, u, amount, k, dk_dv, dk_du = inputs
        ctx.save_for_forward(amount, k, dk_dv, dk_du)

    @staticmethod
    def jvp(ctx, dv, du, damount, *_):
        amount, k, dk_dv, dk_du = ctx.saved_tensors
        dv, du, damount = (torch.zeros_like(amount) if d is None else d
                           for d in (dv, du, damount))
        coef = (x[None, None] for x in (amount * dv, amount * du, damount))
        return _GasTauTangent.apply(k[None], dk_dv[None], dk_du[None],
                                    *coef)[0, 0]


class _GasTauTangent(torch.autograd.Function):
    """(k, dk_dv, dk_du, a, b, c) -> (T, B, NWAVE, NLAY, NG) tangents
    dk_dv a + dk_du b + k c of B states' optical depths of one gas: the
    factors (B, NWAVE, NLAY, NG), the coefficients (T, B, NLAY)
    (``ops/tangent_cuda.py:gas_tau_tangent``, one launch on the card).
    A vmap folds its batch into T where the factors are shared (the
    tangents of ``jacfwd``) and into B where they are not (states), so
    every level of ``jacfwd`` and ``vmap`` ends in one launch."""

    @staticmethod
    def forward(k, dk_dv, dk_du, a, b, c):
        from archnemesis_tpu_torch.ops.tangent_cuda import gas_tau_tangent

        return gas_tau_tangent(k, dk_dv, dk_du, a, b, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, k, dk_dv, dk_du, a, b, c):
        from archnemesis_tpu_torch.ops.overlap_cuda import _stack_batch

        n = info.batch_size
        factors = zip((k, dk_dv, dk_du), in_dims[:3])
        coefs = zip((a, b, c), in_dims[3:])
        if all(d is None for d in in_dims[:3]):
            # factors shared: the batch joins the tangents
            a, b, c = (_stack_batch(x, d, n).flatten(0, 1) for x, d in coefs)
            out = _GasTauTangent.apply(k, dk_dv, dk_du, a, b, c)
            return out.unflatten(0, (n, -1)), 0
        # batched factors: the batch joins the states
        k, dk_dv, dk_du = (_stack_batch(x, d, n).flatten(0, 1)
                           for x, d in factors)
        a, b, c = (_stack_batch(x, d, n).movedim(0, 1).flatten(1, 2)
                   for x, d in coefs)
        out = _GasTauTangent.apply(k, dk_dv, dk_du, a, b, c)
        return out.unflatten(1, (n, -1)), 1
