"""Tangent passes of the correlated-k forward under ``torch.func.jacfwd``:
the Hopper kernels and their plain versions.

``gas_tau_tangent`` forms the stacked tangents of one gas's optical depth
from its factored k (``ops/ktab.py:LayerK.tau``); ``skip_rows_`` applies
the random overlap's skip rule to the tangents of one combine in place
(``ops/overlap_cuda.py:mix_pair``); ``emission_tangent`` is the tangent of
the thermal emission along paths and its g-integration
(``rt/emission.py:path_emission_spectrum``). On a CPU tensor each runs its
plain PyTorch version; on a CUDA tensor it launches its kernel in
``csrc/tangent_ops.cu`` or raises. None falls back from the card to the
plain version. The library is built with ``nvcc`` at first use
(``ops/cuda_build.py``) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from archnemesis_tpu_torch.ops import cuda_build
from archnemesis_tpu_torch.ops.planck import planck_slope

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def build() -> dict:
    """Compile the kernel library (once per source content) and return
    ``{"path", "seconds", "ptxas"}`` (``ops.cuda_build.build``)."""
    return cuda_build.build("tangent_ops")


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(build()["path"])
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"gas_tau_tangent_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"skip_rows_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"emission_tangent_{suffix}")
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(name, device, *args):
    if device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {device}")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(_library(), name)(*args, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def gas_tau_tangent_plain(k, dk_dv, dk_du, a, b, c):
    """``gas_tau_tangent`` in plain PyTorch, on any device."""
    def lay(x):
        return x[:, :, None, :, None]

    out = k[None] * lay(c)
    out = torch.addcmul(out, dk_du[None], lay(b))
    return torch.addcmul(out, dk_dv[None], lay(a))


def gas_tau_tangent(k, dk_dv, dk_du, a, b, c):
    """(T, B, NWAVE, NLAY, NG) tangents dk_dv a + dk_du b + k c of B
    states' optical depths of one gas: ``k``, ``dk_dv``, ``dk_du`` (B,
    NWAVE, NLAY, NG); ``a``, ``b``, ``c`` (T, B, NLAY) per-layer
    coefficients (amount dv, amount du, d amount). One kernel launch on
    the card."""
    if k.device.type == "cpu":
        return gas_tau_tangent_plain(k, dk_dv, dk_du, a, b, c)
    ins = [x.contiguous() for x in (k, dk_dv, dk_du, a, b, c)]
    for x in ins:
        if x.dtype != k.dtype or x.device != k.device:
            raise ValueError("gas_tau_tangent: inputs differ in dtype or "
                             "device")
    if k.dtype not in _DTYPES:
        raise TypeError(f"gas_tau_tangent: dtype {k.dtype}")
    n_batch, nwave, nlay, ng = k.shape
    n_tan = a.shape[0]
    if (dk_dv.shape != k.shape or dk_du.shape != k.shape
            or any(x.shape != (n_tan, n_batch, nlay) for x in (a, b, c))):
        raise ValueError("gas_tau_tangent: factors (B, NWAVE, NLAY, NG) and "
                         "coefficients (T, B, NLAY)")
    out = k.new_empty((n_tan, n_batch, nwave, nlay, ng))
    _launch(f"gas_tau_tangent_{_DTYPES[k.dtype]}", k.device,
            *(x.data_ptr() for x in ins), out.data_ptr(), k.numel(), nlay,
            ng, n_batch, n_tan)
    gas_tau_tangent.launches += 1
    return out


gas_tau_tangent.launches = 0


def skip_rows_plain(dout, da, db, skip_a, skip_b):
    """``skip_rows_``'s values in plain PyTorch, on any device, as a new
    tensor."""
    return torch.where(skip_b[None, :, None], da,
                       torch.where(skip_a[None, :, None], db, dout))


def skip_rows_(dout, da, db, skip_a, skip_b):
    """The random overlap's skip rule on a combine's tangents, in place on
    ``dout`` (T, R, NG) and returned: rows where ``skip_b`` take ``da``'s
    values, else rows where ``skip_a`` take ``db``'s; ``skip_a``,
    ``skip_b``: (R,) bool. On the card one launch, which copies only the
    skipped rows."""
    if dout.device.type == "cpu":
        return dout.copy_(skip_rows_plain(dout, da, db, skip_a, skip_b))
    n_tan, rows, ng = dout.shape
    da, db = da.contiguous(), db.contiguous()
    if (not dout.is_contiguous() or da.shape != dout.shape
            or db.shape != dout.shape or dout.dtype not in _DTYPES
            or skip_a.shape != (rows,) or skip_b.shape != (rows,)):
        raise ValueError("skip_rows_: (T, R, NG) contiguous tangents and "
                         "(R,) flags")
    flags = [s.contiguous().to(torch.uint8) for s in (skip_a, skip_b)]
    _launch(f"skip_rows_{_DTYPES[dout.dtype]}", dout.device,
            dout.data_ptr(), da.data_ptr(), db.data_ptr(),
            *(f.data_ptr() for f in flags), rows, ng, n_tan)
    skip_rows_.launches += 1
    return dout


skip_rows_.launches = 0


def path_locations(loc, group, npath, device):
    """(NPATH,) index of each path's location in tau's first axis: paths
    come in groups of ``group``, group j at ``loc[j]`` (all at 0 without
    ``loc``)."""
    if loc is None:
        return torch.zeros(npath, dtype=torch.int64, device=device)
    return loc.repeat_interleave(group)


def emission_tangent_plain(tau, layinc, scale, mask, emtemp, ground, wave,
                           del_g, ispace=0, loc=None, group=None, dtau=None,
                           dscale=None, demtemp=None, dground=None):
    """``emission_tangent`` in plain PyTorch, on any device: the kernel's
    recurrences over the path's layers, vectorised over waves, g and
    paths, then the contractions with the tangents."""
    nlayin, npath = layinc.shape
    group = npath if group is None else group
    at = path_locations(loc, group, npath, tau.device)
    # (NLAYIN, NPATH, NWAVE, NG) -> (NWAVE, NG, NLAYIN, NPATH)
    raw = tau[at[None, :], :, :, layinc].permute(2, 3, 0, 1)
    t = raw * scale * mask
    a = -torch.expm1(-t)
    b, db = planck_slope(wave[:, None, None], emtemp[None], ispace)
    on = mask != 0
    bm = torch.where(on, b * mask, 0.0)  # (NWAVE, NLAYIN, NPATH)
    dbm = torch.where(on, db * mask, 0.0)
    # backward: u_i = B_i - R_i, R the radiance behind layer i
    r = (torch.zeros_like(t[:, :, 0]) if ground is None
         else ground[:, None, :].expand_as(t[:, :, 0]))
    u = torch.empty_like(t)
    for i in range(nlayin - 1, -1, -1):
        u[:, :, i] = bm[:, None, i] - r
        r = torch.exp(-t[:, :, i]) * r + a[:, :, i] * bm[:, None, i]
    tr = torch.exp(-torch.cumsum(t, dim=2))
    trm = torch.cat([torch.ones_like(tr[:, :, :1]), tr[:, :, :-1]], dim=2)
    dg = del_g[None, :, None, None]
    kd = dg * tr * u  # the g-weighted coefficient of each layer's dtau
    n_tan = next(x.shape[0] for x in (dtau, dscale, demtemp, dground)
                 if x is not None)
    out = tau.new_zeros((n_tan, wave.shape[0], npath))
    if dtau is not None:
        # (NLAYIN, NPATH, T, NWAVE, NG)
        dt = dtau[:, at[None, :], :, :, layinc]
        out = out + torch.einsum("nptwg,wgnp->twp", dt, kd * (scale * mask))
    if dscale is not None:
        out = out + torch.einsum("tnp,wnp->twp", dscale,
                                 (kd * raw * mask).sum(dim=1))
    if demtemp is not None:
        out = out + torch.einsum("tnp,wnp->twp", demtemp,
                                 (dg * trm * a).sum(dim=1) * dbm)
    if dground is not None:
        out = out + dground * (del_g[None, :, None]
                               * tr[:, :, -1]).sum(dim=1)[None]
    return out


def emission_tangent(tau, layinc, scale, mask, emtemp, ground, wave, del_g,
                     ispace=0, loc=None, group=None, dtau=None, dscale=None,
                     demtemp=None, dground=None):
    """(T, NWAVE, NPATH) tangents of the g-integrated thermal emission of
    NPATH paths (``rt/emission.py:path_emission_spectrum``).

    Primal: ``tau`` (B, NWAVE, NG, NLAY) layer optical depths of B
    locations, read through its strides; ``layinc``, ``scale``, ``mask``,
    ``emtemp`` (NLAYIN, NPATH); ``ground`` (NWAVE, NPATH) the ground's
    radiance, or None (no ground term); ``wave`` (NWAVE,); ``del_g``
    (NG,). Paths come in groups of ``group`` (all of them by default), the
    paths of group j on location ``loc[j]`` (0 without ``loc``).
    Tangents, each None where absent: ``dtau`` (T, B, NWAVE, NG, NLAY), read
    once through its strides, with no copy; ``dscale``, ``demtemp`` (T,
    NLAYIN, NPATH); ``dground`` (T, NWAVE, NPATH). One kernel launch on the
    card (``.launches``); ``.calls`` counts calls on either device."""
    emission_tangent.calls += 1
    if tau.device.type == "cpu":
        return emission_tangent_plain(
            tau, layinc, scale, mask, emtemp, ground, wave, del_g, ispace,
            loc, group, dtau, dscale, demtemp, dground)
    dtype, device = tau.dtype, tau.device
    if dtype not in _DTYPES:
        raise TypeError(f"emission_tangent: dtype {dtype}")
    nloc, nwave, ng, nlay = tau.shape
    nlayin, npath = layinc.shape
    group = npath if group is None else group
    tangents = [x for x in (dtau, dscale, demtemp, dground) if x is not None]
    n_tan = tangents[0].shape[0]
    shapes = ((dtau, (n_tan, nloc, nwave, ng, nlay)),
              (dscale, (n_tan, nlayin, npath)),
              (demtemp, (n_tan, nlayin, npath)),
              (dground, (n_tan, nwave, npath)),
              (scale, (nlayin, npath)), (mask, (nlayin, npath)),
              (emtemp, (nlayin, npath)), (ground, (nwave, npath)),
              (wave, (nwave,)), (del_g, (ng,)))
    for x, shape in shapes:
        if x is not None and (tuple(x.shape) != shape or x.dtype != dtype
                              or x.device != device):
            raise ValueError(f"emission_tangent: an input of shape "
                             f"{tuple(x.shape)} ({x.dtype}, {x.device}), "
                             f"expected {shape} ({dtype}, {device})")
    if npath % group or (loc is not None and loc.shape != (npath // group,)):
        raise ValueError("emission_tangent: paths in groups of `group`, one "
                         "location each")

    def flat(x, kind=None):
        return None if x is None else x.to(kind or x.dtype).contiguous()

    # the kernel's operands in its order; tau and its tangent through their
    # strides, the small ones contiguous
    out = tau.new_empty((n_tan, nwave, npath))
    ops = [tau, dtau, flat(layinc, torch.int64), flat(loc, torch.int64),
           *(flat(x) for x in (scale, mask, emtemp, ground, wave, del_g,
                               dscale, demtemp, dground)), out]
    ptrs = (ctypes.c_void_p * len(ops))(*(None if x is None else x.data_ptr()
                                          for x in ops))
    dstrides = dtau.stride() if dtau is not None else (0,) * 5
    ints = (ctypes.c_int64 * 17)(n_tan, nwave, ng, nlay, nlayin, npath,
                                 group, int(ispace), *tau.stride(),
                                 *dstrides)
    _launch(f"emission_tangent_{_DTYPES[dtype]}", device, ptrs, ints)
    emission_tangent.launches += 1
    return out


emission_tangent.launches = 0
emission_tangent.calls = 0
