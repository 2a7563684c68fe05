"""Line-of-sight path construction (nadir / limb).

Port of the JAX package's ``rt/path.py`` (reference
AtmCalc/Path machinery, ``AtmCalc_0.py:33-420``, ``Path_0.py:32``): the path's
layer list is a static index permutation (layinc), and the geometric scale
factors are one expression over the layer base radii.

Paths hold static shapes: (nlayin, npath) with a validity mask.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from archnemesis_tpu_torch.core.types import Layers
from archnemesis_tpu_torch.enums import PathCalc
from archnemesis_tpu_torch.rt.layer import ray_segment
from archnemesis_tpu_torch.utils.pytree import static_field, tensor_dataclass


@tensor_dataclass
class Paths:
    """Per-path layer inclusion and scale factors (reference Path_0
    outputs, Path_0.py:161-173: LAYINC, SCALE, EMTEMP, NLAYIN)."""

    layinc: Any  # (NLAYIN, NPATH) int64 layer indices
    scale: Any  # (NLAYIN, NPATH) LOS/vertical scale factor
    emtemp: Any  # (NLAYIN, NPATH) emission temperature
    mask: Any  # (NLAYIN, NPATH) 1.0 where layer participates
    sol_ang: Any  # (NPATH,)
    emiss_ang: Any  # (NPATH,)
    azi_ang: Any  # (NPATH,)

    imod: PathCalc = static_field(default=PathCalc.THERMAL_EMISSION)
    surface_visible: bool = static_field(default=True)

    @property
    def npath(self) -> int:
        return self.layinc.shape[1]

    @property
    def nlayin(self) -> int:
        return self.layinc.shape[0]


def _scale_factors(layers: Layers, radius, h_top, angle_deg, base):
    """LOS/vertical scale factor per layer for a ray with zenith angle
    ``angle_deg`` at altitude ``base`` (reference AtmCalc_0.py:380-400, at
    radius z0 = radius + base)."""
    like = layers.baseh
    ang = torch.deg2rad(torch.as_tensor(angle_deg, dtype=like.dtype,
                                        device=like.device))
    h_top = torch.as_tensor(h_top, dtype=like.dtype,
                            device=like.device).reshape(1)
    h_up = torch.cat([layers.baseh[1:], h_top])
    # (s1 - s0) / (h_up - baseh) with s the length along the ray at each
    # layer's base and top, without subtracting numbers of the planet's
    # size or two path lengths (rt/layer.py:ray_segment): the reference's
    # difference forms leave the factor ~1e-3 off one at nadir and 3e-4
    # off at the limb in float32
    seg = ray_segment(layers.baseh, h_up, base, radius, ang)
    return seg / (h_up - layers.baseh)


def nadir_path(
    layers: Layers,
    radius,
    h_top,
    emiss_ang,
    sol_ang=0.0,
    azi_ang=0.0,
    botlay: int = 0,
    imod: PathCalc = PathCalc.THERMAL_EMISSION,
) -> Paths:
    """Downward-looking nadir paths: layers ordered top->bottom (observer
    in space), zenith angle defined at the bottom layer base
    (IPZEN=BOTTOM). Mirrors AtmCalc_0 nadir branch (AtmCalc_0.py:358-375)
    + SF (:380-400). One path per ray: the host angles are numbers (one
    path) or 1-D arrays of rays, whose scale factors are one expression
    over (NPATH, NLAY). A tensor angle (a location's under ``vmap``,
    ``multiloc.forward_nadir_multiloc``) is taken as it is."""
    nlay = layers.nlay
    nuse = nlay - botlay
    like = layers.temp
    if isinstance(emiss_ang, torch.Tensor):
        emiss = emiss_ang.reshape(-1).to(like.dtype)
    else:
        emiss = np.asarray(emiss_ang, dtype=np.float64).reshape(-1)
    npath = emiss.shape[0]
    uselay = torch.as_tensor(
        np.arange(nlay - 1, botlay - 1, -1), device=like.device
    )  # top->bottom

    sf = _scale_factors(layers, radius, h_top, emiss[:, None],
                        layers.baseh[botlay])  # (NPATH, NLAY)

    def angle(x):
        if isinstance(x, torch.Tensor):
            return x.reshape(-1).to(like.dtype).expand(npath)
        return torch.as_tensor(
            np.broadcast_to(np.asarray(x, dtype=np.float64).reshape(-1),
                            (npath,)).copy(),
            dtype=like.dtype, device=like.device)

    return Paths(
        layinc=uselay[:, None].expand(nuse, npath),
        scale=sf[:, uselay].T,
        emtemp=layers.temp[uselay][:, None].expand(nuse, npath),
        mask=torch.ones((nuse, npath), dtype=like.dtype, device=like.device),
        sol_ang=angle(sol_ang),
        emiss_ang=angle(emiss),
        azi_ang=angle(azi_ang),
        imod=imod,
        surface_visible=True,
    )


def limb_paths(
    layers: Layers,
    radius,
    h_top,
    botlays,
    imod: PathCalc = PathCalc.THERMAL_EMISSION,
) -> Paths:
    """Limb paths, one per tangent (bottom) layer in ``botlays``.

    Each path traverses the atmosphere down to its tangent layer and back
    out: layinc = [top..botlay, botlay..top] (AtmCalc_0.py:344-356). Scale
    factors are taken at 90 degrees about z0 = radius + the tangent
    layer's base; shorter paths are padded to the longest with ``mask``.
    """
    nlay = layers.nlay
    botlays = [int(b) for b in botlays]
    npath = len(botlays)
    nlayin = max(2 * (nlay - b) for b in botlays)
    like = layers.temp

    layinc_np = np.zeros((nlayin, npath), dtype=np.int64)
    mask_np = np.zeros((nlayin, npath))
    for ip, b in enumerate(botlays):
        nuse = 2 * (nlay - b)
        half = nuse // 2
        # first half: top down to the tangent layer; second half: back out
        layinc_np[:half, ip] = np.arange(nlay - 1, b - 1, -1)
        layinc_np[half:nuse, ip] = np.arange(b, nlay)
        mask_np[:nuse, ip] = 1.0
    layinc = torch.as_tensor(layinc_np, device=like.device)
    mask = torch.as_tensor(mask_np, dtype=like.dtype, device=like.device)

    scale = torch.stack([
        _scale_factors(layers, radius, h_top, 90.0, layers.baseh[b])[
            layinc[:, ip]]
        for ip, b in enumerate(botlays)
    ], dim=1) * mask

    # keep real layer temperatures in the padding (its contributions are
    # masked in the emission sum): zeros there make Planck's tangent NaN
    zero = like.new_zeros(npath)
    return Paths(
        layinc=layinc,
        scale=scale,
        emtemp=layers.temp[layinc],
        mask=mask,
        sol_ang=zero,
        emiss_ang=zero,
        azi_ang=zero,
        imod=imod,
        surface_visible=False,
    )
