"""Line-of-sight nadir path construction.

Port of the nadir part of the JAX package's ``rt/path.py`` (reference
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


def _scale_factors(layers: Layers, radius, h_top, angle_deg, z0):
    """LOS/vertical scale factor per layer for a ray with zenith angle
    ``angle_deg`` at radius ``z0`` (reference AtmCalc_0.py:380-400)."""
    like = layers.baseh
    ang = torch.deg2rad(torch.as_tensor(angle_deg, dtype=like.dtype,
                                        device=like.device))
    sin2a = torch.sin(ang) ** 2
    cosa = torch.cos(ang)
    rb = radius + layers.baseh  # (NLAY,)
    h_top = torch.as_tensor(h_top, dtype=like.dtype,
                            device=like.device).reshape(1)
    r_up = torch.cat([rb[1:], radius + h_top])
    h_up = torch.cat([layers.baseh[1:], h_top])
    s0 = torch.sqrt((rb**2 - sin2a * z0**2).clamp_min(0.0)) - z0 * cosa
    s1 = torch.sqrt((r_up**2 - sin2a * z0**2).clamp_min(0.0)) - z0 * cosa
    return (s1 - s0) / (h_up - layers.baseh)


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
    """Single downward-looking nadir path: layers ordered top->bottom
    (observer in space), zenith angle defined at the bottom layer base
    (IPZEN=BOTTOM). Mirrors AtmCalc_0 nadir branch (AtmCalc_0.py:358-375)
    + SF (:380-400)."""
    nlay = layers.nlay
    nuse = nlay - botlay
    like = layers.temp
    uselay = torch.as_tensor(
        np.arange(nlay - 1, botlay - 1, -1), device=like.device
    )  # top->bottom

    z0 = radius + layers.baseh[botlay]
    sf_all = _scale_factors(layers, radius, h_top, emiss_ang, z0)  # (NLAY,)

    def angle(x):
        return torch.as_tensor(x, dtype=like.dtype,
                               device=like.device).reshape(1)

    return Paths(
        layinc=uselay[:, None],
        scale=sf_all[uselay][:, None],
        emtemp=layers.temp[uselay][:, None],
        mask=torch.ones((nuse, 1), dtype=like.dtype, device=like.device),
        sol_ang=angle(sol_ang),
        emiss_ang=angle(emiss_ang),
        azi_ang=angle(azi_ang),
        imod=imod,
        surface_visible=True,
    )
