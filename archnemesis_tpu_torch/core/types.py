"""Core component structures: atmosphere profiles, layering scheme, layers.

Frozen dataclasses of tensors (``utils.pytree``); static fields (counts,
enums, gas ids) are host metadata.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from archnemesis_tpu_torch.enums import (
    AtmosphericProfileFormat,
    LayerIntegrationScheme,
    LayerType,
)
from archnemesis_tpu_torch.utils.pytree import static_field, tensor_dataclass


@tensor_dataclass
class Atmosphere:
    """Vertical profiles of one atmosphere column (reference
    ``Atmosphere_0``, ``Atmosphere_0.py:44``)."""

    h: Any  # (NP,) heights [m]
    p: Any  # (NP,) pressures [Pa]
    t: Any  # (NP,) temperatures [K]
    vmr: Any  # (NP, NVMR) volume mixing ratios
    dust: Any  # (NP, NDUST) aerosol density [particles m-3] (or per gram)
    parah2: Any  # (NP,) para-H2 fraction (zeros if unused)
    molwt: Any  # (NP,) molecular weight profile [kg mol-1]
    radius: Any  # scalar: planetocentric radius at H=0 [m]
    latitude: Any  # scalar [deg]
    # optional retrieved planet-radius override [m] (models 555/556)
    planet_radius: Any = None
    # per-mode dust-column renormalisation target optical depth (reference
    # DUST_RENORMALISATION); None = off, 0 entries = no renorm for that mode
    dust_renorm: Any = None

    gas_id: Tuple[int, ...] = static_field(default=())
    iso_id: Tuple[int, ...] = static_field(default=())
    planet: int = static_field(default=0)
    amform: AtmosphericProfileFormat = static_field(
        default=AtmosphericProfileFormat.CALC_MOLECULAR_WEIGHT_SCALE_VMR_TO_ONE
    )
    dust_units_flag: Optional[Tuple[int, ...]] = static_field(default=None)
    # saturation-vapour-pressure caps: (gas_id, iso_id, vp, svpflag)
    svp: Optional[Tuple[Tuple[int, int, float, int], ...]] = static_field(
        default=None
    )

    @property
    def np_(self) -> int:
        return self.h.shape[0]

    @property
    def nvmr(self) -> int:
        return self.vmr.shape[1]

    @property
    def ndust(self) -> int:
        return self.dust.shape[1]


def stack_atmospheres(atms) -> Atmosphere:
    """Stack single-location Atmospheres into one multi-location
    Atmosphere with a leading (NLOCATIONS,) axis on every profile field
    (the reference's NLOCATIONS mode, Atmosphere_0.py:164-182, 2D (NP,
    NLOCATIONS) arrays): ``multiloc.forward_nadir_multiloc`` vmaps the
    forward over that axis, and model 1002 scales along it. The host
    metadata must match across locations."""
    import dataclasses

    import torch

    from archnemesis_tpu_torch.utils.pytree import tensor_fields

    a0 = atms[0]
    for a in atms[1:]:
        if (a.gas_id, a.iso_id, a.planet, a.amform) != (
                a0.gas_id, a0.iso_id, a0.planet, a0.amform):
            raise ValueError("atmospheres must share static metadata")
    stacked = {}
    for name in tensor_fields(Atmosphere):
        values = [getattr(a, name) for a in atms]
        stacked[name] = (None if values[0] is None
                         else torch.stack([torch.as_tensor(v)
                                           for v in values]))
    return dataclasses.replace(a0, **stacked)


@tensor_dataclass
class LayerConfig:
    """Layering scheme (reference ``Layer_0`` settings); all host metadata."""

    nlay: int = static_field(default=20)
    laytyp: LayerType = static_field(default=LayerType.EQUAL_LOG_PRESSURE)
    layint: LayerIntegrationScheme = static_field(
        default=LayerIntegrationScheme.ABSORBER_WEIGHTED_AVERAGE
    )
    nint: int = static_field(default=101)
    layht: float = static_field(default=0.0)
    # user-specified base grids for LayerType.BASE_PRESSURE / BASE_HEIGHT
    h_base: Optional[np.ndarray] = static_field(default=None)
    p_base: Optional[np.ndarray] = static_field(default=None)


@tensor_dataclass
class Layers:
    """Averaged per-layer properties along the splitting path (reference
    ``Layer_0.py:153-182``); LAYSF scales slant columns back to vertical."""

    baseh: Any  # (NLAY,) base altitude [m]
    basep: Any  # (NLAY,) base pressure [Pa]
    baset: Any  # (NLAY,) base temperature [K]
    delh: Any  # (NLAY,) layer vertical thickness [m]
    height: Any  # (NLAY,) effective altitude [m]
    press: Any  # (NLAY,) effective pressure [Pa]
    temp: Any  # (NLAY,) effective temperature [K]
    totam: Any  # (NLAY,) vertical gas column density [m-2]
    amount: Any  # (NLAY, NVMR) vertical per-gas column density [m-2]
    pp: Any  # (NLAY, NVMR) effective partial pressures [Pa]
    cont: Any  # (NLAY, NDUST) vertical dust column density [m-2]
    frac: Any  # (NLAY,) para-H2 fraction
    laysf: Any  # (NLAY,) layer scaling factor (slant path / vertical)

    @property
    def nlay(self) -> int:
        return self.baseh.shape[0]
