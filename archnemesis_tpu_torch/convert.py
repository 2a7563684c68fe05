"""Carry the JAX package's structures across into the port's.

Each function takes one structure of the JAX package given as a dict of its
fields (arrays as numpy, static fields as they are, e.g. built with
``{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}``) and
builds the port's counterpart, with its arrays as tensors on ``device``
(None = CUDA). Both packages then compute on the same numbers.

A field the port's structure lacks is accepted only when it is ``None``:
a set field that belongs to a later slice (e.g. the Hapke surface block)
raises instead of being dropped.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from archnemesis_tpu_torch.core.spectra import (
    AerosolOptics,
    CIATables,
    KTables,
    SurfaceSpec,
)
from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
from archnemesis_tpu_torch.enums import RayleighScatteringMode, WaveUnit
from archnemesis_tpu_torch.forward import ForwardConfig
from archnemesis_tpu_torch.utils.device import resolve_device
from archnemesis_tpu_torch.utils.pytree import tensor_fields


def _kwargs(cls, fields: dict, device=None) -> dict:
    known = {f.name: f for f in dataclasses.fields(cls)}
    extra = sorted(k for k, v in fields.items()
                   if k not in known and v is not None)
    if extra:
        raise ValueError(f"{cls.__name__} of the port has no fields {extra}")
    tensors = set(tensor_fields(cls))
    out = {}
    for name, f in known.items():
        if name not in fields:
            continue
        v = fields[name]
        if name in tensors and v is not None:
            v = torch.as_tensor(np.asarray(v), device=device)
        elif isinstance(f.default, enum.Enum) and v is not None:
            v = type(f.default)(int(v))
        out[name] = v
    return out


def _build(cls, fields: dict, device):
    return cls(**_kwargs(cls, fields, resolve_device(device)))


def atmosphere(fields: dict, device=None) -> Atmosphere:
    return _build(Atmosphere, fields, device)


def layer_config(fields: dict) -> LayerConfig:
    return LayerConfig(**_kwargs(LayerConfig, fields))


def ktables(fields: dict, device=None) -> KTables:
    return _build(KTables, fields, device)


def cia_tables(fields: dict, device=None) -> CIATables:
    return _build(CIATables, fields, device)


def aerosol_optics(fields: dict, device=None) -> AerosolOptics:
    return _build(AerosolOptics, fields, device)


def surface_spec(fields: dict, device=None) -> SurfaceSpec:
    return _build(SurfaceSpec, fields, device)


def forward_config(fields: dict) -> ForwardConfig:
    """ForwardConfig of the port from the JAX one's fields; fields that only
    other slices read (runtime-LBL self-broadening columns, the scattering
    wave tile) and the XLA combine's straddle count, which the port's
    combines do not need, are not carried."""
    names = [f.name for f in dataclasses.fields(ForwardConfig)]
    kw = {n: fields[n] for n in names if n in fields}
    kw["ispace"] = WaveUnit(int(kw["ispace"]))
    kw["iray"] = RayleighScatteringMode(int(kw["iray"]))
    return ForwardConfig(**kw)
