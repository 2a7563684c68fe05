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
    StellarSpec,
    SurfaceSpec,
)
from archnemesis_tpu_torch.core.types import Atmosphere, LayerConfig
from archnemesis_tpu_torch.enums import RayleighScatteringMode, WaveUnit
from archnemesis_tpu_torch.forward import ForwardConfig
from archnemesis_tpu_torch.io.legacy import Deck, Geometry, RunSettings
from archnemesis_tpu_torch.models.base import ModelEntry, ProfileTarget
from archnemesis_tpu_torch.retrieval.statevector import StateVector
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


def stellar_spec(fields: dict, device=None) -> StellarSpec:
    return _build(StellarSpec, fields, device)


def _host_dataclass(cls, fields: dict):
    """A host (numpy) dataclass of the port from the same-named fields;
    enum-typed fields are rebuilt from their integer values."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if isinstance(v, enum.Enum):
            v = int(v)
        kw[f.name] = v
    return cls(**kw)


def geometry(fields: dict) -> Geometry:
    return _host_dataclass(Geometry, fields)


def run_settings(fields: dict) -> RunSettings:
    """RunSettings of the port; its enum fields are rebuilt as the port's
    enums (``io.legacy.load_deck`` builds them the same way)."""
    from archnemesis_tpu_torch.enums import (
        LowerBoundaryCondition,
        ParaH2Ratio,
        SpectralCalculationMode,
        SpectraUnit,
    )

    st = _host_dataclass(RunSettings, fields)
    return dataclasses.replace(
        st, ispace=WaveUnit(st.ispace), ilbl=SpectralCalculationMode(st.ilbl),
        iform=SpectraUnit(st.iform), inormal=ParaH2Ratio(st.inormal),
        lowbc=LowerBoundaryCondition(st.lowbc))


def deck(fields: dict, device=None) -> Deck:
    """A loaded deck carried across: ``fields`` maps each field of the JAX
    ``Deck`` to the flattened structure (a dict as the functions above take
    it), to ``None``, or for host fields (paths, tuples) to the value."""
    makers = dict(
        atmosphere=atmosphere, ktables=ktables, cia=cia_tables,
        aerosol=aerosol_optics, surface=surface_spec, stellar=stellar_spec,
    )
    kw = {}
    for name, v in fields.items():
        if v is None:
            kw[name] = None
        elif name in makers:
            kw[name] = makers[name](v, device=device)
        elif name == "layer_config":
            kw[name] = layer_config(v)
        elif name == "geometry":
            kw[name] = geometry(v)
        elif name == "settings":
            kw[name] = run_settings(v)
        else:
            kw[name] = v
    return Deck(**kw)


def state_vector(fields: dict, nvmr: int) -> StateVector:
    """StateVector of the port from the JAX one's fields; ``entries`` is a
    sequence of dicts of the ModelEntry fields with ``target`` given by its
    value (a string). ``nvmr`` sizes the VMR-rescaling mask."""
    entries = tuple(
        ModelEntry(**{**e, "varident": tuple(e["varident"]),
                      "target": ProfileTarget(e["target"]),
                      "extra": tuple(e.get("extra", ()))})
        for e in fields["entries"]
    )
    kw = {k: v for k, v in fields.items() if k != "entries"}
    for k in ("xa", "sa", "lx", "fix", "inum"):
        kw[k] = np.asarray(kw[k])
    return StateVector(entries=entries, **kw).with_iscale(nvmr)
