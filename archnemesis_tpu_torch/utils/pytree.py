"""Frozen dataclasses of tensors.

Counterpart of the JAX package's pytree dataclasses: fields that hold
arrays are ``torch.Tensor`` (or ``None``); fields declared with
``static_field()`` are host metadata (counts, enums, gas ids). ``.to(device)``
moves every tensor field (and makes a tensor of every numpy field) on one
device, nested structures included, and returns a new instance.
"""

import dataclasses

import numpy as np
import torch


def static_field(**kwargs):
    """Mark a dataclass field as host metadata (never a tensor)."""
    metadata = dict(kwargs.pop("metadata", {}))
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def tensor_fields(cls):
    """Names of the fields of ``cls`` that hold tensors (or ``None``)."""
    return [f.name for f in dataclasses.fields(cls)
            if not f.metadata.get("static", False)]


def tensor_dataclass(cls):
    """Decorator: frozen dataclass with ``replace`` and ``to(device)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = tensor_fields(cls)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    def to(self, device):
        moved = {}
        for n in names:
            x = getattr(self, n)
            if isinstance(x, np.ndarray):
                x = torch.as_tensor(x, device=device)
            if isinstance(x, torch.Tensor) or (
                    dataclasses.is_dataclass(x) and hasattr(x, "to")):
                x = x.to(device)
            moved[n] = x
        return dataclasses.replace(self, **moved)

    cls.replace = replace
    cls.to = to
    return cls
