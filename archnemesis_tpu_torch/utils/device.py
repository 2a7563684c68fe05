"""Device selection for the port's entry points.

Every function that creates tensors takes ``device=None``, which means the
CUDA card. Without a card that raises: the CPU is used only when the caller
asks for it (``device="cpu"``), never as a fallback.

``device_constant`` makes a host number or numpy array a tensor on the
device once, not on every call: each such copy waits for the host, and a
CUDA graph cannot capture one.
"""

import contextlib
from collections import OrderedDict
from typing import Iterator, List

import numpy as np
import torch

CONSTANTS_KEPT = 256  # device constants kept, the least recently used go
_constants: OrderedDict = OrderedDict()
_holders: List[list] = []


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def device_constant(x, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)`` with the same
    values, made once per (device, dtype, value) where ``x`` is a host
    number or numpy array and returned from a cache after that (a tensor
    is converted as ``torch.as_tensor`` converts it). The result is
    shared: never write into it."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(x, dtype=dtype, device=device)
    a = np.asarray(x)
    key = (torch.device(device), dtype, a.dtype.str, a.shape, a.tobytes())
    t = _constants.pop(key, None)
    if t is None:
        # a normal tensor even under inference mode, so that it serves
        # outside it too
        with torch.inference_mode(False):
            t = torch.as_tensor(x, dtype=dtype, device=device)
            if t.device.type == "cpu":
                t = t.clone()  # not the numpy array's memory
    _constants[key] = t
    if len(_constants) > CONSTANTS_KEPT:
        _constants.popitem(last=False)
    for held in _holders:
        held.append(t)
    return t


@contextlib.contextmanager
def holding_constants() -> Iterator[list]:
    """A list that keeps every tensor ``device_constant`` returns inside
    the block alive (a CUDA graph reads them at their addresses after the
    cache has let them go)."""
    held: list = []
    _holders.append(held)
    try:
        yield held
    finally:
        _holders.remove(held)
