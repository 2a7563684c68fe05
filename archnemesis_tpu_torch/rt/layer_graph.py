"""The nadir forward's layering and path as CUDA graphs.

``forward_nadir`` lays out the layers (``build_layers``,
``apply_dust_renorm``) and the path (``nadir_path``) in some 600 PyTorch
kernels of at most NLAY x NINT x NVMR values each: on the card they take
about a millisecond, and the host takes ten or more to launch them one by
one while the card idles. ``layering_and_path`` captures each of the two
stages once as a ``torch.cuda.CUDAGraph`` and replays the pair on every
later call with the same key: the same kernels, so the same bits.

The key is the layout, not the values: the atmosphere's shapes and the
``LayerConfig``. The atmosphere's tensors and the three angles are copied
into the graphs' inputs before each replay, so a retrieval's forwards
over many viewing geometries of one atmosphere replay one pair of graphs.

It captures only what a graph can hold: on the card, on a stream that is
not capturing, with host-number angles, and with no input under a
``torch.func`` transform, carrying a forward-mode tangent or, where grad
is enabled, requiring grad (autograd would save the graphs' outputs,
which the next replay overwrites). Anything else (the CPU, ``jacfwd``,
``vmap``, autograd) runs the two stages eagerly, as before.

Counters: ``layering_and_path.captures`` (keys captured),
``.replays`` (calls replayed, both graphs each) and ``.eager`` (calls run
eagerly).
"""

from __future__ import annotations

import dataclasses
import numbers
import threading
from collections import OrderedDict

import numpy as np
import torch
from torch._C import _functorch

from archnemesis_tpu_torch.core.types import Atmosphere
from archnemesis_tpu_torch.enums import PathCalc
from archnemesis_tpu_torch.rt.layer import build_layers
from archnemesis_tpu_torch.rt.path import nadir_path
from archnemesis_tpu_torch.utils.device import (
    device_constant,
    holding_constants,
)
from archnemesis_tpu_torch.utils.host import has_tangent
from archnemesis_tpu_torch.utils.profiling import annotate
from archnemesis_tpu_torch.utils.pytree import tensor_fields

REPLAY_SPAN = "nemesis.layering.replay"
# layouts kept, the least recently used go: a retrieval or a benchmark
# cell uses one. At 71 layers x 101 samples x 7 gases (float32, H100) a
# capture takes ~31 ms, some 5 eager layerings, and keeps 33.6 MB
KEPT = 8
# the Atmosphere fields the layering and the path read
READ = ("h", "p", "t", "vmr", "dust", "parah2", "molwt", "radius",
        "dust_renorm")

_graphs: OrderedDict = OrderedDict()


def _layers(atm: Atmosphere, laycfg):
    from archnemesis_tpu_torch.forward import apply_dust_renorm

    return apply_dust_renorm(build_layers(atm, laycfg, layang=0.0), atm)


def _path(layers, atm: Atmosphere, emiss_ang, sol_ang, azi_ang):
    return nadir_path(layers, atm.radius, atm.h[-1], emiss_ang,
                      sol_ang=sol_ang, azi_ang=azi_ang,
                      imod=PathCalc.THERMAL_EMISSION)


def _tensors(obj):
    """The tensors of ``obj``: a tensor, a dataclass of them (nested), or a
    list or tuple of those."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for n in tensor_fields(type(obj)):
            yield from _tensors(getattr(obj, n))
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)


def _plain(t: torch.Tensor) -> bool:
    return not (_functorch.is_functorch_wrapped_tensor(t)
                or (t.requires_grad and torch.is_grad_enabled())
                or has_tangent(t))


def _host(x) -> bytes:
    return np.asarray(x, dtype=np.float64).tobytes()


def _key(atm: Atmosphere, laycfg, angles, others=()):
    """The graphs' key, or None where a graph cannot stand in for the
    stages."""
    inputs = [(n, getattr(atm, n)) for n in READ]
    inputs = [(n, t) for n, t in inputs if t is not None]
    dev = atm.h.device
    if (dev.type != "cuda"
            or not all(isinstance(a, numbers.Real) for a in angles)
            or not isinstance(laycfg.layht, numbers.Real)
            or not all(t.device == dev and _plain(t) for _, t in inputs)
            or not all(_plain(t) for t in _tensors(others))
            or torch.cuda.is_current_stream_capturing()):
        return None
    return (dev, threading.get_ident(),
            torch.cuda.current_stream(dev).cuda_stream,
            torch.is_inference_mode_enabled(),
            tuple((n, t.shape, t.dtype) for n, t in inputs),
            atm.dust_units_flag,
            (laycfg.nlay, laycfg.laytyp, laycfg.layint, laycfg.nint,
             _host(laycfg.layht),
             None if laycfg.h_base is None else _host(laycfg.h_base),
             None if laycfg.p_base is None else _host(laycfg.p_base)))


def _angle_values(angles, like: torch.Tensor):
    """The host angles as (1,) device tensors, the values ``nadir_path``
    makes of them (``device_constant``s: no copy from the host after the
    first call with a value)."""
    return [device_constant(np.array([a], dtype=np.float64), like.dtype,
                            like.device) for a in angles]


class _Graphs:
    """The two stages of one layout captured: their static inputs (the
    atmosphere's tensors the stages read, and the angles), the graphs,
    the outputs they write and the device constants they read."""

    def __init__(self, atm: Atmosphere, laycfg, angles):
        dev = atm.h.device
        self.inputs = {n: getattr(atm, n).clone(
            memory_format=torch.contiguous_format)
            for n in READ if getattr(atm, n) is not None}
        self.angles = [a.clone() for a in _angle_values(angles, atm.t)]
        # a field the stages do not read is None in the captured atmosphere
        static = dataclasses.replace(atm, **{
            n: self.inputs.get(n) for n in tensor_fields(Atmosphere)})
        with torch.cuda.device(dev), holding_constants() as self.constants:
            # warm up off the capturing stream: lazy set-up, constants
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _path(_layers(static, laycfg), static, *self.angles)
            torch.cuda.current_stream().wait_stream(side)
            self.layering = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.layering,
                                  capture_error_mode="thread_local"):
                self.layers = _layers(static, laycfg)
            self.path_graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.path_graph,
                                  pool=self.layering.pool(),
                                  capture_error_mode="thread_local"):
                self.path = _path(self.layers, static, *self.angles)


def _cloned(obj):
    return obj.replace(**{n: getattr(obj, n).clone()
                          for n in tensor_fields(type(obj))
                          if isinstance(getattr(obj, n), torch.Tensor)})


def layering_and_path(atm: Atmosphere, laycfg, emiss_ang, sol_ang, azi_ang,
                      others=(), own: bool = False):
    """The nadir forward's layers (``build_layers`` at layang 0, then
    ``apply_dust_renorm``) in the span ``nemesis.layering`` and their
    thermal-emission ``nadir_path`` in ``nemesis.path``; returns (layers,
    path). ``others``: the forward's other inputs (structures of
    tensors), held to the same rule as the atmosphere. Replayed from CUDA
    graphs where the inputs allow it (module docstring), each replay in a
    span ``REPLAY_SPAN``; the layers and path are then the graphs'
    outputs, which the next replay of the layout overwrites: ``own=True``
    returns copies."""
    angles = (emiss_ang, sol_ang, azi_ang)
    key = _key(atm, laycfg, angles, others)
    if key is None:
        layering_and_path.eager += 1
        with annotate("nemesis.layering"):
            layers = _layers(atm, laycfg)
        with annotate("nemesis.path"):
            path = _path(layers, atm, *angles)
        return layers, path
    graphs = _graphs.pop(key, None)
    if graphs is None:
        graphs = _Graphs(atm, laycfg, angles)
        layering_and_path.captures += 1
    _graphs[key] = graphs
    if len(_graphs) > KEPT:
        _graphs.popitem(last=False)
    with annotate("nemesis.layering"):
        for n, buf in graphs.inputs.items():
            buf.copy_(getattr(atm, n))
        with annotate(REPLAY_SPAN):
            graphs.layering.replay()
    with annotate("nemesis.path"):
        for buf, a in zip(graphs.angles, _angle_values(angles, atm.t)):
            buf.copy_(a)
        with annotate(REPLAY_SPAN):
            graphs.path_graph.replay()
    layering_and_path.replays += 1
    if own:
        return _cloned(graphs.layers), _cloned(graphs.path)
    return graphs.layers, graphs.path


layering_and_path.captures = 0
layering_and_path.replays = 0
layering_and_path.eager = 0
