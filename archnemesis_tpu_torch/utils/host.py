"""Host reads of tensors inside ``torch.func`` transforms.

A forward that takes a data-dependent branch (an iteration's stopping
test, an anchor level) reads a few values on the host. Under ``jvp`` and
``jacfwd`` the values are the primal's; under ``vmap`` over states each
row has its own, and ``.item()`` raises. ``host_values`` reads them all.
"""

import torch
import torch.autograd.forward_ad as fwAD
from torch._C import _functorch


def host_values(t: torch.Tensor) -> torch.Tensor:
    """The values of ``t`` as a plain CPU tensor, read through any
    ``torch.func`` transform: the primal under ``jvp``/``jacfwd``, every
    row of a vmapped tensor (its batch axes then lie somewhere in the
    shape, so read it as a set of values)."""
    while _functorch.is_functorch_wrapped_tensor(t):
        t = _functorch.get_unwrapped(t)
    return t.detach().cpu()


def has_tangent(*ts: torch.Tensor) -> bool:
    """Whether any of ``ts`` carries a forward-mode tangent (under
    ``torch.func.jvp``/``jacfwd`` or a ``forward_ad`` dual level); a tensor
    only vmapped over carries none. Under a ``vmap`` inside ``jacfwd`` the
    tangent is read below the batching wrappers, which cannot unpack it."""
    return any(_has_tangent(t) for t in ts)


def _has_tangent(t: torch.Tensor) -> bool:
    while True:
        try:
            return fwAD.unpack_dual(t).tangent is not None
        except RuntimeError:
            if not _functorch.is_functorch_wrapped_tensor(t):
                raise
            t = _functorch.get_unwrapped(t)
