"""Host reads of tensors inside ``torch.func`` transforms.

A forward that takes a data-dependent branch (an iteration's stopping
test, an anchor level) reads a few values on the host. Under ``jvp`` and
``jacfwd`` the values are the primal's; under ``vmap`` over states each
row has its own, and ``.item()`` raises. ``host_values`` reads them all.
"""

import torch
from torch._C import _functorch


def host_values(t: torch.Tensor) -> torch.Tensor:
    """The values of ``t`` as a plain CPU tensor, read through any
    ``torch.func`` transform: the primal under ``jvp``/``jacfwd``, every
    row of a vmapped tensor (its batch axes then lie somewhere in the
    shape, so read it as a set of values)."""
    while _functorch.is_functorch_wrapped_tensor(t):
        t = _functorch.get_unwrapped(t)
    return t.detach().cpu()
