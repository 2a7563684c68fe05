"""Device selection for the port's entry points.

Every function that creates tensors takes ``device=None``, which means the
CUDA card. Without a card that raises: the CPU is used only when the caller
asks for it (``device="cpu"``), never as a fallback.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
