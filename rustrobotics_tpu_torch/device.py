"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA where there is none raises
    instead of falling back to the CPU: a CPU run is asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested (the default) but torch.cuda.is_available()"
            " is False; pass device='cpu' to run on the CPU"
        )
    return dev
