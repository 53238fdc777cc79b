"""Device selection shared by the port's entry points."""

from __future__ import annotations

import numpy as np
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


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor. A tensor stays on its device unless ``device``
    names one; anything else (a numpy array, a list, a number) is read as
    numpy reads it (floats are f64) and goes to ``device``, None meaning
    the card as for the entry points. ``dtype`` None keeps x's own."""
    if isinstance(x, torch.Tensor):
        if device is None and dtype is None:
            return x
        return x.to(device=device, dtype=dtype)
    arr = np.asarray(x)
    if not arr.flags.writeable:  # a read-only view (a JAX array's, say)
        arr = arr.copy()
    return torch.as_tensor(arr, dtype=dtype, device=resolve_device(device))


def tensor_fields(obj, *names):
    """Turn each named field of the dataclass ``obj`` that holds neither a
    tensor nor None into ``as_tensor`` of it (frozen dataclasses too), so
    its constructor takes numpy arrays as well as tensors."""
    for name in names:
        value = getattr(obj, name)
        if value is not None and not isinstance(value, torch.Tensor):
            object.__setattr__(obj, name, as_tensor(value))
