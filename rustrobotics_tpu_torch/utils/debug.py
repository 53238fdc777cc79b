"""Numerical sanitizers (counterpart of
``rustrobotics_tpu/utils/debug.py``).

The JAX package's ``checked`` runs a function under checkify's float
checks, which test every primitive's output. ``checked`` here does the
same eagerly: a dispatch mode looks at every operation's floating outputs
and raises ``FloatingPointError`` at the first non-finite one, naming the
operation, instead of letting NaN surface later in a poisoned state. It
waits for the device at every operation: a debugging tool, never the
production path. ``check_covariance`` raises its invariant's message
directly, and ``assert_finite`` checks every tensor of a nested structure.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rustrobotics_tpu_torch.utils.tree import leaves, leaves_with_path


class _FiniteCheck(TorchDispatchMode):
    """Raises at the first operation whose floating output holds a NaN
    or an inf (the mode is off while it runs its own check)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"nan or inf generated by {func}")
        return out


def checked(fn):
    """Wrap ``fn`` so calling it raises ``FloatingPointError`` on the first
    operation that makes a NaN or an inf, with the operation's name."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FiniteCheck():
            return fn(*args, **kwargs)

    return wrapper


def check_covariance(cov, atol=1e-5, name="cov"):
    """Raise ``ValueError`` unless the covariance (..., D, D) is symmetric
    within ``atol`` with a diagonal no lower than -atol."""
    asym = float(torch.max(torch.abs(cov - cov.mT)))
    if not asym < atol:
        raise ValueError(f"{name} not symmetric (max asym {asym})")
    dmin = float(torch.min(torch.diagonal(cov, dim1=-2, dim2=-1)))
    if not dmin >= -atol:
        raise ValueError(f"{name} diagonal negative ({dmin})")


def assert_finite(tree, name="pytree"):
    """Host-side: raise if any floating tensor or array of a nested
    structure holds NaN/Inf; returns the structure."""
    bad = []
    for path, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            if not bool(torch.isfinite(leaf).all()):
                bad.append(path)
        elif isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype,
                                                            np.floating):
            if not np.isfinite(leaf).all():
                bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
    return tree
