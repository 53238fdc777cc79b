"""Gaussian state container (counterpart of
``rustrobotics_tpu/utils/state.py``).

``x`` has shape (..., D) and ``cov`` (..., D, D), so a batch of Gaussians
is the same type as a single one. ``select`` is the JAX package's
``jax.tree.map(jnp.where...)`` over such a container: a select per tensor
field.
"""

from __future__ import annotations

import dataclasses

import torch

from rustrobotics_tpu_torch.device import tensor_fields


@dataclasses.dataclass
class GaussianState:
    """Mean + covariance. x: (..., D), cov: (..., D, D)."""

    x: torch.Tensor
    cov: torch.Tensor

    def __post_init__(self):
        tensor_fields(self, "x", "cov")

    @property
    def dim(self) -> int:
        return self.x.shape[-1]


def select(cond, a, b):
    """``a`` where ``cond`` else ``b``, field by field, for two dataclasses
    of one type. A Python or numpy bool picks one whole on the host; a
    tensor selects with ``torch.where`` on its device (no host read).
    Fields that are not tensors are taken from ``a``."""
    if not isinstance(cond, torch.Tensor):
        return a if bool(cond) else b
    out = {}
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, torch.Tensor):
            out[f.name] = torch.where(cond, va, vb)
    return dataclasses.replace(a, **out)
