"""SE(2) poses as (..., 3) tensors ``[x, y, theta]`` (counterpart of
``rustrobotics_tpu/geometry/se2.py``).

Compose, inverse, the residual chart (translation + wrapped angle) and the
boxplus retraction of the pose-graph optimizer. Every function works on
trailing dims and broadcasts over leading ones.
"""

from __future__ import annotations

import torch

from rustrobotics_tpu_torch.utils.angles import wrap_angle


def rotmat(theta: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., 2, 2) rotation matrices."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def _apply(r, v):
    """(..., 2, 2) @ (..., 2) -> (..., 2)."""
    return torch.einsum("...ij,...j->...i", r, v)


def compose(a, b) -> torch.Tensor:
    """a ∘ b for (..., 3) poses."""
    t = a[..., :2] + _apply(rotmat(a[..., 2]), b[..., :2])
    theta = wrap_angle(a[..., 2] + b[..., 2])
    return torch.cat([t, theta[..., None]], dim=-1)


def inverse(a) -> torch.Tensor:
    """a^{-1} for (..., 3) poses."""
    ra_t = rotmat(a[..., 2]).transpose(-1, -2)
    t = -_apply(ra_t, a[..., :2])
    return torch.cat([t, -a[..., 2:3]], dim=-1)


def transform(pose, points) -> torch.Tensor:
    """Apply pose (..., 3) to points (..., 2)."""
    return pose[..., :2] + _apply(rotmat(pose[..., 2]), points)


def retract(pose, delta) -> torch.Tensor:
    """Boxplus: additive translation, additive wrapped angle."""
    return torch.cat(
        [pose[..., :2] + delta[..., :2],
         wrap_angle(pose[..., 2:3] + delta[..., 2:3])],
        dim=-1,
    )


def relative(a, b) -> torch.Tensor:
    """a^{-1} ∘ b."""
    ra_t = rotmat(a[..., 2]).transpose(-1, -2)
    t = _apply(ra_t, b[..., :2] - a[..., :2])
    theta = wrap_angle(b[..., 2] - a[..., 2])
    return torch.cat([t, theta[..., None]], dim=-1)
