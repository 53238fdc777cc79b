"""Measurement models (counterpart of
``rustrobotics_tpu/models/measurement.py``): ``prediction(x, landmark)``
and the closed-form Jacobian; batching over particles or landmarks is
broadcasting over leading axes.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RangeBearingMeasurementModel:
    """Landmark range-bearing model, Probabilistic Robotics p. 177.

    State [x, y, theta]; landmark [lx, ly, ...] (extra dims ignored);
    z = [sqrt(q), atan2(dy, dx) - theta]. The Jacobian's (bearing, y)
    entry is -dx/q, as in the JAX package (the Rust reference has +dx/q).
    """

    @classmethod
    def create(cls):
        return cls()

    def prediction(self, x, landmark):
        dx = landmark[..., 0] - x[..., 0]
        dy = landmark[..., 1] - x[..., 1]
        q = dx * dx + dy * dy
        bearing = torch.atan2(dy, dx) - x[..., 2]
        return torch.stack([torch.sqrt(q), bearing], dim=-1)

    def jacobian(self, x, landmark):
        """(..., 2, 3) analytic Jacobian."""
        dx = landmark[..., 0] - x[..., 0]
        dy = landmark[..., 1] - x[..., 1]
        q = dx * dx + dy * dy
        qs = torch.sqrt(q)
        z = torch.zeros_like(dx)
        mone = -torch.ones_like(dx)
        return torch.stack(
            [
                torch.stack([-dx / qs, -dy / qs, z], dim=-1),
                torch.stack([dy / q, -dx / q, mone], dim=-1),
            ],
            dim=-2,
        )


@dataclasses.dataclass
class SimpleProblemMeasurementModel:
    """GPS-like direct (x, y) observation of a 4-dim state."""

    @classmethod
    def create(cls):
        return cls()

    def prediction(self, x, landmark=None):
        del landmark
        return x[..., :2]

    def jacobian(self, x, landmark=None):
        del landmark
        j = torch.zeros(x.shape[:-1] + (2, x.shape[-1]), dtype=x.dtype,
                        device=x.device)
        j[..., 0, 0] = 1.0
        j[..., 1, 1] = 1.0
        return j
