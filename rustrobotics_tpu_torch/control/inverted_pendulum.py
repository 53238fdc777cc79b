"""Inverted pendulum on a cart, LQR-stabilized (counterpart of
``rustrobotics_tpu/control/inverted_pendulum.py``): Euler-discretized
cart-pole linear model, LQR gain, closed-loop rollout as a Python loop of
steps with no host read."""

from __future__ import annotations

import dataclasses

import torch

from rustrobotics_tpu_torch.control.lqr import LinearTimeInvariantModel, lqr
from rustrobotics_tpu_torch.device import (
    as_tensor,
    resolve_device,
    tensor_fields,
)


@dataclasses.dataclass
class InvertedPendulumModel:
    """State [x, x_dot, theta, theta_dot]."""

    da: torch.Tensor  # (4, 4) continuous-time A
    db: torch.Tensor  # (4, 1) continuous-time B
    q: torch.Tensor
    r: torch.Tensor

    def __post_init__(self):
        tensor_fields(self, "da", "db", "q", "r")

    @classmethod
    def create(cls, l_bar=2.0, mass_cart=1.0, mass_ball=0.3, g=9.8,
               dtype=torch.float32, device=None):
        device = resolve_device(device)
        da = torch.tensor(
            [
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, mass_ball * g / mass_cart, 0.0],
                [0.0, 0.0, 0.0, 1.0],
                [0.0, 0.0, g * (mass_cart + mass_ball) / (l_bar * mass_cart),
                 0.0],
            ],
            dtype=dtype,
        )
        db = torch.tensor(
            [[0.0], [1.0 / mass_cart], [0.0], [1.0 / (l_bar * mass_cart)]],
            dtype=dtype,
        )
        q = torch.diag(torch.tensor([10.0, 1.0, 10.0, 1.0], dtype=dtype))
        r = torch.tensor([[0.01]], dtype=dtype)
        return cls(da=da.to(device), db=db.to(device), q=q.to(device),
                   r=r.to(device))

    def linearize(self, dt) -> LinearTimeInvariantModel:
        """Euler discretization."""
        eye = torch.eye(4, dtype=self.da.dtype, device=self.da.device)
        return LinearTimeInvariantModel(
            a=eye + dt * self.da, b=dt * self.db, q=self.q, r=self.r)


def pendulum_from_numpy(da, db, q, r, device=None,
                        dtype=None) -> InvertedPendulumModel:
    """An ``InvertedPendulumModel`` from the JAX package's model carried
    across as numpy arrays."""
    return InvertedPendulumModel(*(as_tensor(x, device, dtype)
                                   for x in (da, db, q, r)))


def simulate_inverted_pendulum(
    sim_time=5.0, dt=0.01, x0=(0.0, 0.0, -0.2, 0.0), max_iter=500,
    epsilon=0.01, dtype=torch.float32, device=None,
):
    """Closed-loop LQR rollout. Returns (states (T+1, 4), commands
    (T+1,)) on ``device`` (None: the card)."""
    model = InvertedPendulumModel.create(dtype=dtype, device=device)
    lin = model.linearize(dt)
    k_gain = lqr(lin, max_iter=max_iter, epsilon=epsilon)
    num_steps = int(sim_time / dt)
    x = torch.tensor(x0, dtype=dtype).to(lin.a.device)
    xs, us = [x], [torch.zeros(1, dtype=dtype, device=x.device)]
    for _ in range(num_steps):
        u = -(k_gain @ x)
        x = lin.a @ x + lin.b @ u
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.cat(us)
