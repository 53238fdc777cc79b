"""Linear-Quadratic-Gaussian control: LQR + Kalman estimator (counterpart
of ``rustrobotics_tpu/control/lqg.py``).

By the separation principle the optimal controller for a linear system
with Gaussian process/measurement noise is the LQR state-feedback gain
applied to the Kalman-filter state estimate. The steady-state Kalman gain
reuses the same DARE solver as the LQR (the filter DARE is the control
DARE on the transposed system). A closed-loop rollout is a Python loop of
steps with no host read; ``rollout`` draws its noise from a
``torch.Generator``, ``_rollout`` takes it.
"""

from __future__ import annotations

import dataclasses

import torch

from rustrobotics_tpu_torch.control.lqr import (
    LinearTimeInvariantModel,
    lqr,
    solve_dare,
)
from rustrobotics_tpu_torch.device import as_tensor, tensor_fields


@dataclasses.dataclass
class LQGController:
    """u = -K x_hat; x_hat via the steady-state Kalman predictor."""

    k: torch.Tensor       # (U, S) LQR gain
    l: torch.Tensor       # (S, Z) steady-state Kalman gain  # noqa: E741
    a: torch.Tensor       # (S, S)
    b: torch.Tensor       # (S, U)
    c: torch.Tensor       # (Z, S) observation matrix

    def __post_init__(self):
        tensor_fields(self, "k", "l", "a", "b", "c")

    def control(self, x_hat):
        return -self.k @ x_hat

    def step(self, x_hat, z):
        """One closed-loop step: ``x_hat`` is the PREDICTED estimate
        x̂_{t|t-1}; the current measurement z_t corrects it, the control
        acts on the corrected estimate, and the next prediction
        propagates through the model:

            x̂_{t|t}   = x̂_{t|t-1} + L (z_t - C x̂_{t|t-1})
            u_t        = -K x̂_{t|t}
            x̂_{t+1|t} = A x̂_{t|t} + B u_t

        Returns (u_t, x̂_{t+1|t})."""
        corr = x_hat + self.l @ (z - self.c @ x_hat)
        u = -self.k @ corr
        return u, self.a @ corr + self.b @ u


def lqg_from_numpy(k, l, a, b, c, device=None,  # noqa: E741
                   dtype=None) -> LQGController:
    """An ``LQGController`` from the JAX package's controller carried
    across as numpy arrays."""
    return LQGController(*(as_tensor(x, device, dtype)
                           for x in (k, l, a, b, c)))


def kalman_gain(a, c, w, v, max_iter: int = 500,
                epsilon: float = 1e-9) -> torch.Tensor:
    """Steady-state (predictor-form) Kalman gain for x' = A x + w,
    z = C x + v, via the dual DARE: (A, B, Q, R) -> (A^T, C^T, W, V)."""
    w, v = as_tensor(w, a.device, a.dtype), as_tensor(v, a.device, a.dtype)
    dual = LinearTimeInvariantModel(a=a.T, b=c.T, q=w, r=v)
    p = solve_dare(dual, max_iter, epsilon)
    return p @ c.T @ torch.linalg.inv_ex(c @ p @ c.T + v).inverse


def lqg(model: LinearTimeInvariantModel, c, w, v,
        max_iter: int = 500, epsilon: float = 1e-9) -> LQGController:
    """Synthesize the LQG controller: LQR gain on (A, B, Q, R) +
    steady-state Kalman gain on (A, C, W, V)."""
    c = as_tensor(c, model.a.device, model.a.dtype)
    k = lqr(model, max_iter, epsilon=0.01)
    gain_l = kalman_gain(model.a, c, w, v, max_iter, epsilon)
    return LQGController(k=k, l=gain_l, a=model.a, b=model.b, c=c)


def rollout(controller: LQGController, generator, x0, num_steps: int,
            w_chol, v_chol):
    """Closed-loop stochastic rollout: returns the state trajectory
    (T, S), estimates (T, S) and controls (T, U). w_chol/v_chol: Cholesky
    factors of the process/measurement noise."""
    x0 = as_tensor(x0)
    kw = dict(generator=generator, dtype=x0.dtype, device=x0.device)
    w_noise = torch.randn((num_steps, x0.shape[0]), **kw)
    v_noise = torch.randn((num_steps, controller.c.shape[0]), **kw)
    return _rollout(controller, x0, w_noise, v_noise, w_chol, v_chol)


def _rollout(controller: LQGController, x0, w_noise, v_noise, w_chol,
             v_chol):
    """``rollout`` on drawn standard normals: process ``w_noise`` (T, S)
    and measurement ``v_noise`` (T, Z)."""
    x0 = as_tensor(x0)
    w_chol = as_tensor(w_chol, x0.device, x0.dtype)
    v_chol = as_tensor(v_chol, x0.device, x0.dtype)
    x, x_hat = x0, torch.zeros_like(x0)
    xs, xhs, us = [], [], []
    for t in range(w_noise.shape[0]):
        z = controller.c @ x + v_chol @ v_noise[t]
        u, x_hat = controller.step(x_hat, z)
        x = controller.a @ x + controller.b @ u + w_chol @ w_noise[t]
        xs.append(x)
        xhs.append(x_hat)
        us.append(u)
    return torch.stack(xs), torch.stack(xhs), torch.stack(us)
