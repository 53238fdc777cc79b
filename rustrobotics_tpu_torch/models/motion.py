"""Motion models (counterpart of ``rustrobotics_tpu/models/motion.py``).

Prediction, Jacobians w.r.t. state and input, control-space noise
covariance and stochastic sampling, as pure functions of tensors with any
leading batch axes. ``sample(generator, ...)`` draws its standard normals
from a ``torch.Generator``; ``_sample(..., noise)`` takes them directly, in
the shapes the JAX package draws them.

As in the JAX package, ``Velocity::jacobian_wrt_input`` reads the angular
rate from the control (the Rust reference reads it from the state).
"""

from __future__ import annotations

import dataclasses

import torch

from rustrobotics_tpu_torch.device import as_tensor, tensor_fields
from rustrobotics_tpu_torch.utils.angles import wrap_angle

_OMEGA_EPS = 1e-10  # |omega| below this uses the straight-line branch


def _randn(generator, shape, like):
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


@dataclasses.dataclass
class VelocityMotionModel:
    """Unicycle velocity model, Probabilistic Robotics ch. 5.

    State [x, y, theta], control [v, omega]. Exact-arc prediction with a
    straight-line branch for omega ~ 0, selected with ``torch.where`` so
    the model has no branch on a device value.
    """

    alpha: torch.Tensor  # (6,) noise coefficients a0..a5

    def __post_init__(self):
        tensor_fields(self, "alpha")

    @classmethod
    def create(cls, alpha, device=None, dtype=None):
        return cls(alpha=as_tensor(alpha, device, dtype))

    def prediction(self, x, u, dt):
        theta = x[..., 2]
        v, w = u[..., 0], u[..., 1]
        straight = torch.abs(w) < _OMEGA_EPS
        ws = torch.where(straight, torch.ones_like(w), w)  # safe denominator
        arc_dx = v / ws * (-torch.sin(theta) + torch.sin(theta + w * dt))
        arc_dy = v / ws * (torch.cos(theta) - torch.cos(theta + w * dt))
        lin_dx = v * torch.cos(theta) * dt
        lin_dy = v * torch.sin(theta) * dt
        dx = torch.where(straight, lin_dx, arc_dx)
        dy = torch.where(straight, lin_dy, arc_dy)
        return torch.stack(
            [x[..., 0] + dx, x[..., 1] + dy, wrap_angle(theta + w * dt)],
            dim=-1)

    def jacobian_wrt_state(self, x, u, dt):
        """df/dx, (..., 3, 3). The straight branch's dy/dtheta is
        +v cos(theta) dt, as in the JAX package."""
        theta = x[..., 2]
        v, w = u[..., 0], u[..., 1]
        straight = torch.abs(w) < _OMEGA_EPS
        ws = torch.where(straight, torch.ones_like(w), w)
        j02 = torch.where(
            straight,
            -v * torch.sin(theta) * dt,
            v / ws * (-torch.cos(theta) + torch.cos(theta + w * dt)),
        )
        j12 = torch.where(
            straight,
            v * torch.cos(theta) * dt,
            v / ws * (-torch.sin(theta) + torch.sin(theta + w * dt)),
        )
        one = torch.ones_like(theta)
        zero = torch.zeros_like(theta)
        return torch.stack(
            [
                torch.stack([one, zero, j02], dim=-1),
                torch.stack([zero, one, j12], dim=-1),
                torch.stack([zero, zero, one], dim=-1),
            ],
            dim=-2,
        )

    def jacobian_wrt_input(self, x, u, dt):
        """df/du, (..., 3, 2)."""
        theta = x[..., 2]
        v, w = u[..., 0], u[..., 1]
        straight = torch.abs(w) < _OMEGA_EPS
        ws = torch.where(straight, torch.ones_like(w), w)
        sint, cost = torch.sin(theta), torch.cos(theta)
        sintdt, costdt = torch.sin(theta + w * dt), torch.cos(theta + w * dt)
        w2 = ws * ws
        j00 = torch.where(straight, cost * dt, (-sint + sintdt) / ws)
        j10 = torch.where(straight, sint * dt, (cost - costdt) / ws)
        zeros = torch.zeros_like(j00)
        j01 = torch.where(
            straight, zeros, v * ((sint - sintdt) / w2 + costdt * dt / ws))
        j11 = torch.where(
            straight, zeros, v * (-(cost - costdt) / w2 + sintdt * dt / ws))
        dt_arr = zeros + dt
        return torch.stack(
            [
                torch.stack([j00, j01], dim=-1),
                torch.stack([j10, j11], dim=-1),
                torch.stack([zeros, dt_arr], dim=-1),
            ],
            dim=-2,
        )

    def cov_noise_control_space(self, u):
        """diag(a0 v^2 + a1 w^2 + eps, a2 v^2 + a3 w^2 + eps)."""
        v2 = torch.square(u[..., 0])
        w2 = torch.square(u[..., 1])
        eps = 1e-5
        a = self.alpha
        d0 = a[0] * v2 + a[1] * w2 + eps
        d1 = a[2] * v2 + a[3] * w2 + eps
        zeros = torch.zeros_like(d0)
        return torch.stack(
            [torch.stack([d0, zeros], dim=-1),
             torch.stack([zeros, d1], dim=-1)],
            dim=-2,
        )

    def pose_noise_cov(self, x, u, dt):
        """(3, 3) pose-space covariance of ONE ``sample`` step: V M V^T
        plus the gamma heading-diffusion term (a4 v^2 + a5 w^2) dt^2."""
        v_jac = self.jacobian_wrt_input(x, u, dt)
        m = self.cov_noise_control_space(u)
        cov = v_jac @ m @ v_jac.mT
        v2 = torch.square(u[..., 0])
        w2 = torch.square(u[..., 1])
        a = self.alpha
        a4 = a[4] if a.shape[-1] > 4 else a[-1]
        a5 = a[5] if a.shape[-1] > 5 else a[-1]
        g_var = (a4 * v2 + a5 * w2) * dt * dt
        cov = cov.clone()
        cov[..., 2, 2] += g_var
        return cov

    def sample(self, generator, x, u, dt):
        """Noisy propagation with the gamma heading term; three standard
        normals per state (v, omega, gamma)."""
        return self._sample(x, u, dt, _randn(generator, (3,) + x.shape[:-1],
                                             x))

    def _sample(self, x, u, dt, noise):
        """``sample`` on drawn normals ``noise`` (3, ...) = (v, omega,
        gamma), each of shape x.shape[:-1]."""
        theta = x[..., 2]
        v, w = u[..., 0], u[..., 1]
        v2, w2 = torch.square(v), torch.square(w)
        eps = 1e-5
        a = self.alpha
        std_v = torch.sqrt(a[0] * v2 + a[1] * w2 + eps)
        std_w = torch.sqrt(a[2] * v2 + a[3] * w2 + eps)
        std_g = torch.sqrt(a[4] * v2 + a[5] * w2)
        vn = v + std_v * noise[0]
        wn = w + std_w * noise[1]
        gn = std_g * noise[2]
        straight = torch.abs(wn) < _OMEGA_EPS
        wns = torch.where(straight, torch.ones_like(wn), wn)
        dx = torch.where(
            straight,
            vn * torch.cos(theta) * dt,
            vn / wns * (-torch.sin(theta) + torch.sin(theta + wn * dt)),
        )
        dy = torch.where(
            straight,
            vn * torch.sin(theta) * dt,
            vn / wns * (torch.cos(theta) - torch.cos(theta + wn * dt)),
        )
        return torch.stack(
            [x[..., 0] + dx, x[..., 1] + dy,
             wrap_angle(theta + wn * dt + gn * dt)],
            dim=-1,
        )


@dataclasses.dataclass
class SimpleProblemMotionModel:
    """4-state [x, y, yaw, v] constant-velocity + yaw-rate demo model.
    Control [v, omega]."""

    @classmethod
    def create(cls):
        return cls()

    def prediction(self, x, u, dt):
        yaw, v = x[..., 2], x[..., 3]
        return torch.stack(
            [
                x[..., 0] + torch.cos(yaw) * v * dt,
                x[..., 1] + torch.sin(yaw) * v * dt,
                yaw + u[..., 1] * dt,
                u[..., 0] * torch.ones_like(yaw),
            ],
            dim=-1,
        )

    def jacobian_wrt_state(self, x, u, dt):
        """(..., 4, 4); reads v from the control u[0], as the reference
        does."""
        yaw = x[..., 2]
        v = u[..., 0]
        z = torch.zeros_like(yaw)
        one = torch.ones_like(yaw)
        dt_ = dt * one
        return torch.stack(
            [
                torch.stack([one, z, -dt_ * v * torch.sin(yaw),
                             dt_ * torch.cos(yaw)], -1),
                torch.stack([z, one, dt_ * v * torch.cos(yaw),
                             dt_ * torch.sin(yaw)], -1),
                torch.stack([z, z, one, z], -1),
                torch.stack([z, z, z, z], -1),
            ],
            dim=-2,
        )

    def sample(self, generator, x, u, dt):
        # deterministic: the filter adds its own R noise (as in the JAX
        # package; the reference leaves this unimplemented)
        del generator
        return self.prediction(x, u, dt)

    def _sample(self, x, u, dt, noise=None):
        del noise
        return self.prediction(x, u, dt)


@dataclasses.dataclass
class OdometryMotionModel:
    """Odometry (rot1-trans-rot2) motion model (Probabilistic Robotics
    ch. 5.4). Control u = [rot1, trans, rot2]; dt is ignored.

    alphas = [a1..a4]: control-space noise
    var = [a1 r1^2 + a2 t^2, a3 t^2 + a4 (r1^2 + r2^2), a1 r2^2 + a2 t^2].
    """

    alphas: torch.Tensor  # (4,)

    def __post_init__(self):
        tensor_fields(self, "alphas")

    @classmethod
    def create(cls, alphas, device=None, dtype=None):
        return cls(alphas=as_tensor(alphas, device, dtype))

    def prediction(self, x, u, dt):
        del dt
        r1, t, r2 = u[..., 0], u[..., 1], u[..., 2]
        heading = x[..., 2] + r1
        return torch.stack(
            [
                x[..., 0] + t * torch.cos(heading),
                x[..., 1] + t * torch.sin(heading),
                wrap_angle(x[..., 2] + r1 + r2),
            ],
            dim=-1,
        )

    def jacobian_wrt_state(self, x, u, dt):
        del dt
        r1, t = u[..., 0], u[..., 1]
        heading = x[..., 2] + r1
        z = torch.zeros_like(heading)
        one = torch.ones_like(heading)
        return torch.stack(
            [
                torch.stack([one, z, -t * torch.sin(heading)], -1),
                torch.stack([z, one, t * torch.cos(heading)], -1),
                torch.stack([z, z, one], -1),
            ],
            dim=-2,
        )

    def jacobian_wrt_input(self, x, u, dt):
        """(..., 3, 3) w.r.t. [rot1, trans, rot2]."""
        del dt
        r1, t = u[..., 0], u[..., 1]
        heading = x[..., 2] + r1
        z = torch.zeros_like(heading)
        one = torch.ones_like(heading)
        return torch.stack(
            [
                torch.stack([-t * torch.sin(heading), torch.cos(heading), z],
                            -1),
                torch.stack([t * torch.cos(heading), torch.sin(heading), z],
                            -1),
                torch.stack([one, z, one], -1),
            ],
            dim=-2,
        )

    def cov_noise_control_space(self, u):
        a1, a2, a3, a4 = (self.alphas[..., k] for k in range(4))
        r1, t, r2 = u[..., 0], u[..., 1], u[..., 2]
        v = torch.stack(
            [
                a1 * r1**2 + a2 * t**2,
                a3 * t**2 + a4 * (r1**2 + r2**2),
                a1 * r2**2 + a2 * t**2,
            ],
            dim=-1,
        )
        return torch.diag_embed(v)

    def pose_noise_cov(self, x, u, dt):
        """(3, 3) pose-space covariance of one ``sample`` step (V M V^T)."""
        v_jac = self.jacobian_wrt_input(x, u, dt)
        m = self.cov_noise_control_space(u)
        return v_jac @ m @ v_jac.mT

    def sample(self, generator, x, u, dt):
        """Noisy odometry step: one standard normal per control component
        (u's shape, as the JAX package draws it)."""
        return self._sample(x, u, dt, _randn(generator, u.shape, x))

    def _sample(self, x, u, dt, noise):
        var = torch.diagonal(self.cov_noise_control_space(u), 0, -2, -1)
        std = torch.sqrt(torch.clamp(var, min=1e-20))
        return self.prediction(x, u + noise * std, dt)
