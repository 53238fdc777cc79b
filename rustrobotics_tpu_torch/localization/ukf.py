"""Unscented Kalman filter with scaled sigma points (counterpart of
``rustrobotics_tpu/localization/ukf.py``).

Weights from (alpha, beta, kappa), 2n+1 sigma points on one (..., 2S+1, S)
axis through a Cholesky square root scaled by gamma, weighted-moment
predict/update and the cross-covariance gain. The square root is
``mvn.cholesky`` (NaN on a matrix that is not positive definite, no host
read) and the inverses ``torch.linalg.inv_ex``. States may carry leading
batch axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from rustrobotics_tpu_torch.device import as_tensor, tensor_fields
from rustrobotics_tpu_torch.localization.ekf import inv, sequential_updates
from rustrobotics_tpu_torch.utils.angles import wrap_angle
from rustrobotics_tpu_torch.utils.mvn import cholesky
from rustrobotics_tpu_torch.utils.state import GaussianState, select


def sigma_weights(dim: int, alpha: float, beta: float, kappa: float):
    """Scaled sigma-point weights: (mean weights, cov weights) as f64
    numpy arrays, and gamma."""
    lam = alpha**2 * (dim + kappa) - dim
    v = 1.0 / (2.0 * (dim + lam))
    mw = np.full(2 * dim + 1, v)
    cw = np.full(2 * dim + 1, v)
    mw[0] = lam / (dim + lam)
    cw[0] = lam / (dim + lam) + 1.0 - alpha**2 + beta
    gamma = np.sqrt(dim + lam)
    return mw, cw, gamma


def _sigma(x, cov, gamma):
    """(..., 2S+1, S) points: [x, x + gamma*L_i, x - gamma*L_i]."""
    cols = (cholesky(cov) * gamma).mT  # row i is gamma * L[:, i]
    x = x[..., None, :]
    return torch.cat([x, x + cols, x - cols], dim=-2)


def _moment(w, a, b):
    """sum_k w_k a_k b_k^T over the sigma axis: (..., K, I), (..., K, J)
    -> (..., I, J)."""
    return (a * w[:, None]).mT @ b


@dataclasses.dataclass
class UnscentedKalmanFilter:
    q: torch.Tensor  # (S, S) process noise (the reference calls it q)
    r: torch.Tensor  # (Z, Z) measurement noise
    gamma: torch.Tensor  # scalar
    mw: torch.Tensor  # (2S+1,) mean weights
    cw: torch.Tensor  # (2S+1,) cov weights
    motion_model: Any
    measurement_model: Any

    def __post_init__(self):
        tensor_fields(self, "q", "r", "gamma", "mw", "cw")

    @classmethod
    def create(cls, q, r, measurement_model, motion_model, alpha, beta,
               kappa, device=None, dtype=None):
        q = as_tensor(q, device, dtype)
        mw, cw, gamma = sigma_weights(q.shape[-1], alpha, beta, kappa)
        return cls(
            q=q,
            r=as_tensor(r, q.device, q.dtype),
            gamma=torch.as_tensor(gamma, dtype=q.dtype, device=q.device),
            mw=torch.as_tensor(mw, dtype=q.dtype, device=q.device),
            cw=torch.as_tensor(cw, dtype=q.dtype, device=q.device),
            motion_model=motion_model,
            measurement_model=measurement_model,
        )

    def sigma_points(self, state: GaussianState) -> torch.Tensor:
        """(..., 2S+1, S) points (the reference interleaves columns in
        another order; the weighted moments do not depend on it)."""
        return _sigma(state.x, state.cov, self.gamma)

    def step(self, state: GaussianState, u, z, dt) -> GaussianState:
        # predict
        sp = self.sigma_points(state)
        sp_pred = self.motion_model.prediction(sp, u[..., None, :], dt)
        mean_pred = self.mw @ sp_pred
        dxp = sp_pred - mean_pred[..., None, :]
        cov_pred = _moment(self.cw, dxp, dxp) + self.q

        # update (fresh sigma points around the prediction)
        sp2 = self.sigma_points(GaussianState(x=mean_pred, cov=cov_pred))
        sp_z = self.measurement_model.prediction(sp2)
        mean_z = self.mw @ sp_z
        dz = sp_z - mean_z[..., None, :]
        cov_z = _moment(self.cw, dz, dz) + self.r
        dx2 = sp2 - mean_pred[..., None, :]
        cross = _moment(self.cw, dx2, dz)

        gain = cross @ inv(cov_z)
        x = mean_pred + (gain @ (z - mean_z)[..., None])[..., 0]
        cov = cov_pred - gain @ cov_z @ gain.mT
        return GaussianState(x=x, cov=cov)


@dataclasses.dataclass
class UnscentedKalmanFilterKnownCorrespondences:
    """UKF against a known landmark map (the reference leaves it
    ``todo!()``).

    Predict: sigma points through the motion model, plus control-space
    noise mapped through the input Jacobian (V M V^T). Update:
    per-measurement sigma points through the landmark measurement model,
    in slot order over a padded masked block; ``_update_one`` is one slot
    without the mask.
    """

    q: torch.Tensor  # (Z, Z) measurement noise
    gamma: torch.Tensor
    mw: torch.Tensor
    cw: torch.Tensor
    landmarks: Any
    motion_model: Any
    measurement_model: Any

    def __post_init__(self):
        tensor_fields(self, "q", "gamma", "mw", "cw")

    @classmethod
    def create(cls, q, landmarks, measurement_model, motion_model,
               alpha=1.0, beta=2.0, kappa=0.0, state_dim=3, dtype=None,
               device=None):
        q = as_tensor(q, device)
        dtype = dtype or q.dtype
        mw, cw, gamma = sigma_weights(state_dim, alpha, beta, kappa)

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=q.device)

        return cls(q=q, gamma=t(gamma), mw=t(mw), cw=t(cw),
                   landmarks=landmarks, motion_model=motion_model,
                   measurement_model=measurement_model)

    def _sigma_points(self, state: GaussianState):
        return _sigma(state.x, state.cov, self.gamma)

    def predict(self, state: GaussianState, u, dt) -> GaussianState:
        sp = self._sigma_points(state)
        sp_pred = self.motion_model.prediction(sp, u[..., None, :], dt)
        mean = self.mw @ sp_pred
        dx = sp_pred - mean[..., None, :]
        v = self.motion_model.jacobian_wrt_input(mean, u, dt)
        m = self.motion_model.cov_noise_control_space(u)
        cov = _moment(self.cw, dx, dx) + v @ m @ v.mT
        return GaussianState(x=mean, cov=cov)

    def _update_one(self, st: GaussianState, lm, z) -> GaussianState:
        sp = self._sigma_points(st)
        sp_z = self.measurement_model.prediction(sp, lm)
        # bearings are circular: re-center the sigma bearings on the first
        # point's, so that a spread straddling +-pi keeps its weighted
        # mean, and wrap the innovation
        b0 = sp_z[..., :1, 1]
        sp_z[..., 1] = b0 + wrap_angle(sp_z[..., 1] - b0)
        mean_z = self.mw @ sp_z
        dz = sp_z - mean_z[..., None, :]
        cov_z = _moment(self.cw, dz, dz) + self.q
        dx = sp - st.x[..., None, :]
        cross = _moment(self.cw, dx, dz)
        gain = cross @ inv(cov_z)
        innov = z - mean_z
        innov[..., 1] = wrap_angle(z[..., 1] - mean_z[..., 1])
        x = st.x + (gain @ innov[..., None])[..., 0]
        cov = st.cov - gain @ cov_z @ gain.mT
        return GaussianState(x=x, cov=cov)

    def update(self, state: GaussianState, ids, z, mask) -> GaussianState:
        return sequential_updates(self, state, ids, z, mask)

    def step(self, state, u, has_control, ids, z, mask, dt) -> GaussianState:
        state = select(has_control, self.predict(state, u, dt), state)
        return self.update(state, ids, z, mask)
