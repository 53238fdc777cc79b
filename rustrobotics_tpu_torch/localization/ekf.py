"""Extended Kalman filters (counterpart of
``rustrobotics_tpu/localization/ekf.py``).

Predict ``cov = G cov G^T + R``, gain ``K = cov H^T S^-1`` and the update
in Joseph form. The known-correspondence variant predicts with
``G cov G^T + V M V^T`` and applies per-landmark innovation updates
sequentially over a padded, masked measurement block; ``_update_one`` is
one slot's update without the mask, for a caller that skips the invalid
slots on the host. States may carry leading batch axes. Inverses use
``torch.linalg.inv_ex``, which neither checks nor waits for the card
(``jnp.linalg.inv`` returns inf/NaN and carries on), so a step makes no
host read.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from rustrobotics_tpu_torch.device import tensor_fields
from rustrobotics_tpu_torch.localization.landmark_table import LandmarkTable
from rustrobotics_tpu_torch.utils.angles import wrap_angle
from rustrobotics_tpu_torch.utils.state import GaussianState, select


def inv(a):
    """Batched inverse without the singularity check."""
    return torch.linalg.inv_ex(a).inverse


def wrap_bearing(innov):
    """Innovation with component 1 (a bearing difference) wrapped."""
    innov = innov.clone()
    innov[..., 1] = wrap_angle(innov[..., 1])
    return innov


def _kalman_update(x, cov, z, z_pred, h, q, wrap=None):
    """EKF innovation update in Joseph form,
    ``(I-KH) P (I-KH)^T + K Q K^T``: PSD-preserving in f32, where the
    short form ``(I - KH) P`` degrades (the JAX package's finding on the
    UTIAS replay). ``wrap``: optional innovation wrap (angle components).
    """
    innov = z - z_pred
    if wrap is not None:
        innov = wrap(innov)
    ht = h.mT
    s = h @ cov @ ht + q
    k = cov @ ht @ inv(s)
    x_new = x + (k @ innov[..., None])[..., 0]
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    ikh = eye - k @ h
    cov_new = ikh @ cov @ ikh.mT + k @ q @ k.mT
    return x_new, cov_new


@dataclasses.dataclass
class ExtendedKalmanFilter:
    """EKF with additive state noise R and measurement noise Q."""

    r: torch.Tensor  # (S, S) process noise
    q: torch.Tensor  # (Z, Z) measurement noise
    motion_model: Any
    measurement_model: Any

    def __post_init__(self):
        tensor_fields(self, "r", "q")

    def predict(self, state: GaussianState, u, dt) -> GaussianState:
        g = self.motion_model.jacobian_wrt_state(state.x, u, dt)
        x = self.motion_model.prediction(state.x, u, dt)
        cov = g @ state.cov @ g.mT + self.r
        return GaussianState(x=x, cov=cov)

    def update(self, state: GaussianState, z) -> GaussianState:
        h = self.measurement_model.jacobian(state.x)
        z_pred = self.measurement_model.prediction(state.x)
        x, cov = _kalman_update(state.x, state.cov, z, z_pred, h, self.q)
        return GaussianState(x=x, cov=cov)

    def step(self, state: GaussianState, u, z, dt) -> GaussianState:
        return self.update(self.predict(state, u, dt), z)


@dataclasses.dataclass
class ExtendedKalmanFilterKnownCorrespondences:
    """EKF against a known landmark map.

    ``step`` consumes one merged event: optional control (``has_control``)
    and a padded measurement block (ids (M,), z (M, Z), mask (M,)).
    Measurements whose id is absent from the table are masked out, and the
    updates run in slot order.
    """

    q: torch.Tensor  # (Z, Z)
    landmarks: LandmarkTable
    motion_model: Any
    measurement_model: Any

    def __post_init__(self):
        tensor_fields(self, "q")

    def predict(self, state: GaussianState, u, dt) -> GaussianState:
        g = self.motion_model.jacobian_wrt_state(state.x, u, dt)
        v = self.motion_model.jacobian_wrt_input(state.x, u, dt)
        m = self.motion_model.cov_noise_control_space(u)
        x = self.motion_model.prediction(state.x, u, dt)
        cov = g @ state.cov @ g.mT + v @ m @ v.mT
        return GaussianState(x=x, cov=cov)

    def _update_one(self, state: GaussianState, lm, z) -> GaussianState:
        """One landmark's update (lm (D,), z (Z,)), unmasked."""
        z_pred = self.measurement_model.prediction(state.x, lm)
        h = self.measurement_model.jacobian(state.x, lm)
        x, cov = _kalman_update(state.x, state.cov, z, z_pred, h, self.q,
                                wrap=wrap_bearing)
        return GaussianState(x=x, cov=cov)

    def update(self, state: GaussianState, ids, z, mask) -> GaussianState:
        return sequential_updates(self, state, ids, z, mask)

    def step(self, state, u, has_control, ids, z, mask, dt) -> GaussianState:
        state = select(has_control, self.predict(state, u, dt), state)
        return self.update(state, ids, z, mask)


def sequential_updates(filt, state, ids, z, mask):
    """``filt._update_one`` slot by slot over a padded block (ids (M,),
    z (M, Z), mask (M,)); a slot that is masked or names an id the table
    lacks leaves the state as it was (a select, no host read)."""
    lms, valid = filt.landmarks.lookup(ids)
    valid = torch.logical_and(valid, mask)
    for m in range(ids.shape[0]):
        state = select(valid[m], filt._update_one(state, lms[m], z[m]), state)
    return state
