"""Extended Information Filter, the dual of the EKF (counterpart of
``rustrobotics_tpu/localization/eif.py``).

State in information form: ``lam = cov^-1`` and ``eta = lam @ x``.
Measurement updates are additive (``lam += H^T Q^-1 H``,
``eta += H^T Q^-1 (z - z_pred + H x)``), so the known-correspondence
variant sums its per-landmark contributions in one batched reduction;
prediction goes through moment form. Inverses and solves use
``torch.linalg.inv_ex`` / ``solve_ex``, which do not wait for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from rustrobotics_tpu_torch.device import tensor_fields
from rustrobotics_tpu_torch.localization.ekf import inv, wrap_bearing
from rustrobotics_tpu_torch.localization.landmark_table import LandmarkTable
from rustrobotics_tpu_torch.utils.state import GaussianState, select


def _solve(a, b):
    return torch.linalg.solve_ex(a, b).result


@dataclasses.dataclass
class InformationState:
    """Canonical-form Gaussian: eta = lam x, lam = cov^-1."""

    eta: torch.Tensor  # (S,)
    lam: torch.Tensor  # (S, S)

    def __post_init__(self):
        tensor_fields(self, "eta", "lam")

    @classmethod
    def from_moments(cls, state: GaussianState) -> "InformationState":
        lam = inv(state.cov)
        return cls(eta=lam @ state.x, lam=lam)

    def to_moments(self) -> GaussianState:
        cov = inv(self.lam)
        return GaussianState(x=cov @ self.eta, cov=cov)

    @property
    def x(self):
        return _solve(self.lam, self.eta)


@dataclasses.dataclass
class ExtendedInformationFilter:
    """EIF with additive state noise R and measurement noise Q."""

    r: torch.Tensor  # (S, S) process noise
    q: torch.Tensor  # (Z, Z) measurement noise
    motion_model: Any
    measurement_model: Any

    def __post_init__(self):
        tensor_fields(self, "r", "q")

    def predict(self, state: InformationState, u, dt) -> InformationState:
        """Through moment form: the information parameterization's one
        inverse pair."""
        cov = inv(state.lam)
        x = cov @ state.eta
        g = self.motion_model.jacobian_wrt_state(x, u, dt)
        x_new = self.motion_model.prediction(x, u, dt)
        lam = inv(g @ cov @ g.T + self.r)
        return InformationState(eta=lam @ x_new, lam=lam)

    def update(self, state: InformationState, z) -> InformationState:
        x = _solve(state.lam, state.eta)
        h = self.measurement_model.jacobian(x)
        z_pred = self.measurement_model.prediction(x)
        ht_qi = h.T @ inv(self.q)
        lam = state.lam + ht_qi @ h
        eta = state.eta + ht_qi @ (z - z_pred + h @ x)
        return InformationState(eta=eta, lam=lam)

    def step(self, state: InformationState, u, z, dt) -> InformationState:
        return self.update(self.predict(state, u, dt), z)


@dataclasses.dataclass
class ExtendedInformationFilterKnownCorrespondences:
    """EIF against a known landmark map: the per-landmark updates are
    batched rank-Z adds at the common predicted state, summed in one
    reduction (the EKF applies them one after another)."""

    q: torch.Tensor  # (Z, Z)
    landmarks: LandmarkTable
    motion_model: Any
    measurement_model: Any

    def __post_init__(self):
        tensor_fields(self, "q")

    def predict(self, state: InformationState, u, dt) -> InformationState:
        cov = inv(state.lam)
        x = cov @ state.eta
        g = self.motion_model.jacobian_wrt_state(x, u, dt)
        v = self.motion_model.jacobian_wrt_input(x, u, dt)
        m = self.motion_model.cov_noise_control_space(u)
        x_new = self.motion_model.prediction(x, u, dt)
        lam = inv(g @ cov @ g.T + v @ m @ v.T)
        return InformationState(eta=lam @ x_new, lam=lam)

    def update(self, state: InformationState, ids, z,
               mask) -> InformationState:
        lms, valid = self.landmarks.lookup(ids)
        valid = torch.logical_and(valid, mask)
        x = _solve(state.lam, state.eta)
        z_pred = self.measurement_model.prediction(x, lms)  # (M, Z)
        h = self.measurement_model.jacobian(x, lms)  # (M, Z, S)
        innov = wrap_bearing(z - z_pred)
        w = valid.to(x.dtype)
        ht_qi = h.mT @ inv(self.q)  # (M, S, Z)
        lam = state.lam + ((ht_qi @ h) * w[:, None, None]).sum(0)
        rhs = innov + h @ x
        eta = state.eta + ((ht_qi @ rhs[..., None])[..., 0]
                           * w[:, None]).sum(0)
        return InformationState(eta=eta, lam=lam)

    def step(self, state, u, has_control, ids, z, mask,
             dt) -> InformationState:
        state = select(has_control, self.predict(state, u, dt), state)
        return self.update(state, ids, z, mask)
