"""EKF-SLAM with known and unknown correspondences, and the Schmidt
(consider-state) update (counterpart of
``rustrobotics_tpu/mapping/ekf_slam.py``; Probabilistic Robotics ch. 10).

A joint state [robot pose (3) | landmark positions (2 each)] with its full
joint covariance; prediction propagates the robot block and its cross
terms; each measurement of a landmark slot initializes it on first sight
and then applies the EKF innovation over the sparse (robot, landmark)
Jacobian, in Joseph form.

Landmark capacity is static (``max_landmarks``) and a step's measurement
block is padded and masked, as in the JAX package. A slot index ``k`` may
be a Python int or a 0-dim tensor on the state's device: slices become
gathers and ``index_copy``/``index_put`` on a device index, with no host
read. The masked forms (``update_one``, ``step``, ``step_unknown``,
``schmidt_*``) select with ``torch.where``; ``_update`` is one slot's
update without the mask, for a replay that skips invalid slots on the host
(bit for bit the masked step's state). The 2x2 inverses are
``torch.linalg.inv_ex``, which does not wait for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from rustrobotics_tpu_torch.device import as_tensor, tensor_fields
from rustrobotics_tpu_torch.utils.angles import wrap_angle
from rustrobotics_tpu_torch.utils.state import select

_INIT_LM_VAR = 1e6  # covariance of a never-seen landmark slot


def _inv(a):
    return torch.linalg.inv_ex(a).inverse


def _bool(valid, like):
    """``valid`` as a bool tensor on ``like``'s device (a Python bool is
    filled there, not copied from the host)."""
    if isinstance(valid, torch.Tensor):
        return valid.to(device=like.device, dtype=torch.bool)
    return torch.full((), bool(valid), dtype=torch.bool, device=like.device)


def _slot_rows(k, device):
    """The two state rows of landmark slot ``k`` (an int or a 0-dim
    tensor): a (2,) index tensor."""
    return 3 + 2 * k + torch.arange(2, device=device)


def _slot(k, device):
    """Slot ``k`` as a (1,) index tensor."""
    if isinstance(k, torch.Tensor):
        return k.reshape(1)
    return torch.arange(k, k + 1, device=device)


@dataclasses.dataclass
class EkfSlamState:
    x: torch.Tensor  # (3 + 2L,) robot pose then landmarks
    cov: torch.Tensor  # (3 + 2L, 3 + 2L)
    seen: torch.Tensor  # (L,) bool

    def __post_init__(self):
        tensor_fields(self, "x", "cov", "seen")

    @property
    def robot(self) -> torch.Tensor:
        return self.x[:3]

    def landmark(self, k) -> torch.Tensor:
        if isinstance(k, torch.Tensor):
            return self.x.index_select(0, _slot_rows(k, self.x.device))
        return self.x[3 + 2 * k:5 + 2 * k]

    @property
    def landmarks(self) -> torch.Tensor:
        return self.x[3:].reshape(-1, 2)


def ekf_slam_state_from_numpy(x, cov, seen, device=None,
                              dtype=None) -> EkfSlamState:
    """An ``EkfSlamState`` from the JAX package's state carried across as
    numpy arrays (its ``x``, ``cov`` and ``seen``)."""
    return EkfSlamState(x=as_tensor(x, device, dtype),
                        cov=as_tensor(cov, device, dtype),
                        seen=as_tensor(seen, device, torch.bool))


@dataclasses.dataclass
class EkfSlamKnownCorrespondences:
    """q: (2, 2) range-bearing measurement noise; motion noise enters via
    the control-space covariance of the motion model (V M V^T)."""

    q: torch.Tensor
    motion_model: Any
    max_landmarks: int
    # ML-association gates for step_unknown (two-threshold scheme):
    # match an existing track below alpha (chi^2(2) 95%), open a NEW track
    # only above beta, and DISCARD ambiguous measurements in between
    alpha: float = 5.991
    beta: float = 25.0

    def __post_init__(self):
        tensor_fields(self, "q")

    @classmethod
    def create(cls, q, motion_model, max_landmarks: int,
               alpha: float = 5.991, beta: float = 25.0):
        return cls(q=as_tensor(q), motion_model=motion_model,
                   max_landmarks=max_landmarks, alpha=alpha, beta=beta)

    def init_state(self, robot_pose, robot_cov=None) -> EkfSlamState:
        robot_pose = as_tensor(robot_pose)
        dtype, device = robot_pose.dtype, robot_pose.device
        dim = 3 + 2 * self.max_landmarks
        x = torch.zeros(dim, dtype=dtype, device=device)
        x[:3] = robot_pose
        cov = torch.eye(dim, dtype=dtype, device=device) * _INIT_LM_VAR
        cov[:3, :3] = (torch.zeros((3, 3), dtype=dtype, device=device)
                       if robot_cov is None
                       else as_tensor(robot_cov, device, dtype))
        return EkfSlamState(
            x=x, cov=cov,
            seen=torch.zeros(self.max_landmarks, dtype=torch.bool,
                             device=device))

    def predict(self, state: EkfSlamState, u, dt) -> EkfSlamState:
        """Robot-block propagation; landmarks are static. Full-joint form:
        G_full = diag(G_r, I) so cov_rr <- G cov_rr G^T + V M V^T,
        cov_rm <- G cov_rm."""
        robot = state.x[:3]
        g = self.motion_model.jacobian_wrt_state(robot, u, dt)
        v = self.motion_model.jacobian_wrt_input(robot, u, dt)
        m = self.motion_model.cov_noise_control_space(u)
        x = state.x.clone()
        x[:3] = self.motion_model.prediction(robot, u, dt)
        cov = state.cov.clone()
        cov_rr = g @ cov[:3, :3] @ g.T + v @ m @ v.T
        cov_rm = g @ cov[:3, 3:]
        cov[:3, :3] = cov_rr
        cov[:3, 3:] = cov_rm
        cov[3:, :3] = cov_rm.T
        return EkfSlamState(x=x, cov=cov, seen=state.seen)

    def _initialize_landmark(self, state: EkfSlamState, k, z):
        """First sighting: place the landmark at the inverse measurement
        (x + r cos(b + θ), y + r sin(b + θ)); its slot variance stays at
        the large prior so the first update dominates."""
        rng, bearing = z[0], z[1]
        theta = state.x[2]
        lxy = torch.stack([state.x[0] + rng * torch.cos(bearing + theta),
                           state.x[1] + rng * torch.sin(bearing + theta)])
        dev = state.x.device
        x = state.x.index_copy(0, _slot_rows(k, dev), lxy)
        seen = state.seen.index_fill(0, _slot(k, dev), True)
        return EkfSlamState(x=x, cov=state.cov, seen=seen)

    def _measurement_jacobian(self, state: EkfSlamState, k):
        """Sparse H (2, 3+2L): nonzero on the robot and landmark-k blocks
        (range-bearing model)."""
        lm = state.landmark(k)
        dx = lm[0] - state.x[0]
        dy = lm[1] - state.x[1]
        q = dx * dx + dy * dy
        qs = torch.sqrt(q)
        zero, one = torch.zeros_like(dx), torch.ones_like(dx)
        h_robot = torch.stack([torch.stack([-dx / qs, -dy / qs, zero]),
                               torch.stack([dy / q, -dx / q, -one])])
        h_lm = torch.stack([torch.stack([dx / qs, dy / qs]),
                            torch.stack([-dy / q, dx / q])])
        h = torch.zeros((2, state.x.shape[0]), dtype=state.x.dtype,
                        device=state.x.device)
        h[:, :3] = h_robot
        return h.index_copy(1, _slot_rows(k, h.device), h_lm)

    def _z_pred(self, state: EkfSlamState, k):
        lm = state.landmark(k)
        dx = lm[0] - state.x[0]
        dy = lm[1] - state.x[1]
        return torch.stack([torch.sqrt(dx * dx + dy * dy),
                            torch.atan2(dy, dx) - state.x[2]])

    def _fresh_init(self, state: EkfSlamState, k, z, valid):
        """The state with slot k initialized where it is valid and not yet
        seen (``valid`` None: valid, known on the host)."""
        fresh = ~state.seen[k]
        if valid is not None:
            fresh = fresh & valid
        init = self._initialize_landmark(state, k, z)
        return EkfSlamState(x=torch.where(fresh, init.x, state.x),
                            cov=state.cov,
                            seen=torch.where(fresh, init.seen, state.seen))

    def _innovation(self, state: EkfSlamState, k, z):
        h = self._measurement_jacobian(state, k)
        z_pred = self._z_pred(state, k)
        innov = torch.stack([z[0] - z_pred[0], wrap_angle(z[1] - z_pred[1])])
        return h, innov

    def _update(self, state: EkfSlamState, k, z, valid=None) -> EkfSlamState:
        """One measurement of slot k, unmasked: the (x, cov) update of the
        state after ``_fresh_init``."""
        state = self._fresh_init(state, k, z, valid)
        h, innov = self._innovation(state, k, z)
        s = h @ state.cov @ h.T + self.q
        gain = state.cov @ h.T @ _inv(s)
        x_new = state.x + gain @ innov
        # Joseph form: PSD/symmetry-preserving in f32
        ikh = (torch.eye(state.x.shape[0], dtype=state.x.dtype,
                         device=state.x.device) - gain @ h)
        cov_new = ikh @ state.cov @ ikh.T + gain @ self.q @ gain.T
        return EkfSlamState(x=x_new, cov=cov_new, seen=state.seen)

    def update_one(self, state: EkfSlamState, k, z, valid) -> EkfSlamState:
        """One masked measurement of landmark slot k."""
        valid = _bool(valid, state.x)
        new = self._update(state, k, z, valid)
        return EkfSlamState(x=torch.where(valid, new.x, state.x),
                            cov=torch.where(valid, new.cov, state.cov),
                            seen=new.seen)

    def step(self, state: EkfSlamState, u, has_control, lm_idx, z, mask,
             dt) -> EkfSlamState:
        """One merged event: optional control + padded measurement block
        (lm_idx (M,) slot indices, z (M, 2), mask (M,))."""
        state = select(has_control, self.predict(state, u, dt), state)
        for k, zi, ok in zip(lm_idx, z, mask):
            state = self.update_one(state, k, zi, ok)
        return state

    # ------ unknown correspondences (Probabilistic Robotics table 10.3)

    def associate(self, state: EkfSlamState, z):
        """Maximum-likelihood data association, vectorized over ALL
        landmark slots at once: Mahalanobis distance pi_l = nu^T S_l^-1 nu
        against every seen slot using only the sparse (robot, landmark)
        covariance blocks.

        Returns (slot k, is_new, usable), 0-dim tensors."""
        dtype = state.x.dtype
        big = self.max_landmarks
        lms = state.landmarks  # (L, 2)
        dx = lms[:, 0] - state.x[0]
        dy = lms[:, 1] - state.x[1]
        q = dx * dx + dy * dy
        qs = torch.sqrt(torch.clamp(q, min=1e-12))
        z_pred = torch.stack([qs, torch.atan2(dy, dx) - state.x[2]], -1)
        nu = torch.stack([z[0] - z_pred[:, 0],
                          wrap_angle(z[1] - z_pred[:, 1])], -1)  # (L, 2)

        # per-slot 2x3 / 2x2 measurement Jacobians
        zr = torch.zeros_like(dx)
        h_r = torch.stack([
            torch.stack([-dx / qs, -dy / qs, zr], -1),
            torch.stack([dy / q, -dx / q, -torch.ones_like(dx)], -1),
        ], -2)  # (L, 2, 3)
        h_l = torch.stack([
            torch.stack([dx / qs, dy / qs], -1),
            torch.stack([-dy / q, dx / q], -1),
        ], -2)  # (L, 2, 2)

        # sparse covariance blocks: robot-robot, robot-lm_l, lm_l-lm_l
        c_rr = state.cov[:3, :3]
        c_rl = state.cov[:3, 3:].reshape(3, big, 2).permute(1, 0, 2)
        c_full = state.cov[3:, 3:].reshape(big, 2, big, 2)
        c_ll = torch.diagonal(c_full, dim1=0, dim2=2).permute(2, 0, 1)

        s = (torch.einsum("lij,jk,lmk->lim", h_r, c_rr, h_r)
             + torch.einsum("lij,ljk,lmk->lim", h_r, c_rl, h_l)
             + torch.einsum("lij,lkj,lmk->lim", h_l, c_rl, h_r)
             + torch.einsum("lij,ljk,lmk->lim", h_l, c_ll, h_l)
             + self.q.to(dtype))  # (L, 2, 2)
        pi = torch.einsum("li,lij,lj->l", nu, _inv(s), nu)
        pi = torch.where(state.seen, pi, torch.full_like(pi, torch.inf))

        best = torch.argmin(pi)
        best_pi = pi[best]
        is_match = best_pi < self.alpha
        is_new = best_pi > self.beta
        any_free = ~state.seen.all()
        first_free = torch.argmin(state.seen.to(torch.int32))  # first False
        k = torch.where(is_match, best, first_free)
        usable = is_match | (is_new & any_free)
        return k, is_new, usable

    def step_unknown(self, state: EkfSlamState, u, has_control, z, mask,
                     dt) -> EkfSlamState:
        """Unknown-correspondence step: ML-associate each masked
        measurement (sequentially, so later associations see earlier
        updates), then reuse the known-correspondence update (which
        initializes fresh slots via the seen flag)."""
        state = select(has_control, self.predict(state, u, dt), state)
        for zi, ok in zip(z, mask):
            k, _, usable = self.associate(state, zi)
            state = self.update_one(state, k, zi, _bool(ok, state.x) & usable)
        return state


# ----------------------------------------------------- Schmidt-EKF SLAM

def schmidt_update_one(slam: EkfSlamKnownCorrespondences,
                       state: EkfSlamState, k, z, valid, consider_lm):
    """Consider-state (Schmidt-EKF) measurement update.

    Landmarks flagged in ``consider_lm`` (L,) get ZERO Kalman gain: their
    estimates are frozen, but their cross-covariances with the active
    block keep being tracked, so the filter stays consistent. The
    covariance uses the general-gain form

        P <- P - K (H P) - (H P)^T K^T + K S K^T,

    which for a masked K is exactly Schmidt's update.
    """
    valid = _bool(valid, state.x)
    fresh = valid & ~state.seen[k]
    state = slam._fresh_init(state, k, z, valid)
    h, innov = slam._innovation(state, k, z)

    dtype, device = state.x.dtype, state.x.device
    # per-dim active mask: robot always active; a CONSIDER landmark stays
    # frozen even when observed. Only a fresh initialization overrides
    # the freeze.
    lm_consider = _bool(consider_lm, state.x)
    lm_consider = lm_consider.index_copy(
        0, _slot(k, device), (lm_consider[k] & ~fresh).reshape(1))
    active = torch.cat([torch.ones(3, dtype=torch.bool, device=device),
                        ~torch.repeat_interleave(lm_consider, 2)])

    hp = h @ state.cov                      # (2, n)
    s = hp @ h.T + slam.q
    gain = (state.cov @ h.T) @ _inv(s)
    gain = gain * active[:, None].to(dtype)  # Schmidt: K_c = 0
    x_new = state.x + gain @ innov
    cov_new = (state.cov - gain @ hp - hp.T @ gain.T
               + gain @ s @ gain.T)
    cov_new = 0.5 * (cov_new + cov_new.T)
    return EkfSlamState(x=torch.where(valid, x_new, state.x),
                        cov=torch.where(valid, cov_new, state.cov),
                        seen=state.seen)


def schmidt_step(slam: EkfSlamKnownCorrespondences, state: EkfSlamState,
                 u, has_control, lm_idx, z, mask, dt, consider_lm):
    """One merged event with consider-state updates (see
    schmidt_update_one). ``consider_lm`` (L,) bool selects the frozen
    landmark set, a recency/distance policy chosen by the caller."""
    state = select(has_control, slam.predict(state, u, dt), state)
    for k, zi, ok in zip(lm_idx, z, mask):
        state = schmidt_update_one(slam, state, k, zi, ok, consider_lm)
    return state
