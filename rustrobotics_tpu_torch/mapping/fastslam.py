"""FastSLAM 1.0 and 2.0 (counterpart of
``rustrobotics_tpu/mapping/fastslam.py``; Probabilistic Robotics ch. 13).

Rao-Blackwellized particle filter: each particle carries a robot pose
hypothesis plus an independent EKF per landmark. The cloud is one set of
batched tensors: poses (N, 3), landmark means (N, L, 2), covariances
(N, L, 2, 2), seen flags (N, L), so propagation, every per-landmark EKF
update, weighting and resampling are batched ops over the N axis. The
effective-sample-size gate of the resample is a device ``torch.where``:
a step makes no host read.

Randomness: each stochastic function takes a ``torch.Generator``, and has
a private form that takes its draws, in the shapes the JAX package draws
them: ``FastSlam._init_particles(pose0, noise (N, 3))``,
``FastSlam._step(..., motion_noise, resample_u)`` (the motion model's
``_sample`` noise and the systematic resampler's uniform),
``_fastslam_step_unknown`` likewise and ``_fastslam2_step(..., eps (N, 3),
resample_u)``. A slot index may be a Python int or a 0-dim tensor;
``valid`` a Python bool, a 0-dim or an (N,) tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from rustrobotics_tpu_torch.device import as_tensor, tensor_fields
from rustrobotics_tpu_torch.localization.pf import _resample_systematic
from rustrobotics_tpu_torch.utils.angles import wrap_angle

_INIT_LM_VAR = 1e6
_LOG_2PI2 = 2 * math.log(2 * math.pi)


def _inv(a):
    return torch.linalg.inv_ex(a).inverse


def _log_gauss(innov, s, s_inv):
    """Log N(innov; 0, S) for (..., 2) innovations, S's determinant in
    closed form and clipped as in the JAX package."""
    det = s[..., 0, 0] * s[..., 1, 1] - s[..., 0, 1] * s[..., 1, 0]
    maha = torch.einsum("...i,...ij,...j->...", innov, s_inv, innov)
    return -0.5 * (maha + torch.log(torch.clamp(det, min=1e-20)) + _LOG_2PI2)


@dataclasses.dataclass
class FastSlamParticles:
    poses: torch.Tensor    # (N, 3)
    lm_mu: torch.Tensor    # (N, L, 2)
    lm_cov: torch.Tensor   # (N, L, 2, 2)
    seen: torch.Tensor     # (N, L) bool
    logw: torch.Tensor     # (N,) accumulated log-weights (ESS-gated resample)

    def __post_init__(self):
        tensor_fields(self, "poses", "lm_mu", "lm_cov", "seen", "logw")

    def replace(self, **updates) -> "FastSlamParticles":
        return dataclasses.replace(self, **updates)

    def take(self, idx) -> "FastSlamParticles":
        """The particles at rows ``idx`` (N,)."""
        return FastSlamParticles(*(getattr(self, f.name).index_select(0, idx)
                                   for f in dataclasses.fields(self)))


def particles_from_numpy(poses, lm_mu, lm_cov, seen, logw, device=None,
                         dtype=None) -> FastSlamParticles:
    """``FastSlamParticles`` from the JAX package's cloud carried across
    as numpy arrays."""
    return FastSlamParticles(
        poses=as_tensor(poses, device, dtype),
        lm_mu=as_tensor(lm_mu, device, dtype),
        lm_cov=as_tensor(lm_cov, device, dtype),
        seen=as_tensor(seen, device, torch.bool),
        logw=as_tensor(logw, device, dtype))


def _valid_rows(valid, n, like):
    """``valid`` broadcast to (N,) bool on ``like``'s device."""
    if isinstance(valid, torch.Tensor):
        return valid.to(device=like.device, dtype=torch.bool).expand(n)
    return torch.full((n,), bool(valid), dtype=torch.bool,
                      device=like.device)


def _set_slot(a, k, value):
    """``a`` with column k (dim 1) replaced by ``value``, k an int or a
    0-dim tensor."""
    kk = (k.reshape(1) if isinstance(k, torch.Tensor)
          else torch.arange(k, k + 1, device=a.device))
    return a.index_copy(1, kk, value.unsqueeze(1))


def _select_poses(has_control, a, b):
    if not isinstance(has_control, torch.Tensor):
        return a if bool(has_control) else b
    return torch.where(has_control, a, b)


def _resample_gated(particles: FastSlamParticles, logw_new, resample_u):
    """Accumulate the weights and resample systematically only when the
    effective sample size drops below N/2 (a device select)."""
    n = particles.poses.shape[0]
    logw = particles.logw + logw_new
    w = torch.exp(logw - torch.max(logw))
    wn = w / torch.sum(w)
    ess = 1.0 / torch.sum(wn * wn)
    do_resample = ess < 0.5 * n
    idx = torch.where(do_resample, _resample_systematic(w, resample_u),
                      torch.arange(n, device=w.device))
    particles = particles.take(idx)
    return particles.replace(
        logw=torch.where(do_resample, torch.zeros_like(logw), logw))


@dataclasses.dataclass
class FastSlam:
    """q: (2, 2) range-bearing noise; motion_model must provide a noisy
    ``sample`` (control-space noise drives particle diversity)."""

    q: torch.Tensor
    motion_model: Any
    max_landmarks: int

    def __post_init__(self):
        tensor_fields(self, "q")

    @classmethod
    def create(cls, q, motion_model, max_landmarks):
        return cls(q=as_tensor(q), motion_model=motion_model,
                   max_landmarks=max_landmarks)

    def init_particles(self, generator, pose0, num_particles,
                       init_sigma=(0.0, 0.0, 0.0)) -> FastSlamParticles:
        pose0 = as_tensor(pose0)
        noise = torch.randn((num_particles, 3), generator=generator,
                            dtype=pose0.dtype, device=pose0.device)
        return self._init_particles(pose0, noise, init_sigma)

    def _init_particles(self, pose0, noise,
                        init_sigma=(0.0, 0.0, 0.0)) -> FastSlamParticles:
        """The initial cloud on drawn standard normals ``noise`` (N, 3)."""
        pose0 = as_tensor(pose0)
        dtype, device = pose0.dtype, pose0.device
        n, lmax = noise.shape[0], self.max_landmarks
        sigma = torch.tensor(init_sigma, dtype=dtype).to(device)
        return FastSlamParticles(
            poses=pose0 + noise.to(device=device, dtype=dtype) * sigma,
            lm_mu=torch.zeros((n, lmax, 2), dtype=dtype, device=device),
            lm_cov=(torch.eye(2, dtype=dtype, device=device)
                    * _INIT_LM_VAR).expand(n, lmax, 2, 2),
            seen=torch.zeros((n, lmax), dtype=torch.bool, device=device),
            logw=torch.zeros(n, dtype=dtype, device=device),
        )

    # ------------------------------------------------------------ internals

    def _z_pred_jac(self, poses, mu):
        """Batched over particles: predicted range-bearing of landmark
        mean mu (N, 2) from poses (N, 3), plus the (N, 2, 2) Jacobian
        w.r.t. the LANDMARK position."""
        dx = mu[:, 0] - poses[:, 0]
        dy = mu[:, 1] - poses[:, 1]
        q = torch.clamp(dx * dx + dy * dy, min=1e-12)
        qs = torch.sqrt(q)
        z_pred = torch.stack([qs, torch.atan2(dy, dx) - poses[:, 2]], -1)
        h = torch.stack([
            torch.stack([dx / qs, dy / qs], -1),
            torch.stack([-dy / q, dx / q], -1),
        ], -2)  # (N, 2, 2)
        return z_pred, h

    def _update_one(self, particles: FastSlamParticles, k, z, valid):
        """One measurement of landmark slot k against EVERY particle:
        per-particle 2x2 EKF update + likelihood weight. Returns
        (particles, log-weights (N,))."""
        poses = particles.poses
        n = poses.shape[0]
        mu = particles.lm_mu[:, k]        # (N, 2)
        cov = particles.lm_cov[:, k]      # (N, 2, 2)
        seen = particles.seen[:, k]       # (N,)
        valid = _valid_rows(valid, n, poses)

        # fresh init: inverse measurement from each particle's pose
        rng_m, bearing = z[0], z[1]
        theta = poses[:, 2]
        init_mu = torch.stack(
            [poses[:, 0] + rng_m * torch.cos(bearing + theta),
             poses[:, 1] + rng_m * torch.sin(bearing + theta)], -1)
        fresh = valid & ~seen
        mu = torch.where(fresh[:, None], init_mu, mu)

        z_pred, h = self._z_pred_jac(poses, mu)
        innov = torch.stack(
            [z[0] - z_pred[:, 0], wrap_angle(z[1] - z_pred[:, 1])], -1)
        s = torch.einsum("nij,njk,nlk->nil", h, cov, h) + self.q
        s_inv = _inv(s)
        gain = torch.einsum("nij,nkj,nkl->nil", cov, h, s_inv)
        mu_new = mu + torch.einsum("nij,nj->ni", gain, innov)
        ikh = torch.eye(2, dtype=poses.dtype, device=poses.device) \
            - gain @ h
        cov_new = (torch.einsum("nij,njk,nlk->nil", ikh, cov, ikh)
                   + torch.einsum("nij,jk,nlk->nil", gain, self.q, gain))
        # measurement likelihood (log) per particle
        logw = _log_gauss(innov, s, s_inv)

        particles = particles.replace(
            lm_mu=_set_slot(particles.lm_mu, k,
                            torch.where(valid[:, None], mu_new, mu)),
            lm_cov=_set_slot(particles.lm_cov, k,
                             torch.where(valid[:, None, None], cov_new, cov)),
            seen=_set_slot(particles.seen, k, seen | valid),
        )
        logw = torch.where(valid & ~fresh, logw, torch.zeros_like(logw))
        return particles, logw

    def _measure(self, particles: FastSlamParticles, lm_idx, z, mask):
        """Every slot's update in order; (particles, summed log-weights)."""
        logw = torch.zeros_like(particles.logw)
        for ki, zi, ok in zip(lm_idx, z, mask):
            particles, lw = self._update_one(particles, ki, zi, ok)
            logw = logw + lw
        return particles, logw

    # -------------------------------------------------------------- stepping

    def step(self, generator, particles: FastSlamParticles, u, has_control,
             lm_idx, z, mask, dt) -> FastSlamParticles:
        """One merged event: noisy motion sample + masked measurement
        block (lm_idx (M,), z (M, 2), mask (M,)) + systematic resample
        when the effective sample size drops below N/2."""
        prop = self.motion_model.sample(generator, particles.poses, u, dt)
        resample_u = torch.rand((), generator=generator,
                                dtype=particles.logw.dtype,
                                device=particles.logw.device)
        return self._advance(particles, prop, has_control, lm_idx, z, mask,
                             resample_u)

    def _step(self, particles: FastSlamParticles, u, has_control, lm_idx,
              z, mask, dt, motion_noise, resample_u) -> FastSlamParticles:
        """``step`` on drawn noise: ``motion_noise`` as the motion model's
        ``_sample`` takes it, ``resample_u`` the resampler's uniform."""
        prop = self.motion_model._sample(particles.poses, u, dt,
                                         motion_noise)
        return self._advance(particles, prop, has_control, lm_idx, z, mask,
                             resample_u)

    def _advance(self, particles, prop, has_control, lm_idx, z, mask,
                 resample_u):
        particles = particles.replace(
            poses=_select_poses(has_control, prop, particles.poses))
        particles, logw_new = self._measure(particles, lm_idx, z, mask)
        return _resample_gated(particles, logw_new, resample_u)

    def estimate(self, particles: FastSlamParticles):
        """Weighted mean pose (angle via circular mean) and landmark map;
        weights are the carried log-weights (uniform right after an
        ESS-triggered resample)."""
        poses = particles.poses
        w = torch.exp(particles.logw - torch.max(particles.logw))
        w = w / torch.sum(w)
        xy = torch.einsum("n,ni->i", w, poses[:, :2])
        th = torch.atan2(torch.sum(w * torch.sin(poses[:, 2])),
                         torch.sum(w * torch.cos(poses[:, 2])))
        seen_any = particles.seen.any(dim=0)
        wl = w[:, None] * particles.seen  # (N, L)
        norm = torch.clamp(wl.sum(dim=0), min=1e-20)
        lm = torch.einsum("nl,nli->li", wl, particles.lm_mu) / norm[:, None]
        return torch.cat([xy, th[None]]), lm, seen_any


def _per_slot_likelihood(slam: FastSlam, particles: FastSlamParticles, z):
    """(N, L) log-likelihood of measurement z against EVERY landmark slot
    of EVERY particle: one (N, L, 2, 2) einsum chain, no loops."""
    poses = particles.poses
    mu = particles.lm_mu                      # (N, L, 2)
    dx = mu[..., 0] - poses[:, None, 0]
    dy = mu[..., 1] - poses[:, None, 1]
    q = torch.clamp(dx * dx + dy * dy, min=1e-12)
    qs = torch.sqrt(q)
    z_pred_b = torch.atan2(dy, dx) - poses[:, None, 2]
    innov = torch.stack([z[0] - qs, wrap_angle(z[1] - z_pred_b)], -1)
    h = torch.stack([
        torch.stack([dx / qs, dy / qs], -1),
        torch.stack([-dy / q, dx / q], -1),
    ], -2)  # (N, L, 2, 2)
    s = torch.einsum("nlij,nljk,nlmk->nlim", h, particles.lm_cov, h) + slam.q
    return _log_gauss(innov, s, _inv(s))


def fastslam_step_unknown(slam: FastSlam, generator,
                          particles: FastSlamParticles, u, has_control, z,
                          mask, dt, match_logl=-4.0,
                          new_track_logl=-10.0) -> FastSlamParticles:
    """Unknown-correspondence FastSLAM step: EVERY PARTICLE associates
    each measurement independently by maximum likelihood over its own map.
    Two-threshold gating as in EKF-SLAM: match above ``match_logl``, open
    a new track below ``new_track_logl``, DISCARD the ambiguous band."""
    prop = slam.motion_model.sample(generator, particles.poses, u, dt)
    resample_u = torch.rand((), generator=generator,
                            dtype=particles.logw.dtype,
                            device=particles.logw.device)
    return _unknown_advance(slam, particles, prop, has_control, z, mask,
                            resample_u, match_logl, new_track_logl)


def _fastslam_step_unknown(slam: FastSlam, particles: FastSlamParticles, u,
                           has_control, z, mask, dt, motion_noise,
                           resample_u, match_logl=-4.0,
                           new_track_logl=-10.0) -> FastSlamParticles:
    """``fastslam_step_unknown`` on drawn noise (as ``FastSlam._step``)."""
    prop = slam.motion_model._sample(particles.poses, u, dt, motion_noise)
    return _unknown_advance(slam, particles, prop, has_control, z, mask,
                            resample_u, match_logl, new_track_logl)


def _unknown_advance(slam, particles, prop, has_control, z, mask,
                     resample_u, match_logl, new_track_logl):
    particles = particles.replace(
        poses=_select_poses(has_control, prop, particles.poses))
    n = particles.poses.shape[0]
    rows = torch.arange(n, device=particles.poses.device)

    def assoc_update(parts, zi, ok):
        logl = _per_slot_likelihood(slam, parts, zi)          # (N, L)
        logl = torch.where(parts.seen, logl,
                           torch.full_like(logl, -torch.inf))
        best = torch.argmax(logl, dim=1)                      # (N,)
        best_logl = torch.take_along_dim(logl, best[:, None], 1)[:, 0]
        first_free = torch.argmin(parts.seen.to(torch.int32), dim=1)
        any_free = ~parts.seen.all(dim=1)
        is_match = best_logl > match_logl
        is_new = best_logl < new_track_logl
        k = torch.where(is_match, best, first_free)           # per particle
        usable = _valid_rows(ok, n, parts.poses) & (
            is_match | (is_new & any_free))

        # per-particle slot update: gather slot k of each particle,
        # EKF-update it, scatter back
        sub = FastSlamParticles(
            poses=parts.poses, lm_mu=parts.lm_mu[rows, k][:, None],
            lm_cov=parts.lm_cov[rows, k][:, None],
            seen=parts.seen[rows, k][:, None], logw=parts.logw)
        sub, logw = slam._update_one(sub, 0, zi, usable)

        def put(a, v):
            return a.index_put((rows, k), v)

        parts = parts.replace(
            lm_mu=put(parts.lm_mu, sub.lm_mu[:, 0]),
            lm_cov=put(parts.lm_cov, sub.lm_cov[:, 0]),
            seen=put(parts.seen, sub.seen[:, 0]))
        return parts, logw

    logw_new = torch.zeros_like(particles.logw)
    for zi, ok in zip(z, mask):
        particles, lw = assoc_update(particles, zi, ok)
        logw_new = logw_new + lw
    return _resample_gated(particles, logw_new, resample_u)


# --------------------------------------------------------- FastSLAM 2.0

def _pose_jacobian_rb(m, mu):
    """(N, 2, 3) Jacobian of the range-bearing measurement w.r.t. the
    POSE, batched over particles (m (N, 3) poses, mu (N, 2) landmarks)."""
    dx = mu[:, 0] - m[:, 0]
    dy = mu[:, 1] - m[:, 1]
    q = torch.clamp(dx * dx + dy * dy, min=1e-12)
    qs = torch.sqrt(q)
    zeros = torch.zeros_like(dx)
    return torch.stack([
        torch.stack([-dx / qs, -dy / qs, zeros], -1),
        torch.stack([dy / q, -dx / q, -torch.ones_like(dx)], -1),
    ], -2)


def fastslam2_step(slam: FastSlam, generator, particles: FastSlamParticles,
                   u, has_control, lm_idx, z, mask, dt,
                   pose_noise_eps=1e-6) -> FastSlamParticles:
    """FastSLAM 2.0 step (Probabilistic Robotics table 13.3): the pose
    PROPOSAL incorporates the current measurements.

    Per particle, batched over the cloud:
    1. deterministic motion predict x̂ = g(x, u) with pose-space noise
       R = the motion model's ``pose_noise_cov`` (V M V^T without one)
       + eps*I;
    2. condition the pose Gaussian (m, S) on every valid measurement of an
       already-seen landmark; the importance weight accumulates
       logN(innov; 0, L) at the proposal's prior;
    3. sample the pose from N(m, S) (one Cholesky);
    4. per-landmark EKF updates at the sampled pose (weights not counted
       twice), fresh landmarks initialized by inverse measurement,
       ESS-gated systematic resample.
    """
    dtype, device = particles.poses.dtype, particles.poses.device
    eps = torch.randn(particles.poses.shape, generator=generator,
                      dtype=dtype, device=device)
    resample_u = torch.rand((), generator=generator, dtype=dtype,
                            device=device)
    return _fastslam2_step(slam, particles, u, has_control, lm_idx, z, mask,
                           dt, eps, resample_u, pose_noise_eps)


def _fastslam2_step(slam: FastSlam, particles: FastSlamParticles, u,
                    has_control, lm_idx, z, mask, dt, eps, resample_u,
                    pose_noise_eps=1e-6) -> FastSlamParticles:
    """``fastslam2_step`` on drawn noise: ``eps`` (N, 3) standard normals
    of the pose sample, ``resample_u`` the resampler's uniform."""
    poses = particles.poses
    dtype, device = poses.dtype, poses.device
    n = poses.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=device)
    model = slam.motion_model

    # 1. deterministic predict + pose-space motion noise (it must match
    # the sample() noise model, the velocity model's gamma term included)
    x_hat = model.prediction(poses, u, dt)
    if hasattr(model, "pose_noise_cov"):
        r_pose = model.pose_noise_cov(poses, u, dt)
    else:
        v = model.jacobian_wrt_input(poses, u, dt)
        mcov = model.cov_noise_control_space(u)
        r_pose = torch.einsum("nij,jk,nlk->nil", v, mcov, v)
    r_pose = r_pose + eye3 * pose_noise_eps

    m = _select_poses(has_control, x_hat, poses)
    s = _select_poses(has_control, r_pose.expand(n, 3, 3),
                      (eye3 * pose_noise_eps).expand(n, 3, 3))
    logw_new = torch.zeros(n, dtype=dtype, device=device)

    # 2. condition the pose Gaussian on each seen-landmark measurement
    for ki, zi, ok in zip(lm_idx, z, mask):
        usable = _valid_rows(ok, n, poses) & particles.seen[:, ki]
        mu = particles.lm_mu[:, ki]
        cov = particles.lm_cov[:, ki]
        dxy = mu - m[:, :2]
        q = torch.clamp(torch.sum(dxy * dxy, -1), min=1e-12)
        z_pred = torch.stack(
            [torch.sqrt(q), torch.atan2(dxy[:, 1], dxy[:, 0]) - m[:, 2]], -1)
        innov = torch.stack(
            [zi[0] - z_pred[:, 0], wrap_angle(zi[1] - z_pred[:, 1])], -1)
        hx = _pose_jacobian_rb(m, mu)                       # (N, 2, 3)
        hm = -hx[:, :, :2]                                  # (N, 2, 2)
        big_l = (torch.einsum("nij,njk,nlk->nil", hx, s, hx)
                 + torch.einsum("nij,njk,nlk->nil", hm, cov, hm)
                 + slam.q)
        l_inv = _inv(big_l)
        lw = _log_gauss(innov, big_l, l_inv)
        gain = torch.einsum("nij,nkj,nkl->nil", s, hx, l_inv)
        m_new = m + torch.einsum("nij,nj->ni", gain, innov)
        m_new = torch.cat([m_new[:, :2], wrap_angle(m_new[:, 2:3])], -1)
        s_new = s - torch.einsum("nij,njk,nkl->nil", gain, big_l,
                                 gain.mT)
        m = torch.where(usable[:, None], m_new, m)
        s = torch.where(usable[:, None, None], s_new, s)
        logw_new = logw_new + torch.where(usable, lw, torch.zeros_like(lw))

    # 3. sample the pose from the conditioned proposal
    chol = torch.linalg.cholesky_ex(s + eye3 * pose_noise_eps).L
    sampled = m + torch.einsum("nij,nj->ni", chol, eps.to(device, dtype))
    sampled = torch.cat([sampled[:, :2], wrap_angle(sampled[:, 2:3])], -1)
    particles = particles.replace(poses=sampled)

    # 4. landmark EKF updates at the sampled pose (weights already
    # accounted by the proposal-consistent terms above)
    particles, _ = slam._measure(particles, lm_idx, z, mask)
    return _resample_gated(particles, logw_new, resample_u)
