"""Particle filters with vectorized resampling (counterpart of
``rustrobotics_tpu/localization/pf.py``).

The cloud is one (N, S) tensor; propagation, weighting and resampling are
tensor ops, and weights are carried in log space. Systematic resampling is
the closed-form inverse CDF (scatter-max + cummax); stratified and
multinomial search sorted draws with ``searchsorted``.

Randomness: each stochastic function takes a ``torch.Generator``, and has
a private form that takes its draws directly, in the shapes the JAX
package draws them: ``_resample_*(weights, uniforms)``, the filters'
``_step(..., noise, draws)`` and ``_init_particles``. The filters factor
their constant noise covariances once, when they are built, so a step
makes no host read.

Reference behaviour kept: with every weight underflowed to 0, only
``resample_systematic`` falls back to a uniform pick; ``multinomial`` and
``stratified`` return particle 0 for every draw.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from rustrobotics_tpu_torch.device import tensor_fields
from rustrobotics_tpu_torch.localization.landmark_table import LandmarkTable
from rustrobotics_tpu_torch.utils.mvn import MultiVariateNormal
from rustrobotics_tpu_torch.utils.state import GaussianState


def _index_sample_sorted(cum_weights, sorted_draws):
    """Inverse CDF of sorted draws: first index with cum >= draw."""
    idx = torch.searchsorted(cum_weights, sorted_draws, side="left")
    return torch.clamp(idx, 0, cum_weights.shape[0] - 1)


def _resample_multinomial(weights, u):
    """IID multinomial resampling on uniforms u (N,)."""
    cum = torch.cumsum(weights, 0)
    draws = u * cum[-1]
    return _index_sample_sorted(cum, torch.sort(draws).values)


def _resample_stratified(weights, u):
    """Stratified: one uniform per stratum, u (N,)."""
    n = weights.shape[0]
    cum = torch.cumsum(weights, 0)
    draws = (torch.arange(n, dtype=weights.dtype, device=weights.device)
             + u) / n * cum[-1]
    return _index_sample_sorted(cum, draws)  # sorted by construction


def _resample_systematic(weights, u):
    """Systematic, one uniform offset u (a 0-dim tensor): particle i
    receives ceil(n c_i - u) - ceil(n c_{i-1} - u) copies (c = normalized
    cumsum); each index is written at its first output position and the
    runs filled with a cummax. An all-zero cloud degrades to a uniform
    pick."""
    n = weights.shape[0]
    dev = weights.device
    cum = torch.cumsum(weights, 0)
    total = torch.clamp(cum[-1], min=torch.finfo(weights.dtype).tiny)
    ar = torch.arange(n, device=dev)
    c = torch.where(cum[-1] > 0, cum / total,
                    (ar.to(weights.dtype) + 1) / n)
    ends = torch.ceil(n * c - u).long()  # draws strictly below c_i
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    # starts past the end (trailing zero-count particles) are dropped, as
    # JAX's .at[].max drops them: they write 0, which the max ignores
    inside = starts < n
    marked = torch.zeros(n, dtype=torch.long, device=dev).scatter_reduce_(
        0, torch.where(inside, starts, 0), torch.where(inside, ar, 0),
        "amax")
    return torch.cummax(marked, 0).values


_RESAMPLERS = {
    "multinomial": _resample_multinomial,
    "stratified": _resample_stratified,
    "systematic": _resample_systematic,
}


def _resample_draws(resampling, generator, weights):
    """The uniforms a resampler takes for a cloud like ``weights`` (N,...):
    () for systematic, (N,) else."""
    shape = () if resampling == "systematic" else weights.shape[:1]
    return torch.rand(shape, generator=generator, dtype=weights.dtype,
                      device=weights.device)


def resample_multinomial(generator, weights):
    return _resample_multinomial(
        weights, _resample_draws("multinomial", generator, weights))


def resample_stratified(generator, weights):
    return _resample_stratified(
        weights, _resample_draws("stratified", generator, weights))


def resample_systematic(generator, weights):
    return _resample_systematic(
        weights, _resample_draws("systematic", generator, weights))


def gaussian_estimate(particles) -> GaussianState:
    """Particle mean/cov, dividing by N (not ``torch.cov``'s N - 1)."""
    x = torch.mean(particles, dim=0)
    dx = particles - x
    cov = dx.mT @ dx / particles.shape[0]
    return GaussianState(x=x, cov=cov)


def effective_sample_size(logw):
    """ESS = (sum w)^2 / sum w^2 from log-weights, shift-stable."""
    w = torch.exp(logw - torch.max(logw))
    return torch.square(torch.sum(w)) / torch.sum(torch.square(w))


def weighted_gaussian_estimate(particles, logw) -> GaussianState:
    """Particle mean/cov under carried log-weights."""
    w = torch.exp(logw - torch.max(logw))
    w = w / torch.sum(w)
    x = w @ particles
    dx = particles - x
    cov = (dx * w[:, None]).mT @ dx
    return GaussianState(x=x, cov=cov)


def init_particles(generator, initial_state: GaussianState, noise_cov,
                   num_particles):
    """Sample the initial cloud around x0."""
    x = initial_state.x
    u = torch.randn((num_particles, x.shape[-1]), generator=generator,
                    dtype=x.dtype, device=x.device)
    return _init_particles(initial_state, noise_cov, u)


def _init_particles(initial_state: GaussianState, noise_cov, u):
    """``init_particles`` on standard normals u (N, S)."""
    return MultiVariateNormal.create(initial_state.x, noise_cov)._sample(u)


def _zero_mean_mvn(cov):
    return MultiVariateNormal.create(
        torch.zeros(cov.shape[-1], dtype=cov.dtype, device=cov.device), cov)


@dataclasses.dataclass
class ParticleFilter:
    """SIR PF with additive process noise."""

    r: torch.Tensor  # (S, S) process noise added after propagation
    q: torch.Tensor  # (Z, Z) measurement noise
    motion_model: Any
    measurement_model: Any
    resampling: str = "systematic"

    def __post_init__(self):
        tensor_fields(self, "r", "q")
        self._noise = _zero_mean_mvn(self.r)
        self._meas_noise = _zero_mean_mvn(self.q)

    def _draws(self, generator, particles):
        noise = torch.randn(particles.shape, generator=generator,
                            dtype=particles.dtype, device=particles.device)
        return noise, _resample_draws(self.resampling, generator, particles)

    def _propagate_weigh(self, particles, u, z, dt, noise):
        pred = self.motion_model.prediction(particles, u, dt)
        pred = pred + self._noise._sample(noise)
        z_pred = self.measurement_model.prediction(pred)
        return pred, self._meas_noise.logpdf(z - z_pred)

    def step(self, generator, particles, u, z, dt):
        return self._step(particles, u, z, dt,
                          *self._draws(generator, particles))

    def _step(self, particles, u, z, dt, noise, draws):
        """``step`` on drawn noise: standard normals (N, S) for the
        process noise, the resampler's uniforms."""
        pred, logw = self._propagate_weigh(particles, u, z, dt, noise)
        w = torch.exp(logw - torch.max(logw))
        idx = _RESAMPLERS[self.resampling](w, draws)
        return pred[idx]


@dataclasses.dataclass
class AdaptiveParticleFilter(ParticleFilter):
    """SIR PF with ESS-triggered resampling (log-weights carried).

    ``step`` carries ``(particles, logw)`` and returns
    ``(particles, logw, did)``; read the posterior with
    ``weighted_gaussian_estimate``. The JAX package selects the branch with
    ``lax.cond``; here both are computed and ``torch.where`` selects, so a
    step makes no host read (the resample's gather runs every step). With
    ``ess_frac > 1`` every step resamples and the trajectory equals
    ``ParticleFilter``'s on the same draws.
    """

    ess_frac: float = 0.5

    def step(self, generator, particles, logw, u, z, dt):
        return self._step(particles, logw, u, z, dt,
                          *self._draws(generator, particles))

    def _step(self, particles, logw, u, z, dt, noise, draws):
        pred, lik = self._propagate_weigh(particles, u, z, dt, noise)
        logw = logw + lik
        # shift so exp() never overflows; when every log-likelihood
        # underflowed to -inf the shift is 0, the ESS gate triggers and the
        # systematic resampler's zero-sum fallback recovers
        m = torch.max(logw)
        logw = logw - torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        n = particles.shape[0]
        ess = effective_sample_size(logw)
        # inverted predicate: a NaN ESS resamples
        did = torch.logical_not(ess >= self.ess_frac * n)
        idx = _RESAMPLERS[self.resampling](torch.exp(logw), draws)
        return (torch.where(did, pred[idx], pred),
                torch.where(did, torch.zeros_like(logw), logw),
                did.to(torch.int32))


@dataclasses.dataclass
class ParticleFilterKnownCorrespondences:
    """Landmark PF: propagate through the noisy motion sampler, weight
    over all matched landmarks, resample (multinomial by default).

    ``step`` consumes one merged event (optional control + padded
    measurement block). The log-weights add up slot by slot in slot order,
    so a caller that skips the invalid slots on the host
    (``_log_weights`` on the valid ones) gets the same sums.
    """

    q: torch.Tensor  # (Z, Z)
    landmarks: LandmarkTable
    motion_model: Any
    measurement_model: Any
    resampling: str = "multinomial"

    def __post_init__(self):
        tensor_fields(self, "q")
        self._meas_noise = _zero_mean_mvn(self.q)

    def _log_weights(self, particles, lms, z, valid=None):
        """Sum over slots m of log N(z_m - h(particles, lm_m); 0, Q),
        slot m counted where valid[m] (all slots when valid is None)."""
        logw = torch.zeros(particles.shape[:-1], dtype=particles.dtype,
                           device=particles.device)
        for m in range(len(lms)):
            lp = self._meas_noise.logpdf(
                z[m] - self.measurement_model.prediction(particles, lms[m]))
            if valid is not None:
                lp = torch.where(valid[m], lp, torch.zeros_like(lp))
            logw = logw + lp
        return logw

    def _resample(self, particles, logw, draws):
        w = torch.exp(logw - torch.max(logw))
        return particles[_RESAMPLERS[self.resampling](w, draws)]

    def step(self, generator, particles, u, has_control, ids, z, mask, dt):
        prop = self.motion_model.sample(generator, particles, u, dt)
        draws = _resample_draws(self.resampling, generator, particles)
        return self._weigh_resample(prop, particles, has_control, ids, z,
                                    mask, draws)

    def _step(self, particles, u, has_control, ids, z, mask, dt,
              motion_noise, draws):
        """``step`` on drawn noise: the motion model's ``_sample`` normals
        and the resampler's uniforms."""
        prop = self.motion_model._sample(particles, u, dt, motion_noise)
        return self._weigh_resample(prop, particles, has_control, ids, z,
                                    mask, draws)

    def _weigh_resample(self, prop, particles, has_control, ids, z, mask,
                        draws):
        particles = torch.where(has_control, prop, particles)
        lms, valid = self.landmarks.lookup(ids)
        valid = torch.logical_and(valid, mask)
        logw = self._log_weights(particles, lms, z, valid)
        resampled = self._resample(particles, logw, draws)
        return torch.where(torch.any(valid), resampled, particles)
