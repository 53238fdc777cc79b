"""Synthetic 2D localization problem, the minimum end-to-end slice
(counterpart of ``rustrobotics_tpu/localization/simulation.py``).

A unicycle driven with constant control, noisy GPS observations and noisy
control inputs, filtered by EKF / UKF / PF. The episode is a Python loop
over steps (the JAX package's ``lax.scan``). ``run_simulation`` draws its
noise from a ``torch.Generator``; ``_run_simulation`` takes the draws
(``simulation_draws``' dict) directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from rustrobotics_tpu_torch.device import resolve_device, tensor_fields
from rustrobotics_tpu_torch.localization.ekf import ExtendedKalmanFilter
from rustrobotics_tpu_torch.localization.pf import (
    ParticleFilter,
    _init_particles,
    gaussian_estimate,
)
from rustrobotics_tpu_torch.localization.ukf import UnscentedKalmanFilter
from rustrobotics_tpu_torch.models import (
    SimpleProblemMeasurementModel,
    SimpleProblemMotionModel,
)
from rustrobotics_tpu_torch.utils.angles import deg2rad
from rustrobotics_tpu_torch.utils.state import GaussianState


@dataclasses.dataclass
class SimpleProblem:
    """Noisy truth/observation generator."""

    gps_noise: torch.Tensor  # (2, 2)
    input_noise: torch.Tensor  # (2, 2)
    motion_model: Any
    measurement_model: Any

    def __post_init__(self):
        tensor_fields(self, "gps_noise", "input_noise")

    def observation(self, generator, x_true, x_dr, u, dt):
        n = torch.randn((2, 2), generator=generator, dtype=x_true.dtype,
                        device=x_true.device)
        return self._observation(x_true, x_dr, u, dt, n[0], n[1])

    def _observation(self, x_true, x_dr, u, dt, gps_draw, input_draw):
        """``observation`` on two standard normal pairs: the GPS noise's
        and the control noise's."""
        x_true_next = self.motion_model.prediction(x_true, u, dt)
        z = (self.measurement_model.prediction(x_true_next)
             + self.gps_noise @ gps_draw)
        ud = u + self.input_noise @ input_draw
        x_dr_next = self.motion_model.prediction(x_dr, ud, dt)
        return x_true_next, z, x_dr_next, ud


def default_problem(dtype=torch.float32, device=None):
    """Noise settings of the reference example."""
    device = resolve_device(device)
    return SimpleProblem(
        gps_noise=torch.tensor([[0.25, 0.0], [0.0, 0.25]], dtype=dtype,
                               device=device),
        input_noise=torch.tensor([[1.0, 0.0], [0.0, deg2rad(30.0) ** 2]],
                                 dtype=dtype, device=device),
        motion_model=SimpleProblemMotionModel.create(),
        measurement_model=SimpleProblemMeasurementModel.create(),
    )


def default_noise_covs(dtype=torch.float32, device=None):
    """Q, R of the reference example."""
    device = resolve_device(device)
    q = torch.diag(torch.tensor([0.1, 0.1, deg2rad(1.0), 1.0], dtype=dtype,
                                device=device))
    q = q @ q
    r = torch.eye(2, dtype=dtype, device=device)
    return q, r


def make_filter(algo: str, dtype=torch.float32, num_particles: int = 300,
                device=None):
    q, r = default_noise_covs(dtype, device)
    mot = SimpleProblemMotionModel.create()
    meas = SimpleProblemMeasurementModel.create()
    if algo == "ekf":
        # the reference passes its Q as the EKF's R and R as Q
        return ExtendedKalmanFilter(
            r=q, q=r, motion_model=mot, measurement_model=meas
        )
    if algo == "ukf":
        return UnscentedKalmanFilter.create(
            q=q, r=r, measurement_model=meas, motion_model=mot,
            alpha=0.1, beta=2.0, kappa=0.0,
        )
    if algo == "pf":
        return ParticleFilter(
            r=q, q=r, motion_model=mot, measurement_model=meas,
            resampling="stratified",
        )
    raise ValueError(f"unknown algo {algo!r}")


def simulation_draws(generator, algo: str, num_steps: int,
                     num_particles: int = 300, dtype=torch.float32,
                     device=None):
    """The standard normals and uniforms of one episode: "gps" and "input"
    (T, 2); for the PF also "init" (N, 4), "noise" (T, N, 4) and the
    stratified resampler's "resample" (T, N)."""
    device = resolve_device(device)
    kw = dict(generator=generator, dtype=dtype, device=device)
    draws = {"gps": torch.randn((num_steps, 2), **kw),
             "input": torch.randn((num_steps, 2), **kw)}
    if algo == "pf":
        draws["init"] = torch.randn((num_particles, 4), **kw)
        draws["noise"] = torch.randn((num_steps, num_particles, 4), **kw)
        draws["resample"] = torch.rand((num_steps, num_particles), **kw)
    return draws


def run_simulation(
    generator=None,
    algo: str = "ekf",
    sim_time: float = 50.0,
    dt: float = 0.1,
    num_particles: int = 300,
    dtype=torch.float32,
    device=None,
):
    """Run the full episode on ``device`` (None: the card), its noise
    drawn from ``generator`` (None: one seeded with 0 on the device).
    Returns a history dict of stacked tensors: z, x_true, x_dr, x_est,
    cov_est."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    draws = simulation_draws(generator, algo, int(sim_time / dt),
                             num_particles, dtype, device)
    return _run_simulation(draws, algo, sim_time, dt, num_particles, dtype,
                           device)


# the JAX package's jitted entry; here the same function
run_simulation_jit = run_simulation


def _run_simulation(draws, algo: str = "ekf", sim_time: float = 50.0,
                    dt: float = 0.1, num_particles: int = 300,
                    dtype=torch.float32, device=None):
    """``run_simulation`` on drawn noise (``simulation_draws``)."""
    device = resolve_device(device)
    num_steps = int(sim_time / dt)
    problem = default_problem(dtype, device)
    filt = make_filter(algo, dtype, num_particles, device)
    u = torch.tensor([1.0, 0.1], dtype=dtype, device=device)
    x0 = torch.zeros(4, dtype=dtype, device=device)
    init = GaussianState(x=x0, cov=torch.eye(4, dtype=dtype, device=device))
    is_pf = algo == "pf"
    fstate = _init_particles(init, filt.r, draws["init"]) if is_pf else init
    x_true = x_dr = x0
    history = {k: [] for k in ("z", "x_true", "x_dr", "x_est", "cov_est")}
    for k in range(num_steps):
        x_true, z, x_dr, ud = problem._observation(
            x_true, x_dr, u, dt, draws["gps"][k], draws["input"][k])
        if is_pf:
            fstate = filt._step(fstate, ud, z, dt, draws["noise"][k],
                                draws["resample"][k])
            est = gaussian_estimate(fstate)
        else:
            fstate = filt.step(fstate, ud, z, dt)
            est = fstate
        for key, val in (("z", z), ("x_true", x_true), ("x_dr", x_dr),
                         ("x_est", est.x), ("cov_est", est.cov)):
            history[key].append(val)
    return {k: torch.stack(v) for k, v in history.items()}
