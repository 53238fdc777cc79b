"""Landmark-based localization on the UTIAS dataset (counterpart of
``rustrobotics_tpu/localization/landmark_replay.py``).

EKF-KC, UKF-KC or PF-KC against the barcode-keyed landmark map, consuming
the merged odometry/measurement event stream; and the fleet: B banked
EKF-KC filters from perturbed initial states on the same stream.

The replay is a Python loop over events. It decides on the host copies of
the event flags (``EventArrays.*_np``) and makes no host read of a device
value: an event without control skips the predict, and each measurement
slot that is padding or names an id the table lacks is skipped. The JAX
package's masked step returns the old state exactly there
(``jnp.where``), so the states are the same, bit for bit, and the padded
slots' launches are gone.

Randomness: the PF's initial cloud and the fleet's initial spread come
from a ``torch.Generator`` (None: one seeded with ``seed`` on the device);
``_run_utias_localization`` and ``_run_utias_localization_fleet`` take the
draws directly.
"""

from __future__ import annotations

import numpy as np
import torch

from rustrobotics_tpu_torch.data.utias import EventArrays, UtiasDataset
from rustrobotics_tpu_torch.device import resolve_device
from rustrobotics_tpu_torch.localization.ekf import (
    ExtendedKalmanFilterKnownCorrespondences,
)
from rustrobotics_tpu_torch.localization.landmark_table import LandmarkTable
from rustrobotics_tpu_torch.localization.pf import (
    ParticleFilterKnownCorrespondences,
    _init_particles,
    gaussian_estimate,
)
from rustrobotics_tpu_torch.localization.ukf import (
    UnscentedKalmanFilterKnownCorrespondences,
)
from rustrobotics_tpu_torch.models import (
    RangeBearingMeasurementModel,
    VelocityMotionModel,
)
from rustrobotics_tpu_torch.utils.state import GaussianState

# noise settings of the reference example
_ALPHA = (1.0, 1.0, 30.0, 30.0, 10.0, 10.0)
_Q = (0.1, 0.2)


def _landmark_table(dataset: UtiasDataset, dtype, device):
    return LandmarkTable.create(
        ids=dataset.landmark_ids,
        positions=np.concatenate(
            [dataset.landmarks[:, :2], np.zeros((len(dataset.landmarks), 1))],
            axis=1,
        ),
        device=device, dtype=dtype,
    )


def _noise(dtype, device):
    alpha = torch.tensor(_ALPHA, dtype=dtype, device=device)
    return alpha, torch.diag(torch.tensor(_Q, dtype=dtype, device=device))


def build_filter(dataset: UtiasDataset, algo: str = "ekf",
                 dtype=torch.float64, device=None):
    """The EKF-KC, UKF-KC or PF-KC of the reference example on ``device``
    (None: the card)."""
    device = resolve_device(device)
    landmarks = _landmark_table(dataset, dtype, device)
    alpha, q = _noise(dtype, device)
    motion = VelocityMotionModel.create(alpha)
    meas = RangeBearingMeasurementModel.create()
    if algo == "ekf":
        return ExtendedKalmanFilterKnownCorrespondences(
            q=q, landmarks=landmarks, motion_model=motion,
            measurement_model=meas,
        )
    if algo == "ukf":
        return UnscentedKalmanFilterKnownCorrespondences.create(
            q=q, landmarks=landmarks, measurement_model=meas,
            motion_model=motion, alpha=1.0, beta=2.0, kappa=0.0,
            dtype=dtype,
        )
    if algo == "pf":
        return ParticleFilterKnownCorrespondences(
            q=q, landmarks=landmarks, motion_model=motion,
            measurement_model=meas,
        )
    raise ValueError(f"unknown algo {algo!r}")


def _valid_slots(landmarks: LandmarkTable, events: EventArrays):
    """Per event, the (table row, slot) pairs of its valid measurements,
    from the host copies."""
    rows, known = landmarks.lookup_np(events.meas_ids_np)
    valid = known & events.meas_mask_np
    return [[(int(rows[t, m]), int(m)) for m in np.flatnonzero(valid[t])]
            for t in range(len(valid))]


def _first_dt(events: EventArrays):
    """dt of the first event is measured from the groundtruth start."""
    dt = events.dt.clone()
    dt[0] = events.times[0]
    return dt


def _replay_kalman(filt, state: GaussianState, events: EventArrays, dt):
    """EKF-KC or UKF-KC over every event: (T,)-stacked states."""
    slots = _valid_slots(filt.landmarks, events)
    pos, u, z = filt.landmarks.positions, events.control, events.meas_z
    xs, covs = [], []
    for t, has_control in enumerate(events.has_control_np):
        if has_control:
            state = filt.predict(state, u[t], dt[t])
        for row, m in slots[t]:
            state = filt._update_one(state, pos[row], z[t, m])
        xs.append(state.x)
        covs.append(state.cov)
    return GaussianState(x=torch.stack(xs), cov=torch.stack(covs))


def _replay_pf(filt, particles, events: EventArrays, dt, motion, resample):
    """PF-KC over every event on drawn noise (motion (T, 3, N), resample
    (T, N)): the (T,)-stacked Gaussian estimates."""
    slots = _valid_slots(filt.landmarks, events)
    pos, u, z = filt.landmarks.positions, events.control, events.meas_z
    xs, covs = [], []
    for t, has_control in enumerate(events.has_control_np):
        if has_control:
            particles = filt.motion_model._sample(particles, u[t], dt[t],
                                                  motion[t])
        if slots[t]:
            logw = filt._log_weights(particles,
                                     [pos[row] for row, _ in slots[t]],
                                     [z[t, m] for _, m in slots[t]])
            particles = filt._resample(particles, logw, resample[t])
        est = gaussian_estimate(particles)
        xs.append(est.x)
        covs.append(est.cov)
    return GaussianState(x=torch.stack(xs), cov=torch.stack(covs))


def run_utias_localization(
    dataset: UtiasDataset,
    algo: str = "ekf",
    max_events: int = 10000,
    num_particles: int = 300,
    seed: int = 0,
    dtype=torch.float64,
    device=None,
    generator=None,
):
    """Returns (times (T,) numpy, estimates GaussianState with a leading T
    axis on ``device``, None: the card)."""
    device = resolve_device(device)
    if algo == "pf" and generator is None:
        generator = torch.Generator(device).manual_seed(seed)
    return _run_utias_localization(dataset, algo, max_events, num_particles,
                                   dtype, device, generator=generator)


def _pf_draws(generator, t_len, num_particles, dtype, device):
    kw = dict(generator=generator, dtype=dtype, device=device)
    return dict(init=torch.randn((num_particles, 3), **kw),
                motion=torch.randn((t_len, 3, num_particles), **kw),
                resample=torch.rand((t_len, num_particles), **kw))


def _run_utias_localization(dataset: UtiasDataset, algo="ekf",
                            max_events=10000, num_particles=300,
                            dtype=torch.float64, device=None,
                            generator=None, draws=None):
    """``run_utias_localization`` on drawn noise. For the PF, ``draws``
    is a dict of "init" (N, 3) standard normals of the initial cloud,
    "motion" (T, 3, N) of the motion sampler and the multinomial
    resampler's uniforms "resample" (T, N); None draws them from
    ``generator``."""
    device = resolve_device(device)
    filt = build_filter(dataset, algo, dtype, device)
    events = dataset.events(max_events=max_events, dtype=dtype,
                            device=device)
    x0 = torch.as_tensor(dataset.groundtruth[0, 1:4], dtype=dtype,
                         device=device)
    dt = _first_dt(events)
    if algo in ("ekf", "ukf"):
        # the UKF needs a nondegenerate Cholesky for its sigma points
        init_var = 1e-10 if algo == "ekf" else 1e-6
        state0 = GaussianState(
            x=x0, cov=torch.eye(3, dtype=dtype, device=device) * init_var)
        states = _replay_kalman(filt, state0, events, dt)
    else:
        # initial cloud around groundtruth with r = diag(.2, .2, .2)
        r = torch.diag(torch.full((3,), 0.2, dtype=dtype, device=device))
        if draws is None:
            draws = _pf_draws(generator, events.num_events, num_particles,
                              dtype, device)
        particles0 = _init_particles(GaussianState(x=x0, cov=r), r,
                                     draws["init"])
        states = _replay_pf(filt, particles0, events, dt, draws["motion"],
                            draws["resample"])
    return events.times.cpu().numpy(), states


def build_banked_filter(dataset: UtiasDataset, dtype=torch.float32,
                        device=None):
    """Banked EKF-KC with the same noise settings as ``build_filter``'s
    EKF: the fleet entry point's filter (bank axis last)."""
    from rustrobotics_tpu_torch.localization.banked import (
        velocity_banked_ekf_kc,
    )

    device = resolve_device(device)
    alpha, q = _noise(dtype, device)
    return velocity_banked_ekf_kc(alpha, q,
                                  _landmark_table(dataset, dtype, device))


def _replay_banked(filt, x, cov, events: EventArrays, dt):
    """Every event advances all B filters; estimates (T, 3, B)."""
    slots = _valid_slots(filt.landmarks, events)
    pos, u, z = filt.landmarks.positions, events.control, events.meas_z
    bank = x.shape[-1]
    xs = []
    for t, has_control in enumerate(events.has_control_np):
        if has_control:
            x, cov = filt.predict_step(x, cov, u[t][:, None].expand(2, bank),
                                       dt[t])
        for row, m in slots[t]:
            x, cov = filt._update_one(x, cov, pos[row], z[t, m])
        xs.append(x)
    return torch.stack(xs)


def run_utias_localization_fleet(
    dataset: UtiasDataset,
    bank: int = 1024,
    max_events: int = 10000,
    seed: int = 0,
    spread: float = 0.1,
    dtype=torch.float32,
    device=None,
    generator=None,
):
    """Fleet replay: B banked EKF-KC filters consume the same UTIAS event
    stream from initial states perturbed by N(0, spread²) (Monte-Carlo
    over initialization). Returns (times (T,) numpy, xs (T, 3, B))."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(seed)
    noise = torch.randn((3, bank), generator=generator, dtype=dtype,
                        device=device)
    return _run_utias_localization_fleet(dataset, noise, max_events, spread,
                                         dtype, device)


def _run_utias_localization_fleet(dataset: UtiasDataset, noise,
                                  max_events=10000, spread=0.1,
                                  dtype=torch.float32, device=None):
    """The fleet replay on drawn standard normals ``noise`` (3, B)."""
    device = resolve_device(device)
    filt = build_banked_filter(dataset, dtype, device)
    events = dataset.events(max_events=max_events, dtype=dtype,
                            device=device)
    x0 = torch.as_tensor(dataset.groundtruth[0, 1:4], dtype=dtype,
                         device=device)
    bank = noise.shape[-1]
    x0b = x0[:, None] + spread * noise
    cov0 = (torch.eye(3, dtype=dtype, device=device)
            * 1e-10)[:, :, None].expand(3, 3, bank)
    xs = _replay_banked(filt, x0b, cov0, events, _first_dt(events))
    return events.times.cpu().numpy(), xs


def ate_vs_groundtruth(dataset: UtiasDataset, times, states) -> float:
    """RMSE of estimated xy against time-interpolated groundtruth."""
    gt = dataset.groundtruth
    gt_times = gt[:, 0] - gt[0, 0]  # event times are groundtruth-relative
    gx = np.interp(times, gt_times, gt[:, 1])
    gy = np.interp(times, gt_times, gt[:, 2])
    est = states.x[:, :2]
    if isinstance(est, torch.Tensor):
        est = est.detach().cpu().numpy()
    est = np.asarray(est)
    return float(np.sqrt(np.mean((est[:, 0] - gx) ** 2
                                 + (est[:, 1] - gy) ** 2)))
