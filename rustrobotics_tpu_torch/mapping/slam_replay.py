"""EKF-SLAM and FastSLAM replays of the SLAM-course log (counterpart of
``rustrobotics_tpu/mapping/slam_replay.py``).

The ODOMETRY records drive the odometry motion model and the SENSOR
records feed the known-correspondence EKF-SLAM or FastSLAM; ``world.dat``
gives the landmark ground truth used as the accuracy anchor (the dataset
has no pose ground truth). Landmark positions are recovered up to the
gauge fixed by anchoring the start pose at the origin.

A replay is a Python loop over events with no host read. It decides on
host copies of the measurement mask and slots: padded slots are skipped,
where the JAX package's masked update returns the state as it was, so the
states are the same bit for bit. FastSLAM's randomness comes from a
``torch.Generator`` (None: one seeded with ``seed`` on the device);
``_run_slam_course_fastslam`` takes the draws.
"""

from __future__ import annotations

import numpy as np
import torch

from rustrobotics_tpu_torch.data.slam_course import SlamCourseDataset
from rustrobotics_tpu_torch.device import resolve_device
from rustrobotics_tpu_torch.mapping.ekf_slam import (
    EkfSlamKnownCorrespondences,
    EkfSlamState,
)
from rustrobotics_tpu_torch.models.motion import OdometryMotionModel


def _slam_inputs(dataset: SlamCourseDataset, dtype, device):
    """(odometry (T, 3), z (T, M, 2) on ``device``, and per event the host
    list of its valid (slot, row) pairs). Slots follow ``landmark_ids``
    order; searchsorted needs ascending world.dat ids."""
    host = dataset.arrays(dtype=dtype, device="cpu")
    lids = np.asarray(dataset.landmark_ids)
    assert np.all(np.diff(lids) > 0), \
        "world.dat landmark ids must be strictly ascending"
    slots = np.clip(np.searchsorted(lids, host.meas_ids.numpy()), 0,
                    len(lids) - 1)
    mask = host.meas_mask.numpy()
    valid = [[(int(slots[t, m]), int(m)) for m in np.flatnonzero(mask[t])]
             for t in range(len(mask))]
    return host.odometry.to(device), host.meas_z.to(device), valid


def _replay(slam, state0, odometry, z, valid):
    """EKF-SLAM over every event: predict, then each valid slot's update.
    Returns (final state, robot poses (T, 3) on the device)."""
    dt = 0.0  # the odometry model ignores dt
    st, traj = state0, []
    for t in range(odometry.shape[0]):
        st = slam.predict(st, odometry[t], dt)
        for k, m in valid[t]:
            st = slam._update(st, k, z[t, m])
        traj.append(st.x[:3])
    return st, torch.stack(traj)


def _ekf_slam(dataset: SlamCourseDataset, alphas, sensor_noise, dtype,
              device, extra_slots=0):
    """The replay's EKF-SLAM: the odometry model and range-bearing noise,
    a slot per world.dat landmark and ``extra_slots`` more (headroom for
    unknown correspondences)."""
    return EkfSlamKnownCorrespondences.create(
        q=torch.diag(torch.tensor(sensor_noise, dtype=dtype) ** 2).to(device),
        motion_model=OdometryMotionModel.create(alphas, device, dtype),
        max_landmarks=len(dataset.landmark_ids) + extra_slots,
    )


def run_slam_course(
    dataset: SlamCourseDataset,
    alphas=(0.05, 0.01, 0.02, 0.01),
    sensor_noise=(0.2, 0.1),
    dtype=torch.float32,
    device=None,
):
    """Returns (trajectory (T, 3) numpy, EkfSlamState on ``device``, None:
    the card). Landmark slots follow ``dataset.landmark_ids`` order."""
    device = resolve_device(device)
    odometry, z, valid = _slam_inputs(dataset, dtype, device)
    slam = _ekf_slam(dataset, alphas, sensor_noise, dtype, device)
    state0 = slam.init_state(torch.zeros(3, dtype=dtype, device=device))
    state, traj = _replay(slam, state0, odometry, z, valid)
    return traj.cpu().numpy(), state


def landmark_map_error(dataset: SlamCourseDataset, state: EkfSlamState):
    """Max / mean distance between estimated and true landmark positions
    for every seen landmark, and how many were seen."""
    seen = state.seen.cpu().numpy()
    est = state.landmarks.double().cpu().numpy()[seen]
    true = np.asarray(dataset.landmarks)[seen]
    err = np.linalg.norm(est - true, axis=-1)
    return float(err.max()), float(err.mean()), int(seen.sum())


def _fastslam_draws(generator, t_len, num_particles, version, dtype,
                    device):
    kw = dict(generator=generator, dtype=dtype, device=device)
    draws = dict(init=torch.randn((num_particles, 3), **kw))
    if version == 2:
        draws["eps"] = torch.randn((t_len, num_particles, 3), **kw)
    else:
        draws["motion"] = torch.randn((t_len, 3), **kw)
    draws["resample"] = torch.rand((t_len,), **kw)
    return draws


def run_slam_course_fastslam(
    dataset: SlamCourseDataset,
    num_particles: int = 256,
    alphas=(1e-4, 2e-5, 5e-5, 2e-5),
    sensor_noise=(0.2, 0.1),
    seed: int = 0,
    dtype=torch.float32,
    version: int = 1,
    device=None,
    generator=None,
):
    """FastSLAM replay of the SLAM-course log (this log's odometry is
    nearly noise-free, hence the small default alphas). ``version=2``
    uses the measurement-driven proposal (fastslam2_step). Returns
    (FastSlamParticles on ``device``, None: the card; the estimated
    landmark map (L, 2) and seen mask, numpy)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(seed)
    draws = _fastslam_draws(generator, len(dataset.odometry), num_particles,
                            version, dtype, device)
    return _run_slam_course_fastslam(dataset, draws, alphas, sensor_noise,
                                     dtype, version, device)


def _fastslam(dataset: SlamCourseDataset, alphas, sensor_noise, dtype,
              device, extra_slots=0):
    """The replay's FastSlam, with the slots of ``_ekf_slam``."""
    from rustrobotics_tpu_torch.mapping.fastslam import FastSlam

    return FastSlam.create(
        q=torch.diag(torch.tensor(sensor_noise, dtype=dtype) ** 2).to(device),
        motion_model=OdometryMotionModel.create(alphas, device, dtype),
        max_landmarks=len(dataset.landmark_ids) + extra_slots,
    )


def _fastslam_replay(slam, parts, odometry, z, valid, draws, version):
    """FastSLAM over every event on the drawn noise; the valid slots only
    (the masked update of a padded slot leaves the cloud and adds a zero
    log-weight)."""
    from rustrobotics_tpu_torch.mapping.fastslam import _fastslam2_step

    dt = 0.0
    for t in range(odometry.shape[0]):
        ks = [k for k, _ in valid[t]]
        zs = [z[t, m] for _, m in valid[t]]
        ok = [True] * len(ks)
        if version == 2:
            parts = _fastslam2_step(slam, parts, odometry[t], True, ks, zs,
                                    ok, dt, draws["eps"][t],
                                    draws["resample"][t])
        else:
            parts = slam._step(parts, odometry[t], True, ks, zs, ok, dt,
                               draws["motion"][t], draws["resample"][t])
    return parts


def _run_slam_course_fastslam(dataset: SlamCourseDataset, draws,
                              alphas=(1e-4, 2e-5, 5e-5, 2e-5),
                              sensor_noise=(0.2, 0.1), dtype=torch.float32,
                              version=1, device=None):
    """``run_slam_course_fastslam`` on drawn noise: ``draws`` holds "init"
    (N, 3) standard normals of the initial cloud, "motion" (T, 3) of the
    odometry sampler (version 1) or "eps" (T, N, 3) of the 2.0 proposal
    (version 2), and the resampler's uniforms "resample" (T,)."""
    device = resolve_device(device)
    odometry, z, valid = _slam_inputs(dataset, dtype, device)
    slam = _fastslam(dataset, alphas, sensor_noise, dtype, device)
    parts = slam._init_particles(torch.zeros(3, dtype=dtype, device=device),
                                 draws["init"])
    parts = _fastslam_replay(slam, parts, odometry, z, valid, draws, version)
    _, est_lm, seen = slam.estimate(parts)
    return parts, est_lm.cpu().numpy(), seen.cpu().numpy()
