"""Graph-SLAM front-end: build a pose graph from a raw sensor log
(counterpart of ``rustrobotics_tpu/mapping/frontend.py``). For the
slam_course log:

- one SE2 node per timestep, chained by odometry edges whose measurement is
  the relative pose implied by the (rot1, trans, rot2) odometry record;
- one XY landmark node per world.dat id, connected by pose-landmark edges
  with the range-bearing sighting converted to a robot-frame XY offset
  (the measurement convention of EDGE_SE2_XY);
- information matrices from the odometry/sensor noise models.

The result is a standard PoseGraphData on the requested device, so every
backend and both GN/LM drivers apply unchanged. The graph is built on the
host in f64 and cast once.
"""

from __future__ import annotations

import numpy as np
import torch

from rustrobotics_tpu_torch.data.slam_course import SlamCourseDataset
from rustrobotics_tpu_torch.mapping.g2o import PoseGraphData, graph_from_numpy


def _odom_step(pose, u):
    r1, t, r2 = u
    heading = pose[2] + r1
    return np.array([
        pose[0] + t * np.cos(heading),
        pose[1] + t * np.sin(heading),
        (pose[2] + r1 + r2 + np.pi) % (2 * np.pi) - np.pi,
    ])


def build_pose_graph_from_slam_course(
    dataset: SlamCourseDataset,
    odom_sigma=(0.05, 0.05, 0.02),
    meas_sigma=0.1,
    dtype=torch.float32,
    device=None,
) -> PoseGraphData:
    """Pose graph from the slam_course log (initial poses = dead
    reckoning; landmarks initialized from their first sighting), on
    ``device`` (None: the card)."""
    odom = np.asarray(dataset.odometry, np.float64)
    T = len(odom)
    poses = np.zeros((T + 1, 3))
    for k in range(T):
        poses[k + 1] = _odom_step(poses[k], odom[k])

    # odometry edges: z = relative pose in the source frame
    pp_from = np.arange(T, dtype=np.int32)
    pp_to = np.arange(1, T + 1, dtype=np.int32)
    pp_z = np.zeros((T, 3))
    for k in range(T):
        r1, t, r2 = odom[k]
        pp_z[k] = [t * np.cos(r1), t * np.sin(r1), r1 + r2]
    info = np.diag(1.0 / np.asarray(odom_sigma) ** 2)
    pp_omega = np.broadcast_to(info, (T, 3, 3)).copy()

    # landmark nodes + pose-landmark edges
    id_to_slot = {int(i): k for k, i in enumerate(dataset.landmark_ids)}
    n_lm = len(dataset.landmark_ids)
    lm_init = np.zeros((n_lm, 2))
    lm_seen = np.zeros(n_lm, bool)
    pl_pose, pl_lm, pl_z = [], [], []
    for k, sens in enumerate(dataset.sensors):
        pose = poses[k + 1]  # sensor record follows the odometry step
        for row in np.asarray(sens, np.float64).reshape(-1, 3):
            lid, rng, bearing = int(row[0]), row[1], row[2]
            slot = id_to_slot[lid]
            # robot-frame XY measurement (EDGE_SE2_XY convention)
            mx = rng * np.cos(bearing)
            my = rng * np.sin(bearing)
            pl_pose.append(k + 1)
            pl_lm.append(slot)
            pl_z.append([mx, my])
            if not lm_seen[slot]:
                th = pose[2]
                lm_init[slot] = pose[:2] + [
                    rng * np.cos(bearing + th), rng * np.sin(bearing + th)
                ]
                lm_seen[slot] = True
    e_pl = len(pl_pose)
    pl_omega = np.broadcast_to(
        np.eye(2) / meas_sigma**2, (e_pl, 2, 2)
    ).copy()

    n_poses = T + 1
    pose2_offsets = np.arange(n_poses, dtype=np.int32) * 3
    lm2_offsets = n_poses * 3 + np.arange(n_lm, dtype=np.int32) * 2

    fields = dict(
        poses2=poses, landmarks2=lm_init, poses3=np.zeros((0, 7)),
        pp_from=pp_from, pp_to=pp_to, pp_z=pp_z, pp_omega=pp_omega,
        pl_pose=pl_pose, pl_lm=pl_lm,
        pl_z=np.asarray(pl_z).reshape(e_pl, 2), pl_omega=pl_omega,
        qq_from=[], qq_to=[], qq_z=np.zeros((0, 7)),
        qq_omega=np.zeros((0, 6, 6)), pose2_offsets=pose2_offsets,
        lm2_offsets=lm2_offsets, pose3_offsets=[],
    )
    return graph_from_numpy(fields, n_poses * 3 + n_lm * 2, prior2=0,
                            prior3=-1, device=device, dtype=dtype)
