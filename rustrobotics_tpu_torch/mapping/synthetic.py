"""Synthetic pose-graph generators (counterpart of
``rustrobotics_tpu/mapping/synthetic.py``).

Everything is drawn in numpy from ``np.random.default_rng(seed)`` exactly
as the JAX package does, and turned into tensors at the end, so one seed
gives identical arrays in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from rustrobotics_tpu_torch.mapping.g2o import PoseGraphData, graph_from_numpy


def _rel(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    rt = np.array([[c, s], [-s, c]])
    d = rt @ (b[:2] - a[:2])
    th = (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi
    return np.array([d[0], d[1], th])


def _to_graph(init, lm_init, pp, pl, num_poses, num_landmarks, dtype,
              device) -> PoseGraphData:
    pp_from, pp_to, pp_z, pp_omega = pp
    pl_pose, pl_lm, pl_z, pl_omega = pl
    fields = {
        "poses2": init,
        "landmarks2": lm_init.reshape(-1, 2),
        "poses3": np.zeros((0, 7)),
        "pp_from": pp_from,
        "pp_to": pp_to,
        "pp_z": np.asarray(pp_z).reshape(-1, 3),
        "pp_omega": np.asarray(pp_omega).reshape(-1, 3, 3),
        "pl_pose": pl_pose,
        "pl_lm": pl_lm,
        "pl_z": np.asarray(pl_z).reshape(-1, 2) if pl_z else np.zeros((0, 2)),
        "pl_omega": (np.asarray(pl_omega).reshape(-1, 2, 2)
                     if pl_omega else np.zeros((0, 2, 2))),
        "qq_from": [],
        "qq_to": [],
        "qq_z": np.zeros((0, 7)),
        "qq_omega": np.zeros((0, 6, 6)),
        # reference dof layout: poses first, then landmarks
        "pose2_offsets": np.arange(num_poses) * 3,
        "lm2_offsets": num_poses * 3 + np.arange(num_landmarks) * 2,
        "pose3_offsets": [],
    }
    return graph_from_numpy(
        fields, num_poses * 3 + num_landmarks * 2, prior2=0, prior3=-1,
        device=device, dtype=dtype)


def synthetic_pose_graph_2d(
    num_poses: int = 64,
    num_landmarks: int = 8,
    noise: float = 0.05,
    seed: int = 0,
    dtype=torch.float64,
    device=None,
) -> PoseGraphData:
    """Circle trajectory with odometry edges, loop closures across the
    circle, and landmark observations; initial guess perturbed by
    ``noise`` (first pose exact: it carries the gauge prior)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2.0 * np.pi, num_poses, endpoint=False)
    radius = 5.0
    gt = np.stack(
        [radius * np.cos(t), radius * np.sin(t), t + np.pi / 2.0], axis=-1
    )
    gt[:, 2] = (gt[:, 2] + np.pi) % (2 * np.pi) - np.pi

    pp_from, pp_to, pp_z, pp_omega = [], [], [], []
    omega = np.diag([100.0, 100.0, 400.0])
    for i in range(num_poses - 1):
        pp_from.append(i)
        pp_to.append(i + 1)
        pp_z.append(_rel(gt[i], gt[i + 1]))
        pp_omega.append(omega)
    # loop closures every num_poses//8 steps to the opposite side
    stride = max(num_poses // 8, 2)
    for i in range(0, num_poses, stride):
        j = (i + num_poses // 2) % num_poses
        pp_from.append(i)
        pp_to.append(j)
        pp_z.append(_rel(gt[i], gt[j]))
        pp_omega.append(omega)

    # landmarks on an inner circle
    ring = np.linspace(0, 2 * np.pi, max(num_landmarks, 1), endpoint=False)
    lm_gt = np.stack([2.5 * np.cos(ring), 2.5 * np.sin(ring)],
                     axis=-1)[:num_landmarks]
    pl_pose, pl_lm, pl_z, pl_omega = [], [], [], []
    om2 = np.diag([50.0, 50.0])
    for i in range(0, num_poses, max(num_poses // 16, 1)):
        for k in range(num_landmarks):
            c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
            rt = np.array([[c, s], [-s, c]])
            pl_pose.append(i)
            pl_lm.append(k)
            pl_z.append(rt @ (lm_gt[k] - gt[i, :2]))
            pl_omega.append(om2)

    init = gt + rng.normal(scale=noise, size=gt.shape)
    init[0] = gt[0]
    lm_init = (lm_gt + rng.normal(scale=noise, size=lm_gt.shape)
               if num_landmarks else np.zeros((0, 2)))
    return _to_graph(init, lm_init, (pp_from, pp_to, pp_z, pp_omega),
                     (pl_pose, pl_lm, pl_z, pl_omega), num_poses,
                     num_landmarks, dtype, device)


def synthetic_corridor_graph_2d(
    num_poses: int = 1024,
    num_landmarks: int = 0,
    closure_stride: int = 16,
    closure_span: int = 64,
    noise: float = 0.05,
    seed: int = 0,
    dtype=torch.float64,
    device=None,
) -> PoseGraphData:
    """Corridor trajectory with local loop closures only: every
    ``closure_stride`` poses, a closure ``closure_span`` poses back.
    Landmarks sit along the corridor, each observed by a window of nearby
    poses. The RCM bandwidth is O(span) whatever the length."""
    rng = np.random.default_rng(seed)
    s = np.arange(num_poses) * 0.5
    gt = np.stack(
        [s, 2.0 * np.sin(s * 0.05), 0.1 * np.cos(s * 0.05)], axis=-1
    )

    pp_from, pp_to, pp_z, pp_omega = [], [], [], []
    omega = np.diag([100.0, 100.0, 400.0])
    for i in range(num_poses - 1):
        pp_from.append(i)
        pp_to.append(i + 1)
        pp_z.append(_rel(gt[i], gt[i + 1]))
        pp_omega.append(omega)
    for i in range(closure_span, num_poses, closure_stride):
        j = i - closure_span
        pp_from.append(j)
        pp_to.append(i)
        pp_z.append(_rel(gt[j], gt[i]))
        pp_omega.append(omega)

    # landmarks along the corridor, observed by a +-span/2 pose window
    pl_pose, pl_lm, pl_z, pl_omega = [], [], [], []
    om2 = np.diag([50.0, 50.0])
    if num_landmarks:
        anchor = np.linspace(0, num_poses - 1, num_landmarks).astype(int)
        lm_gt = gt[anchor, :2] + np.array([0.0, 1.5])
        for k in range(num_landmarks):
            w = closure_span // 2
            for i in range(max(0, anchor[k] - w),
                           min(num_poses, anchor[k] + w), 8):
                c, sn = np.cos(gt[i, 2]), np.sin(gt[i, 2])
                rt = np.array([[c, sn], [-sn, c]])
                pl_pose.append(i)
                pl_lm.append(k)
                pl_z.append(rt @ (lm_gt[k] - gt[i, :2]))
                pl_omega.append(om2)
    else:
        lm_gt = np.zeros((0, 2))

    init = gt + rng.normal(scale=noise, size=gt.shape)
    init[0] = gt[0]
    lm_init = (lm_gt + rng.normal(scale=noise, size=lm_gt.shape)
               if num_landmarks else np.zeros((0, 2)))
    return _to_graph(init, lm_init, (pp_from, pp_to, pp_z, pp_omega),
                     (pl_pose, pl_lm, pl_z, pl_omega), num_poses,
                     num_landmarks, dtype, device)
