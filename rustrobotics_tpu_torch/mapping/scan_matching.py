"""Scan-matching odometry + occupancy mapping pipeline (counterpart of
``rustrobotics_tpu/mapping/scan_matching.py``).

The classic lidar-SLAM front end: consecutive range scans are aligned by
point-to-point ICP to produce odometry, poses compose along SE(2), and
every scan is fused into a log-odds occupancy grid at its estimated pose;
``scan_matching_slam_pgo`` adds ICP loop closures and pose-graph
optimization.

The alignments of an odometry chain do not depend on each other, so
``icp_odometry`` runs them as batches of scan pairs (one ICP over a
leading pair axis) and composes the chain afterwards; a loop-closure
refinement runs its 7 yaw seeds as one batched ICP.
"""

from __future__ import annotations

import numpy as np
import torch

from rustrobotics_tpu_torch.device import as_tensor
from rustrobotics_tpu_torch.geometry import se2
from rustrobotics_tpu_torch.mapping.icp import icp
from rustrobotics_tpu_torch.mapping.occupancy import (
    OccupancyGrid,
    integrate_trajectory,
)

# elements of the (pairs, N, M) distance matrices of one odometry batch
_PAIR_BATCH_ELEMS = 1 << 26


def scan_to_points(ranges, angles, max_range):
    """Robot-frame (..., B, 2) points of a scan's valid returns; invalid
    beams (>= max_range or non-finite) collapse onto the origin with a
    False mask."""
    ok = torch.isfinite(ranges) & (ranges < max_range)
    r = torch.where(ok, ranges, torch.zeros_like(ranges))
    pts = torch.stack([r * torch.cos(angles), r * torch.sin(angles)], -1)
    return pts, ok


def _icp_pose(src, dst, num_iterations, reject_quantile):
    """ICP of src onto dst as SE2 poses [x, y, theta] (..., 3), and the
    rmse."""
    r, t, rmse = icp(src, dst, num_iterations=num_iterations,
                     reject_quantile=reject_quantile)
    theta = torch.atan2(r[..., 1, 0], r[..., 0, 0])
    return torch.stack([t[..., 0], t[..., 1], theta], -1), rmse


def icp_odometry(scans, angles, max_range, num_iterations: int = 15,
                 reject_quantile=0.9):
    """Chain ICP alignments of consecutive scans into SE(2) poses.

    scans (T, B) ranges with shared beam angles (B,). Returns poses
    (T, 3) with pose[0] = identity, the points (T, B, 2) and their masks.
    Each alignment maps scan t's points onto scan t-1's frame, i.e. the
    relative motion, composed left.
    """
    scans = as_tensor(scans)
    angles = as_tensor(angles)
    t_total, beams = scans.shape
    pts_all, ok_all = scan_to_points(scans, angles, max_range)
    # masked-out beams sit at the origin on both sides; with the outlier
    # quantile they are trimmed from the alignment
    chunk = max(1, _PAIR_BATCH_ELEMS // (beams * beams))
    rels = []
    for s in range(1, t_total, chunk):
        e = min(s + chunk, t_total)
        rels.append(_icp_pose(pts_all[s:e], pts_all[s - 1:e - 1],
                              num_iterations, reject_quantile)[0])
    poses = [torch.zeros(3, dtype=scans.dtype, device=scans.device)]
    for rel in (torch.cat(rels) if rels else []):
        poses.append(se2.compose(poses[-1], rel))
    return torch.stack(poses), pts_all, ok_all


def _grid_origin(grid_size, resolution, origin):
    if origin is None:
        span = grid_size * resolution
        origin = (-span / 2, -span / 2)
    return origin


def scan_matching_slam(scans, angles, max_range, grid_size=160,
                       resolution=0.25, origin=None,
                       samples_per_beam: int = 96):
    """Full front end: ICP odometry + occupancy fusion.

    Returns (poses (T, 3), OccupancyGrid), on the scans' device."""
    scans = as_tensor(scans)
    angles = as_tensor(angles)
    poses, _, _ = icp_odometry(scans, angles, max_range)
    grid = OccupancyGrid.create(
        grid_size, grid_size, resolution,
        origin=_grid_origin(grid_size, resolution, origin),
        dtype=scans.dtype, device=scans.device)
    grid = integrate_trajectory(grid, poses, scans, angles,
                                max_range=max_range,
                                samples_per_beam=samples_per_beam)
    return poses, grid


def _build_pose_graph(poses, odo_rels, closures, odo_omega, clos_omega,
                      dtype, device):
    """PoseGraphData from an odometry chain + ICP loop closures (numpy
    in; the graph on ``device`` in ``dtype``)."""
    from rustrobotics_tpu_torch.mapping.g2o import graph_from_numpy

    t_total = poses.shape[0]
    pp_from = list(range(t_total - 1))
    pp_to = list(range(1, t_total))
    pp_z = [np.asarray(z) for z in odo_rels]
    pp_omega = [np.asarray(odo_omega)] * (t_total - 1)
    for (i, j, rel) in closures:
        pp_from.append(i)
        pp_to.append(j)
        pp_z.append(np.asarray(rel))
        pp_omega.append(np.asarray(clos_omega))
    empty = np.zeros(0, np.int64)
    fields = dict(
        poses2=np.asarray(poses, np.float64),
        landmarks2=np.zeros((0, 2)), poses3=np.zeros((0, 7)),
        pp_from=np.asarray(pp_from), pp_to=np.asarray(pp_to),
        pp_z=np.stack(pp_z).astype(np.float64),
        pp_omega=np.stack(pp_omega).astype(np.float64),
        pl_pose=empty, pl_lm=empty,
        pl_z=np.zeros((0, 2)), pl_omega=np.zeros((0, 2, 2)),
        qq_from=empty, qq_to=empty,
        qq_z=np.zeros((0, 7)), qq_omega=np.zeros((0, 6, 6)),
        pose2_offsets=np.arange(t_total) * 3, lm2_offsets=empty,
        pose3_offsets=empty,
    )
    return graph_from_numpy(fields, total_dof=int(t_total * 3), prior2=0,
                            prior3=-1, device=device, dtype=dtype)


def _refine(src_pts, dst_pts, rel0, yaw_seeds):
    """MULTISTART ICP: by revisit time the odometry's angular drift can
    exceed ICP's convergence basin, so a fan of yaw-perturbed
    initializations runs as ONE batched ICP and the best-rmse hypothesis
    wins. Returns (rel (3,), rmse), both on the device."""
    rel_init = rel0.expand(yaw_seeds.shape + (3,)).clone()
    rel_init[:, 2] += yaw_seeds
    moved = se2.transform(rel_init[:, None, :], src_pts)   # (7, B, 2)
    pose, rmses = _icp_pose(moved, dst_pts, 15, 0.9)
    rels = se2.compose(pose, rel_init)
    best = torch.argmin(rmses)
    return rels[best], rmses[best]


def scan_matching_slam_pgo(scans, angles, max_range,
                           closure_gap: int = 6,
                           closure_radius: float = 1.0,
                           odo_sigma=(0.03, 0.03, 0.02),
                           clos_sigma=(0.02, 0.02, 0.015),
                           grid_size=160, resolution=0.25, origin=None,
                           samples_per_beam: int = 96,
                           num_iterations: int = 30,
                           passes: int = 2):
    """Full lidar SLAM: ICP odometry + ICP loop closures + pose-graph
    optimization + occupancy fusion at the OPTIMIZED poses.

    Loop-closure candidates are pose pairs (i, j) with j - i >
    ``closure_gap`` whose current estimates sit within
    ``closure_radius``; each candidate is verified/refined by ICP from the
    current relative estimate (7 yaw seeds in one batch; the best rmse
    is read on the host and kept below 0.3). The graph is initialized by
    chordal rotation averaging when it has closures, then solved by
    Gauss-Newton, on ``banded-direct`` above 64 poses, else ``dense``
    (as the JAX package chooses). The detect-close-optimize cycle runs
    ``passes`` times.

    Returns (poses (T, 3), OccupancyGrid, PoseGraphData), on the scans'
    device."""
    from rustrobotics_tpu_torch.mapping.initialization import (
        chordal_init_se2,
    )
    from rustrobotics_tpu_torch.mapping.pgo import optimize

    scans = as_tensor(scans)
    angles = as_tensor(angles)
    dtype, device = scans.dtype, scans.device
    poses_odo, pts_all, _ = icp_odometry(scans, angles, max_range)
    t_total = scans.shape[0]
    odo_rels = se2.relative(poses_odo[:-1], poses_odo[1:]).cpu().numpy()

    yaw_seeds = torch.linspace(-0.9, 0.9, 7, dtype=dtype, device=device)
    odo_omega = np.diag(1.0 / np.square(np.asarray(odo_sigma)))
    clos_omega = np.diag(1.0 / np.square(np.asarray(clos_sigma)))
    cur = poses_odo
    closures = {}
    res = None
    for _ in range(passes):
        poses_np = cur.cpu().numpy()
        for j in range(closure_gap, t_total):
            d = np.linalg.norm(poses_np[:j - closure_gap + 1, :2]
                               - poses_np[j, :2], axis=1)
            i = int(np.argmin(d))
            if d[i] < closure_radius:
                rel0 = se2.relative(cur[i], cur[j])
                rel, rmse = _refine(pts_all[j], pts_all[i], rel0, yaw_seeds)
                if float(rmse) < 0.3:
                    closures[(i, j)] = rel.cpu().numpy()
        graph = _build_pose_graph(
            poses_np, odo_rels,
            [(i, j, r) for (i, j), r in closures.items()],
            odo_omega, clos_omega, dtype, device)
        # a loop closure against heavy angular drift is a large-residual
        # nonlinear fold: chordal initialization (rotation averaging)
        # puts the whole loop in the closure's basin before GN refines
        if closures:
            graph = chordal_init_se2(graph)
        res = optimize(graph, num_iterations=num_iterations,
                       backend="banded-direct"
                       if graph.poses2.shape[0] > 64 else "dense",
                       device=device)
        cur = res.graph.poses2.to(dtype)
    poses = cur

    grid = OccupancyGrid.create(
        grid_size, grid_size, resolution,
        origin=_grid_origin(grid_size, resolution, origin),
        dtype=dtype, device=device)
    grid = integrate_trajectory(grid, poses, scans, angles,
                                max_range=max_range,
                                samples_per_beam=samples_per_beam)
    return poses, grid, res.graph
