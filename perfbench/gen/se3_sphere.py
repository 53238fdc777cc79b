"""sphere2500's shape: SE3 poses on rings of a sphere, the odometry chain
and a closure from each pose to the pose one ring below (a copy of the
construction the port's smoke run uses, with the guesses drawn on the
device).

Ground truth: poses on a sphere of radius ``radius_m``, ring r at latitude
-pi/2 + pi (r + 1/2) / rings, pose k of a ring at longitude 2 pi k /
per_ring, heading along the ring (x east, z outward). Odometry i -> i + 1
and a closure i - per_ring -> i for every i >= per_ring; exact
relative-pose measurements with information diag(omega); the gauge prior
sits on pose 0. Poses are (7,) [t, q_wxyz].
"""

from __future__ import annotations

import numpy as np
import torch

DIM = 6  # dof of a pose


def _qmul(a, b):
    """Hamilton product of (..., 4) wxyz quaternions (numpy)."""
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], axis=-1)


def _qrot(q, v):
    t = 2.0 * np.cross(q[..., 1:], v)
    return v + q[..., :1] * t + np.cross(q[..., 1:], t)


def _qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _qnorm(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def truth(cfg):
    rings, per_ring = cfg["rings"], cfg["per_ring"]
    n = rings * per_ring
    lat = np.repeat(-np.pi / 2 + np.pi * (np.arange(rings) + 0.5) / rings,
                    per_ring)
    lon = np.tile(2.0 * np.pi * np.arange(per_ring) / per_ring, rings)
    normal = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                       np.sin(lat)], axis=-1)
    # R = Rz(lon + pi/2) Rx(pi/2 - lat): x east, z along the outward normal
    yaw, tilt = 0.5 * (lon + np.pi / 2), 0.5 * (np.pi / 2 - lat)
    zero = np.zeros(n)
    q = _qmul(np.stack([np.cos(yaw), zero, zero, np.sin(yaw)], -1),
              np.stack([np.cos(tilt), np.sin(tilt), zero, zero], -1))
    return np.concatenate([cfg["radius_m"] * normal, q], axis=-1)


def structure(cfg):
    """As ``se2_corridor.structure``, for SE3 poses."""
    per_ring = cfg["per_ring"]
    gt = truth(cfg)
    n = len(gt)
    fr = np.concatenate([np.arange(n - 1), np.arange(n - per_ring)])
    to = np.concatenate([np.arange(1, n), np.arange(per_ring, n)])
    qc = _qconj(gt[fr, 3:])
    z = np.concatenate([_qrot(qc, gt[to, :3] - gt[fr, :3]),
                        _qnorm(_qmul(qc, gt[to, 3:]))], -1)
    omega = np.broadcast_to(np.diag(cfg["omega"]), (len(fr), 6, 6)).copy()
    empty = np.zeros(0, np.int64)
    fields = dict(
        poses2=np.zeros((0, 3)), landmarks2=np.zeros((0, 2)), poses3=gt.copy(),
        pp_from=empty, pp_to=empty, pp_z=np.zeros((0, 3)),
        pp_omega=np.zeros((0, 3, 3)), pl_pose=empty, pl_lm=empty,
        pl_z=np.zeros((0, 2)), pl_omega=np.zeros((0, 2, 2)),
        qq_from=fr.astype(np.int64), qq_to=to.astype(np.int64), qq_z=z,
        qq_omega=omega, pose2_offsets=empty, lm2_offsets=empty,
        pose3_offsets=DIM * np.arange(n))
    return dict(fields=fields, total_dof=DIM * n, prior2=-1, prior3=0,
                node_field="poses3", truth=gt)


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def guesses(cfg, struct, seed, count, device):
    """(count, poses, 7) float32 on ``device``: the ground truth retracted
    by N(0, sigma_t^2) on translation and N(0, sigma_r^2) on rotation (q
    times exp(w), the rotation noise in the body frame), pose 0 exact. One
    draw of a ``torch.Generator`` on ``device`` seeded with ``seed``; the
    retraction in f64."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    gt = torch.as_tensor(struct["truth"], dtype=torch.float64, device=device)
    noise = torch.randn((count, gt.shape[0], 6), generator=gen,
                        dtype=torch.float32, device=device).double()
    noise[:, 0] = 0.0
    dt = cfg["guess_sigma_m"] * noise[..., :3]
    dw = cfg["guess_sigma_rad"] * noise[..., 3:]
    theta = torch.linalg.vector_norm(dw, dim=-1, keepdim=True)
    half = 0.5 * theta
    k = torch.where(theta > 0, torch.sin(half) / theta.clamp(min=1e-300),
                    torch.full_like(theta, 0.5))
    dq = torch.cat([torch.cos(half), k * dw], dim=-1)
    q = _quat_mul(gt[:, 3:].expand(count, -1, -1), dq)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.cat([gt[:, :3] + dt, q], dim=-1).float()
