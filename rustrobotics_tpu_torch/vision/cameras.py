"""Pinhole camera model helpers in homogeneous geometry (counterpart of
``rustrobotics_tpu/vision/cameras.py``)."""

from __future__ import annotations

import torch


def projection_matrix(k, r, t):
    """P = K [R | t], (3, 4)."""
    return k @ torch.cat([r, t[:, None]], dim=1)


def project(p, points):
    """Project (N, 3) world points through (3, 4) P -> (N, 2) pixels."""
    ph = torch.cat([points, torch.ones(points.shape[:-1] + (1,),
                                       dtype=points.dtype,
                                       device=points.device)], -1)
    uvw = ph @ p.T
    return uvw[..., :2] / uvw[..., 2:3]


def decompose_projection(p):
    """P -> (K, R, t) with K upper-triangular (positive diagonal) and R a
    proper rotation: the RQ decomposition, built from QR on the flipped
    matrix."""
    m = p[:, :3]
    # RQ(M): reverse rows/cols, QR, reverse back
    rev = torch.flip(torch.eye(3, dtype=p.dtype, device=p.device), [0])
    q_, r_ = torch.linalg.qr((rev @ m).T)
    k = rev @ r_.T @ rev
    r = rev @ q_.T
    # fix signs: K = K̂ D (column scale), R = D R̂, D = diag(sign(diag K̂))
    s = torch.sign(torch.diagonal(k))
    s = torch.where(s == 0, torch.ones_like(s), s)
    k = k * s[None, :]
    r = s[:, None] * r
    # improper R means P carried a negative overall scale: flip P
    det = torch.linalg.det(r)
    r = r * det
    t = torch.linalg.solve_ex(k, p[:, 3] * det).result
    scale = k[2, 2]
    return k / scale, r, t
