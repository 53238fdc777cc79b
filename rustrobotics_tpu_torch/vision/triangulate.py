"""Linear (DLT) triangulation (counterpart of
``rustrobotics_tpu/vision/triangulate.py``).

Each observation (P_i, x_i) contributes two homogeneous constraints on the
3D point X: x u_i p3_i - p1_i and y v_i p3_i - p2_i. Stacking all views
gives A X_h = 0, solved by the smallest right singular vector; a cloud of
N points is one batched SVD of (N, 2V, 4) systems. That vector's sign is
arbitrary, and ``xh[:3] / xh[3]`` cancels it. A point whose system holds
a NaN (one pixel, in any view: the mask multiplies and 0·NaN is NaN, as
in JAX) comes out NaN and the rest of the cloud as without it.
"""

from __future__ import annotations

import torch

from rustrobotics_tpu_torch.utils.linalg import svd


def _triangulate_one(ps, obs, mask):
    """ps (V, 3, 4) cameras, obs (..., V, 2) pixels, mask (..., V) valid
    views (leading batch axes allowed). Returns (..., 3)."""
    a = torch.cat([
        obs[..., 0:1] * ps[:, 2] - ps[:, 0],
        obs[..., 1:2] * ps[:, 2] - ps[:, 1],
    ], dim=-2)  # (..., 2V, 4)
    w = mask.to(a.dtype).repeat_interleave(2, dim=-1)
    a = a * w[..., None]
    _, _, vt = svd(a, full_matrices=True)
    xh = vt[..., -1, :]
    return xh[..., :3] / xh[..., 3:4]


def triangulate(ps, obs, mask=None):
    """Batched DLT triangulation.

    ps (V, 3, 4): projection matrices; obs (N, V, 2): pixel observations
    of N points in V views; mask (N, V) optional visibility.
    Returns (N, 3) world points.
    """
    n, v = obs.shape[:2]
    if mask is None:
        mask = torch.ones((n, v), dtype=torch.bool, device=obs.device)
    return _triangulate_one(ps, obs, mask)


def triangulate_pair(p1, p2, x1, x2):
    """Two-view convenience: x1, x2 (N, 2) -> (N, 3)."""
    ps = torch.stack([p1, p2])
    obs = torch.stack([x1, x2], dim=1)
    return triangulate(ps, obs)
