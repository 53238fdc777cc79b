"""Iterative Closest Point (2D and 3D) scan matching (counterpart of
``rustrobotics_tpu/mapping/icp.py``).

ICP estimates the rigid transform aligning a source cloud to a target
cloud by alternating a correspondence search and a closed-form alignment.
The search is a brute-force (N, M) squared-distance matrix (one product,
full f32: the package turns TF32 off at import); the alignment is the
Kabsch/Umeyama SVD of the (D, D) cross-covariance. The refinement is a
Python loop over iterations that reads nothing back to the host (on the
card ``torch.linalg.svd`` itself waits for its convergence check).

Beyond the JAX functions, which take one problem, ``rigid_align`` and
``icp`` take leading batch axes: src (..., N, D) against dst (M, D) or
(..., M, D), so several alignments (the yaw seeds of a loop-closure
refinement, the scan pairs of an odometry chain) run as one batch.
"""

from __future__ import annotations

import torch

from rustrobotics_tpu_torch.device import as_tensor
from rustrobotics_tpu_torch.utils.linalg import svd


def rigid_align(src, dst, weights=None):
    """Closed-form weighted rigid alignment (Kabsch/Umeyama): returns
    (R, t) minimizing sum_i w_i ||R src_i + t - dst_i||^2.

    src, dst: (..., N, D); weights: optional (..., N). A problem with a
    non-finite point (a zero weight does not hide it: 0·NaN is NaN) gets R
    and t NaN, as in JAX.
    """
    n, d = src.shape[-2:]
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-12)
    mu_s = (w[..., None, :] @ src)[..., 0, :]
    mu_d = (w[..., None, :] @ dst)[..., 0, :]
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = (dc * w[..., None]).mT @ sc  # (..., D, D)
    u, _, vt = svd(cov)
    # proper rotation: flip the last singular direction if det < 0
    det = _det(u @ vt)
    s = torch.cat([torch.ones(det.shape + (d - 1,), dtype=src.dtype,
                              device=src.device),
                   torch.sign(det)[..., None]], -1)
    r = (u * s[..., None, :]) @ vt
    t = mu_d - (r @ mu_s[..., None])[..., 0]
    return r, t


def _det(m):
    """Determinant of (..., D, D): the cofactor expansion for D <= 3
    (``torch.linalg.det`` runs an LU factorization), else
    ``torch.linalg.det``."""
    d = m.shape[-1]
    if d == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    if d == 3:
        return torch.sum(m[..., 0, :] * torch.linalg.cross(m[..., 1, :],
                                                           m[..., 2, :]), -1)
    return torch.linalg.det(m)


def _quantile(x, q):
    """``torch.quantile(x, q, dim=-1, keepdim=True)`` for a Python float q
    (linear interpolation, as ``jnp.quantile``): a sort and two gathers at
    positions known on the host."""
    n = x.shape[-1]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    v = torch.sort(x, dim=-1).values
    return torch.lerp(v[..., lo:lo + 1], v[..., hi:hi + 1], pos - lo)


def _nearest(src, dst):
    """(..., N) index of each src point's nearest dst point, and its
    squared distance. ||s - d||^2 = ||s||^2 - 2 s.d + ||d||^2: one (N, M)
    product a problem."""
    d2 = (torch.sum(src * src, -1)[..., :, None]
          - 2.0 * src @ dst.mT
          + torch.sum(dst * dst, -1)[..., None, :])
    idx = torch.argmin(d2, dim=-1)
    return idx, torch.take_along_dim(d2, idx[..., None], -1)[..., 0]


def icp(src, dst, num_iterations: int = 20, reject_quantile=None):
    """Point-to-point ICP: returns (R, t, rmse) aligning src onto dst.

    ``reject_quantile``: optionally down-weight the worst correspondences
    (outlier trimming): pairs whose squared distance exceeds the given
    quantile per iteration get zero weight (linear interpolation, as
    ``jnp.quantile``).
    """
    src = as_tensor(src)
    dst = as_tensor(dst)
    batch, d = src.shape[:-2], src.shape[-1]
    r = torch.eye(d, dtype=src.dtype, device=src.device).expand(
        batch + (d, d))
    t = torch.zeros(batch + (d,), dtype=src.dtype, device=src.device)
    dst_b = dst.expand(batch + dst.shape[-2:])
    for _ in range(num_iterations):
        cur = src @ r.mT + t[..., None, :]
        idx, d2 = _nearest(cur, dst)
        matched = torch.take_along_dim(dst_b, idx[..., None], -2)
        if reject_quantile is not None:
            cut = _quantile(d2, reject_quantile)
            w = (d2 <= cut).to(src.dtype)
        else:
            w = torch.ones_like(d2)
        # incremental alignment of the CURRENT cloud, composed into (R, t)
        dr, dt = rigid_align(cur, matched, w)
        r, t = dr @ r, (dr @ t[..., None])[..., 0] + dt
    cur = src @ r.mT + t[..., None, :]
    _, d2 = _nearest(cur, dst)
    return r, t, torch.sqrt(torch.mean(d2, -1))


# the JAX package's jitted name; the port runs the same function
icp_jit = icp


def icp_se2(src, dst, num_iterations: int = 20, reject_quantile=None):
    """2D convenience: returns the SE2 pose [x, y, theta] aligning src
    onto dst (composes with geometry.se2)."""
    r, t, rmse = icp(src, dst, num_iterations, reject_quantile)
    theta = torch.atan2(r[..., 1, 0], r[..., 0, 0])
    return torch.stack([t[..., 0], t[..., 1], theta], -1), rmse
