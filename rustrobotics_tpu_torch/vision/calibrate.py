"""Camera calibration: DLT and Zhang's method (counterpart of
``rustrobotics_tpu/vision/calibrate.py``).

Every solver is a normalized homogeneous linear system closed by an SVD;
Zhang's homographies are one batch over the views. The radial-distortion
stage is one linear least-squares solve. A non-finite input gives NaN
where JAX's gives it (``utils.linalg``).
"""

from __future__ import annotations

import math

import torch

from rustrobotics_tpu_torch.utils.linalg import lstsq, svd
from rustrobotics_tpu_torch.vision.cameras import decompose_projection


def _normalize_2d(x):
    """Hartley normalization: zero-mean, sqrt(2) RMS. Returns (xn, T);
    leading batch axes allowed."""
    mu = torch.mean(x, dim=-2)
    d = torch.sqrt(torch.mean(torch.sum((x - mu[..., None, :]) ** 2, -1),
                              -1))
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-12)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    t = torch.stack([
        torch.stack([s, zero, -s * mu[..., 0]], -1),
        torch.stack([zero, s, -s * mu[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return (x - mu[..., None, :]) * s[..., None, None], t


def _normalize_3d(x):
    mu = torch.mean(x, dim=0)
    d = torch.sqrt(torch.mean(torch.sum((x - mu) ** 2, -1)))
    s = math.sqrt(3.0) / torch.clamp(d, min=1e-12)
    u = torch.eye(4, dtype=x.dtype, device=x.device) * s
    u[3, 3] = 1.0
    u[:3, 3] = -s * mu
    return (x - mu) * s, u


def _null_vector(a):
    """The right singular vector of the smallest singular value (the last
    row of Vᴴ), batched."""
    return svd(a, full_matrices=True)[2][..., -1, :]


def dlt_camera(points3d, points2d):
    """Direct Linear Transform: (3, 4) projection matrix from >= 6 2D-3D
    correspondences, plus its (K, R, t) decomposition. Normalized DLT
    (Hartley) for conditioning."""
    x2, t2 = _normalize_2d(points2d)
    x3, t3 = _normalize_3d(points3d)
    n = points3d.shape[0]
    xh = torch.cat([x3, torch.ones((n, 1), dtype=x3.dtype,
                                   device=x3.device)], -1)  # (N, 4)
    zero = torch.zeros_like(xh)
    rows_u = torch.cat([xh, zero, -x2[:, 0:1] * xh], dim=1)  # (N, 12)
    rows_v = torch.cat([zero, xh, -x2[:, 1:2] * xh], dim=1)
    a = torch.cat([rows_u, rows_v], dim=0)  # (2N, 12)
    p_n = _null_vector(a).reshape(3, 4)
    # denormalize: x2 = T2 x  =>  P = T2^-1 P_n T3
    p = torch.linalg.solve_ex(t2, p_n).result @ t3
    k, r, t = decompose_projection(p)
    return p / p[2, 3], (k, r, t)


def homography(src, dst):
    """(3, 3) homography mapping src (..., N, 2) -> dst (..., N, 2),
    normalized DLT, N >= 4; leading batch axes allowed."""
    xs, ts = _normalize_2d(src)
    xd, td = _normalize_2d(dst)
    xs = xs.expand(xd.shape)
    ts = ts.expand(td.shape)
    xh = torch.cat([xs, torch.ones(xs.shape[:-1] + (1,), dtype=xs.dtype,
                                   device=xs.device)], -1)
    zero = torch.zeros_like(xh)
    rows_u = torch.cat([xh, zero, -xd[..., 0:1] * xh], -1)
    rows_v = torch.cat([zero, xh, -xd[..., 1:2] * xh], -1)
    a = torch.cat([rows_u, rows_v], -2)
    h_n = _null_vector(a).reshape(a.shape[:-2] + (3, 3))
    h = torch.linalg.solve_ex(td, h_n).result @ ts
    return h / h[..., 2:3, 2:3]


def _vij(h, i, j):
    """Zhang's absolute-conic constraint row from homography columns;
    h (..., 3, 3) -> (..., 6)."""
    return torch.stack([
        h[..., 0, i] * h[..., 0, j],
        h[..., 0, i] * h[..., 1, j] + h[..., 1, i] * h[..., 0, j],
        h[..., 1, i] * h[..., 1, j],
        h[..., 2, i] * h[..., 0, j] + h[..., 0, i] * h[..., 2, j],
        h[..., 2, i] * h[..., 1, j] + h[..., 1, i] * h[..., 2, j],
        h[..., 2, i] * h[..., 2, j],
    ], -1)


def zhang_calibrate(object_points, image_points):
    """Zhang's method: intrinsics K (+ per-view extrinsics) from >= 3
    views of a PLANAR target.

    object_points (N, 2): target-plane coordinates (z = 0);
    image_points (V, N, 2): their pixels in each view.
    Returns (K, rs (V, 3, 3), ts (V, 3), hs (V, 3, 3)).
    """
    hs = homography(object_points, image_points)           # (V, 3, 3)
    v = torch.cat([_vij(hs, 0, 1), _vij(hs, 0, 0) - _vij(hs, 1, 1)],
                  dim=0)  # (2V, 6)
    b11, b12, b22, b13, b23, b33 = _null_vector(v)

    # closed-form intrinsics from B = K^-T K^-1 (Zhang eq. in appendix)
    v0 = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + v0 * (b12 * b13 - b11 * b23)) / b11
    alpha = torch.sqrt(torch.clamp(lam / b11, min=1e-12))
    beta = torch.sqrt(torch.clamp(lam * b11 / (b11 * b22 - b12 * b12),
                                  min=1e-12))
    gamma = -b12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - b13 * alpha * alpha / lam
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    k = torch.stack([torch.stack([alpha, gamma, u0]),
                     torch.stack([zero, beta, v0]),
                     torch.stack([zero, zero, one])])

    # extrinsics per view: [r1 r2 t] = lam K^-1 H
    kin_h = torch.linalg.solve_ex(k, hs).result                  # (V, 3, 3)
    s = 1.0 / torch.clamp(torch.linalg.norm(kin_h[:, :, 0], dim=-1),
                          min=1e-12)
    # the homography sign is arbitrary: pick the one that puts the target
    # in front of the camera (t_z > 0)
    s = (s * torch.sign(kin_h[:, 2, 2]))[:, None]
    r1 = kin_h[:, :, 0] * s
    r2 = kin_h[:, :, 1] * s
    ts = kin_h[:, :, 2] * s
    r3 = torch.linalg.cross(r1, r2)
    r_approx = torch.stack([r1, r2, r3], dim=-1)
    # project onto SO(3)
    u, _, vt = svd(r_approx)
    return k, u @ vt, ts, hs


def estimate_radial_distortion(k, rs, ts, object_points, image_points):
    """Zhang's second stage: (k1, k2) radial distortion by linear least
    squares, given the closed-form intrinsics/extrinsics.

    The distorted pixel obeys u_d = u + (u - u0)(k1 r^2 + k2 r^4) with r^2
    the squared NORMALIZED radius of the ideal projection: linear in
    (k1, k2), so all views' constraints stack into one (2VN, 2) solve.
    """
    u0, v0 = k[0, 2], k[1, 2]
    obj3 = torch.cat([object_points,
                      torch.zeros(object_points.shape[:-1] + (1,),
                                  dtype=object_points.dtype,
                                  device=object_points.device)], -1)
    cam = obj3 @ rs.mT + ts[:, None, :]                     # (V, N, 3)
    xn = cam[..., 0] / cam[..., 2]
    yn = cam[..., 1] / cam[..., 2]
    r2 = xn * xn + yn * yn
    uvw = torch.einsum("ij,vjn->vni", k,
                       torch.stack([xn, yn, torch.ones_like(xn)], 1))
    u = uvw[..., 0] / uvw[..., 2]
    v = uvw[..., 1] / uvw[..., 2]
    a = torch.cat([
        torch.stack([(u - u0) * r2, (u - u0) * r2 * r2], -1),
        torch.stack([(v - v0) * r2, (v - v0) * r2 * r2], -1),
    ], dim=1).reshape(-1, 2)
    b = torch.cat([image_points[..., 0] - u, image_points[..., 1] - v],
                  dim=1).reshape(-1)
    # The JAX package's lstsq is SVD based; on the card torch.linalg.lstsq
    # solves by QR ("gels") only, which assumes full column rank. This
    # system is tall ((2VN, 2)) and of full rank for any target off the
    # optical axis, so QR reaches the same least-squares solution.
    return lstsq(a, b[:, None])[:, 0]  # (k1, k2)


def distort_points(k, k1, k2, uv):
    """Apply the radial model to ideal pixels uv (N, 2)."""
    u0 = torch.stack([k[0, 2], k[1, 2]])
    # normalized radius of the ideal point
    xy1 = torch.cat([uv, torch.ones(uv.shape[:-1] + (1,), dtype=uv.dtype,
                                    device=uv.device)], -1)
    xn = torch.linalg.solve_ex(k, xy1.T).result.T
    r2 = torch.sum(xn[:, :2] ** 2, -1, keepdim=True)
    return uv + (uv - u0) * (k1 * r2 + k2 * r2 * r2)
