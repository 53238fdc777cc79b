"""Perspective-3-Point pose (Grunert) and batched-RANSAC PnP (counterpart
of ``rustrobotics_tpu/vision/p3p.py``).

Given three 3D points and their bearing rays, the camera pose follows
from the distances along each ray, which satisfy Grunert's quartic in the
ratio v = s3/s1. Everything is real closed-form arithmetic (trigonometric
cubic + Ferrari factorization into two quadratics), batched over leading
axes: the four candidates of a problem, and the hypotheses of a RANSAC
batch, are tensor axes. Branches that are not taken may carry NaN inside
``torch.where``, as in the JAX package; a forward pass never reads them.
A rejected candidate (mask False) may hold a different garbage pose.

``pnp_ransac`` draws its minimal samples from a ``torch.Generator``;
``_pnp_ransac`` takes the (H, 3) sample indices.
"""

from __future__ import annotations

import math

import torch

from rustrobotics_tpu_torch.mapping.icp import rigid_align


def _real_cubic_roots(b, c, d):
    """All real roots of z^3 + b z^2 + c z + d (trig/Cardano), returned as
    (..., 3) (the single-real case repeats the root)."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    shift = -b / 3.0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # three-real branch (disc <= 0): trigonometric method
    mp = torch.clamp(-p / 3.0, min=1e-18)
    acos_arg = torch.clamp(3.0 * q / (2.0 * p) * torch.rsqrt(mp), -1.0, 1.0)
    phi = torch.arccos(acos_arg) / 3.0
    amp = 2.0 * torch.sqrt(mp)
    k = torch.arange(3, dtype=b.dtype, device=b.device)
    trig = shift[..., None] + amp[..., None] * torch.cos(
        phi[..., None] - 2.0 * math.pi * k / 3.0)

    # one-real branch (disc > 0): Cardano
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u = _cbrt(-q / 2.0 + sq)
    v = _cbrt(-q / 2.0 - sq)
    single = shift + u + v

    three = disc <= 0
    return torch.where(three[..., None], trig, single[..., None].expand(
        single.shape + (3,)))


def _cbrt(x):
    """Real cube root (jnp.cbrt): sign(x) |x|^(1/3)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _quartic_roots(a4, a3, a2, a1, a0):
    """Real roots of a4 x^4 + ... + a0, as (..., 4) values + (..., 4)
    mask. Ferrari: depressed quartic -> resolvent cubic -> two
    quadratics."""
    a4 = torch.where(torch.abs(a4) < 1e-14, torch.full_like(a4, 1e-14), a4)
    b = a3 / a4
    c = a2 / a4
    d = a1 / a4
    e = a0 / a4
    p = c - 3.0 * b * b / 8.0
    q = d - b * c / 2.0 + b ** 3 / 8.0
    r = e - b * d / 4.0 + b * b * c / 16.0 - 3.0 * b ** 4 / 256.0

    # resolvent z^3 - (p/2) z^2 - r z + (4 p r - q^2)/8 = 0; pick the root
    # giving the largest s^2 = 2z - p (real factorization exists whenever
    # the quartic has real roots)
    zs = _real_cubic_roots(-p / 2.0, -r, (4.0 * p * r - q * q) / 8.0)
    s2 = 2.0 * zs - p[..., None]
    pick = torch.argmax(s2, dim=-1, keepdim=True)
    z0 = torch.take_along_dim(zs, pick, -1)[..., 0]
    s2 = torch.clamp(torch.take_along_dim(s2, pick, -1)[..., 0], min=0.0)
    s = torch.sqrt(s2)
    small = s < 1e-12
    safe_s = torch.where(small, torch.ones_like(s), s)
    root_r = torch.sqrt(torch.clamp(z0 * z0 - r, min=0.0))
    t1 = torch.where(small, z0 - root_r, z0 - q / (2.0 * safe_s))
    t2 = torch.where(small, z0 + root_r, z0 + q / (2.0 * safe_s))

    def quad(sgn, t):
        # y^2 + sgn*s y + t = 0
        disc = s2 / 4.0 - t
        ok = disc >= 0
        root = torch.sqrt(torch.clamp(disc, min=0.0))
        return (torch.stack([-sgn * s / 2.0 + root, -sgn * s / 2.0 - root],
                            -1),
                torch.stack([ok, ok], -1))

    y12, m12 = quad(1.0, t1)
    y34, m34 = quad(-1.0, t2)
    y = torch.cat([y12, y34], -1)
    mask = torch.cat([m12, m34], -1)
    return y - b[..., None] / 4.0, mask


def p3p(world_pts, bearings):
    """Grunert P3P: world_pts (..., 3, 3), bearings (..., 3, 3) unit rays
    in the camera frame. Returns (rs (..., 4, 3, 3), ts (..., 4, 3),
    mask (..., 4)): up to four pose candidates X_cam = R X_world + t."""
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    p1, p2, p3_ = (world_pts[..., 0, :], world_pts[..., 1, :],
                   world_pts[..., 2, :])
    a2 = torch.sum((p2 - p3_) ** 2, -1)
    b2 = torch.sum((p1 - p3_) ** 2, -1)
    c2 = torch.sum((p1 - p2) ** 2, -1)
    ca = torch.sum(f2 * f3, -1)   # cos alpha (opposite side a)
    cb = torch.sum(f1 * f3, -1)   # cos beta
    cg = torch.sum(f1 * f2, -1)   # cos gamma

    amc = (a2 - c2) / b2
    apc = (a2 + c2) / b2
    a4 = (amc - 1.0) ** 2 - 4.0 * c2 / b2 * ca * ca
    a3 = 4.0 * (amc * (1.0 - amc) * cb
                - (1.0 - apc) * ca * cg
                + 2.0 * c2 / b2 * ca * ca * cb)
    a2c = 2.0 * (amc * amc - 1.0
                 + 2.0 * amc * amc * cb * cb
                 + 2.0 * (b2 - c2) / b2 * ca * ca
                 - 4.0 * apc * ca * cb * cg
                 + 2.0 * (b2 - a2) / b2 * cg * cg)
    a1 = 4.0 * (-amc * (1.0 + amc) * cb
                + 2.0 * a2 / b2 * cg * cg * cb
                - (1.0 - apc) * ca * cg)
    a0 = (1.0 + amc) ** 2 - 4.0 * a2 / b2 * cg * cg

    vs, ok = _quartic_roots(a4, a3, a2c, a1, a0)       # (..., 4)

    def col(x):
        return x[..., None]

    a2, b2, c2, ca, cb, cg = map(col, (a2, b2, c2, ca, cb, cg))
    denom = 1.0 + vs * vs - 2.0 * vs * cb
    ok = ok & (denom > 1e-12)
    s1 = torch.sqrt(b2 / torch.clamp(denom, min=1e-12))
    s3 = vs * s1
    # s2 from side c: s2^2 - 2 s1 cg s2 + (s1^2 - c2) = 0
    disc = s1 * s1 * cg * cg - (s1 * s1 - c2)
    ok = ok & (disc >= 0.0)
    rootd = torch.sqrt(torch.clamp(disc, min=0.0))
    cands = torch.stack([s1 * cg + rootd, s1 * cg - rootd], -1)
    # disambiguate with side a: s2^2 + s3^2 - 2 s2 s3 ca = a2
    s3c, cac, a2c_ = s3[..., None], ca[..., None], a2[..., None]
    resid = torch.abs(cands ** 2 + s3c * s3c - 2.0 * cands * s3c * cac
                      - a2c_)
    pick = torch.argmin(resid, dim=-1, keepdim=True)
    s2 = torch.take_along_dim(cands, pick, -1)[..., 0]
    ok = ok & (torch.amin(resid, -1) < 1e-4 * a2 + 1e-9)
    ok = ok & (s1 > 0) & (s2 > 0) & (s3 > 0)
    cam_pts = torch.stack([s1[..., None] * f1[..., None, :],
                           s2[..., None] * f2[..., None, :],
                           s3[..., None] * f3[..., None, :]], -2)
    # a non-finite distance fails its ok test above; zero it, since
    # torch.linalg.svd raises on NaN where jnp.linalg.svd returns NaN (the
    # pose of such a rejected candidate is garbage in either package)
    cam_pts = torch.where(torch.isfinite(cam_pts), cam_pts,
                          torch.zeros_like(cam_pts))
    world = world_pts[..., None, :, :].expand(cam_pts.shape)
    rs, ts = rigid_align(world, cam_pts)
    return rs, ts, ok


def p3p_best(world_pts, bearings, extra_pt, extra_bearing):
    """Disambiguate the P3P candidates with a 4th correspondence: pick the
    pose minimizing the angular error of the extra ray. Returns (R, t)."""
    rs, ts, oks = p3p(world_pts, bearings)
    pc = rs @ extra_pt + ts
    pc = pc / torch.clamp(torch.linalg.norm(pc, dim=-1, keepdim=True),
                          min=1e-12)
    err = 1.0 - pc @ extra_bearing
    errs = torch.where(oks, err, torch.full_like(err, torch.inf))
    best = torch.argmin(errs)
    return rs[best], ts[best]


def pnp_ransac(world_pts, bearings, generator, num_hypotheses: int = 256,
               inlier_cos: float = 0.9998):
    """Robust PnP: batched RANSAC over P3P minimal samples.

    A FIXED batch of ``num_hypotheses`` random 3-point samples (drawn
    from ``generator``), each solved by closed-form P3P, every candidate
    pose scored against ALL points in one einsum; the best pose by inlier
    count (angular gate ``inlier_cos``) is refined by an SVD alignment on
    its inliers.

    world_pts (N, 3), bearings (N, 3) unit camera-frame rays.
    Returns (R, t, inlier_mask (N,)).
    """
    n = world_pts.shape[0]
    # random distinct-ish triples (collisions merely waste a hypothesis)
    idx = torch.randint(0, n, (num_hypotheses, 3), generator=generator,
                        device=world_pts.device)
    return _pnp_ransac(world_pts, bearings, idx, inlier_cos)


def _pnp_ransac(world_pts, bearings, idx, inlier_cos: float = 0.9998):
    """``pnp_ransac`` on drawn sample indices ``idx`` (H, 3)."""
    idx = idx.to(world_pts.device)
    rs, ts, oks = p3p(world_pts[idx], bearings[idx])   # (H, 4, ...)
    pc = torch.einsum("hcij,nj->hcni", rs, world_pts) + ts[:, :, None, :]
    pc = pc / torch.clamp(torch.linalg.norm(pc, dim=-1, keepdim=True),
                          min=1e-12)
    agree = torch.einsum("hcni,ni->hcn", pc, bearings)
    inl = (agree > inlier_cos) & (pc[..., 2] > 0)               # (H, 4, N)
    counts = torch.where(oks, torch.sum(inl, dim=-1),
                         torch.full_like(oks, -1, dtype=torch.int64))
    best_c = torch.argmax(counts, dim=1)                         # (H,)
    h_rows = torch.arange(idx.shape[0], device=idx.device)
    counts_h = counts[h_rows, best_c]
    best = torch.argmax(counts_h)
    r, t = rs[best, best_c[best]], ts[best, best_c[best]]
    inl = inl[best, best_c[best]]

    # refinement: weighted absolute orientation on the inliers, using
    # each inlier's depth along its measured ray as the camera point
    depth = torch.einsum("ni,ni->n", world_pts @ r.T + t, bearings)
    cam_pts = bearings * depth[:, None]
    r2, t2 = rigid_align(world_pts, cam_pts, inl.to(world_pts.dtype))
    return r2, t2, inl
