"""SE(3) poses as (..., 7) tensors ``[tx, ty, tz, qw, qx, qy, qz]``
(counterpart of ``rustrobotics_tpu/geometry/se3.py``).

Quaternion algebra, the SO(3) exp/log maps and the right-perturbation
retraction of the pose-graph optimizer. Every function works on trailing
dims and broadcasts over leading ones, and is written out of place (no
indexed assignment) so that ``torch.func.vmap`` and ``jacfwd`` trace it.
The guards at the identity (``+ 1e-32`` under the square roots, the
small-angle series) are ``torch.where`` selects, which keep forward-mode
derivatives finite where a residual rotation is the identity.
"""

from __future__ import annotations

import torch


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(a, b):
    """Hamilton product for (..., 4) wxyz quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def quat_to_mat(q):
    """(..., 4) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
                        dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
                        dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
                        dim=-1),
        ],
        dim=-2,
    )


def so3_exp(omega):
    """Rotation vector (..., 3) -> quaternion (..., 4), safe at 0."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-32)
    half = 0.5 * theta
    # sin(t/2)/t with a series fallback near 0
    small = theta2 < 1e-12
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * omega], dim=-1)


def so3_log(q):
    """Quaternion (..., 4) -> rotation vector (..., 3), safe at identity."""
    q = torch.where(q[..., :1] < 0, -q, q)  # take the w >= 0 cover
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(vn2 + 1e-32)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn2 < 1e-14
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), angle / vn)
    return k * v


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    zero = torch.zeros_like(v[..., 0])
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def compose(a, b):
    """a ∘ b for (..., 7) poses."""
    t = a[..., :3] + quat_rotate(a[..., 3:], b[..., :3])
    q = quat_normalize(quat_mul(a[..., 3:], b[..., 3:]))
    return torch.cat([t, q], dim=-1)


def inverse(a):
    qc = quat_conj(a[..., 3:])
    t = -quat_rotate(qc, a[..., :3])
    return torch.cat([t, qc], dim=-1)


def relative(a, b):
    """a^{-1} ∘ b."""
    return compose(inverse(a), b)


def retract(pose, delta):
    """Boxplus: t += dt (global), q <- q ∘ exp(domega) (right/local
    rotation perturbation). delta: (..., 6) = [dt, domega]."""
    t = pose[..., :3] + delta[..., :3]
    q = quat_normalize(quat_mul(pose[..., 3:], so3_exp(delta[..., 3:])))
    return torch.cat([t, q], dim=-1)


def log(pose):
    """Pose -> (..., 6) chart [t, so3_log(q)] (translation left as-is)."""
    return torch.cat([pose[..., :3], so3_log(pose[..., 3:])], dim=-1)


def identity(shape=(), dtype=torch.float32, device=None):
    lead = tuple(shape)
    zeros = torch.zeros(lead + (3,), dtype=dtype, device=device)
    ones = torch.ones(lead + (1,), dtype=dtype, device=device)
    return torch.cat([zeros, ones, zeros], dim=-1)


def transform(pose, points):
    """Apply a (..., 7) pose to (..., 3) points: R(q) p + t."""
    return pose[..., :3] + quat_rotate(pose[..., 3:], points)
