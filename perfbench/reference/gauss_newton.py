"""The plain reference optimizer: Gauss-Newton on a pose graph with a
dense normal-equation solve, in plain PyTorch.

It takes the graph's structure as the generator made it (numpy arrays:
edges, measurements, information, the gauge prior's pose) and a guess,
and works out everything else itself: the residuals from their
definitions, their Jacobians by forward-mode differentiation through the
retraction, the dense normal equations H dx = -b with the gauge prior
(``PRIOR_WEIGHT`` on the prior pose's diagonal), a symmetrically
Jacobi-scaled dense solve (LU with partial pivoting), and the
retraction. No ordering, band or kernel of the program is used.

Definitions (g2o's): an SE2 edge's residual is the chart of z^-1 x1^-1 x2
(translation, heading wrapped to [-pi, pi)); an SE3 edge's is
[translation of z^-1 x1^-1 x2, log of its rotation] with poses
[t, q_wxyz]. The retraction adds dt to the translation; SE2 adds dtheta to
the heading (wrapped), SE3 right-multiplies q by exp(dw). The trace holds
the chi^2 of the iterate before each step and of the last iterate.

``precision="f64"`` is the reference. The two other precisions compute in
float32 with TF32 where a float32 build of the program with TF32 matrix
products would have it. The program computes its residuals, Jacobians,
normal equations and chi^2 by elementwise multiply-adds, which TF32 does
not touch, so these stay full float32; its factorization is a chain of
matrix products, so the factorization's products take TF32 operands
(10-bit mantissa), each diagonal block or panel factored in full float32,
``BLOCK`` columns a step:

- ``"tf32"``, the control: the reference's own solve, a right-looking
  blocked LU with partial pivoting of the Jacobi-scaled H, whose
  off-diagonal and trailing-update products take TF32 operands. It needs
  no positive definiteness, so it gives a step wherever f32 does;
- ``"tf32-cholesky"``: the program's method, a right-looking blocked
  Cholesky with TF32 products in the same places. A pivot that is not
  positive gives a step of NaN, as the program's factorization would.

The triangular sweeps of both are matrix-vector work and stay float32.

This module imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRIOR_WEIGHT = 1e7
# columns a step of the control's blocked Cholesky
BLOCK = 128


def tf32(t):
    """float32 t rounded to TF32 (10 explicit mantissa bits), to nearest."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


# ------------------------------------------------------------------ SE2
#


def _matvec(m, v):
    return (m @ v[..., None])[..., 0]


def _rot2(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def _se2_residual(x1, x2, z):
    d = _matvec(_rot2(x1[..., 2]).mT, x2[..., :2] - x1[..., :2])
    t = _matvec(_rot2(z[..., 2]).mT, d - z[..., :2])
    return torch.cat([t, _wrap(x2[..., 2:] - x1[..., 2:] - z[..., 2:])], -1)


def _se2_retract(x, d):
    return torch.cat([x[..., :2] + d[..., :2], _wrap(x[..., 2:] + d[..., 2:])],
                     dim=-1)


# ------------------------------------------------------------------ SE3


def _qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def _qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _qunit(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _rot3(q):
    """The rotation matrix of a unit quaternion."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _so3_exp(w):
    th2 = (w * w).sum(-1, keepdim=True)
    th = torch.sqrt(th2 + 1e-300)
    small = th2 < 1e-12
    k = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
    c = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    return torch.cat([c, k * w], dim=-1)


def _so3_log(q):
    q = torch.where(q[..., :1] < 0, -q, q)
    w, v = q[..., :1], q[..., 1:]
    vn2 = (v * v).sum(-1, keepdim=True)
    vn = torch.sqrt(vn2 + 1e-300)
    small = vn2 < 1e-14
    k = torch.where(small, 2.0 / w.clamp(min=1e-12),
                    2.0 * torch.atan2(vn, w) / vn)
    return k * v


def _se3_residual(x1, x2, z):
    q1, qz = _qunit(x1[..., 3:]), _qunit(z[..., 3:])
    t12 = _matvec(_rot3(q1).mT, x2[..., :3] - x1[..., :3])
    t = _matvec(_rot3(qz).mT, t12 - z[..., :3])
    q = _qmul(_qconj(qz), _qmul(_qconj(q1), _qunit(x2[..., 3:])))
    return torch.cat([t, _so3_log(q)], -1)


def _se3_retract(x, d):
    q = _qunit(_qmul(x[..., 3:], _so3_exp(d[..., 3:])))
    return torch.cat([x[..., :3] + d[..., :3], q], dim=-1)


# --------------------------------------------------------------- solver


def _cholesky_tf32(a):
    """The lower Cholesky factor of the symmetric float32 a by blocks of
    ``BLOCK`` columns: each diagonal block in full float32, the panel
    below it (through the block's inverse factor, as the program's
    factorization takes it) and the trailing update as products of TF32
    operands. None when a pivot is not positive."""
    a = a.clone()
    n = a.shape[0]
    for k in range(0, n, BLOCK):
        e = min(k + BLOCK, n)
        lkk, info = torch.linalg.cholesky_ex(a[k:e, k:e])
        if int(info):
            return None
        a[k:e, k:e] = lkk
        if e == n:
            break
        inv_t = torch.linalg.inv(lkk).mT
        panel = tf32(a[e:, k:e]) @ tf32(inv_t)
        a[e:, k:e] = panel
        a[e:, e:] -= tf32(panel) @ tf32(panel).mT
    return torch.tril(a)


def _cholesky_solve_tf32(a, rhs):
    """a^-1 rhs through ``_cholesky_tf32``'s factor and two float32
    triangular sweeps; NaN where the factorization breaks down."""
    low = _cholesky_tf32(a)
    if low is None:
        return torch.full_like(rhs, math.nan)
    y = torch.linalg.solve_triangular(low, rhs[:, None], upper=False)
    return torch.linalg.solve_triangular(low.mT, y, upper=True)[:, 0]


def _lu_solve_tf32(a, rhs):
    """a^-1 rhs by a right-looking blocked LU with partial pivoting: each
    panel of ``BLOCK`` columns factored in full float32 (rows swapped
    across the whole matrix), the block row of U and the trailing update
    as products of TF32 operands; then two float32 triangular sweeps."""
    a = a.clone()
    n = a.shape[0]
    perm = torch.arange(n, device=a.device)
    for k in range(0, n, BLOCK):
        e = min(k + BLOCK, n)
        lu, piv = torch.linalg.lu_factor(a[k:, k:e])
        rows = list(range(n - k))
        for i, j in enumerate((piv - 1).tolist()):
            rows[i], rows[j] = rows[j], rows[i]
        rows = torch.as_tensor(rows, device=a.device)
        a[k:] = a[k:][rows]
        perm[k:] = perm[k:][rows]
        a[k:, k:e] = lu
        if e == n:
            break
        l11 = torch.tril(lu[:e - k], -1) + torch.eye(e - k, dtype=a.dtype,
                                                      device=a.device)
        u12 = tf32(torch.linalg.inv(l11)) @ tf32(a[k:e, e:])
        a[k:e, e:] = u12
        a[e:, e:] -= tf32(a[e:, k:e]) @ tf32(u12)
    y = torch.linalg.solve_triangular(a, rhs[perm][:, None], upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(a, y, upper=True)[:, 0]



class Problem:
    """One graph structure on a device, in one precision."""

    def __init__(self, struct, device, precision="f64"):
        if precision not in ("f64", "tf32", "tf32-cholesky"):
            raise ValueError(f"unknown precision {precision!r}")
        f = struct["fields"]
        self.se3 = struct["node_field"] == "poses3"
        self.dim = 6 if self.se3 else 3
        pre = "qq" if self.se3 else "pp"
        self.precision = precision
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        self.device = torch.device(device)
        as_t = dict(dtype=self.dtype, device=self.device)
        self.fr = torch.as_tensor(np.asarray(f[f"{pre}_from"]), device=device)
        self.to = torch.as_tensor(np.asarray(f[f"{pre}_to"]), device=device)
        self.z = torch.as_tensor(np.asarray(f[f"{pre}_z"]), **as_t)
        self.omega = torch.as_tensor(np.asarray(f[f"{pre}_omega"]), **as_t)
        self.n_nodes = len(np.asarray(f[struct["node_field"]]))
        self.n = self.dim * self.n_nodes
        prior = struct["prior3"] if self.se3 else struct["prior2"]
        self.prior_dofs = torch.arange(self.dim, device=device) \
            + self.dim * prior
        residual = _se3_residual if self.se3 else _se2_residual
        self.retract = _se3_retract if self.se3 else _se2_retract
        retract = self.retract

        def perturbed(d1, d2, x1, x2, z):
            return residual(retract(x1, d1), retract(x2, d2), z)

        self._jac = torch.func.vmap(
            torch.func.jacfwd(perturbed, argnums=(0, 1)),
            in_dims=(None, None, 0, 0, 0))
        self._residual = residual
        # dense positions of the four blocks of every edge
        d = torch.arange(self.dim, device=device)
        oi = (self.dim * self.fr)[:, None] + d
        oj = (self.dim * self.to)[:, None] + d
        self._rows = [a[:, :, None].expand(-1, -1, self.dim)
                      for a in (oi, oi, oj, oj)]
        self._cols = [a[:, None, :].expand(-1, self.dim, -1)
                      for a in (oi, oj, oi, oj)]
        self._oi, self._oj = oi, oj

    def chi2(self, poses):
        """chi^2 of poses (nodes, 3 or 7), in this problem's precision."""
        poses = torch.as_tensor(poses, device=self.device).to(self.dtype)
        e = self._residual(poses[self.fr], poses[self.to], self.z)[..., None]
        return float((e.mT @ (self.omega @ e)).sum())

    def step(self, poses):
        """(chi^2 of poses, the Gauss-Newton step dx)."""
        x1, x2 = poses[self.fr], poses[self.to]
        zero = poses.new_zeros(self.dim)
        ja, jb = (j.to(self.dtype) for j in
                  self._jac(zero, zero, x1, x2, self.z))
        e = self._residual(x1, x2, self.z)[..., None]
        om_e = self.omega @ e
        om_a, om_b = self.omega @ ja, self.omega @ jb
        blocks = (ja.mT @ om_a, ja.mT @ om_b, jb.mT @ om_a, jb.mT @ om_b)
        h = poses.new_zeros(self.n, self.n)
        for r, c, blk in zip(self._rows, self._cols, blocks):
            h.index_put_((r.reshape(-1), c.reshape(-1)), blk.reshape(-1),
                         accumulate=True)
        h[self.prior_dofs, self.prior_dofs] += PRIOR_WEIGHT
        b = poses.new_zeros(self.n)
        b.index_add_(0, self._oi.reshape(-1), (ja.mT @ om_e).reshape(-1))
        b.index_add_(0, self._oj.reshape(-1), (jb.mT @ om_e).reshape(-1))
        chi2 = float((e.mT @ om_e).sum())
        s = torch.rsqrt(torch.diagonal(h))
        a, rhs = h * s[:, None] * s[None, :], -b * s
        solve = {"f64": torch.linalg.solve, "tf32": _lu_solve_tf32,
                 "tf32-cholesky": _cholesky_solve_tf32}[self.precision]
        y = solve(a, rhs)
        return chi2, (y * s).reshape(self.n_nodes, self.dim)

    def solve(self, guess, iterations):
        """(final poses, chi^2 trace of iterations + 1 entries) from a
        guess (nodes, 3 or 7), in this problem's precision."""
        poses = torch.as_tensor(guess, device=self.device).to(self.dtype)
        trace = []
        for _ in range(iterations):
            chi2, dx = self.step(poses)
            trace.append(chi2)
            poses = self.retract(poses, dx)
        trace.append(self.chi2(poses))
        return poses, trace
