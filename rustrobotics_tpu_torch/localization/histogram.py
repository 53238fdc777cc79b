"""Histogram (discrete Bayes / grid) filter for 2D localization
(counterpart of ``rustrobotics_tpu/localization/histogram.py``).

The belief is a dense (Gx, Gy, Gtheta) probability grid. The motion update
shifts each theta slab by the velocity model with a bilinear gather
(``_bilinear``: ``jax.scipy.ndimage.map_coordinates`` at order 1 with
``mode="constant"``, cval 0: each of the four corners outside the grid
counts 0, and the terms add in its order), rolls theta by the heading
change with a gather on a device index (no host read), then blurs with a
small separable Gaussian; the measurement update multiplies a pointwise
likelihood over all cells against the landmark map.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rustrobotics_tpu_torch.device import as_tensor, tensor_fields
from rustrobotics_tpu_torch.utils.angles import wrap_angle
from rustrobotics_tpu_torch.utils.state import select


@dataclasses.dataclass
class GridBelief:
    """belief: (Gx, Gy, Gt), sums to 1. Cell centers:
    x = x0 + (i + 0.5) dx, theta spans [-pi, pi) circularly."""

    belief: torch.Tensor
    x0: float
    y0: float
    dx: float
    dy: float

    def __post_init__(self):
        tensor_fields(self, "belief")

    @property
    def shape(self):
        return self.belief.shape

    def replace(self, **changes) -> "GridBelief":
        return dataclasses.replace(self, **changes)

    def centers(self):
        gx, gy, gt = self.belief.shape
        kw = dict(dtype=self.belief.dtype, device=self.belief.device)
        xs = self.x0 + (torch.arange(gx, **kw) + 0.5) * self.dx
        ys = self.y0 + (torch.arange(gy, **kw) + 0.5) * self.dy
        ts = -math.pi + (torch.arange(gt, **kw) + 0.5) * (2 * math.pi / gt)
        return xs, ys, ts

    def estimate(self):
        """Mean position + circular-mean heading of the belief."""
        xs, ys, ts = self.centers()
        b = self.belief
        px = torch.einsum("xyt,x->", b, xs)
        py = torch.einsum("xyt,y->", b, ys)
        ct = torch.einsum("xyt,t->", b, torch.cos(ts))
        st = torch.einsum("xyt,t->", b, torch.sin(ts))
        return torch.stack([px, py, torch.atan2(st, ct)])


def _bilinear(b, cx, cy):
    """Each theta slab of b (Gx, Gy, Gt) sampled at (cx, cy), broadcast
    to (Gx, Gy, Gt): order-1 map_coordinates with zeros outside."""
    gx, gy, gt = b.shape
    t = torch.arange(gt, device=b.device)

    def nodes(c, size):
        lower = torch.floor(c)
        upper_w = c - lower
        idx = lower.long()
        return [(i, (i >= 0) & (i < size), w)
                for i, w in ((idx, 1 - upper_w), (idx + 1, upper_w))]

    out = None
    for ix, vx, wx in nodes(cx, gx):
        for iy, vy, wy in nodes(cy, gy):
            val = b[ix.clamp(0, gx - 1), iy.clamp(0, gy - 1), t]
            term = wx * wy * torch.where(vx & vy, val, torch.zeros_like(val))
            out = term if out is None else out + term
    return out


def _shift_zero(b, o, axis):
    """Roll with zero fill (non-circular axis shift)."""
    rolled = torch.roll(b, o, dims=axis)
    n = b.shape[axis]
    idx = torch.arange(n, device=b.device)
    valid = (idx >= o) & (idx < n + o)
    shape = [1] * b.ndim
    shape[axis] = n
    return rolled * valid.reshape(shape)


@dataclasses.dataclass
class HistogramFilter:
    """Velocity-model grid filter against a known landmark map.

    motion_sigma: (3,) std of the per-step pose diffusion in grid units
    of (x, y, theta) after the deterministic shift; q: (2, 2)
    range-bearing measurement noise.
    """

    landmarks: torch.Tensor  # (L, 2)
    q: torch.Tensor          # (2, 2)
    motion_sigma: torch.Tensor  # (3,)

    def __post_init__(self):
        tensor_fields(self, "landmarks", "q", "motion_sigma")

    @classmethod
    def create(cls, landmarks, q, motion_sigma=(0.15, 0.15, 0.1),
               device=None, dtype=None):
        landmarks = as_tensor(landmarks, device, dtype)
        return cls(
            landmarks=landmarks,
            q=as_tensor(q, landmarks.device, dtype),
            motion_sigma=as_tensor(motion_sigma, landmarks.device, dtype),
        )

    def init_uniform(self, shape, x0, y0, dx, dy) -> GridBelief:
        b = torch.full(shape, 1.0 / (shape[0] * shape[1] * shape[2]),
                       dtype=self.q.dtype, device=self.q.device)
        return GridBelief(belief=b, x0=x0, y0=y0, dx=dx, dy=dy)

    def init_at(self, shape, x0, y0, dx, dy, pose) -> GridBelief:
        g = self.init_uniform(shape, x0, y0, dx, dy)
        pose = as_tensor(pose, self.q.device, self.q.dtype)
        xs, ys, ts = g.centers()
        d2 = (
            ((xs[:, None, None] - pose[0]) / (2 * dx)) ** 2
            + ((ys[None, :, None] - pose[1]) / (2 * dy)) ** 2
            + (wrap_angle(ts[None, None, :] - pose[2]) / 0.3) ** 2
        )
        b = torch.exp(-0.5 * d2)
        return g.replace(belief=b / torch.sum(b))

    # ------------------------------------------------------------ motion

    def predict(self, g: GridBelief, u, dt) -> GridBelief:
        """Deterministic per-theta shift by the velocity model + separable
        Gaussian diffusion (process noise)."""
        gx, gy, gt = g.belief.shape
        _, _, ts = g.centers()
        v, w = u[0], u[1]
        dth = w * dt

        # cell (i, j) of the new belief pulls from (i - sx/dx, j - sy/dy)
        # of the old, per theta bin
        kw = dict(dtype=g.belief.dtype, device=g.belief.device)
        ii = torch.arange(gx, **kw)
        jj = torch.arange(gy, **kw)
        sx = v * dt * torch.cos(ts) / g.dx
        sy = v * dt * torch.sin(ts) / g.dy
        shifted = _bilinear(g.belief, ii[:, None, None] - sx,
                            jj[None, :, None] - sy)

        # theta advance: circular continuous roll by dth (linear interp
        # between the two neighboring integer rolls), rolled by gathers
        step = dth / (2 * math.pi / gt)
        lo = torch.floor(step)
        frac = step - lo
        src = torch.arange(gt, device=g.belief.device) - lo.long()
        rolled = (1 - frac) * shifted[:, :, torch.remainder(src, gt)] \
            + frac * shifted[:, :, torch.remainder(src - 1, gt)]

        # separable diffusion; theta axis wraps
        def gauss_kernel(sigma, delta):
            x = torch.arange(-3, 4, **kw)
            k = torch.exp(-0.5 * (x * delta / torch.clamp(sigma, min=1e-6))
                          ** 2)
            return k / torch.sum(k)

        kx = gauss_kernel(self.motion_sigma[0], g.dx)
        ky = gauss_kernel(self.motion_sigma[1], g.dy)
        kt = gauss_kernel(self.motion_sigma[2], 2 * math.pi / gt)

        def conv_axis(b, k, axis, circular):
            r = (len(k) - 1) // 2
            out = torch.zeros_like(b)
            for o in range(-r, r + 1):
                if circular:
                    out = out + k[o + r] * torch.roll(b, -o, dims=axis)
                else:
                    out = out + k[o + r] * _shift_zero(b, -o, axis)
            return out

        b = conv_axis(rolled, kx, 0, False)
        b = conv_axis(b, ky, 1, False)
        b = conv_axis(b, kt, 2, True)
        b = b / torch.clamp(torch.sum(b), min=1e-30)
        return g.replace(belief=b)

    # ------------------------------------------------------- measurement

    def update(self, g: GridBelief, lm_idx, z, mask) -> GridBelief:
        """Multiply by the likelihood of a masked block of range-bearing
        measurements (lm_idx (M,), z (M, 2), mask (M,)) over every cell."""
        xs, ys, ts = g.centers()
        q_inv = torch.linalg.inv_ex(self.q).inverse
        lms = self.landmarks[lm_idx]  # (M, 2)
        dxl = lms[:, 0][:, None, None] - xs[None, :, None]   # (M, Gx, 1)
        dyl = lms[:, 1][:, None, None] - ys[None, None, :]   # (M, 1, Gy)
        rng = torch.sqrt(torch.clamp(dxl**2 + dyl**2, min=1e-12))
        bear = torch.atan2(dyl, dxl)                          # (M, Gx, Gy)
        dr = z[:, 0][:, None, None] - rng                     # (M, Gx, Gy)
        db = wrap_angle(
            z[:, 1][:, None, None, None] - bear[..., None]
            + ts[None, None, None, :]
        )  # (M, Gx, Gy, Gt): the bearing depends on the heading
        loglik = -0.5 * (
            q_inv[0, 0] * (dr[..., None] ** 2)
            + q_inv[1, 1] * db**2
            + 2 * q_inv[0, 1] * dr[..., None] * db
        )
        loglik = torch.einsum("mxyt,m->xyt", loglik, mask.to(loglik.dtype))
        b = g.belief * torch.exp(loglik - torch.max(loglik))
        return g.replace(belief=b / torch.clamp(torch.sum(b), min=1e-30))

    def step(self, g: GridBelief, u, has_control, lm_idx, z, mask,
             dt) -> GridBelief:
        g = select(has_control, self.predict(g, u, dt), g)
        return self.update(g, lm_idx, z, mask)
