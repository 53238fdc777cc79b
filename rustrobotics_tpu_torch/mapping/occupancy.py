"""Occupancy-grid mapping (log-odds) from range scans at known poses
(counterpart of ``rustrobotics_tpu/mapping/occupancy.py``).

Every beam is sampled at a fixed number of points along its ray, so the
shapes are static: (B, S) sample positions. All samples of all beams turn
into cell indices in one vectorized step, and their log-odds (a miss along
the ray, a hit at the endpoint) land in the grid through two scatter-adds
on the flattened grid (``index_put_`` with ``accumulate=True``: atomic
adds on the card, whose order only rounds the sum), then one clamp. A
trajectory is a Python loop of scans with no host read.

Cells touched by several beams accumulate additively, which is exactly
the log-odds independence assumption.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rustrobotics_tpu_torch.device import as_tensor, resolve_device

LOG_ODDS_HIT = 0.85     # log odds of occupied given a hit (~p=0.7)
LOG_ODDS_MISS = -0.4    # log odds given pass-through (~p=0.4)
LOG_ODDS_CLAMP = 10.0   # saturation


@dataclasses.dataclass
class OccupancyGrid:
    """log_odds: (H, W); world frame x = origin[0] + col * resolution."""

    log_odds: torch.Tensor
    origin: torch.Tensor     # (2,) world coords of cell (0, 0) corner
    resolution: float

    @classmethod
    def create(cls, height, width, resolution, origin=(0.0, 0.0),
               dtype=torch.float32, device=None):
        device = resolve_device(device)
        return cls(
            log_odds=torch.zeros((height, width), dtype=dtype, device=device),
            origin=torch.as_tensor(np.asarray(origin), dtype=dtype,
                                   device=device),
            resolution=resolution,
        )

    @property
    def probability(self):
        return torch.sigmoid(self.log_odds)

    def world_to_cell(self, xy):
        """(..., 2) world -> (row, col) float indices."""
        rc = (xy - self.origin) / self.resolution
        return rc[..., 1], rc[..., 0]

    def replace(self, **updates) -> "OccupancyGrid":
        return dataclasses.replace(self, **updates)


def grid_from_numpy(log_odds, origin, resolution, device=None,
                    dtype=None) -> OccupancyGrid:
    """An ``OccupancyGrid`` from the JAX package's grid carried across as
    numpy (its ``log_odds``, ``origin`` and ``resolution``)."""
    return OccupancyGrid(log_odds=as_tensor(log_odds, device, dtype),
                         origin=as_tensor(origin, device, dtype),
                         resolution=float(resolution))


def integrate_scan(grid: OccupancyGrid, pose, ranges, angles,
                   max_range: float, samples_per_beam: int = 64):
    """Fuse one range scan taken at ``pose`` [x, y, theta].

    ranges (B,): measured distances (>= max_range or non-finite = no
    return: the ray is free along its whole length, no hit endpoint).
    angles (B,): beam bearings in the robot frame.
    """
    h, w = grid.log_odds.shape
    dtype, device = grid.log_odds.dtype, grid.log_odds.device
    r = torch.where(torch.isfinite(ranges), ranges,
                    torch.full_like(ranges, max_range))
    no_hit = r >= max_range
    r = torch.clamp(r, 0.0, max_range)
    heading = pose[2] + angles
    direction = torch.stack([torch.cos(heading), torch.sin(heading)], -1)

    # free-space samples strictly inside the beam, one hit at the end
    frac = (torch.arange(samples_per_beam, dtype=dtype, device=device)
            + 0.5) / samples_per_beam
    dist = r[:, None] * frac[None, :]                         # (B, S)
    pts = pose[:2] + direction[:, None, :] * dist[..., None]  # (B, S, 2)
    hit_pts = pose[:2] + direction * r[:, None]               # (B, 2)

    def to_cells(xy):
        rc = (xy - grid.origin) / grid.resolution
        col = torch.floor(rc[..., 0]).to(torch.int64)
        row = torch.floor(rc[..., 1]).to(torch.int64)
        ok = (row >= 0) & (row < h) & (col >= 0) & (col < w)
        return torch.clamp(row, 0, h - 1), torch.clamp(col, 0, w - 1), ok

    fr, fc, f_ok = to_cells(pts)
    hr, hc, h_ok = to_cells(hit_pts)
    # samples in the hit cell must not erase the hit: drop free samples
    # that land on the beam's endpoint cell
    same = (fr == hr[:, None]) & (fc == hc[:, None])
    f_ok = f_ok & ~same
    # dedup consecutive samples that fall in the same cell, so a beam
    # contributes at most one miss per traversed cell regardless of the
    # sample density (log-odds evidence must not scale with S)
    dup = torch.zeros_like(f_ok)
    dup[:, 1:] = (fr[:, 1:] == fr[:, :-1]) & (fc[:, 1:] == fc[:, :-1])
    f_ok = f_ok & ~dup
    h_ok = h_ok & ~no_hit

    # the mask times the constant, in the grid's dtype (a where of two
    # Python floats would round them to the default f32 first)
    miss = f_ok.to(dtype) * LOG_ODDS_MISS
    hit = h_ok.to(dtype) * LOG_ODDS_HIT
    lo = grid.log_odds.flatten().clone()
    lo.index_put_(((fr * w + fc).flatten(),), miss.flatten(),
                  accumulate=True)
    lo.index_put_((hr * w + hc,), hit, accumulate=True)
    lo = torch.clamp(lo, -LOG_ODDS_CLAMP, LOG_ODDS_CLAMP)
    return grid.replace(log_odds=lo.view(h, w))


def integrate_trajectory(grid: OccupancyGrid, poses, ranges, angles,
                         max_range: float, samples_per_beam: int = 64):
    """Fuse a whole trajectory: poses (T, 3), ranges (T, B), shared beam
    angles (B,); a Python loop over scans, no host read."""
    for pose, rng in zip(poses, ranges):
        grid = integrate_scan(grid, pose, rng, angles, max_range,
                              samples_per_beam)
    return grid


# the JAX package's jitted name; the port runs the same function
integrate_trajectory_jit = integrate_trajectory
