"""A 2D pose graph at a published pose and edge count: a corridor
trajectory, its odometry chain, and loop closures drawn without repetition
among the pose pairs that lie within a span of each other.

The ground truth follows the port's corridor generator: pose i at arc
length s = step * i, x = s, y = 2 sin(0.05 s), heading 0.1 cos(0.05 s).
Edge k of the chain goes from pose k to pose k + 1; a closure goes from
pose i to pose j with ``min_span <= i - j <= max_span``. Every measurement
is exact (the relative pose of the ground truth) with information
diag(omega); the gauge prior sits on pose 0.

``structure(cfg)`` depends on the configuration alone (its structure seed
draws the closures); ``guesses(cfg, structure, seed, count, device)`` is
the only draw that the run's seed makes.
"""

from __future__ import annotations

import numpy as np
import torch

DIM = 3  # x, y, heading


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _relative(a, b):
    """a^-1 b for (E, 3) SE2 poses, heading wrapped."""
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    return np.stack([c * dx + s * dy, -s * dx + c * dy,
                     _wrap(b[:, 2] - a[:, 2])], axis=-1)


def truth(cfg):
    s = np.arange(cfg["poses"]) * cfg["step_m"]
    return np.stack([s, 2.0 * np.sin(s * 0.05), 0.1 * np.cos(s * 0.05)],
                    axis=-1)


def closure_pairs(cfg):
    """(from, to) of the closures: ``closures`` pairs drawn without
    repetition, by numpy default_rng(structure_seed), from every (i, j)
    with min_span <= i - j <= max_span, in (i, j) order."""
    n, spans = cfg["poses"], range(cfg["min_span"], cfg["max_span"] + 1)
    fr = np.concatenate([np.arange(d, n) for d in spans])
    to = np.concatenate([np.arange(0, n - d) for d in spans])
    rng = np.random.default_rng(cfg["structure_seed"])
    pick = rng.choice(len(fr), size=cfg["closures"], replace=False)
    order = np.lexsort((to[pick], fr[pick]))
    return fr[pick][order], to[pick][order]


def structure(cfg):
    """The graph as numpy arrays: ``fields`` (the port's graph fields,
    the ground truth as the poses), ``total_dof``, ``prior2``, ``prior3``,
    ``node_field`` and ``truth``."""
    n = cfg["poses"]
    gt = truth(cfg)
    ci, cj = closure_pairs(cfg)
    fr = np.concatenate([np.arange(n - 1), ci]).astype(np.int64)
    to = np.concatenate([np.arange(1, n), cj]).astype(np.int64)
    omega = np.broadcast_to(np.diag(cfg["omega"]), (len(fr), 3, 3)).copy()
    empty = np.zeros(0, np.int64)
    fields = dict(
        poses2=gt.copy(), landmarks2=np.zeros((0, 2)), poses3=np.zeros((0, 7)),
        pp_from=fr, pp_to=to, pp_z=_relative(gt[fr], gt[to]), pp_omega=omega,
        pl_pose=empty, pl_lm=empty, pl_z=np.zeros((0, 2)),
        pl_omega=np.zeros((0, 2, 2)), qq_from=empty, qq_to=empty,
        qq_z=np.zeros((0, 7)), qq_omega=np.zeros((0, 6, 6)),
        pose2_offsets=DIM * np.arange(n), lm2_offsets=empty,
        pose3_offsets=empty)
    return dict(fields=fields, total_dof=DIM * n, prior2=0, prior3=-1,
                node_field="poses2", truth=gt)


def guesses(cfg, struct, seed, count, device):
    """(count, poses, 3) float32 on ``device``: the ground truth plus
    N(0, sigma^2) on x, y and heading, pose 0 exact. One draw of a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    gt = torch.as_tensor(struct["truth"], dtype=torch.float64, device=device)
    noise = torch.randn((count,) + tuple(gt.shape), generator=gen,
                        dtype=torch.float32, device=device)
    noise[:, 0] = 0.0
    return (gt + cfg["guess_sigma"] * noise.double()).float()
