"""The port's ICP and occupancy grid against the JAX package's, f64 on the
CPU on the same seeded numpy inputs: rigid alignment and ICP (2D and 3D,
with and without outlier trimming) to atol 1e-9, the grid's log-odds
after one scan and after a trajectory to atol 1e-12 (sums of the same
constants), and the port's batched ICP against one problem at a time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import icp as jicp
from rustrobotics_tpu.mapping import occupancy as jocc
from rustrobotics_tpu_torch.mapping import icp as ticp
from rustrobotics_tpu_torch.mapping import occupancy as tocc

ATOL = 1e-9


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _rot2(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s], [s, c]])


def _cloud(seed, n, d, outliers=False):
    """src and a moved, noisy copy dst (10% gross outliers if asked)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-3, 3, (n, d))
    if d == 2:
        r = _rot2(0.18)
    else:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        r = q * np.sign(np.linalg.det(q))
        r = np.eye(3) * 0.9 + r * 0.1
        u, _, vt = np.linalg.svd(r)
        r = u @ vt
    dst = src @ r.T + rng.normal(size=d) * 0.3 \
        + rng.normal(size=(n, d)) * 0.005
    if outliers:
        dst[::10] += rng.uniform(3, 6, dst[::10].shape)
    return src, dst, rng


@pytest.mark.parametrize("d,weighted", [(2, False), (2, True), (3, False),
                                        (3, True)])
def test_rigid_align_matches_jax(d, weighted):
    src, dst, rng = _cloud(0, 50, d)
    w = rng.uniform(0.0, 1.0, 50) if weighted else None
    rj, tj = jicp.rigid_align(jnp.asarray(src), jnp.asarray(dst),
                              None if w is None else jnp.asarray(w))
    rt, tt = ticp.rigid_align(t(src), t(dst), None if w is None else t(w))
    close(rt, rj)
    close(tt, tj)
    assert abs(torch.linalg.det(rt) - 1.0) < 1e-12


def test_rigid_align_reflection_fix_matches_jax():
    """A mirrored target: the det < 0 branch flips the last direction."""
    src, _, _ = _cloud(1, 40, 2)
    dst = src * np.array([1.0, -1.0])
    rj, tj = jicp.rigid_align(jnp.asarray(src), jnp.asarray(dst))
    rt, tt = ticp.rigid_align(t(src), t(dst))
    close(rt, rj)
    close(tt, tj)
    assert float(torch.linalg.det(rt)) > 0


@pytest.mark.parametrize("d,quantile,outliers", [
    (2, None, False), (2, 0.85, True), (3, None, False), (3, 0.9, True)])
def test_icp_matches_jax(d, quantile, outliers):
    src, dst, _ = _cloud(2 + d, 200, d, outliers)
    rj, tj, ej = jicp.icp(jnp.asarray(src), jnp.asarray(dst), 20, quantile)
    rt, tt, et = ticp.icp(t(src), t(dst), 20, quantile)
    close(rt, rj)
    close(tt, tj)
    close(et, ej)


def test_icp_se2_and_jit_alias_match_jax():
    src, dst, _ = _cloud(7, 300, 2, outliers=True)
    pj, ej = jicp.icp_se2(jnp.asarray(src), jnp.asarray(dst), 30, 0.85)
    pt, et = ticp.icp_se2(t(src), t(dst), 30, 0.85)
    close(pt, pj)
    close(et, ej)
    rj, tj, _ = jicp.icp_jit(jnp.asarray(src), jnp.asarray(dst),
                             num_iterations=5)
    rt, tt, _ = ticp.icp_jit(t(src), t(dst), num_iterations=5)
    close(rt, rj)
    close(tt, tj)


def test_batched_icp_equals_one_problem_at_a_time():
    """The port's leading batch axis (shared dst, and one dst a problem)
    gives each problem's own ICP."""
    src, dst, rng = _cloud(8, 120, 2)
    srcs = np.stack([src, src[::-1] + 0.05, src * 1.01])
    rb, tb, eb = ticp.icp(t(srcs), t(dst), 10, 0.9)
    dsts = np.stack([dst, dst + 0.1, dst[rng.permutation(120)]])
    rb2, tb2, eb2 = ticp.icp(t(srcs), t(dsts), 10, 0.9)
    for i in range(3):
        r1, t1, e1 = ticp.icp(t(srcs[i]), t(dst), 10, 0.9)
        close(rb[i], r1, 1e-12)
        close(tb[i], t1, 1e-12)
        close(eb[i], e1, 1e-12)
        r2, t2, e2 = ticp.icp(t(srcs[i]), t(dsts[i]), 10, 0.9)
        close(rb2[i], r2, 1e-12)
        close(tb2[i], t2, 1e-12)
        close(eb2[i], e2, 1e-12)


def _room_ranges(poses, angles, half=4.0):
    """Ranges to the walls of a square room of half-width ``half``."""
    th = poses[:, 2:3] + angles[None, :]
    dx, dy = np.cos(th), np.sin(th)
    with np.errstate(divide="ignore"):
        tx = np.where(dx > 0, (half - poses[:, :1]) / dx,
                      np.where(dx < 0, (-half - poses[:, :1]) / dx, np.inf))
        ty = np.where(dy > 0, (half - poses[:, 1:2]) / dy,
                      np.where(dy < 0, (-half - poses[:, 1:2]) / dy, np.inf))
    return np.minimum(tx, ty)


def _grids(res=0.1, size=(60, 70), origin=(-3.2, -3.6)):
    jg = jocc.OccupancyGrid.create(*size, res, origin=origin,
                                   dtype=jnp.float64)
    tg = tocc.OccupancyGrid.create(*size, res, origin=origin,
                                   dtype=torch.float64, device="cpu")
    return jg, tg


def test_grid_create_probability_world_to_cell():
    jg, tg = _grids()
    rng = np.random.default_rng(3)
    lo = rng.normal(size=(60, 70)) * 3
    jg = jg.replace(log_odds=jnp.asarray(lo))
    tg = tocc.grid_from_numpy(np.asarray(jg.log_odds), np.asarray(jg.origin),
                              jg.resolution, device="cpu")
    close(tg.probability, jg.probability, 1e-15)
    xy = rng.uniform(-4, 4, (5, 7, 2))
    for a, b in zip(tg.world_to_cell(t(xy)),
                    jg.world_to_cell(jnp.asarray(xy))):
        close(a, b, 1e-12)


def test_integrate_scan_matches_jax():
    """One scan with valid, over-range and non-finite beams, part of it
    leaving the grid."""
    jg, tg = _grids()
    angles = np.linspace(-np.pi, np.pi, 90, endpoint=False)
    pose = np.array([0.7, -0.4, 0.3])
    ranges = _room_ranges(pose[None], angles)[0]
    ranges[::7] = 12.0      # no return
    ranges[3::11] = np.inf
    ranges[5::13] = np.nan
    jg2 = jocc.integrate_scan(jg, jnp.asarray(pose), jnp.asarray(ranges),
                              jnp.asarray(angles), max_range=10.0,
                              samples_per_beam=48)
    tg2 = tocc.integrate_scan(tg, t(pose), t(ranges), t(angles),
                              max_range=10.0, samples_per_beam=48)
    close(tg2.log_odds, jg2.log_odds, 1e-12)
    assert np.abs(np.asarray(jg2.log_odds)).sum() > 10


@pytest.mark.parametrize("jitted", [False, True])
def test_integrate_trajectory_matches_jax(jitted):
    """Three poses in the room (the JAX test's), log-odds saturating at
    the clamp on the walls."""
    jg, tg = _grids(0.1, (100, 100), (-5.0, -5.0))
    angles = np.linspace(-np.pi, np.pi, 180, endpoint=False)
    poses = np.array([[0.0, 0.0, 0.0], [1.0, 0.5, 0.3], [-1.0, -0.5, 2.0]])
    poses = np.concatenate([poses] * 5)  # 15 scans reach the clamp
    ranges = _room_ranges(poses, angles)
    jfn = jocc.integrate_trajectory_jit if jitted else \
        jocc.integrate_trajectory
    tfn = tocc.integrate_trajectory_jit if jitted else \
        tocc.integrate_trajectory
    jg2 = jfn(jg, jnp.asarray(poses), jnp.asarray(ranges),
              jnp.asarray(angles), max_range=12.0, samples_per_beam=128)
    tg2 = tfn(tg, t(poses), t(ranges), t(angles), max_range=12.0,
              samples_per_beam=128)
    close(tg2.log_odds, jg2.log_odds, 1e-12)
    prob = tg2.probability.numpy()
    assert prob[40:60, 40:60].max() < 0.2
    assert prob[9:12, 20:80].max() > 0.9
    assert np.abs(tg2.log_odds.numpy()).max() == tocc.LOG_ODDS_CLAMP
