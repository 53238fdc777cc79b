"""The port's scan-matching pipeline against the JAX package's, f64 on the
CPU on the same scans: a robot circling a ±6 m room with two pillars (the
room of the JAX package's loop-closure test, chip_smoke.scan_data) at 28
scans of 120 beams.
``icp_odometry`` and ``scan_matching_slam`` to atol 1e-8,
``scan_matching_slam_pgo`` (ICP loop closures, chordal initialization,
Gauss-Newton on ``dense``) to atol 1e-6 on the poses, with the built
graph's fields equal and its grid's log-odds to atol 1e-12."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import scan_matching as jsm
from rustrobotics_tpu_torch.mapping import scan_matching as tsm

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAX_RANGE = 20.0


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def scans():
    """chip_smoke.scan_data's room and circle at 28 scans of 120 beams,
    a few beams without a return."""
    gt, ranges, angles = cs.scan_data(28, 120, 1, torch.float64, "cpu")
    ranges, angles = ranges.numpy(), angles.numpy()
    ranges[3, ::17] = np.inf
    ranges[5, 2::19] = 30.0
    return gt, angles, ranges


def test_scan_to_points_matches_jax(scans):
    _, angles, ranges = scans
    pj, okj = jsm.scan_to_points(jnp.asarray(ranges[3]), jnp.asarray(angles),
                                 MAX_RANGE)
    pt, okt = tsm.scan_to_points(t(ranges[3]), t(angles), MAX_RANGE)
    close(pt, pj, 1e-15)
    assert (okt.numpy() == np.asarray(okj)).all() and not okt.all()


def test_icp_odometry_matches_jax(scans):
    _, angles, ranges = scans
    pj, ptsj, okj = jsm.icp_odometry(jnp.asarray(ranges), jnp.asarray(angles),
                                     MAX_RANGE)
    pt, ptst, okt = tsm.icp_odometry(t(ranges), t(angles), MAX_RANGE)
    close(pt, pj, 1e-8)
    close(ptst, ptsj, 1e-15)
    assert (okt.numpy() == np.asarray(okj)).all()


def test_scan_matching_slam_matches_jax(scans):
    _, angles, ranges = scans
    pj, gj = jsm.scan_matching_slam(jnp.asarray(ranges), jnp.asarray(angles),
                                    MAX_RANGE, grid_size=70, resolution=0.2)
    pt, gt_ = tsm.scan_matching_slam(t(ranges), t(angles), MAX_RANGE,
                                     grid_size=70, resolution=0.2)
    close(pt, pj, 1e-8)
    close(gt_.origin, gj.origin, 0)
    assert gt_.resolution == gj.resolution
    close(gt_.log_odds, gj.log_odds, 1e-12)


def test_scan_matching_slam_pgo_matches_jax(scans):
    """Loop closures occur, and the optimized poses, the graph and the
    grid equal JAX's."""
    gt, angles, ranges = scans
    kw = dict(closure_gap=8, closure_radius=2.5, grid_size=70,
              resolution=0.2)
    pj, gj, graphj = jsm.scan_matching_slam_pgo(
        jnp.asarray(ranges), jnp.asarray(angles), MAX_RANGE, **kw)
    pt, gt_, grapht = tsm.scan_matching_slam_pgo(
        t(ranges), t(angles), MAX_RANGE, **kw)
    n_edges = graphj.pp_from.shape[0]
    assert n_edges > len(gt) - 1, n_edges  # closures were added
    for name in ("pp_from", "pp_to", "pose2_offsets"):
        assert (getattr(grapht, name).numpy()
                == np.asarray(getattr(graphj, name))).all(), name
    assert (grapht.total_dof, grapht.prior2, grapht.prior3) == (
        graphj.total_dof, graphj.prior2, graphj.prior3)
    for name in ("landmarks2", "poses3", "pl_z", "qq_z", "pl_pose"):
        assert getattr(grapht, name).shape == getattr(graphj, name).shape
    close(grapht.pp_z, graphj.pp_z, 1e-8)
    close(grapht.pp_omega, graphj.pp_omega, 0)
    close(grapht.poses2, graphj.poses2, 1e-6)
    close(pt, pj, 1e-6)
    close(gt_.log_odds, gj.log_odds, 1e-12)


def test_build_pose_graph_matches_jax():
    rng = np.random.default_rng(4)
    poses = rng.normal(size=(6, 3))
    odo = [rng.normal(size=3) for _ in range(5)]
    closures = [(0, 5, rng.normal(size=3)), (1, 4, rng.normal(size=3))]
    om1, om2 = np.diag([1.0, 2.0, 3.0]), np.diag([4.0, 5.0, 6.0])
    gj = jsm._build_pose_graph(poses, odo, closures, om1, om2, jnp.float64)
    gt_ = tsm._build_pose_graph(poses, odo, closures, om1, om2,
                                torch.float64, "cpu")
    for name in ("poses2", "pp_from", "pp_to", "pp_z", "pp_omega",
                 "pose2_offsets", "landmarks2", "pl_omega", "qq_omega"):
        a, b = getattr(gt_, name).numpy(), np.asarray(getattr(gj, name))
        assert a.shape == b.shape and (a == b).all(), name
    assert (gt_.total_dof, gt_.prior2, gt_.prior3) == (18, 0, -1)
