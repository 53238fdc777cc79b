"""The port's SLAM-course loader and graph-SLAM front end against the JAX
package's, f64 on the CPU, on a synthetic two-file log
(``chip_smoke.write_slam_course``: 200 noisy odometry records along the
corridor path, 6 landmarks sighted within 5 m): the parsed dataset and its
padded arrays equal, the built graph equal, and LM on ``banded-direct``
from it (χ² trace to rtol 1e-9, landmarks to 1e-9)."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.data import slam_course as jsc
from rustrobotics_tpu.mapping import frontend as jfe
from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu_torch.data import SlamCourseArrays, load_slam_course
from rustrobotics_tpu_torch.mapping import build_pose_graph_from_slam_course
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping.g2o import FLOAT_FIELDS, INDEX_FIELDS

ROOT = pathlib.Path(__file__).resolve().parent.parent


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def log_dir(tmp_path_factory):
    cs = load_chip_smoke()
    d = tmp_path_factory.mktemp("slam_course")
    path, landmarks = cs.slam_course_world(201, 6)
    cs.write_slam_course(d, path, landmarks, seed=3)
    return d


def test_load_slam_course_matches(log_dir):
    ref = jsc.load_slam_course(log_dir)
    got = load_slam_course(log_dir)
    np.testing.assert_array_equal(got.odometry, ref.odometry)
    np.testing.assert_array_equal(got.landmark_ids, ref.landmark_ids)
    np.testing.assert_array_equal(got.landmarks, ref.landmarks)
    assert got.odometry.shape == (200, 3) and len(got.sensors) == 200
    assert [np.asarray(s).tolist() for s in got.sensors] == [
        np.asarray(s).tolist() for s in ref.sensors]
    assert sum(len(s) for s in got.sensors) > 6 * 10


@pytest.mark.parametrize("max_measurements", [None, 2])
def test_arrays_match(log_dir, max_measurements):
    want = jsc.load_slam_course(log_dir).arrays(max_measurements)
    got = load_slam_course(log_dir).arrays(max_measurements, device="cpu")
    assert isinstance(got, SlamCourseArrays)
    assert got.num_steps == want.num_steps == 200
    for name in ("odometry", "meas_ids", "meas_z", "meas_mask"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_front_end_graph_matches(log_dir):
    ref = jfe.build_pose_graph_from_slam_course(
        jsc.load_slam_course(log_dir), dtype=jnp.float64)
    got = build_pose_graph_from_slam_course(
        load_slam_course(log_dir), dtype=torch.float64, device="cpu")
    for name in FLOAT_FIELDS + INDEX_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.total_dof, got.prior2, got.prior3) == (
        ref.total_dof, ref.prior2, ref.prior3)
    g32 = build_pose_graph_from_slam_course(load_slam_course(log_dir),
                                            device="cpu")
    assert g32.dtype == torch.float32


def test_front_end_lm_matches(log_dir):
    ds = load_slam_course(log_dir)
    ref = jpgo.optimize(jfe.build_pose_graph_from_slam_course(
        jsc.load_slam_course(log_dir), dtype=jnp.float64),
        num_iterations=10, solver="levenberg_marquardt",
        backend="banded-direct")
    res = tpgo.optimize(build_pose_graph_from_slam_course(
        ds, dtype=torch.float64, device="cpu"), num_iterations=10,
        solver="levenberg_marquardt", backend="banded-direct", device="cpu")
    np.testing.assert_allclose(res.errors, ref.errors, rtol=1e-9)
    assert res.errors[-1] < res.errors[0] / 2
    np.testing.assert_allclose(res.graph.landmarks2.numpy(),
                               np.asarray(ref.graph.landmarks2), rtol=0,
                               atol=1e-9)
