"""The port's chordal initialization against the JAX package's, f64 on the
CPU: ``chordal_init_se2`` on zeroed 2D graphs (poses and landmarks to
1e-9) and ``chordal_init_se3`` on an identity-initialized sphere (poses to
1e-9); then Gauss-Newton on ``banded-direct`` from the chordal graph
reaches the optimum that the zeroed start misses (the JAX package's
tests/test_pgo_golden.py::test_chordal_initialization_rescues_bad_init on
a synthetic circle)."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import g2o as jg2o
from rustrobotics_tpu.mapping import initialization as jinit
from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping import synthetic as jsyn
from rustrobotics_tpu_torch.mapping import g2o as tg2o
from rustrobotics_tpu_torch.mapping import initialization as tinit
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping import synthetic as tsyn

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-9


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()


def zeroed(kind):
    if kind == "circle":
        args = dict(num_poses=64, num_landmarks=8)
        ref, port = (jsyn.synthetic_pose_graph_2d(**args),
                     tsyn.synthetic_pose_graph_2d(**args, device="cpu"))
    else:
        args = dict(num_poses=200, num_landmarks=4, closure_span=24, seed=2)
        ref, port = (jsyn.synthetic_corridor_graph_2d(**args),
                     tsyn.synthetic_corridor_graph_2d(**args, device="cpu"))
    return (ref.replace(poses2=jnp.zeros_like(ref.poses2)),
            port.replace(poses2=torch.zeros_like(port.poses2)))


@pytest.mark.parametrize("kind", ["circle", "corridor"])
def test_chordal_se2_matches_jax(kind):
    ref0, port0 = zeroed(kind)
    want = jinit.chordal_init_se2(ref0)
    got = tinit.chordal_init_se2(port0)
    np.testing.assert_allclose(got.poses2.numpy(), np.asarray(want.poses2),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.landmarks2.numpy(),
                               np.asarray(want.landmarks2), rtol=0, atol=ATOL)
    # the rest of the graph is untouched; dtype and device are kept
    torch.testing.assert_close(got.pp_z, port0.pp_z, rtol=0, atol=0)
    g32 = tinit.chordal_init_se2(port0.to(dtype=torch.float32))
    assert g32.poses2.dtype == g32.landmarks2.dtype == torch.float32
    assert g32.device == torch.device("cpu")


def test_chordal_se3_matches_jax(tmp_path):
    spec = cs.sphere_graph(rings=4, per_ring=8, seed=3)
    poses = spec["fields"]["poses3"]
    spec["fields"]["poses3"] = np.tile([0.0] * 3 + [1.0] + [0.0] * 3,
                                       (len(poses), 1))
    path = tmp_path / "sphere-identity.g2o"
    path.write_text(cs.g2o_text(spec))
    want = jinit.chordal_init_se3(jg2o.load_g2o(str(path)))
    port = tg2o.load_g2o(str(path), device="cpu")
    got = tinit.chordal_init_se3(port)
    np.testing.assert_allclose(got.poses3.numpy(), np.asarray(want.poses3),
                               rtol=0, atol=ATOL)
    # exact measurements: the chordal graph is the optimum up to rounding
    assert float(tpgo.global_error(got)) < 1e-12
    assert float(tpgo.global_error(port)) > 1e3


def test_chordal_rescues_zeroed_start():
    ref0, port0 = zeroed("circle")
    stuck = tpgo.optimize(port0, num_iterations=30, backend="banded-direct",
                          device="cpu")
    want = jpgo.optimize(ref0, num_iterations=30, backend="banded-direct")
    assert stuck.errors[-1] > 5000.0  # a local minimum without init
    np.testing.assert_allclose(stuck.errors, want.errors, rtol=1e-9)

    gc = tinit.chordal_init_se2(port0)
    res = tpgo.optimize(gc, num_iterations=30, backend="banded-direct",
                        device="cpu")
    assert res.errors[0] < 1e-12 and res.errors[-1] < 1e-12
    jres = jpgo.optimize(jinit.chordal_init_se2(ref0), num_iterations=30,
                         backend="banded-direct")
    assert res.iterations == jres.iterations


def test_chip_smoke_chordal_anchors(tmp_path):
    """chip_smoke.py's bootstrap anchors are the JAX package's f64 chordal
    graphs of zeroed corridor-1728 and identity sphere-2500 (column sums
    of |poses| and |landmarks|), and the port's f64 chordal graphs give
    them too."""
    ref = jsyn.synthetic_corridor_graph_2d(1728, num_landmarks=32,
                                           closure_span=112)
    want = jinit.chordal_init_se2(ref.replace(
        poses2=jnp.zeros_like(ref.poses2)))
    port0 = tsyn.synthetic_corridor_graph_2d(
        1728, num_landmarks=32, closure_span=112, device="cpu")
    got = tinit.chordal_init_se2(port0.replace(
        poses2=torch.zeros_like(port0.poses2)))
    for sums, arrays in (
            (cs.CHORDAL_SUMS_2D, (want.poses2, got.poses2)),
            (cs.CHORDAL_LM_SUMS_2D, (want.landmarks2, got.landmarks2))):
        for a in arrays:
            np.testing.assert_allclose(np.abs(np.asarray(a)).sum(0), sums,
                                       rtol=1e-9)

    spec = cs.sphere_graph()
    spec["fields"]["poses3"] = np.tile([0.0] * 3 + [1.0] + [0.0] * 3,
                                       (len(spec["fields"]["poses3"]), 1))
    path = tmp_path / "sphere-2500-identity.g2o"
    path.write_text(cs.g2o_text(spec))
    want3 = jinit.chordal_init_se3(jg2o.load_g2o(str(path)))
    got3 = tinit.chordal_init_se3(cs.port_graph(spec, "cpu"))
    for a in (want3.poses3, got3.poses3):
        np.testing.assert_allclose(np.abs(np.asarray(a)).sum(0),
                                   cs.CHORDAL_SUMS_3D, rtol=1e-9)
