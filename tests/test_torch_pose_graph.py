"""The port's ``PoseGraph`` wrapper against the JAX package's, f64 on the
CPU: the χ² trace (rtol 1e-9, atol 1e-12), ``iteration`` and ``global_error`` from a
g2o file in Gauss-Newton and Levenberg-Marquardt on ``banded-direct`` and
``host``; an LM trace with rejected steps (the trace records the rejected
trial χ²); and the per-iteration plots."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping import synthetic as jsyn
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping.synthetic import (
    synthetic_corridor_graph_2d,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# χ² traces agree to RTOL; GN reaches the f64 rounding floor of χ² (~1e-18
# on these graphs), where entries are held to ATOL instead
RTOL, ATOL = 1e-9, 1e-12


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()


@pytest.fixture(scope="module")
def corridor_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("pg") / "corridor-300.g2o"
    path.write_text(cs.g2o_text(cs.graph_spec(synthetic_corridor_graph_2d(
        300, num_landmarks=6, closure_span=32, device="cpu"))))
    return path


@pytest.mark.parametrize("backend", ["banded-direct", "host"])
@pytest.mark.parametrize("solver", ["gauss_newton", "levenberg_marquardt"])
def test_pose_graph_matches_jax(corridor_file, solver, backend):
    ref = jpgo.PoseGraph(corridor_file, solver=solver)
    port = tpgo.PoseGraph(corridor_file, solver=solver, device="cpu")
    assert port.name == ref.name == "corridor-300"
    np.testing.assert_allclose(port.global_error(), ref.global_error(),
                               rtol=RTOL)
    for _ in range(2):  # a second call continues from the kept estimates
        want = ref.optimize(3, backend=backend)
        got = port.optimize(3, backend=backend)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert port.iteration == ref.iteration
        np.testing.assert_allclose(port.global_error(), ref.global_error(),
                                   rtol=RTOL, atol=ATOL)
    assert port.iteration > 3  # GN stops early on ‖dx‖ < 1e-4, as JAX's
    np.testing.assert_allclose(port.data.poses2.numpy(),
                               np.asarray(ref.data.poses2), rtol=0,
                               atol=1e-9)


def test_pose_graph_dtype_and_data():
    ref = jsyn.synthetic_corridor_graph_2d(96, num_landmarks=2,
                                           closure_span=16)
    port = synthetic_corridor_graph_2d(96, num_landmarks=2, closure_span=16,
                                       device="cpu")
    pg = tpgo.PoseGraph(port, dtype=torch.float32, device="cpu")
    assert pg.name == "graph" and pg.data.dtype == torch.float32
    assert pg.data.pp_from.dtype == torch.int64
    np.testing.assert_allclose(pg.global_error(),
                               jpgo.PoseGraph(ref).global_error(), rtol=1e-5)


def test_lm_trace_keeps_rejected_chi2():
    """A wrecked corridor (initial poses N(0, 1²) off): LM rejects steps,
    and the trace records each rejected trial χ² (an entry above its
    predecessor), as the JAX package's does."""
    args = dict(num_poses=160, num_landmarks=4, closure_span=24, noise=1.0,
                seed=1)
    ref = jpgo.PoseGraph(jsyn.synthetic_corridor_graph_2d(**args),
                         solver="levenberg_marquardt")
    port = tpgo.PoseGraph(synthetic_corridor_graph_2d(**args, device="cpu"),
                          solver="levenberg_marquardt", device="cpu")
    want = ref.optimize(8, backend="banded-direct")
    got = port.optimize(8, backend="banded-direct")
    rises = [k for k in range(1, len(got)) if got[k] > got[k - 1]]
    assert rises, got
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert port.iteration == ref.iteration == 8


def test_plot_writes_the_same_files(tmp_path, corridor_file):
    pytest.importorskip("matplotlib")
    ref_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    jpgo.PoseGraph(corridor_file).optimize(2, plot=True, backend="host",
                                           out_dir=str(ref_dir))
    tpgo.PoseGraph(corridor_file, device="cpu").optimize(
        2, plot=True, backend="host", out_dir=str(port_dir))
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in ref_dir.iterdir())
    assert names == [f"corridor-300-{i}-gauss_newton.png" for i in range(3)]
    assert all((port_dir / n).stat().st_size > 0 for n in names)


def test_plot_helpers_take_tensors(tmp_path):
    pytest.importorskip("matplotlib")
    from rustrobotics_tpu.utils import plot as jplot
    from rustrobotics_tpu_torch.utils import plot as tplot

    cov = np.array([[0.5, 0.1], [0.1, 0.2]])
    np.testing.assert_allclose(
        tplot.covariance_ellipse(torch.tensor([1.0, 2.0]), torch.tensor(cov)),
        jplot.covariance_ellipse(np.array([1.0, 2.0]), cov), rtol=1e-12)
    rng = np.random.default_rng(0)
    hist = {k: torch.tensor(rng.normal(size=(20, 3))) for k in
            ("x_true", "x_dr", "x_est", "z")}
    hist["cov_est"] = torch.eye(3).expand(20, 3, 3)
    out = tplot.plot_filter_history(hist, str(tmp_path / "hist.png"))
    assert pathlib.Path(out).stat().st_size > 0
    graph = synthetic_corridor_graph_2d(64, num_landmarks=2, closure_span=16,
                                        device="cpu")
    covs = torch.eye(3, dtype=torch.float64).expand(64, 3, 3) * 0.01
    out = tplot.plot_pose_graph(graph, str(tmp_path / "g.png"),
                                covariances=covs, title="t")
    assert pathlib.Path(out).stat().st_size > 0
