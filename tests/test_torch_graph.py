"""The port's graph data, generators and g2o parser against the JAX
package, and a static check that the port stands alone."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import g2o as jg2o
from rustrobotics_tpu.mapping import synthetic as jsyn
from rustrobotics_tpu_torch.mapping import g2o as tg2o
from rustrobotics_tpu_torch.mapping import synthetic as tsyn

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = tg2o.FLOAT_FIELDS + tg2o.INDEX_FIELDS
META = ("total_dof", "prior2", "prior3")


def assert_same_graph(port, ref):
    for name in FIELDS:
        got = getattr(port, name).cpu().numpy()
        want = np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in META:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", ["circle", "corridor"])
def test_generators_identical(kind, seed):
    if kind == "circle":
        args = dict(num_poses=48, num_landmarks=5, seed=seed)
        ref = jsyn.synthetic_pose_graph_2d(**args)
        port = tsyn.synthetic_pose_graph_2d(**args, device="cpu")
    else:
        args = dict(num_poses=200, num_landmarks=4, closure_span=32,
                    seed=seed)
        ref = jsyn.synthetic_corridor_graph_2d(**args)
        port = tsyn.synthetic_corridor_graph_2d(**args, device="cpu")
    assert_same_graph(port, ref)
    assert port.num_nodes == ref.num_nodes
    assert port.num_edges == ref.num_edges


def test_graph_from_numpy_round_trip():
    ref = jsyn.synthetic_corridor_graph_2d(96, num_landmarks=3,
                                           closure_span=16, seed=3)
    fields = {name: np.asarray(getattr(ref, name)) for name in FIELDS}
    port = tg2o.graph_from_numpy(fields, ref.total_dof, ref.prior2,
                                 ref.prior3, device="cpu")
    assert_same_graph(port, ref)
    assert port.dtype == torch.float64
    g32 = port.to(dtype=torch.float32)
    assert g32.poses2.dtype == torch.float32
    assert g32.pp_from.dtype == torch.int64


G2O_TEXT = """\
VERTEX_SE2 0 0.0 0.0 0.0
VERTEX_SE2 1 1.0 0.1 0.05
VERTEX_XY 7 2.0 1.5
VERTEX_SE2 2 2.1 0.0 -0.1
EDGE_SE2 0 1 1.0 0.0 0.0 100.0 0.0 0.0 100.0 0.0 400.0
EDGE_SE2_XY 1 7 1.0 1.4 50.0 1.0 50.0
EDGE_SE2 1 2 1.0 -0.1 -0.1 100.0 2.0 0.5 90.0 0.0 300.0
EDGE_SE2 0 2 2.0 0.0 -0.1 80.0 0.0 0.0 80.0 0.0 200.0
"""


def test_load_g2o_matches(tmp_path):
    path = tmp_path / "tiny.g2o"
    path.write_text(G2O_TEXT)
    ref = jg2o.load_g2o(str(path))
    port = tg2o.load_g2o(str(path), device="cpu")
    assert_same_graph(port, ref)
    assert port.total_dof == 11 and port.prior2 == 0


FORBIDDEN = ("jax", "jaxlib", "flax", "rustrobotics_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "rustrobotics_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    # the JAX-free rank processes of the distributed tests
    files += sorted((ROOT / "tests").glob("test_torch_*_worker.py"))
    assert len(files) > 10
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"rustrobotics_tpu_torch/parallel/block_layout.py",
            "rustrobotics_tpu_torch/parallel/pgo_blocks.py",
            "rustrobotics_tpu_torch/cli.py",
            "rustrobotics_tpu_torch/benchmarks.py",
            "rustrobotics_tpu_torch/bench.py",
            "rustrobotics_tpu_torch/entry.py",
            "rustrobotics_tpu_torch/examples/distributed_pgo.py",
            "tests/test_torch_blocks_worker.py",
            "tests/test_torch_parallel_worker.py"} <= names
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad
