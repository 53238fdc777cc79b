"""The port's marginals against the JAX package and against a dense
inverse, f64 on the CPU: ``pgo.marginal_variances`` and
``pgo.pose_covariances`` (the banded selected inverse,
``band_chol._selected_inverse``), with and without a robust kernel, over
a fleet's batch axis, on a graph with one block row, through the dense
fallback, and on a 3D graph.

The 2D graph is a corridor with landmarks (n = 776, kb = 256, nb = 4) at
its initial estimates; the 3D graph is
``chip_smoke.sphere_graph`` at 6 rings of 12 poses (432 dof, kb = 256,
nb = 2). They mirror ``tests/test_pgo_golden.py``'s
``test_marginal_variances`` and ``test_pose_covariance_blocks``, which
need a dataset."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rustrobotics_tpu.mapping import assemble as jasm
from rustrobotics_tpu.mapping import g2o as jg2o
from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu.ops import band_chol as jbc
from rustrobotics_tpu_torch.mapping import assemble as tasm
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    graph_from_numpy,
)
from rustrobotics_tpu_torch.ops import band_assemble_kernels as bak
from rustrobotics_tpu_torch.ops import band_chol as tbc
from rustrobotics_tpu_torch.ops import band_chol_kernels as bk

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small-matrix tests: the suite runs
    several workers on one machine, and more threads oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_port(ref):
    fields = {n: np.asarray(getattr(ref, n)) for n in FLOAT_FIELDS + INDEX_FIELDS}
    return graph_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                            device="cpu")


def corridor(num_poses=256):
    return synthetic_corridor_graph_2d(num_poses, num_landmarks=4,
                                       closure_span=32)


@pytest.fixture(scope="module")
def case():
    ref = corridor()
    return ref, to_port(ref)


def dense_inverse(port, robust=None):
    """np.linalg.inv of the undamped H, assembled from the port's triplets
    (tests/test_torch_assemble.py holds them to JAX's)."""
    lay = tasm.build_layout(port)
    vals, _, _ = tasm.system_values(port, 0.0, robust=robust)
    h = sp.coo_matrix((vals.numpy(), (lay.rows, lay.cols)),
                      shape=(lay.n, lay.n)).toarray()
    return np.linalg.inv(h)


def assert_rel(got, want, rtol):
    """Every entry within rtol of its own magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("robust", [None, "cauchy"])
def test_marginal_variances_match(case, robust):
    ref, port = case
    var = tpgo.marginal_variances(port, robust=robust, device="cpu")
    assert var.shape == (port.total_dof,) and var.dtype == torch.float64
    assert_rel(var.numpy(), jpgo.marginal_variances(ref, robust=robust), 1e-9)
    want = np.diag(dense_inverse(port, robust))
    assert np.abs(var.numpy() - want).max() / np.abs(want).max() < 1e-8
    assert (var > 0).all()
    # the gauge-anchored pose is the most certain
    off = int(port.pose2_offsets[port.prior2])
    assert float(var[off:off + 3].max()) < float(var.median())


@pytest.mark.parametrize("robust", [None, "cauchy"])
def test_pose_covariances_match(case, robust):
    ref, port = case
    blocks = tpgo.pose_covariances(port, robust=robust, device="cpu").numpy()
    assert blocks.shape == (port.poses2.shape[0], 3, 3)
    want = np.asarray(jpgo.pose_covariances(ref, robust=robust))
    np.testing.assert_allclose(blocks, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    c_ref = dense_inverse(port, robust)
    offs = port.pose2_offsets.numpy()
    for i in [0, 10, len(offs) // 2, len(offs) - 1]:
        o = offs[i]
        blk = c_ref[o:o + 3, o:o + 3]
        assert np.abs(blocks[i] - blk).max() / np.abs(blk).max() < 1e-8
    np.testing.assert_allclose(blocks, np.swapaxes(blocks, -1, -2), atol=1e-12)
    assert (np.linalg.eigvalsh(blocks) > -1e-12).all()


def test_marginal_node_blocks_with_landmarks(case):
    """Blocks of every node kind at once (3-dof poses, 2-dof landmarks
    padded with the identity) against the dense inverse."""
    ref, port = case
    lay = jasm.build_layout(ref)
    vals, _, _ = jasm.system_values(ref, jnp.float64(0.0))
    offs = np.concatenate([port.pose2_offsets.numpy(),
                           port.lm2_offsets.numpy()])
    sizes = np.array([3] * port.poses2.shape[0] + [2] * port.landmarks2.shape[0])
    bl = tbc.build_band_chol(tasm.build_layout(port))
    got = tbc.marginal_node_blocks(bl, torch.tensor(np.asarray(vals)), offs,
                                   sizes, pad_size=3).numpy()
    want = np.asarray(jbc.marginal_node_blocks(jbc.build_band_chol(lay), vals,
                                               offs, sizes, pad_size=3))
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    c_ref = dense_inverse(port)
    for k in (len(offs) - 1, len(offs) - 2):
        o, s = offs[k], sizes[k]
        np.testing.assert_allclose(got[k, :s, :s], c_ref[o:o + s, o:o + s],
                                   rtol=1e-8)
        assert got[k, 2, 2] == 1.0 and got[k, 2, :2].tolist() == [0.0, 0.0]


def test_marginals_fleet_rows(case):
    """A fleet of two (the graph and a jittered copy): each row equals the
    one-graph call on that graph."""
    from rustrobotics_tpu_torch.mapping.pgo import stack_graphs

    _, port = case
    poses = port.poses2.numpy()
    other = port.replace(poses2=torch.as_tensor(
        poses + np.random.default_rng(0).normal(0.0, 0.02, poses.shape)))
    fleet = stack_graphs([port, other])
    var = tpgo.marginal_variances(fleet, device="cpu")
    blocks = tpgo.pose_covariances(fleet, device="cpu")
    assert var.shape == (2, port.total_dof)
    assert blocks.shape == (2, port.poses2.shape[0], 3, 3)
    for i, g in enumerate((port, other)):
        torch.testing.assert_close(var[i], tpgo.marginal_variances(
            g, device="cpu"), rtol=1e-12, atol=0)
        torch.testing.assert_close(blocks[i], tpgo.pose_covariances(
            g, device="cpu"), rtol=1e-12, atol=1e-12 * float(blocks.abs().max()))


def dense_blocks(c, offs):
    idx = offs[:, None] + np.arange(3)[None, :]
    return c[idx[:, :, None], idx[:, None, :]]


def test_one_block_row():
    """nb = 1: the recursion is the root block alone (against the dense
    inverse)."""
    port = to_port(corridor(num_poses=48))
    assert tbc.build_band_chol(tasm.build_layout(port)).nb == 1
    c_ref = dense_inverse(port)
    var = tpgo.marginal_variances(port, device="cpu").numpy()
    assert_rel(var, np.diag(c_ref), 1e-8)
    blocks = tpgo.pose_covariances(port, device="cpu").numpy()
    want = dense_blocks(c_ref, port.pose2_offsets.numpy())
    np.testing.assert_allclose(blocks, want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())


def test_dense_fallback(case, monkeypatch):
    """Without a band plan both functions take the dense inverse, as the
    JAX package's do (its fallback is np.linalg.inv's math)."""
    _, port = case
    monkeypatch.setattr(tbc, "build_band_chol", lambda *a, **k: None)
    c_ref = dense_inverse(port)
    var = tpgo.marginal_variances(port, device="cpu").numpy()
    assert_rel(var, np.diag(c_ref), 1e-9)
    blocks = tpgo.pose_covariances(port, device="cpu").numpy()
    want = dense_blocks(c_ref, port.pose2_offsets.numpy())
    np.testing.assert_allclose(blocks, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


def test_f32_runs_the_kernel_wrappers(case, monkeypatch):
    """f32 values take the K4 + K1 wrappers, whose plain versions run on
    the CPU (no launch counted). The undamped system is at f32's edge (the
    1e7 gauge prior): the f32 variances read up to 1.2e-2 of each dof's
    own from f64 here, so the bound is 5e-2."""
    _, port = case
    calls = []
    for mod, name in ((bk, "factorize_plain"), (bak, "band_assemble_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    before = {**bk.LAUNCHES, **bak.LAUNCHES}
    var32 = tpgo.marginal_variances(port.to(dtype=torch.float32), device="cpu")
    assert var32.dtype == torch.float32
    assert sorted(calls) == ["band_assemble_plain", "factorize_plain"]
    assert {**bk.LAUNCHES, **bak.LAUNCHES} == before
    var64 = tpgo.marginal_variances(port, device="cpu")
    rel = float(((var32.double() - var64).abs() / var64).max())
    assert rel < 5e-2, rel


def test_marginals_se3():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    g = cs.sphere_graph(rings=6, per_ring=12, seed=1)
    f = g["fields"]
    ref = jg2o.PoseGraphData(
        **{k: jnp.asarray(v, jnp.int32 if k in INDEX_FIELDS else None)
           for k, v in f.items()},
        total_dof=g["total_dof"], prior2=g["prior2"], prior3=g["prior3"])
    port = cs.port_graph(g, "cpu")
    var = tpgo.marginal_variances(port, device="cpu").numpy()
    assert var.shape == (432,)
    assert_rel(var, np.asarray(jpgo.marginal_variances(ref)), 1e-9)
    assert_rel(var, np.diag(dense_inverse(port)), 1e-8)
    # the pose covariances read the SE2 poses, of which a 3D graph has none
    assert tpgo.pose_covariances(port, device="cpu").shape == (0, 3, 3)
    assert np.asarray(jpgo.pose_covariances(ref)).shape == (0, 3, 3)
