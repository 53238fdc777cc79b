"""The port's entry points (``rustrobotics_tpu_torch.entry``) against the
JAX package's ``__graft_entry__`` on the CPU.

``entry()``'s GN step equals ``__graft_entry__._gn_step_fn`` on the same
graph (``synthetic_pose_graph_2d(96, 12)``): in f64 within 1e-9 of the
largest entry; ``entry()`` itself in f32 within 1e-4 of the f64 step's
poses and 1e-4 relative of its χ² (f32's rounding through a 324-dof
Cholesky, ~1e-6 measured). ``dryrun_multichip``'s golden trace (dense GN
3 on the corridor of 16 n poses) equals JAX's
``make_optimize_jit(..., backend="dense")`` trace in f64 within 1e-9. The
dry run runs at gloo world size 1 in this process and at world size 4 as
ranks of ``test_torch_blocks_worker.py dryrun`` (its checks raise, so a
rank that returns passed them); those ranks also give the benchmarks'
block-scaling and sharded-PF rows at four ranks, held to the JAX rows'
keys. JAX's own ``dryrun_multichip`` is not run (its distributed compiles
cost ~5-19 s each).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as jax_entry
import test_torch_blocks_worker as W
from rustrobotics_tpu.mapping.pgo import make_optimize_jit
from rustrobotics_tpu.mapping.synthetic import (
    synthetic_corridor_graph_2d,
    synthetic_pose_graph_2d,
)
from rustrobotics_tpu_torch import entry
from test_torch_bench_suite import _schema, distributed_schema
from test_torch_block_step import graph_inputs

RTOL = 1e-9
F32_TOL = 1e-4


def _port(jax_graph):
    return W.graph_of(graph_inputs({"g": jax_graph}), "g")


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, computed while the four dry-run ranks run:
    the GN step on the entry's graph in f64, the dense golden trace on
    the 64-pose corridor in f64; and the ranks' outputs."""
    d = tmp_path_factory.mktemp("entry")
    np.savez(d / "in.npz")
    procs = W.spawn("dryrun", (4,), d, d / "in.npz")
    try:
        g = synthetic_pose_graph_2d(num_poses=96, num_landmarks=12,
                                    dtype=jnp.float64)
        step = jax.jit(jax_entry._gn_step_fn(g))(g)
        corridor = synthetic_corridor_graph_2d(num_poses=64, num_landmarks=4,
                                               dtype=jnp.float64)
        golden = np.asarray(make_optimize_jit(
            corridor, num_iterations=3, backend="dense",
            tolerance=0.0)(corridor)[1])
    finally:
        ranks = W.collect(procs, "dryrun", (4,), d)
    return dict(graph=g, step=step, corridor=corridor,
                golden=golden[~np.isnan(golden)], ranks=ranks)


def test_gn_step_matches_jax_f64(runs):
    g, want = runs["graph"], runs["step"]
    pg = _port(g)
    got = entry._gn_step_fn(pg)(pg)
    for a, b in zip(got, want):
        _close(a.numpy(), b, RTOL)


def test_entry_f32_tracks_the_f64_step(runs):
    want = runs["step"]
    fn, (graph,) = entry.entry(device="cpu")
    assert graph.dtype == torch.float32 and graph.poses2.shape == (96, 3)
    poses, landmarks, chi2 = fn(graph)
    _close(poses.numpy(), want[0], F32_TOL)
    _close(landmarks.numpy(), want[1], F32_TOL)
    assert abs(float(chi2) - float(want[2])) <= F32_TOL * float(want[2])


def test_golden_trace_matches_jax(runs):
    _close(entry._golden_trace(_port(runs["corridor"])), runs["golden"],
           RTOL)


def test_dryrun_world1_in_process(tmp_path):
    with pytest.raises(RuntimeError):
        entry.dryrun_multichip(1, device="cpu")  # no process group
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError):
            entry.dryrun_multichip(2, device="cpu")
        entry.dryrun_multichip(1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_dryrun_world4_ranks(runs):
    out = runs["ranks"]
    rows = json.loads(str(out[(4, 0)]["rows"]))
    assert _schema(rows) == distributed_schema(4)
    assert all(np.isfinite(r["value"]) for r in rows)
    # every rank holds the sharded PF's row; only rank 0 the scaling rows
    for rank in (1, 2, 3):
        other = json.loads(str(out[(4, rank)]["rows"]))
        assert [r["metric"] for r in other] == [
            "pf_sharded_1m_bounded_exchange"]
        assert "gloo group, world size 4" in other[0]["note"]
