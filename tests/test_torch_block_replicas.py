"""The port's 2-D (replica x blocks) mesh (``block_optimize_multistart``,
``make_block_optimize`` on ``make_mesh_2d``) against the JAX package's,
f64, on the circle graph of ``test_torch_block_step``.

The port runs as 4 gloo ranks (``test_torch_blocks_worker.py``) on a 2 x 2
mesh; JAX on ``make_mesh_2d(blocks=2, replicas=2)`` of its virtual CPU
devices and on ``make_mesh(2, axis="blocks")``. Contracts, as the JAX
package's ``tests/test_blocks_2d.py`` sets them:

- multi-start: each replica's χ² trace within 1e-8 relative of JAX's (the
  jitter is numpy ``default_rng(seed)``'s draws keyed by node id, the
  JAX package's), the same best replica, and its poses within 1e-8 of
  their largest entry;
- a replica row given the unjittered state reproduces the 1-D run of the
  same blocks exactly (the replica axis adds nothing to the solve), and
  JAX's 1-D run within 1e-8;
- the replica group carries only the scalar MAX of the stop flags: every
  sum, gather and point-to-point message of ``run`` stays on the blocks
  group (the collectives are recorded by a wrapper in the worker).
"""

import ast

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_blocks_worker as W
from rustrobotics_tpu.parallel.block_layout import build_block_layout
from rustrobotics_tpu.parallel.mesh import make_mesh, make_mesh_2d
from rustrobotics_tpu.parallel.pgo_blocks import (
    block_optimize_multistart,
    layout_device_arrays,
    make_block_optimize,
)
from test_torch_block_step import graph_inputs, jax_graphs

RTOL = 1e-8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("block_replicas")
    graph = jax_graphs(d)["circle"]
    np.savez(d / "in.npz", **graph_inputs({"circle": graph}))
    procs = W.spawn("replicas", (4,), d, d / "in.npz")
    try:
        g, traces, best = block_optimize_multistart(
            make_mesh_2d(blocks=2, replicas=2), graph,
            num_iterations=W.REP_ITERATIONS, jitter=W.REP_JITTER,
            seed=W.REP_SEED, tolerance=0.0, cg_tol=W.OPT_CG_TOL)
        layout = build_block_layout(graph, 2)
        state, edges, maps = layout_device_arrays(layout, jnp.float64)
        st1, errs1, it1, cg1 = make_block_optimize(
            make_mesh(2, axis="blocks"), layout,
            num_iterations=W.REP_ITERATIONS, tolerance=0.0,
            cg_tol=W.OPT_CG_TOL, dtype=jnp.float64)(state, edges, maps)
        ref = dict(traces=np.asarray(traces), best=best,
                   poses2=np.asarray(g.poses2), errors=np.asarray(errs1),
                   iterations=int(it1), rounds=int(cg1),
                   state=[np.asarray(a) for a in st1])
    finally:
        port = W.collect(procs, "replicas", (4,), d)
    return ref, port


def test_multistart_matches_jax(runs):
    ref, port = runs
    assert len(ref["traces"]) == 2
    assert np.abs(ref["traces"][1] - ref["traces"][0]).max() > 1e-6  # jittered
    for rank in range(4):  # every rank returns every trace and the best
        got = port[(4, rank)]
        np.testing.assert_allclose(got["multistart_traces"], ref["traces"],
                                   rtol=RTOL, atol=0)
        assert int(got["multistart_best"]) == ref["best"]
        np.testing.assert_allclose(
            got["multistart_poses2"], ref["poses2"], rtol=0,
            atol=RTOL * np.abs(ref["poses2"]).max())


def test_replica_rows_reproduce_the_1d_run(runs):
    ref, port = runs
    for rank in range(4):
        got = port[(4, rank)]
        np.testing.assert_array_equal(got["row_errors"], got["oned_errors"])
        assert int(got["row_iterations"]) == int(got["oned_iterations"])
        assert int(got["row_rounds"]) == int(got["oned_rounds"])
        for i in range(3):
            np.testing.assert_array_equal(got[f"row_state{i}"],
                                          got[f"oned_state{i}"])
        np.testing.assert_allclose(got["oned_errors"], ref["errors"],
                                   rtol=RTOL, atol=0)
        assert int(got["oned_iterations"]) == ref["iterations"]
        assert int(got["oned_rounds"]) == ref["rounds"]
        scale = np.abs(ref["state"][0]).max()
        np.testing.assert_allclose(got["oned_state0"], ref["state"][0],
                                   rtol=0, atol=RTOL * scale)


def test_replica_axis_carries_only_the_scalar_max(runs):
    """The counterpart of the JAX package's
    test_replica_axis_carries_no_cg_traffic, on the calls the port makes:
    on the replica group, only all_reduce(MAX) of one int; every other call
    on the blocks group."""
    _, port = runs
    for rank in range(4):
        got = port[(4, rank)]
        rep = ast.literal_eval(str(got["replica_group"]))
        blocks = ast.literal_eval(str(got["blocks_group"]))
        assert len(rep) == 2 and len(blocks) == 2 and rank in rep
        calls = ast.literal_eval(str(got["traffic"]))
        assert calls, "no collectives recorded"
        on_rep = [(k, n) for k, n in calls if k[1] == rep]
        assert on_rep and all(
            name == "all_reduce" and numel == 1 and "MAX" in op
            for (name, _, numel, op), _ in on_rep), on_rep
        others = [k for k, _ in calls if k[1] != rep]
        assert all(k[1] == blocks for k in others), others
        assert any(k[0] == "batch_isend_irecv" for k in others)  # halos
        assert any(k[0] == "all_reduce" and "SUM" in k[3] for k in others)

