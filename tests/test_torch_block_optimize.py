"""The port's map-block optimizer (``parallel.pgo_blocks.block_optimize``,
``block_optimize_elastic``, ``comm_budget``) against the JAX package's on
the same inputs, f64.

JAX runs on sub-meshes of the 8 virtual CPU devices; the port runs as gloo
ranks at world sizes 2 and 4 (``test_torch_blocks_worker.py``) through
every case of ``OPT_CASES`` on the circle graph (24 poses, 3 landmarks,
noisy measurements): GN and LM at D = 2 and 4, Eisenstat-Walker forcing
(``ew``, ``ew-fast``) and Schur at D = 2, the default Schwarz
preconditioner and single-reduction CG, 4 iterations at cg_tol 1e-10.

Tolerances: the χ² traces within 1e-8 relative (the converged χ², ~1e-2
of the first, sits far above rounding), the poses within 1e-8 of their
largest entry, the iterations and the total CG rounds equal, ``comm_budget``'s dict
(``return_stats=True, slice_size=1``) equal key for key. Elastic at D = 2
in segments of 2: interrupted after one segment and resumed, the stitched
trace equals the uninterrupted run's and JAX's within 1e-8, and a snapshot
written by the JAX package after its first segment resumes in the port.
"""

import numpy as np
import pytest

import test_torch_blocks_worker as W
from rustrobotics_tpu.parallel.mesh import make_mesh
from rustrobotics_tpu.parallel.pgo_blocks import (
    block_optimize,
    block_optimize_elastic,
)
from test_torch_block_step import graph_inputs, jax_graphs

WORLDS = (2, 4)
RTOL = 1e-8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("block_optimize")
    graph = jax_graphs(d)["circle"]
    jax_dir = d / "elastic_jax_src"
    np.savez(d / "in.npz", elastic_jax_dir=str(jax_dir),
             **graph_inputs({"circle": graph}))
    procs = W.spawn("optimize", WORLDS, d, d / "in.npz")
    try:
        ref = {}
        kw = dict(segment=W.ELASTIC_SEGMENT, tolerance=0.0,
                  cg_tol=W.OPT_CG_TOL)
        mesh2 = make_mesh(2, axis="blocks")
        # the JAX snapshot after one segment, read by the ranks' last case
        block_optimize_elastic(mesh2, graph, num_iterations=W.ELASTIC_SEGMENT,
                               checkpoint_dir=jax_dir, **kw)
        (jax_dir / "ready").touch()
        g, errs, it = block_optimize_elastic(
            mesh2, graph, num_iterations=W.ELASTIC_ITERATIONS,
            checkpoint_dir=jax_dir, **kw)
        ref["elastic"] = (np.asarray(g.poses2), np.asarray(errs), it, None,
                          None)
        for name, dev, kw in W.OPT_CASES:
            g, errs, it, stats = block_optimize(
                make_mesh(dev, axis="blocks"), graph,
                num_iterations=W.OPT_ITERATIONS, tolerance=0.0,
                cg_tol=W.OPT_CG_TOL, return_stats=True, slice_size=1, **kw)
            ref[(name, dev)] = (np.asarray(g.poses2), np.asarray(errs), it,
                                stats["cg_rounds_total"], stats)
    finally:
        port = W.collect(procs, "optimize", WORLDS, d)
    return graph, ref, port


def _close_trace(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _close_poses(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("name,dev", [c[:2] for c in W.OPT_CASES],
                         ids=[f"{c[0]}-D{c[1]}" for c in W.OPT_CASES])
def test_block_optimize_matches_jax(runs, name, dev):
    _, ref, port = runs
    poses, errs, it, rounds, stats = ref[(name, dev)]
    assert errs[-1] > 1e-3 * errs[0]  # far above rounding
    for rank in range(dev):  # every rank returns the whole graph
        got = port[(dev, rank)]
        _close_trace(got[f"{name}_errors"], errs)
        _close_poses(got[f"{name}_poses2"], poses)
        assert int(got[f"{name}_iterations"]) == it
        assert int(got[f"{name}_rounds"]) == rounds, (
            f"CG rounds: port {int(got[f'{name}_rounds'])}, JAX {rounds}")
        assert str(got[f"{name}_stats"]) == repr(stats)


def test_forcing_cuts_rounds(runs):
    """Eisenstat-Walker forcing takes fewer CG rounds than the fixed
    tolerance on the same graph, in both packages."""
    _, ref, port = runs
    got = port[(2, 0)]
    assert int(got["ew_fast_rounds"]) <= int(got["ew_rounds"]) < int(
        got["gn_rounds"])
    assert ref[("ew", 2)][3] < ref[("gn", 2)][3]


def test_comm_budget_multislice_dcn_matches_jax(runs):
    """The budget's cross-island section (``dcn``), mirroring the JAX
    package's test_comm_budget_multislice_dcn: one slice boundary, halo
    bytes a boundary, and classic CG paying one more traversal a round."""
    from rustrobotics_tpu.parallel.block_layout import (
        build_block_layout as jax_layout,
    )
    from rustrobotics_tpu.parallel.pgo_blocks import comm_budget as jax_budget

    import jax.numpy as jnp
    import torch

    from rustrobotics_tpu_torch.parallel import build_block_layout
    from rustrobotics_tpu_torch.parallel.pgo_blocks import comm_budget
    from test_torch_blocks_worker import graph_of

    graph, _, _ = runs
    layout = build_block_layout(
        graph_of(graph_inputs({"circle": graph}), "circle"), 8)
    jlayout = jax_layout(graph, 8)
    for variant in ("single", "classic"):
        for slice_size in (4, 8, None):
            for dtype, jdtype in ((torch.float64, jnp.float64),
                                  (torch.float32, jnp.float32)):
                got = comm_budget(layout, dtype, gn_iters=4, cg_total=400,
                                  cg_variant=variant, slice_size=slice_size)
                want = jax_budget(jlayout, jdtype, gn_iters=4, cg_total=400,
                                  cg_variant=variant, slice_size=slice_size)
                assert got == want
    b = comm_budget(layout, torch.float64, 4, 400, "single", 4)["dcn"]
    assert b["slices"] == 2 and b["dcn_boundaries"] == 1
    assert b["ici_boundaries"] == 6
    t = {v: comm_budget(layout, torch.float64, 4, 400, v, 4)["dcn"][
        "dcn_traversals_per_gn"] for v in ("single", "classic")}
    assert t["classic"] - t["single"] == pytest.approx(100.0)


def test_elastic_resume_matches_uninterrupted_and_jax(runs):
    _, ref, port = runs
    poses, errs, it, _, _ = ref["elastic"]
    for rank in range(2):
        got = port[(2, rank)]
        assert int(got["elastic_first_iterations"]) == W.ELASTIC_SEGMENT
        assert str(got["elastic_snapshots"]).split(",") == [
            f"block_{i:06d}.npz" for i in range(W.ELASTIC_SEGMENT,
                                                W.ELASTIC_ITERATIONS + 1,
                                                W.ELASTIC_SEGMENT)]
        for case in ("elastic", "elastic_whole", "elastic_from_jax"):
            assert int(got[f"{case}_iterations"]) == it == (
                W.ELASTIC_ITERATIONS)
            _close_trace(got[f"{case}_errors"], errs)
            _close_poses(got[f"{case}_poses2"], poses)
        _close_trace(got["elastic_first"], errs[:W.ELASTIC_SEGMENT + 1])
