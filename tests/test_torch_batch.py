"""The port's fleet path against the JAX package and against its own
unbatched functions, f64 on the CPU: ``stack_graphs`` and the batch
counterpart of ``graph_from_numpy``, the batched assembly and banded
solve, the band assembly's plain version (the K4/K5 job plan), and
``make_optimize_batch`` (JAX: ``jax.vmap`` over ``make_optimize_jit``).

Fleets are a corridor graph and jittered copies of it (numpy seed). The
banded cases use 1024 poses (n=3088, kb=256, nb=13); the dense ones 64.
The tolerances stop the rows at different iterations, which pins the
per-row freeze of the batched loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping.assemble import build_layout as jbuild_layout
from rustrobotics_tpu.mapping.assemble import system_values as jsystem_values
from rustrobotics_tpu.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu.ops import band_chol as jbc
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping.assemble import (
    apply_update,
    build_layout,
    system_values,
)
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    batch_from_numpy,
    graph_from_numpy,
)
from rustrobotics_tpu_torch.mapping.solvers import solve_dense
from rustrobotics_tpu_torch.ops import band_chol as tbc
from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
    band_assemble_kernel,
    band_assemble_plain,
)

JITTER = (0.05, 0.2)  # pose noise of rows 1 and 2; row 0 is the graph
# (graph size, iterations, tolerance per solver): the rows of each fleet
# stop at different iterations (1, 2, 3 on the banded fleet; 1, 2, 3 for
# GN and 1, 4, 5 for LM on the dense one)
CASES = {
    "banded-direct": (1024, 3, {"gauss_newton": 50.0, "lm": 25.0}),
    "dense": (64, 6, {"gauss_newton": 1.0, "lm": 1.0}),
}


def _fleet(num_poses):
    """(JAX graphs, the JAX stacked fleet, the port's fleet, the port's
    graphs)."""
    ref = synthetic_corridor_graph_2d(
        num_poses, num_landmarks=8 if num_poses > 64 else 4,
        closure_span=32 if num_poses > 64 else 8)
    rng = np.random.default_rng(0)
    poses = np.asarray(ref.poses2)
    refs = [ref] + [ref.replace(poses2=jnp.asarray(
        poses + rng.normal(0.0, s, poses.shape))) for s in JITTER]
    stacked = jpgo.stack_graphs(refs)
    fields = {n: np.asarray(getattr(stacked, n))
              for n in FLOAT_FIELDS + INDEX_FIELDS}
    fleet = batch_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                             device="cpu")
    graphs = []
    for r in refs:
        one = {n: np.asarray(getattr(r, n)) for n in FLOAT_FIELDS + INDEX_FIELDS}
        graphs.append(graph_from_numpy(one, r.total_dof, r.prior2, r.prior3,
                                       device="cpu"))
    return refs, stacked, fleet, graphs


_FLEETS = {}


def fleet(num_poses):
    if num_poses not in _FLEETS:
        _FLEETS[num_poses] = _fleet(num_poses)
    return _FLEETS[num_poses]


@pytest.fixture(scope="module")
def big():
    return fleet(1024)


@pytest.fixture(scope="module")
def band(big):
    """The banded plan and the f64 LM-damped systems of the big fleet,
    batched and row by row."""
    _, _, fl, graphs = big
    layout = build_layout(fl)
    bl = tbc.build_band_chol(layout)
    lam = torch.tensor([0.01, 0.02, 0.04], dtype=torch.float64)
    vals, b, chi2 = system_values(fl, lam)
    rows = [system_values(g, float(lam[i])) for i, g in enumerate(graphs)]
    return dict(layout=layout, bl=bl, lam=lam, vals=vals, b=b, chi2=chi2,
                rows=rows)


def assert_rows_close(batched, rows, rtol=1e-12):
    for i, want in enumerate(rows):
        scale = float(want.abs().max())
        np.testing.assert_allclose(batched[i].numpy(), want.numpy(), rtol=rtol,
                                   atol=rtol * scale, err_msg=f"row {i}")


# ------------------------------------------------------------- the fleet


def test_stack_graphs_keeps_structure(big):
    _, _, fl, graphs = big
    stacked = tpgo.stack_graphs(graphs)
    assert stacked.batch_shape == (3,) and fl.batch_shape == (3,)
    assert graphs[0].batch_shape == ()
    for name in FLOAT_FIELDS:
        assert getattr(stacked, name).shape == (
            (3,) + getattr(graphs[0], name).shape), name
        np.testing.assert_array_equal(getattr(stacked, name).numpy(),
                                      getattr(fl, name).numpy(), err_msg=name)
    for name in INDEX_FIELDS:
        assert torch.equal(getattr(stacked, name), getattr(graphs[0], name))
        assert torch.equal(getattr(fl, name), getattr(graphs[0], name))
    assert (stacked.total_dof, stacked.prior2, stacked.prior3) == (
        graphs[0].total_dof, graphs[0].prior2, graphs[0].prior3)
    assert stacked.num_nodes == graphs[0].num_nodes
    assert not stacked.is_3d


def test_stack_graphs_raises_on_another_structure(big):
    _, stacked, _, graphs = big
    other = graphs[1].replace(pp_to=graphs[1].pp_to.flip(0))
    with pytest.raises(ValueError, match="pp_to"):
        tpgo.stack_graphs([graphs[0], other])
    with pytest.raises(ValueError, match="total_dof"):
        tpgo.stack_graphs([graphs[0], graphs[1].replace(total_dof=7)])
    fields = {n: np.asarray(getattr(stacked, n))
              for n in FLOAT_FIELDS + INDEX_FIELDS}
    fields["pl_lm"] = fields["pl_lm"].copy()
    fields["pl_lm"][1] = fields["pl_lm"][1][::-1]
    with pytest.raises(ValueError, match="pl_lm"):
        batch_from_numpy(fields, stacked.total_dof, stacked.prior2,
                         stacked.prior3, device="cpu")


# ---------------------------------------------------- batched assembly


def test_system_values_rows(big, band):
    _, _, fl, graphs = big
    assert band["vals"].shape == (3, band["rows"][0][0].shape[0])
    assert band["b"].shape == (3, fl.total_dof) and band["chi2"].shape == (3,)
    assert_rows_close(band["vals"], [r[0] for r in band["rows"]])
    assert_rows_close(band["b"], [r[1] for r in band["rows"]])
    assert_rows_close(band["chi2"], [r[2] for r in band["rows"]])
    # global_error and apply_update give per-row results
    errs = tpgo.global_error(fl)
    assert_rows_close(errs, [tpgo.global_error(g) for g in graphs])
    dx = torch.as_tensor(np.random.default_rng(1).normal(
        scale=0.1, size=(3, fl.total_dof)))
    moved = apply_update(fl, dx)
    assert_rows_close(moved.poses2, [apply_update(g, dx[i]).poses2
                                     for i, g in enumerate(graphs)])


def test_system_values_match_jax(big, band):
    refs, stacked, _, _ = big
    lam = jnp.asarray(band["lam"].numpy())
    want = jax.jit(jax.vmap(jsystem_values))(stacked, lam)
    for got, w in zip((band["vals"], band["b"], band["chi2"]), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * float(np.abs(w).max()))


def test_prepare_blocks_rows(band):
    bl, vals = band["bl"], band["vals"]
    r_blocks, dinv = tbc._prepare_blocks(bl, vals)
    assert r_blocks.shape == (3, bl.nb, bl.kb, 2 * bl.kb)
    assert dinv.shape == (3, bl.nb * bl.kb)
    rows = [tbc._prepare_blocks(bl, r[0]) for r in band["rows"]]
    assert_rows_close(r_blocks, [r[0] for r in rows])
    assert_rows_close(dinv, [r[1] for r in rows])


def test_band_plan_matches_jax(big, band):
    """The sorted-scatter plan is the JAX package's; seg_ptr bounds its
    segments."""
    refs = big[0]
    jbl = jbc.build_band_chol(jbuild_layout(refs[0]))
    bl = band["bl"]
    for name in ("sel_sorted", "seg_sorted", "uniq_idx"):
        np.testing.assert_array_equal(getattr(bl, name), getattr(jbl, name),
                                      err_msg=name)
    assert bl.seg_ptr[0] == 0 and bl.seg_ptr[-1] == len(bl.sel_sorted)
    np.testing.assert_array_equal(np.diff(bl.seg_ptr),
                                  np.bincount(bl.seg_sorted))


@pytest.mark.parametrize("batched", [False, True])
def test_band_assemble_plain_matches_scatter(band, batched):
    """K4 (one graph) and K5 (the fleet) in their plain form against the
    plain scatter of _prepare_blocks; on the CPU the wrapper is the plain
    version."""
    bl = band["bl"]
    vals = band["vals"] if batched else band["vals"][0]
    want = tbc.scatter_add(bl, vals)
    got = band_assemble_plain(bl, vals)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))
    torch.testing.assert_close(band_assemble_kernel(bl, vals), got, rtol=0,
                               atol=0)
    moved = bl.to("cpu")
    torch.testing.assert_close(band_assemble_plain(moved, vals), got, rtol=0,
                               atol=0)


def test_band_assemble_matches_jax_vmap(big, band):
    """Scaled block rows from the plan's assembly against JAX's
    _prepare_blocks under jax.vmap."""
    refs, stacked, _, _ = big
    jbl = jbc.build_band_chol(jbuild_layout(refs[0]))
    jvals = jnp.asarray(band["vals"].numpy())
    want_r, want_d = jax.vmap(lambda v: jbc._prepare_blocks(jbl, v))(jvals)
    got_r, got_d = tbc._prepare_blocks(band["bl"], band["vals"],
                                       band_assemble_plain)
    for got, want in ((got_r, want_r), (got_d, want_d)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * float(np.abs(want).max()))


def test_factorize_substitute_rows(band):
    bl = band["bl"]
    r_blocks, dinv = tbc._prepare_blocks(bl, band["vals"])
    dsym, lcoup = tbc.split_blocks(r_blocks)
    ldinv, lp = bk.factorize_plain(dsym, lcoup)
    bp = torch.as_tensor(np.random.default_rng(2).normal(
        size=(3, bl.nb, bl.kb)))
    x = bk.substitute_plain(ldinv, lp, bp)
    rows = [bk.factorize_plain(dsym[i], lcoup[i]) for i in range(3)]
    assert_rows_close(ldinv, [r[0] for r in rows])
    assert_rows_close(lp, [r[1] for r in rows])
    assert_rows_close(x, [bk.substitute_plain(*rows[i], bp[i])
                          for i in range(3)])
    # the wrappers take the batch too, and run their plain versions here
    ld_w, lp_w = bk.factorize_kernel(dsym, lcoup)
    torch.testing.assert_close(ld_w, ldinv, rtol=0, atol=0)
    torch.testing.assert_close(bk.substitute_kernel(ldinv, lp, bp), x,
                               rtol=0, atol=0)


@pytest.mark.parametrize("solve", ["banded", "kernel", "dense"])
def test_solve_rows(band, solve):
    bl = band["bl"]
    fn = {"banded": lambda v, b: tbc.solve_band_chol(bl, v, b),
          "kernel": lambda v, b: bk.solve_band_kernel(bl, v, b),
          "dense": lambda v, b: solve_dense(band["layout"], v, b),
          }[solve]
    x = fn(band["vals"], band["b"])
    assert x.shape == band["b"].shape and x.dtype == torch.float64
    rows = [fn(v, b) for v, b, _ in band["rows"]]
    # the kernel solve runs in f32 inside (plain versions on the CPU),
    # where batched and unbatched products round apart: 1e-3 of max|x|,
    # the f32 solve's own distance from f64 on this system
    assert_rows_close(x, rows, rtol=1e-3 if solve == "kernel" else 1e-12)


# ---------------------------------------------------- make_optimize_batch


_JAX_RUNS = {}


def jax_batch(backend, solver):
    """JAX make_optimize_batch on the stacked fleet, cached per case."""
    key = (backend, solver)
    if key not in _JAX_RUNS:
        num_poses, iters, tol = CASES[backend]
        refs, stacked, _, _ = fleet(num_poses)
        run = jpgo.make_optimize_batch(refs[0], num_iterations=iters,
                                       solver=solver, backend=backend,
                                       tolerance=tol[solver])
        g, errors, it = run(stacked)
        _JAX_RUNS[key] = (np.asarray(g.poses2), np.asarray(errors),
                          np.asarray(it))
    return _JAX_RUNS[key]


def assert_trace_close(got, want, rtol, floor=1e-6):
    """Same NaN tail; entries above ``floor`` equal to rtol."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    sel = ~np.isnan(want) & (want > floor)
    assert sel.sum() >= 2
    np.testing.assert_allclose(got[sel], want[sel], rtol=rtol)


@pytest.mark.parametrize("backend", ["banded-direct", "dense"])
@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_make_optimize_batch(backend, solver):
    num_poses, iters, tol = CASES[backend]
    _, _, fl, graphs = fleet(num_poses)
    kw = dict(num_iterations=iters, solver=solver, backend=backend,
              tolerance=tol[solver], device="cpu")
    g, errors, it = tpgo.make_optimize_batch(graphs[0], **kw)(fl)
    assert errors.shape == (3, iters + 1) and it.shape == (3,)
    assert len(set(it.tolist())) == 3, "rows should stop apart"
    # (a) each row against the unbatched loop on that graph
    one = tpgo.make_optimize(graphs[0], **kw)
    for i, gi in enumerate(graphs):
        g1, e1, i1 = one(gi)
        assert int(it[i]) == i1, f"row {i}"
        # batched and unbatched BLAS calls round apart, and the undamped
        # system (1e7 gauge prior) carries that to ~1e-9 of the row's
        # initial χ² in the converged GN tail: hence the atol
        got, want = errors[i].numpy(), e1.numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got[~np.isnan(want)],
                                   want[~np.isnan(want)], rtol=1e-9,
                                   atol=1e-12 * want[0])
        np.testing.assert_allclose(g.poses2[i].numpy(), g1.poses2.numpy(),
                                   atol=1e-8, rtol=0)
    # (b) against JAX's vmapped jit loop on the same stacked inputs
    poses_j, errors_j, it_j = jax_batch(backend, solver)
    np.testing.assert_array_equal(it.numpy(), it_j)
    for i in range(3):
        assert_trace_close(errors[i].numpy(), errors_j[i], rtol=1e-6)
    np.testing.assert_allclose(g.poses2.numpy(), poses_j, atol=1e-8, rtol=0)


def test_make_optimize_batch_kernel_backend_on_cpu():
    """banded-kernel and auto run on the CPU through the plain versions,
    with tolerance 0 every row takes every iteration."""
    _, _, fl, graphs = fleet(64)
    runs = {be: tpgo.make_optimize_batch(graphs[0], num_iterations=3,
                                         backend=be, tolerance=0.0,
                                         device="cpu")(fl)
            for be in ("banded-kernel", "auto", "banded-direct")}
    for be in ("banded-kernel", "auto"):
        _, errors, it = runs[be]
        assert it.tolist() == [3, 3, 3]
        want = runs["banded-direct"][1]
        big = want > 1.0
        torch.testing.assert_close(errors[big], want[big], rtol=1e-3, atol=0)


def test_make_optimize_batch_rejects():
    _, _, fl, graphs = fleet(64)
    with pytest.raises(ValueError, match="device backend"):
        tpgo.make_optimize_batch(graphs[0], backend="host", device="cpu")
    for be in ("cg", "cg-banded", "cg-banded-jnp"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpgo.make_optimize_batch(graphs[0], backend=be, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tpgo.make_optimize_batch(graphs[0], backend="schur", device="cpu")
    run = tpgo.make_optimize_batch(fl, num_iterations=1, device="cpu")
    with pytest.raises(ValueError, match="stack_graphs"):
        run(graphs[0])
