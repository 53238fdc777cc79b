"""The SE2 linearization kernel's CPU side: which graphs take it, its
plan (``build_layout``'s ``linearize_plan``), and its plain version
against ``system_values``.

The kernel itself runs only on a card (``tests/test_torch_kernels_card.py``
holds it to the plain CUDA path); here its plain version
(``se2_linearize_plain``, which the wrapper runs for a CPU graph) writes
the triplet values at the offsets the kernel is given and gathers b by the
plan the kernel reads, and is held to ``system_values``.
"""

import numpy as np
import pytest
import torch

from rustrobotics_tpu_torch.mapping import assemble
from rustrobotics_tpu_torch.mapping.assemble import build_layout, system_values
from rustrobotics_tpu_torch.mapping.pgo import stack_graphs
from rustrobotics_tpu_torch.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu_torch.ops import linearize_kernels as lk

CUDA = torch.device("cuda")
CPU = torch.device("cpu")


@pytest.mark.parametrize("device,dtype,se3_edges,robust,takes", [
    (CUDA, torch.float32, 0, None, True),
    (CPU, torch.float32, 0, None, False),
    (CUDA, torch.float64, 0, None, False),
    (CUDA, torch.float32, 4949, None, False),
    (CUDA, torch.float32, 0, "huber", False),
    (CUDA, torch.float32, 0, "gnc-gm", False),
])
def test_takes_kernel(device, dtype, se3_edges, robust, takes):
    """Only a CUDA f32 graph with no SE3 edge and no robust kernel takes
    the kernel; the predicate reads nothing but its arguments."""
    assert lk.takes_kernel(device, dtype, se3_edges, robust) is takes


def test_cpu_graph_runs_the_plain_code(monkeypatch):
    """system_values on a CPU graph never reaches the kernel's wrapper."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel path ran for a CPU graph")

    monkeypatch.setattr(lk, "se2_linearize_kernel", no_kernel)
    g = _corridor(torch.float32)
    vals, b, chi2 = system_values(g, 0.0)
    assert vals.shape == (build_layout(g).rows.shape[0],)


def _corridor(dtype, num_landmarks=0):
    return synthetic_corridor_graph_2d(192, num_landmarks=num_landmarks,
                                       closure_span=24, device="cpu",
                                       dtype=dtype)


def _fleet(dtype, batch=3):
    g = _corridor(dtype, num_landmarks=6)
    rng = np.random.default_rng(0)
    copies = [g] + [g.replace(
        poses2=g.poses2 + torch.as_tensor(
            rng.normal(0.0, 0.05, g.poses2.shape), dtype=dtype),
        landmarks2=g.landmarks2 + torch.as_tensor(
            rng.normal(0.0, 0.05, g.landmarks2.shape), dtype=dtype))
        for _ in range(batch - 1)]
    return stack_graphs(copies)


GRAPHS = {
    "corridor": lambda dtype: _corridor(dtype),
    "landmarks": lambda dtype: _corridor(dtype, num_landmarks=6),
    "fleet3": lambda dtype: _fleet(dtype),
}


def _parts(graph):
    """The per-edge right-hand side parts in the plan's order, and their
    destination dofs (system_values' index_add_ indices)."""
    from rustrobotics_tpu_torch.mapping import linearize

    *_, bi, bj, _ = linearize.edge_terms_pp_soa(
        graph.poses2, graph.pp_from, graph.pp_to, graph.pp_z, graph.pp_omega)
    *_, li, lj, _ = linearize.edge_terms_pl_soa(
        graph.poses2, graph.landmarks2, graph.pl_pose, graph.pl_lm,
        graph.pl_z, graph.pl_omega)
    batch = graph.batch_shape
    parts = torch.cat([p.reshape(batch + (-1,)) for p in (bi, bj, li, lj)],
                      -1)
    dest = torch.cat([
        (off[None, :] + torch.arange(d)[:, None]).reshape(-1)
        for off, d in ((graph.pose2_offsets[graph.pp_from], 3),
                       (graph.pose2_offsets[graph.pp_to], 3),
                       (graph.pose2_offsets[graph.pl_pose], 3),
                       (graph.lm2_offsets[graph.pl_lm], 2))])
    return parts, dest


@pytest.mark.parametrize("name", ["corridor", "landmarks"])
def test_rhs_plan_lists_each_endpoint_once(name):
    """Each part (an edge endpoint's dof) appears once in the plan, in its
    destination's row, rows in index_add_'s order (ascending part)."""
    g = GRAPHS[name](torch.float64)
    plan = build_layout(g).linearize_plan
    _, dest = _parts(g)
    dest = dest.numpy()
    n_parts = 6 * g.pp_from.shape[0] + 5 * g.pl_pose.shape[0]
    assert plan.src.dtype == np.int32 and plan.ptr.dtype == np.int32
    assert plan.ptr.shape == (g.total_dof + 1,) and plan.ptr[0] == 0
    assert np.array_equal(np.sort(plan.src), np.arange(n_parts))
    counts = np.diff(plan.ptr)
    assert plan.max_degree == counts.max()
    rows = np.repeat(np.arange(g.total_dof), counts)
    assert np.array_equal(dest[plan.src], rows)
    for d in range(g.total_dof):
        assert np.all(np.diff(plan.src[plan.ptr[d]:plan.ptr[d + 1]]) > 0)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_gather_equals_index_add(name):
    """b gathered by the plan equals system_values' index_add_ in f64 (and
    bit for bit: both add each dof's parts from 0 in part order)."""
    g = GRAPHS[name](torch.float64)
    parts, dest = _parts(g)
    want = torch.zeros(g.batch_shape + (g.total_dof,), dtype=torch.float64)
    want.index_add_(-1, dest, parts)
    _, b, _ = lk.se2_linearize_plain(g, 0.0, assemble.PRIOR_WEIGHT,
                                     build_layout(g).linearize_plan.to("cpu"))
    assert torch.equal(-b, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("lam", ["zero", "number", "tensor"])
def test_plain_version_equals_system_values(dtype, name, lam):
    """The kernel's plain version (what the wrapper runs for a CPU graph)
    gives system_values' vals, b and χ², bit for bit in f64 and f32, with
    λ 0, a number, or a tensor of the batch shape (a fleet's λ a row)."""
    g = GRAPHS[name](dtype)
    batch = g.batch_shape
    lam = {"zero": 0.0, "number": 0.01,
           "tensor": torch.linspace(0.1, 0.3, batch.numel()
                                    ).reshape(batch).to(dtype)}[lam]
    want = system_values(g, lam)
    got = lk.se2_linearize_kernel(g, lam, assemble.PRIOR_WEIGHT,
                                  build_layout(g).linearize_plan)
    for w, x in zip(want, got):
        assert x.shape == w.shape and x.dtype == w.dtype
        assert torch.equal(x, w)


def test_vals_layout_matches_build_layout():
    """The plan's offsets are build_layout's triplet order: the
    pose-landmark blocks after the pose-pose ones, the prior's three
    entries and the λ slice, nnz values in all."""
    g = _corridor(torch.float64, num_landmarks=6)
    layout = build_layout(g)
    plan = layout.linearize_plan
    n_pp = g.pp_from.shape[0]
    assert plan.pl_base == 36 * n_pp
    assert plan.prior_base == layout.prior_slice.start
    assert plan.prior_base - plan.pl_base == 25 * g.pl_pose.shape[0]
    assert plan.nnz == layout.rows.shape[0] == layout.lam_slice.stop
    assert plan.nnz - g.total_dof - plan.prior_base == 3
    off = g.pose2_offsets.numpy()
    # the first pose-landmark Hii entry sits on its pose's diagonal
    p = off[g.pl_pose[0]]
    assert (layout.rows[plan.pl_base], layout.cols[plan.pl_base]) == (p, p)
    assert (layout.rows[plan.pl_base - 1], layout.cols[plan.pl_base - 1]) == (
        off[g.pp_to[-1]] + 2, off[g.pp_to[-1]] + 2)


def test_layout_moves_the_plan_once():
    """SystemLayout.to moves the plan's index arrays as int32 tensors, and
    a plan already on a device is not copied again."""
    g = _corridor(torch.float32, num_landmarks=6)
    host = build_layout(g).linearize_plan
    moved = build_layout(g).to(CPU).linearize_plan
    for a, t in ((host.ptr, moved.ptr), (host.src, moved.src)):
        assert t.dtype == torch.int32 and np.array_equal(t.numpy(), a)
    assert moved.to(CPU) is moved
    assert (moved.pl_base, moved.prior_base, moved.nnz) == (
        host.pl_base, host.prior_base, host.nnz)


def test_kernel_rejects_another_graphs_plan():
    """The wrapper refuses a plan whose dof or part counts are not the
    graph's, on any device."""
    g = _corridor(torch.float32, num_landmarks=6)
    other = build_layout(_corridor(torch.float32)).linearize_plan
    with pytest.raises(ValueError, match="not this graph's"):
        lk.se2_linearize_kernel(g, 0.0, assemble.PRIOR_WEIGHT, other)


def test_system_values_builds_the_plan_without_one(monkeypatch):
    """A kernel-path call with no plan writes where build_layout's plan
    says (the wrapper's plain version stands in for the kernel here)."""
    monkeypatch.setattr(lk, "takes_kernel", lambda *args: True)
    seen = []

    def plain(graph, lam, prior_weight, plan):
        seen.append(plan)
        return lk.se2_linearize_plain(graph, lam, prior_weight, plan.to(CPU))

    monkeypatch.setattr(lk, "se2_linearize_kernel", plain)
    g = _corridor(torch.float32, num_landmarks=6)
    got = system_values(g, 0.01)
    want = assemble.system_values_plain(g, 0.01)
    assert len(seen) == 1 and seen[0].nnz == build_layout(g).linearize_plan.nnz
    for x, w in zip(got, want):
        assert torch.equal(x, w)


@pytest.mark.parametrize("entry", ["make_optimize", "make_optimize_batch",
                                   "optimize"])
def test_optimizers_pass_one_plan(monkeypatch, entry):
    """The optimizers build the plan with their layout and hand the same
    plan to every system_values call, so no call rebuilds it."""
    from rustrobotics_tpu_torch.mapping import pgo

    plans = []

    def recording(*args, plan=None, **kwargs):
        plans.append(plan)
        return assemble.system_values(*args, plan=plan, **kwargs)

    monkeypatch.setattr(pgo, "system_values", recording)
    g = _corridor(torch.float32, num_landmarks=6)
    if entry == "make_optimize":
        pgo.make_optimize(g, num_iterations=3, tolerance=0.0,
                          backend="banded-direct", device="cpu")(g)
    elif entry == "make_optimize_batch":
        fleet = _fleet(torch.float32, batch=2).to(dtype=torch.float32)
        pgo.make_optimize_batch(g, num_iterations=3, tolerance=0.0,
                                backend="banded-direct", device="cpu")(fleet)
    else:
        pgo.optimize(g, num_iterations=3, tolerance=0.0,
                     backend="banded-direct", device="cpu")
    assert len(plans) == 3
    assert plans[0] is not None and all(p is plans[0] for p in plans)
    assert plans[0].nnz == build_layout(g).linearize_plan.nnz
