"""The SE2 linearization kernel's CPU side: which graphs take it, its
plan (``build_layout``'s ``linearize_plan``), and its plain version
against ``system_values``.

The kernel itself runs only on a card (``tests/test_torch_kernels_card.py``
holds it to the plain CUDA path); here its plain version
(``se2_linearize_plain``, which the wrapper runs for a CPU graph) writes
the triplet values at the offsets the kernel is given and gathers b by the
plan the kernel reads, and is held to ``system_values``.
"""

import math

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
    (CUDA, torch.float32, 0, "gnc-gm", True),
    (CUDA, torch.float32, 0, "cauchy", False),
    (CUDA, torch.float32, 0, "barron", False),
    (CPU, torch.float32, 0, "gnc-gm", False),
    (CUDA, torch.float64, 0, "gnc-gm", False),
    (CUDA, torch.float32, 4949, "gnc-gm", False),
])
def test_takes_kernel(device, dtype, se3_edges, robust, takes):
    """Only a CUDA f32 graph with no SE3 edge, by least squares or under
    GNC Geman-McClure, takes the kernels: Huber, Cauchy and Barron, SE3
    edges, f64 and the CPU keep the tensor code. The predicate reads
    nothing but its arguments."""
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

    def plain(graph, lam, prior_weight, plan, **robust):
        seen.append(plan)
        return lk.se2_linearize_plain(graph, lam, prior_weight, plan.to(CPU),
                                      **robust)

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


def _gnc_mu(kind, graph):
    """GNC's μ as the optimizer loops pass it: None (1), a number, or a
    tensor of the batch shape (one μ a fleet row)."""
    if kind == "tensor":
        batch = graph.batch_shape
        return torch.linspace(3.0, 40.0, batch.numel()).reshape(batch).to(
            graph.dtype)
    return {"none": None, "number": 7.5}[kind]


def _with_outliers(graph):
    """The graph with every fifth loop closure's measurement moved by 2 m
    and 1 rad, so that GNC's weights span (0, 1)."""
    closure = (graph.pp_to - graph.pp_from).abs() != 1
    bad = torch.nonzero(closure).flatten()[::5]
    z = graph.pp_z.clone()
    z[..., bad, :] += torch.tensor([2.0, -2.0, 1.0], dtype=z.dtype)
    return graph.replace(pp_z=z)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("mu", ["none", "number", "tensor"])
@pytest.mark.parametrize("edges", ["closures", "all"])
def test_gnc_plain_version_equals_system_values(dtype, name, mu, edges):
    """Under GNC Geman-McClure the kernel's plain version gives
    system_values_plain's vals, b and χ² bit for bit: each weighted edge's
    blocks and parts scaled by its weight at its graph's μ, odometry at
    weight 1 under robust_edges="closures"."""
    g = _with_outliers(GRAPHS[name](dtype))
    kw = dict(robust="gnc-gm", robust_delta=1.5, mu=_gnc_mu(mu, g),
              robust_edges=edges)
    want = assemble.system_values_plain(g, 0.01, **kw)
    got = lk.se2_linearize_kernel(g, 0.01, assemble.PRIOR_WEIGHT,
                                  build_layout(g).linearize_plan, **kw)
    for w, x in zip(want, got):
        assert x.shape == w.shape and x.dtype == w.dtype
        assert torch.equal(x, w)
    assert not torch.equal(got[0], lk.se2_linearize_plain(
        g, 0.01, assemble.PRIOR_WEIGHT,
        build_layout(g).linearize_plan.to(CPU))[0])


def _kernel_scale(mu, delta, batch, weights):
    """GNC's s as csrc/se2_linearize.cu forms it from ``_gnc_scale``'s
    arguments, in f32 operations: (μ factor) factor for the weights, μ
    factor for the costs, each of the batch shape with the edge axis; and
    whether μ came as a tensor."""
    mu_t, _, value, factor = lk._gnc_scale(mu, delta, batch, CPU, weights)
    f = torch.tensor(factor, dtype=torch.float32)
    m = (mu_t.reshape(batch) if mu_t is not None
         else torch.tensor(value, dtype=torch.float32))
    return (m * f * f if weights else m * f)[..., None], mu_t is not None


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("delta", [1.0, 1.5, 0.3])
@pytest.mark.parametrize("mu", ["none", "number", "tensor"])
def test_kernel_gnc_scale_is_the_tensor_codes(batch, delta, mu):
    """The kernels' GNC arithmetic on the scale ``_gnc_scale`` passes them
    (csrc/se2_linearize.cu's gnc_weight and gnc_rho, written here as f32
    operations) gives assemble.robust_weight's and robust_rho's bits for μ
    None, a number and a tensor, at δ 1 and away from it: a number's s is
    formed in double as the tensor code forms it, and divided as torch
    divides a number by a tensor (its reciprocal times the number)."""
    gen = torch.Generator().manual_seed(5)
    c2 = torch.exp(torch.empty(batch + (64,)).uniform_(-12.0, 12.0,
                                                      generator=gen))
    if mu == "tensor":
        mu_v = torch.linspace(3.0, 40.0, max(1, math.prod(batch))).reshape(
            batch)
    else:
        mu_v = {"none": None, "number": 7.5}[mu]
    s, tensor = _kernel_scale(mu_v, delta, batch, weights=True)
    q = s / (c2 + s) if tensor else torch.reciprocal(c2 + s) * s
    want = assemble.robust_weight("gnc-gm", c2, delta, mu=mu_v)
    assert torch.equal((q * q).view(torch.int32), want.view(torch.int32))
    s, _ = _kernel_scale(mu_v, delta, batch, weights=False)
    want = assemble.robust_rho("gnc-gm", c2, delta, mu=mu_v)
    assert torch.equal(((s * c2) / (s + c2)).view(torch.int32),
                       want.view(torch.int32))


def test_kernels_refuse_other_robust_kernels():
    g = _corridor(torch.float32)
    plan = build_layout(g).linearize_plan
    with pytest.raises(ValueError, match="gnc-gm"):
        lk.se2_linearize_kernel(g, 0.0, assemble.PRIOR_WEIGHT, plan,
                                robust="cauchy")
    with pytest.raises(ValueError, match="gnc-gm"):
        lk.se2_cost_kernel(g, robust="huber")
    with pytest.raises(ValueError, match="robust run"):
        lk.se2_cost_kernel(g, current=g)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("robust", [None, "gnc-gm"])
@pytest.mark.parametrize("edges", ["closures", "all"])
def test_cost_plain_version_matches_pgo(name, robust, edges):
    """The cost kernel's plain version in f64 gives pgo.global_error and
    pgo.robust_global_cost (the CPU's tensor code, another arithmetic for
    e^T Ω e) to 1e-12, at the trial and at the current graph."""
    from rustrobotics_tpu_torch.mapping import pgo

    cur = _with_outliers(GRAPHS[name](torch.float64))
    trial = cur.replace(poses2=cur.poses2 + 0.01)
    mu = _gnc_mu("tensor", cur)
    kw = dict(robust=robust, robust_delta=1.5, mu=mu, robust_edges=edges)
    chi2, rho, rho_cur = lk.se2_cost_kernel(
        trial, current=cur if robust else None, **kw)
    close = dict(rtol=1e-12, atol=0)
    torch.testing.assert_close(chi2, pgo.global_error(trial), **close)
    if robust is None:
        assert rho is None and rho_cur is None
        return
    for got, g in ((rho, trial), (rho_cur, cur)):
        torch.testing.assert_close(got, pgo.robust_global_cost(
            g, robust, 1.5, mu=mu, robust_edges=edges), **close)


def _cpu_costs(graph, robust, mu):
    """Σ e^T Ω e and Σ ρ(e^T Ω e), odometry quadratic, from the residuals'
    definitions (linearize.residual_pp / residual_pl, quad_form)."""
    from rustrobotics_tpu_torch.mapping import linearize

    c_pp = linearize.quad_form(linearize.residual_pp(
        graph.poses2[..., graph.pp_from, :], graph.poses2[..., graph.pp_to, :],
        graph.pp_z), graph.pp_omega)
    c_pl = linearize.quad_form(linearize.residual_pl(
        graph.poses2[..., graph.pl_pose, :],
        graph.landmarks2[..., graph.pl_lm, :], graph.pl_z), graph.pl_omega)
    rho_pp = torch.where(assemble.odometry(graph.pp_from, graph.pp_to), c_pp,
                         assemble.robust_rho(robust, c_pp, 1.5, mu=mu))
    rho_pl = assemble.robust_rho(robust, c_pl, 1.5, mu=mu)
    return (c_pp.sum(-1) + c_pl.sum(-1),
            rho_pp.sum(-1) + rho_pl.sum(-1))


@pytest.mark.parametrize("robust", [None, "huber", "cauchy", "barron",
                                    "gnc-gm"])
@pytest.mark.parametrize("name", ["landmarks", "fleet3"])
def test_cpu_costs_keep_the_tensor_code(monkeypatch, robust, name):
    """On the CPU global_error and robust_global_cost never reach the cost
    kernel's wrapper, and give the tensor code's sums bit for bit."""
    from rustrobotics_tpu_torch.mapping import pgo

    def no_kernel(*args, **kwargs):
        raise AssertionError("the cost kernel ran for a CPU graph")

    monkeypatch.setattr(lk, "se2_cost_kernel", no_kernel)
    g = _with_outliers(GRAPHS[name](torch.float32))
    mu = _gnc_mu("tensor", g) if robust == "gnc-gm" else None
    chi2, rho = _cpu_costs(g, robust, mu)
    assert torch.equal(pgo.global_error(g), chi2)
    assert torch.equal(pgo.robust_global_cost(g, robust, 1.5, mu=mu),
                       chi2 if robust is None else rho)


@pytest.mark.parametrize("entry", ["make_optimize", "make_optimize_batch"])
@pytest.mark.parametrize("robust", [None, "gnc-gm"])
def test_lm_loops_take_the_kernels_when_the_graph_does(monkeypatch, entry,
                                                       robust):
    """With the kernels admitted (their plain versions standing in on the
    CPU), LM's loops linearize through the kernel once an iteration, at
    each row's μ, and take each accept test's costs from one cost-kernel
    call with the current graph; the χ² trace follows the tensor code's."""
    from rustrobotics_tpu_torch.mapping import pgo

    g = _with_outliers(_corridor(torch.float64))
    fleet = stack_graphs([g, g.replace(poses2=g.poses2 + 0.02)])
    graph = g if entry == "make_optimize" else fleet
    make = getattr(pgo, entry)
    kw = dict(num_iterations=6, solver="lm", tolerance=0.0,
              backend="banded-direct", device="cpu", robust=robust)
    _, want, _ = make(g, **kw)(graph)
    calls = {"linearize": [], "cost": []}

    def linearize(graph, lam, prior_weight, plan, **gnc):
        calls["linearize"].append(gnc.get("mu"))
        return lk.se2_linearize_plain(graph, lam, prior_weight,
                                      plan.to(CPU), **gnc)

    def cost(graph, robust=None, robust_delta=1.0, mu=None,
             robust_edges="closures", current=None):
        calls["cost"].append(current)
        return lk.se2_cost_plain(graph, robust, robust_delta, mu,
                                 robust_edges, current)

    monkeypatch.setattr(lk, "takes_kernel", lambda *args: True)
    monkeypatch.setattr(lk, "se2_linearize_kernel", linearize)
    monkeypatch.setattr(lk, "se2_cost_kernel", cost)
    _, got, it = make(g, **kw)(graph)
    assert len(calls["linearize"]) == 6
    # the first χ² and each accept test: one call each
    assert len(calls["cost"]) == 7
    if robust:
        assert all(torch.is_tensor(m) and m.shape == graph.batch_shape
                   for m in calls["linearize"])
        assert all(c is not None for c in calls["cost"][1:])
    else:
        assert calls["cost"] == [None] * 7
    torch.testing.assert_close(got, want, rtol=1e-9, atol=0)
