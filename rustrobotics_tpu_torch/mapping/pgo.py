"""Pose-graph optimizer: Gauss-Newton and Levenberg-Marquardt (counterpart
of ``rustrobotics_tpu/mapping/pgo.py``).

Per iteration: build the linear system, solve, retract every node. LM
accepts or rejects the step with λ /= 2 or rollback + λ *= 2; the error
history records the trial χ², rejected steps included (the reference
optimizer's trace layout).

Three drivers:
- ``optimize``            : host loop, one host read of χ² and ‖dx‖ per
                            iteration;
- ``make_optimize``       : the device loop (counterpart of
                            ``make_optimize_jit``): every value stays on
                            the device, the trace is a (iters+1,) tensor;
- ``make_optimize_batch`` : the same loop over a fleet of same-structure
                            graphs (``stack_graphs``), the counterpart of
                            ``jax.vmap`` over ``make_optimize_jit``.

Backends: ``banded-kernel`` (the CUDA kernels; ``auto`` on the card),
``banded-direct`` (the same chain in plain PyTorch; ``auto`` on the CPU),
``banded-cr`` (cyclic reduction), ``banded-mixed`` (CG preconditioned by a
low-precision cyclic-reduction factor), ``dense``, ``schur`` (landmarks
eliminated), ``cg`` (block-Jacobi PCG on the ELL operator), ``cg-banded``
(the PCG on the block-banded operator, its SpMV the CUDA kernel K3 on the
card and plain on the CPU), ``cg-banded-jnp`` (the plain SpMV everywhere;
the JAX package's name), the host solvers ``host`` (SuperLU) and
``native`` (the C++ LDL^T), and ``auto-measure``, which times one solve of
the template's system by every banded candidate and keeps the fastest
(``_measure_backend``). ``optimize`` takes every name but the banded PCG's;
``make_optimize`` and ``make_optimize_batch`` take every device backend
(not ``host`` or ``native``), as the JAX package's drivers do. The drivers
expose the backend they run: ``OptimizeResult.backend`` and the
``backend`` attribute of a returned ``run`` (with ``backend_times``, each
measured candidate's seconds, after ``auto-measure``).

Every driver takes SE2 and SE3 graphs and the robust kernels of
``assemble.robust_weight``: a robust LM run accepts a step on the robust
surrogate (``robust_global_cost``) at the current GNC μ, and ``gnc-gm``
anneals μ from μ0 (``max_edge_chi2``, capped at ``GNC_MU0_CAP``) to 1 at
60% of the iteration budget; the loop does not stop while μ > 1.

Uncertainty: ``marginal_variances`` and ``pose_covariances`` (the banded
selected inverse; K4 + K1 for f32 values on the card).

``PoseGraph`` wraps ``optimize`` for a user: a g2o path or a graph in, the
χ² trace out, the estimates and the iteration count kept, plots per
iteration on request.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from rustrobotics_tpu_torch.device import resolve_device
from rustrobotics_tpu_torch.mapping import solvers
from rustrobotics_tpu_torch.mapping.assemble import (
    GNC_MU0_CAP,
    PRIOR_WEIGHT,
    apply_update,
    build_layout,
    dense_hessian,
    odometry,
    robust_rho,
    system_values,
)
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    PoseGraphData,
    load_g2o,
)
from rustrobotics_tpu_torch.mapping.linearize import (
    quad_form,
    residual_pl,
    residual_pp,
    residual_qq,
)
from rustrobotics_tpu_torch.ops import linearize_kernels
from rustrobotics_tpu_torch.utils.metrics import span, spanned

BACKENDS = ("auto", "auto-measure", "banded-kernel", "banded-direct",
            "banded-cr", "banded-mixed", "dense", "schur", "host", "native",
            "cg", "cg-banded", "cg-banded-jnp")
# the host solvers: optimize's alone, as in the JAX package
HOST_BACKENDS = ("host", "native")


def _edge_chi2(graph: PoseGraphData):
    """Per-edge e^T Ω e of the three edge families, (..., E) each; a
    family without edges costs no device work."""
    families = (
        (residual_pp, graph.poses2, graph.pp_from, graph.poses2,
         graph.pp_to, graph.pp_z, graph.pp_omega),
        (residual_pl, graph.poses2, graph.pl_pose, graph.landmarks2,
         graph.pl_lm, graph.pl_z, graph.pl_omega),
        (residual_qq, graph.poses3, graph.qq_from, graph.poses3,
         graph.qq_to, graph.qq_z, graph.qq_omega))
    out = []
    for residual, nodes_i, idx_i, nodes_j, idx_j, z, omega in families:
        if idx_i.shape[0]:
            e = residual(nodes_i[..., idx_i, :], nodes_j[..., idx_j, :], z)
            out.append(quad_form(e, omega))
        else:
            out.append(z.new_zeros(graph.batch_shape + (0,)))
    return out


def _takes_cost_kernel(graph: PoseGraphData, robust) -> bool:
    return linearize_kernels.takes_kernel(graph.device, graph.dtype,
                                          graph.qq_from.shape[0], robust)


@spanned("update")
def global_error(graph: PoseGraphData) -> torch.Tensor:
    """Σ e^T Ω e over all edges, a tensor of the graph's batch shape (0-d
    for one graph) on its device. A graph that takes the SE2 kernels
    (``linearize_kernels.takes_kernel``) is summed by the cost kernel, in
    a fixed order."""
    if _takes_cost_kernel(graph, None):
        return linearize_kernels.se2_cost_kernel(graph)[0]
    return sum(c.sum(-1) for c in _edge_chi2(graph))


def max_edge_chi2(graph: PoseGraphData) -> torch.Tensor:
    """Largest per-edge squared Mahalanobis error (0 at least), of the
    graph's batch shape: seeds the GNC continuation parameter
    mu0 = max(1, 2 r_max^2 / c^2)."""
    mx = torch.zeros(graph.batch_shape, dtype=graph.dtype,
                     device=graph.device)
    for c in _edge_chi2(graph):
        if c.shape[-1]:
            mx = torch.maximum(mx, c.amax(-1))
    return mx


@spanned("update")
def robust_global_cost(graph: PoseGraphData, robust, delta, alpha=-2.0,
                       mu=None, robust_edges="closures"):
    """Sum of per-edge robust losses rho(e^T Ω e), the objective a robust
    run minimizes; odometry pose-pose edges stay quadratic under
    robust_edges="closures", as in system_values. robust=None gives the
    raw χ² of ``global_error``. ``mu`` may carry the batch shape. A graph
    that takes the SE2 kernels (least squares or "gnc-gm") is costed by the
    cost kernel."""
    if _takes_cost_kernel(graph, robust):
        chi2, rho, _ = linearize_kernels.se2_cost_kernel(
            graph, robust, delta, mu, robust_edges)
        return chi2 if robust is None else rho
    c_pp, c_pl, c_qq = _edge_chi2(graph)
    total = torch.zeros(graph.batch_shape, dtype=graph.dtype,
                        device=graph.device)
    for c, fr, to in ((c_pp, graph.pp_from, graph.pp_to),
                      (c_pl, None, None),
                      (c_qq, graph.qq_from, graph.qq_to)):
        if not c.shape[-1]:
            continue
        rho = robust_rho(robust, c, delta, alpha=alpha, mu=mu)
        if robust and robust_edges == "closures" and fr is not None:
            rho = torch.where(odometry(fr, to), c, rho)
        total = total + rho.sum(-1)
    return total


def _accept_costs(trial: PoseGraphData, current: PoseGraphData, robust,
                  delta, alpha, mu):
    """What LM's accept test compares: (the trial's Σ e^T Ω e, its robust
    cost at μ, the current graph's robust cost at μ), the costs None
    without a robust kernel. A graph on the SE2 kernels' path gets all
    three from one launch of the cost kernel, in one order for both
    graphs; else ``global_error`` and ``robust_global_cost``."""
    if robust is not None and _takes_cost_kernel(trial, robust):
        return linearize_kernels.se2_cost_kernel(trial, robust, delta, mu,
                                                 current=current)
    error = global_error(trial)
    if robust is None:
        return error, None, None
    return (error, robust_global_cost(trial, robust, delta, alpha=alpha,
                                      mu=mu),
            robust_global_cost(current, robust, delta, alpha=alpha, mu=mu))


def gnc_mu0(graph: PoseGraphData, robust_delta) -> torch.Tensor:
    """GNC's first μ, of the graph's batch shape: 2 r_max² / c² clamped
    to [1, GNC_MU0_CAP]."""
    mu0 = 2.0 * max_edge_chi2(graph) / (robust_delta * robust_delta)
    return torch.clamp(torch.clamp(mu0, min=1.0), max=GNC_MU0_CAP)


def gnc_iterations(num_iterations: int) -> int:
    """The iteration at which GNC's μ reaches 1: 60% of the budget."""
    return max(1, int(round(0.6 * num_iterations)))


@dataclasses.dataclass
class OptimizeResult:
    graph: PoseGraphData
    errors: list  # χ² before each recorded step (reference-trace layout)
    norms: list  # ‖dx‖ per iteration
    iterations: int
    backend: str | None = None  # the backend that ran (auto-measure's pick)


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure_backend(graph_template: PoseGraphData, layout, device):
    """Pick the fastest banded backend on this device by timing solves of
    the template's undamped normal equations: ``banded-direct``,
    ``banded-cr`` and ``banded-mixed``, and ``banded-kernel`` on the card
    (where the JAX package adds ``banded-pallas`` on a TPU). Each
    candidate solves once, then three times timed (host clock between
    ``torch.cuda.synchronize`` calls), and keeps its best. A candidate
    that returns None (bandwidth too large) or a non-finite x is
    disqualified. Returns (name, {candidate: seconds}); "dense" when no
    candidate qualified.

    One deviation from the JAX package: a candidate that raises is not
    skipped. Skipping it would hide a kernel that failed to build or
    launch, so the exception propagates."""
    g = graph_template.to(device=device)
    vals, b, _ = system_values(g, 0.0, plan=layout.linearize_plan)
    candidates = {"banded-direct": solvers.make_banded_direct,
                  "banded-cr": solvers.make_banded_cr,
                  "banded-mixed": solvers.make_banded_mixed}
    if device.type == "cuda":
        candidates["banded-kernel"] = solvers.make_banded_kernel
    times = {}
    for name, make in candidates.items():
        solve = make(layout, device=device)
        if solve is None:
            continue
        if not bool(torch.isfinite(solve(vals, b)).all()):
            continue
        best = math.inf
        for _ in range(3):
            _synchronize(device)
            t0 = time.perf_counter()
            solve(vals, b)
            _synchronize(device)
            best = min(best, time.perf_counter() - t0)
        times[name] = best
    if not times:
        return "dense", times
    return min(times, key=times.get), times


def _resolve_backend(graph, layout, backend: str, device: torch.device):
    """(backend, measured times) for a backend name: ``auto`` is
    ``banded-kernel`` on the card and ``banded-direct`` on the CPU;
    ``auto-measure`` times the banded candidates on ``graph``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "auto":
        return ("banded-kernel" if device.type == "cuda"
                else "banded-direct"), {}
    if backend == "auto-measure":
        return _measure_backend(graph, layout, device)
    return backend, {}


def _make_solve(layout, backend: str, device: torch.device, cg_tol=1e-10,
                cg_maxiter=None):
    """solve(vals, b) -> dx for a resolved backend name (not ``auto`` or
    ``auto-measure``). ``cg`` always runs up to 4·n rounds (the JAX
    package's ``make_optimize_jit`` does not pass ``cg_maxiter`` to it);
    the banded PCG takes ``cg_maxiter``, and None means
    ``jax.scipy.sparse.linalg.cg``'s 10·n. The banded backends fall back
    to ``dense`` when the RCM bandwidth is too large, as in the JAX
    package."""
    host_solvers = {"host": solvers.solve_host,
                    "native": solvers.solve_native,
                    "schur": solvers.solve_schur}
    if backend in host_solvers:
        # these plan on the host layout (schur splits the triplets there)
        solve = host_solvers[backend]
        return lambda vals, b: solve(layout, vals, b)
    dev_layout = layout.to(device)

    def dense(vals, b):
        return solvers.solve_dense(dev_layout, vals, b)

    if backend == "dense":
        return dense
    if backend == "cg":
        return lambda vals, b: solvers.solve_cg(dev_layout, vals, b,
                                                tol=cg_tol)
    if backend in ("cg-banded", "cg-banded-jnp"):
        from rustrobotics_tpu_torch.ops.banded import build_banded

        blayout = build_banded(layout).to(device)
        maxiter = 10 * layout.n if cg_maxiter is None else cg_maxiter
        use_kernel = backend == "cg-banded"
        return lambda vals, b: solvers.solve_cg_banded(
            dev_layout, blayout, vals, b, tol=cg_tol, maxiter=maxiter,
            use_kernel=use_kernel)
    make = {"banded-kernel": solvers.make_banded_kernel,
            "banded-direct": solvers.make_banded_direct,
            "banded-cr": solvers.make_banded_cr,
            "banded-mixed": solvers.make_banded_mixed}[backend]
    # bandwidth too large for the banded layout: dense is the right call
    return make(layout, device=device) or dense


@spanned("request")
def optimize(
    graph: PoseGraphData,
    num_iterations: int = 50,
    solver: str = "gauss_newton",
    backend: str = "host",
    tolerance: float = 1e-4,
    prior_weight: float = PRIOR_WEIGHT,
    robust: str | None = None,
    robust_delta: float = 1.0,
    robust_alpha: float = -2.0,
    log: bool = False,
    callback=None,
    device=None,
) -> OptimizeResult:
    """Host-driven optimization loop (reference semantics).
    ``robust``/``robust_delta``/``robust_alpha``: optional IRLS
    reweighting of outlier edges (``assemble.robust_weight``); "gnc-gm"
    anneals μ from μ0 to 1 across the iterations. Every backend but the
    banded PCG's; the result's ``backend`` is the one that ran."""
    if backend in ("cg-banded", "cg-banded-jnp"):
        # as in the JAX package, the banded PCG is make_optimize's alone
        raise ValueError(f"backend {backend!r} runs in make_optimize only")
    device = resolve_device(device)
    graph = graph.to(device=device)
    layout = build_layout(graph)
    plan = layout.linearize_plan.to(device)
    dtype = graph.dtype
    backend, _ = _resolve_backend(graph, layout, backend, device)
    solve_fn = _make_solve(layout, backend, device)
    gnc = robust == "gnc-gm"
    mu = mu0 = 1.0
    # geometric continuation schedule reaching mu = 1 at 60% of the budget
    k_gnc = gnc_iterations(num_iterations)
    if gnc:
        mu = mu0 = float(gnc_mu0(graph, robust_delta))

    def cost(g, mu_):
        return float(robust_global_cost(g, robust, robust_delta,
                                        alpha=robust_alpha, mu=mu_))

    lm = solver in ("lm", "levenberg_marquardt")
    lam = 0.01  # λ0
    last_error = float(global_error(graph))
    errors = [last_error]
    norms = []
    if log:
        print(f"Loaded graph with {graph.num_nodes} nodes and "
              f"{graph.num_edges} edges")
        print(f"initial error :{last_error:.5f}")
    cur_cost = None  # carried robust cost (valid while mu is constant)

    it = 0
    for it in range(1, num_iterations + 1):
        vals, b, _ = system_values(graph, lam if lm else 0.0, prior_weight,
                                   robust=robust, robust_delta=robust_delta,
                                   robust_alpha=robust_alpha, mu=mu,
                                   plan=plan)
        dx = solve_fn(vals, b).to(dtype)
        prev_graph = graph
        graph = apply_update(graph, dx)
        norm_dx = float(torch.linalg.vector_norm(dx))
        error = float(global_error(graph))
        if lm:
            if robust is None:
                accept = error <= last_error
            else:
                # accept on the robust surrogate at the current mu; a
                # fixed kernel's mu never changes, so the previous
                # iteration's cost is reused; GNC re-evaluates
                trial = cost(graph, mu)
                cur = cost(prev_graph, mu) if gnc or cur_cost is None \
                    else cur_cost
                accept = trial <= cur
                cur_cost = trial if accept else cur
            if not accept:  # NaN-safe reject
                graph = prev_graph
                lam *= 2.0
            else:
                lam /= 2.0
        if not math.isnan(error):
            last_error = error  # recorded unconditionally, as the reference
        norms.append(norm_dx)
        errors.append(error)
        if log:
            print(f"step {it:3} : |dx| = {norm_dx:3.5f}, error = {error:3.5f}")
        if callback is not None:
            callback(it, graph, error, norm_dx, lam)
        if gnc:
            mu = mu0 ** max(0.0, 1.0 - it / k_gnc)
        # a GNC surrogate can converge while mu is still annealing: keep
        # iterating until the continuation has reached the target loss
        if norm_dx < tolerance and not (gnc and mu > 1.0):
            break

    return OptimizeResult(graph=graph, errors=errors, norms=norms,
                          iterations=it, backend=backend)


_NODE_FIELDS = ("poses2", "landmarks2", "poses3")


def _gnc_mu(mu0, it, k_gnc):
    """μ(it) = μ0^(1 - it/k) clamped at 1, the device loops' schedule;
    ``it`` is a count, or a tensor of counts (one a fleet row). The
    fraction is taken in f32, as ``make_optimize_jit`` takes it (its
    count is int32, and int32 / int is f32 in JAX)."""
    if torch.is_tensor(it):
        frac = torch.clamp(1.0 - it.float() / k_gnc, 0.0, 1.0)
    else:
        frac = float(np.clip(np.float32(1.0) - np.float32(it)
                             / np.float32(k_gnc), 0.0, 1.0))
    return torch.exp(torch.log(mu0) * frac).to(mu0.dtype)


def make_optimize(
    graph_template: PoseGraphData,
    num_iterations: int = 50,
    solver: str = "gauss_newton",
    backend: str = "dense",
    tolerance: float = 1e-4,
    prior_weight: float = PRIOR_WEIGHT,
    robust: str | None = None,
    robust_delta: float = 1.0,
    robust_alpha: float = -2.0,
    cg_tol: float = 1e-10,
    cg_maxiter: int | None = None,
    device=None,
):
    """Build an optimizer for graphs with this template's structure.
    Returns run(graph) -> (graph, errors (iters+1,), iterations): the
    errors tensor is NaN past the last recorded entry.

    ``cg_tol`` sets the PCG of the ``cg`` and ``cg-banded`` backends and
    ``cg_maxiter`` that of ``cg-banded`` (None: 10·n rounds); ``cg`` runs
    up to 4·n rounds whatever ``cg_maxiter`` says, as the JAX package's
    ``make_optimize_jit`` does. f32 does not reach the default 1e-10, so
    an f32 run passes its own, e.g. ``cg_tol=1e-6, cg_maxiter=400``. On
    the card ``cg-banded`` needs an f32 graph: K3 is f32 only. ``host``
    and ``native`` are not device backends and raise ValueError, as in the
    JAX package. ``auto-measure`` times the banded candidates on the
    template's system once, here; ``run.backend`` names the backend that
    runs and ``run.backend_times`` holds the measured seconds.

    Robust runs (``robust``, ``robust_delta``, ``robust_alpha``) mirror
    ``make_optimize_jit``: LM accepts a step on the robust surrogate at
    the current GNC μ, μ(it) anneals from μ0 to 1 at 60% of the budget,
    and a GNC loop does not stop on ‖dx‖ before then.

    The loop keeps every value on the device. Its one host read per
    iteration is the convergence test ``‖dx‖ < tolerance``, skipped when
    tolerance <= 0 (nothing can pass it); capturing the step in a CUDA
    graph is later work."""
    if backend in HOST_BACKENDS:
        raise ValueError(f"jit path needs a device backend, got {backend!r}")
    device = resolve_device(device)
    layout = build_layout(graph_template)
    plan = layout.linearize_plan.to(device)
    backend, times = _resolve_backend(graph_template, layout, backend, device)
    solve = _make_solve(layout, backend, device, cg_tol=cg_tol,
                        cg_maxiter=cg_maxiter)
    lm = solver in ("lm", "levenberg_marquardt")
    gnc = robust == "gnc-gm"
    k_gnc = gnc_iterations(num_iterations)
    robust_kw = dict(robust=robust, robust_delta=robust_delta,
                     robust_alpha=robust_alpha, plan=plan)

    def step_lm(g, lam, last_error, mu, errors, it):
        vals, b, _ = system_values(g, lam, prior_weight, mu=mu, **robust_kw)
        dx = solve(vals, b)
        new_g = apply_update(g, dx)
        with span("lm.accept"):
            error, trial, cur = _accept_costs(new_g, g, robust, robust_delta,
                                              robust_alpha, mu)
            # NaN-safe reject: a non-finite trial error (e.g. f32 Cholesky
            # breakdown at small λ) counts as a rejection; a robust run
            # compares the surrogate at the current mu, on both sides
            reject = ~(error <= last_error if robust is None
                       else trial <= cur)
            g = g.replace(**{f: torch.where(reject, getattr(g, f),
                                            getattr(new_g, f))
                             for f in _NODE_FIELDS})
            lam = torch.where(reject, lam * 2.0, lam / 2.0)
            errors[it + 1] = error
            # the trial error is recorded unconditionally; keep the old one
            # only when the trial was NaN, so one bad solve cannot poison
            # every later accept test
            last_error = torch.where(torch.isnan(error), last_error, error)
        return g, lam, last_error, dx

    def step_gn(g, mu, errors, it):
        # system_values' χ² is the error of the current graph, so GN needs
        # no separate global_error per iteration
        vals, b, chi2 = system_values(g, 0.0, prior_weight, mu=mu,
                                      **robust_kw)
        errors[it] = chi2
        dx = solve(vals, b)
        return apply_update(g, dx), dx

    @spanned("request")
    def run(graph: PoseGraphData):
        g = graph.to(device=device)
        dtype = g.dtype
        errors = torch.full((num_iterations + 1,), math.nan, dtype=dtype,
                            device=device)
        lam = torch.tensor(0.01, dtype=dtype, device=device)
        mu0 = gnc_mu0(g, robust_delta) if gnc else None
        if lm:
            errors[0] = global_error(g)
            last_error = errors[0].clone()
        it = 0
        while it < num_iterations:
            mu = _gnc_mu(mu0, it, k_gnc) if gnc else None
            if lm:
                g, lam, last_error, dx = step_lm(g, lam, last_error, mu,
                                                 errors, it)
            else:
                g, dx = step_gn(g, mu, errors, it)
            it += 1
            # a GNC surrogate can converge while mu is still annealing
            if (tolerance > 0 and (not gnc or it >= k_gnc)
                    and bool(torch.linalg.vector_norm(dx) < tolerance)):
                break
        if not lm:
            errors[it] = global_error(g)
        return g, errors, it

    run.backend, run.backend_times = backend, times
    return run


def stack_graphs(graphs) -> PoseGraphData:
    """Stack same-structure graphs into a fleet: the float fields
    (``FLOAT_FIELDS``) gain a leading batch axis B. The index fields,
    ``total_dof``, ``prior2`` and ``prior3`` are the shared structure and
    must be equal in every graph (ValueError otherwise). The JAX package
    stacks the index leaves too (one copy per graph); the port keeps one
    copy, which every batched function indexes with."""
    graphs = list(graphs)
    first = graphs[0]
    for g in graphs[1:]:
        if (g.total_dof, g.prior2, g.prior3) != (
                first.total_dof, first.prior2, first.prior3):
            raise ValueError("graphs differ in total_dof or the gauge prior")
        for name in INDEX_FIELDS:
            a, b = getattr(first, name), getattr(g, name)
            if a.shape != b.shape or not torch.equal(a, b.to(a.device)):
                raise ValueError(f"graphs differ in {name!r}: a fleet needs "
                                 f"one structure")
    return first.replace(**{
        name: torch.stack([getattr(g, name) for g in graphs])
        for name in FLOAT_FIELDS})



def make_optimize_batch(
    graph_template: PoseGraphData,
    num_iterations: int = 50,
    solver: str = "gauss_newton",
    backend: str = "dense",
    tolerance: float = 1e-4,
    prior_weight: float = PRIOR_WEIGHT,
    robust: str | None = None,
    robust_delta: float = 1.0,
    robust_alpha: float = -2.0,
    cg_tol: float = 1e-10,
    cg_maxiter: int | None = None,
    device=None,
):
    """Batched fleet optimizer, the counterpart of ``jax.vmap`` over
    ``make_optimize_jit``: B same-structure graphs (``stack_graphs``) run
    one loop, each kernel launch covering every graph. Returns
    run(batched_graph) -> (graphs, errors (B, iters+1), iters (B,)).

    Every device backend of ``make_optimize``, with its arguments; the
    template may be one graph or a fleet. ``host`` and ``native`` raise
    ValueError, as the JAX device loop does. The PCG backends (``cg``,
    ``cg-banded``, ``cg-banded-jnp``) run ``solvers.pcg`` over the fleet:
    each row has its own stop test and round count, and a fleet's SpMV is
    one K3 launch a round on the card. ``auto-measure`` times the banded
    candidates on the template's system (``run.backend``,
    ``run.backend_times``).

    The loop has the semantics of JAX's batched ``while_loop``: it runs
    while any row's condition (it < num_iterations and not ‖dx‖ <
    tolerance, and under GNC not before it = 60% of the budget) holds, and
    a row whose condition has failed keeps its state (nodes, λ, last
    error, iteration count, ‖dx‖, trace) from then on. A robust run takes
    each row's own μ0 (``max_edge_chi2``), μ(it) at its own iteration
    count and its own accept test. So row i's errors, NaN tail and
    iteration count equal ``make_optimize`` on graph i. The one host read
    per iteration is the any-row-active test, skipped when tolerance <=
    0."""
    if backend in HOST_BACKENDS:
        raise ValueError(f"the batched loop needs a device backend, got "
                         f"{backend!r}")
    device = resolve_device(device)
    layout = build_layout(graph_template)
    plan = layout.linearize_plan.to(device)
    backend, times = _resolve_backend(graph_template, layout, backend, device)
    solve = _make_solve(layout, backend, device, cg_tol=cg_tol,
                        cg_maxiter=cg_maxiter)
    lm = solver in ("lm", "levenberg_marquardt")
    gnc = robust == "gnc-gm"
    n_it = num_iterations
    k_gnc = gnc_iterations(num_iterations)
    robust_kw = dict(robust=robust, robust_delta=robust_delta,
                     robust_alpha=robust_alpha, plan=plan)

    def select(active, new, old):
        """new where the row is active, else old (rows on the first axis)."""
        return torch.where(active.view((-1,) + (1,) * (new.dim() - 1)),
                           new, old)

    def put(errors, it, value):
        """errors[row, it[row]] = value[row]; an index past the trace (a
        finished row's) is clamped, and select() then drops the write."""
        return errors.scatter(1, it.clamp(max=n_it)[:, None],
                              value[:, None])

    @spanned("request")
    def run(graph: PoseGraphData):
        g = graph.to(device=device)
        if len(g.batch_shape) != 1:
            raise ValueError("make_optimize_batch runs a fleet: build it "
                             "with stack_graphs")
        dtype, batch = g.dtype, g.batch_shape[0]
        errors = torch.full((batch, n_it + 1), math.nan, dtype=dtype,
                            device=device)
        lam = torch.full((batch,), 0.01, dtype=dtype, device=device)
        it = torch.zeros(batch, dtype=torch.long, device=device)
        norm_dx = torch.full((batch,), math.inf, dtype=dtype, device=device)
        last_error = torch.full((batch,), math.inf, dtype=dtype,
                                device=device)
        mu0 = gnc_mu0(g, robust_delta) if gnc else None
        if lm:
            errors[:, 0] = global_error(g)
            last_error = errors[:, 0].clone()
        for _ in range(n_it):
            converged = norm_dx < tolerance
            if gnc:
                converged = converged & (it >= k_gnc)
            active = (it < n_it) & ~converged
            if tolerance > 0 and not bool(active.any()):
                break
            mu = _gnc_mu(mu0, it, k_gnc) if gnc else None
            new_lam, new_last = lam, last_error
            if lm:
                vals, b, _ = system_values(g, lam, prior_weight, mu=mu,
                                           **robust_kw)
                dx = solve(vals, b)
                trial = apply_update(g, dx)
                with span("lm.accept"):
                    error, trial_cost, cur_cost = _accept_costs(
                        trial, g, robust, robust_delta, robust_alpha, mu)
                    # NaN-safe reject, and the trial error recorded
                    # unconditionally, as in make_optimize
                    reject = ~(error <= last_error if robust is None
                               else trial_cost <= cur_cost)
                    new_g = {f: select(reject, getattr(g, f),
                                       getattr(trial, f))
                             for f in _NODE_FIELDS}
                    new_lam = torch.where(reject, lam * 2.0, lam / 2.0)
                    new_errors = put(errors, it + 1, error)
                    new_last = torch.where(torch.isnan(error), last_error,
                                           error)
            else:
                vals, b, chi2 = system_values(g, 0.0, prior_weight, mu=mu,
                                              **robust_kw)
                new_errors = put(errors, it, chi2)
                dx = solve(vals, b)
                trial = apply_update(g, dx)
                new_g = {f: getattr(trial, f) for f in _NODE_FIELDS}
            g = g.replace(**{f: select(active, v, getattr(g, f))
                             for f, v in new_g.items()})
            lam = select(active, new_lam, lam)
            last_error = select(active, new_last, last_error)
            errors = select(active, new_errors, errors)
            norm_dx = select(active, torch.linalg.vector_norm(dx, dim=-1),
                             norm_dx)
            it = it + active.long()
        if not lm:
            errors = put(errors, it, global_error(g))
        return g, errors, it

    run.backend, run.backend_times = backend, times
    return run


class PoseGraph:
    """User-facing wrapper: a graph (a g2o path or a ``PoseGraphData``),
    the solver that optimizes it and the iterations run so far. ``dtype``
    casts the float fields; the graph lives on ``device`` (None: the
    card)."""

    def __init__(self, path_or_data, solver: str = "gauss_newton",
                 dtype=None, device=None):
        self.device = resolve_device(device)
        if isinstance(path_or_data, PoseGraphData):
            self.data = path_or_data.to(device=self.device)
            self.name = "graph"
        else:
            self.data = load_g2o(str(path_or_data), device=self.device)
            self.name = str(path_or_data).rsplit("/", 1)[-1].split(".")[0]
        if dtype is not None:
            self.data = self.data.to(dtype=dtype)
        self.solver = solver
        self.iteration = 0

    def global_error(self) -> float:
        return float(global_error(self.data))

    def optimize(self, num_iterations=50, log=False, plot=False,
                 backend="host", out_dir="img", robust=None, robust_delta=1.0,
                 robust_alpha=-2.0):
        """Run ``optimize`` from the current estimates and keep its result.
        Returns the χ² trace (a list). ``plot`` writes
        ``{out_dir}/{name}-{it}-{solver}.png`` before the first iteration
        and after each one."""
        callback = None
        if plot:
            from rustrobotics_tpu_torch.utils.plot import plot_pose_graph

            plot_pose_graph(self.data,
                            f"{out_dir}/{self.name}-0-{self.solver}.png")

            def callback(it, graph, *_):
                plot_pose_graph(
                    graph, f"{out_dir}/{self.name}-{it}-{self.solver}.png")

        result = optimize(
            self.data, num_iterations=num_iterations, solver=self.solver,
            backend=backend, robust=robust, robust_delta=robust_delta,
            robust_alpha=robust_alpha, log=log, callback=callback,
            device=self.device)
        self.data = result.graph
        self.iteration += result.iterations
        return result.errors


def linearize_and_solve(graph: PoseGraphData, backend: str = "host",
                        device=None):
    """One Gauss-Newton step's dx with λ = 0, by a solver of
    ``solvers.SOLVERS`` (the oracle of the reference's single step)."""
    graph = graph.to(device=resolve_device(device))
    layout = build_layout(graph)
    vals, b, _ = system_values(graph, 0.0, plan=layout.linearize_plan)
    return solvers.SOLVERS[backend](layout, vals, b)


def _marginal_system(graph, robust, robust_delta, device):
    """The undamped system's values and its band plan (None when the RCM
    bandwidth is too large), and the chain that factors it: K4 + K1 for
    f32 values (on the CPU their plain versions), the plain chain for
    f64."""
    from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
        band_assemble_kernel,
    )
    from rustrobotics_tpu_torch.ops.band_chol import build_band_chol
    from rustrobotics_tpu_torch.ops.band_chol_kernels import factorize_kernel

    graph = graph.to(device=resolve_device(device))
    layout = build_layout(graph)
    vals, _, _ = system_values(graph, 0.0, robust=robust,
                               robust_delta=robust_delta,
                               plan=layout.linearize_plan)
    bl = build_band_chol(layout)
    chain = (dict(factorize=factorize_kernel, assemble=band_assemble_kernel)
             if vals.dtype == torch.float32 else {})
    return graph, layout, vals, (None if bl is None
                                 else bl.to(graph.device)), chain


def marginal_variances(graph: PoseGraphData, robust: str | None = None,
                       robust_delta: float = 1.0, device=None):
    """Per-dof marginal variances diag(H^-1) (..., n) at the current
    estimates, by selected inversion of the banded factorization
    (``band_chol.marginal_covariances``, O(n kb^2)); a dense inverse when
    the RCM bandwidth is too large for the banded path. Pass the robust
    kernel the graph was optimized with, so that outlier edges keep their
    IRLS down-weighting in the reported uncertainty. f32 values on the
    card assemble with K4 and factor with K1; f64 values take the plain
    chain."""
    from rustrobotics_tpu_torch.ops.band_chol import marginal_covariances

    _, layout, vals, bl, chain = _marginal_system(graph, robust,
                                                  robust_delta, device)
    if bl is not None:
        return marginal_covariances(bl, vals, **chain)
    h = dense_hessian(layout, vals)
    return torch.diagonal(torch.linalg.inv_ex(h).inverse, dim1=-2, dim2=-1)


def pose_covariances(graph: PoseGraphData, robust: str | None = None,
                     robust_delta: float = 1.0, device=None):
    """(..., N2, 3, 3) marginal covariance blocks of the SE2 poses at the
    current estimates (uncertainty ellipses), from the banded selected
    inverse (``band_chol.marginal_node_blocks``); when the RCM bandwidth
    is too large, the same blocks of a dense inverse. The chain as in
    ``marginal_variances``."""
    from rustrobotics_tpu_torch.ops.band_chol import marginal_node_blocks

    graph, layout, vals, bl, chain = _marginal_system(graph, robust,
                                                      robust_delta, device)
    offs = graph.pose2_offsets.cpu().numpy()
    if bl is not None:
        return marginal_node_blocks(bl, vals, offs, np.full(len(offs), 3),
                                    pad_size=3, **chain)
    hinv = torch.linalg.inv_ex(dense_hessian(layout, vals)).inverse
    idx = torch.as_tensor(offs[:, None] + np.arange(3)[None, :],
                          device=vals.device)                  # (N2, 3)
    return hinv[..., idx[:, :, None], idx[:, None, :]]
