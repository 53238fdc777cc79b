"""SE2 linearization and LM's accept test: the CUDA kernels for Hopper
and their plain PyTorch versions.

They replace no TPU kernel: the JAX package leaves
``mapping/assemble.py::system_values`` and ``mapping/pgo.py``'s costs to
XLA's fusion. The port's plain version of the linearization is a chain of
~224 small PyTorch operations whose host time kept the card idle;
``csrc/se2_linearize.cu`` does the same work in two launches and says what
bounds it on an H100. What it computes is ``assemble.system_values(graph,
lam, prior_weight)`` for a graph whose edges are all SE2 (pose-pose and
pose-landmark), by least squares or under GNC Geman-McClure (``robust``
"gnc-gm", each graph's μ read from the device): the triplet values in
``build_layout``'s order (pose-pose blocks, pose-landmark blocks, the gauge
prior, λ on every diagonal), the negated right-hand side and χ², for one
graph or a batch of graphs. The cost kernel gives, in one launch, the
numbers LM's accept test compares: each graph's Σ e^T Ω e at the trial
poses and, for a GNC run, Σ ρ_μ at the trial and at the current poses
(``pgo.global_error`` and ``pgo.robust_global_cost``).

Where it writes comes from the layout: ``build_layout`` builds a
``LinearizePlan`` with the triplet offsets and the incidence plan of the
right-hand side, once a graph structure, and the optimizer loops move it
to the card once. The right-hand side is gathered, not scattered: the
plan lists the per-edge parts that land on each dof in the order the
CPU's ``index_add_`` adds them, so each dof sums its parts from 0 in a
fixed order and needs no zero-fill.

``takes_kernel`` says which graphs take the kernels. The wrappers take the
plain versions for a graph on the CPU, and only then; for a CUDA graph
they launch the kernel or raise. ``LAUNCHES["se2_linearize"]`` counts the
linearization's calls (two kernel launches each),
``LAUNCHES["se2_lm_cost"]`` the cost kernel's (one launch each).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from rustrobotics_tpu_torch.mapping import linearize
from rustrobotics_tpu_torch.ops import cuda_lib

LAUNCHES = {"se2_linearize": 0, "se2_lm_cost": 0}
# threads a CTA of the edge kernel: csrc/se2_linearize.cu's THREADS, which
# sets how many χ² partial sums the scratch buffer holds
EDGE_THREADS = 256
# the robust kernels the CUDA kernels take besides least squares
KERNEL_ROBUST = ("gnc-gm",)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # (device, graphs, poses, pose_stride, lms, lm_stride, pp_from, pp_to,
    #  pp_z, pp_z_stride, pp_om, pp_om_stride, n_pp, pl_pose, pl_lm, pl_z,
    #  pl_z_stride, pl_om, pl_om_stride, n_pl, ptr, src, n, pl_base,
    #  prior_base, prior, prior_weight, lam, lam_stride, lam_value, gnc, mu,
    #  mu_stride, mu_value, delta, closures_only, vals, nnz, b, chi2,
    #  scratch, scratch_floats, stream)
    "se2_linearize_f32": [_I, _I, _P, _L, _P, _L, _P, _P, _P, _L, _P, _L, _L,
                          _P, _P, _P, _L, _P, _L, _L, _P, _P, _L, _L, _L, _L,
                          _F, _P, _L, _F, _I, _P, _L, _F, _F, _I, _P, _L, _P,
                          _P, _P, _L, _P],
    # (device, graphs, poses, pose_stride, lms, lm_stride, pp_from, pp_to,
    #  pp_z, pp_z_stride, pp_om, pp_om_stride, n_pp, pl_pose, pl_lm, pl_z,
    #  pl_z_stride, pl_om, pl_om_stride, n_pl, cur_poses, cur_lms, mu,
    #  mu_stride, mu_value, d2, closures_only, chi2, rho, rho_cur, stream)
    "se2_lm_cost_f32": [_I, _I, _P, _L, _P, _L, _P, _P, _P, _L, _P, _L, _L,
                        _P, _P, _P, _L, _P, _L, _L, _P, _P, _P, _L, _F, _F,
                        _I, _P, _P, _P, _P],
}


def takes_kernel(device: torch.device, dtype, se3_edges: int, robust) -> bool:
    """Whether ``system_values``, ``pgo.global_error`` and
    ``pgo.robust_global_cost`` run the kernels: a CUDA f32 graph with no
    SE3 edge, by least squares (``robust`` None) or GNC Geman-McClure
    ("gnc-gm"). SE3 edges, the Huber, Cauchy and Barron kernels, f64 and
    the CPU take the plain code."""
    return (device.type == "cuda" and dtype == torch.float32
            and se3_edges == 0 and (robust is None or robust in KERNEL_ROBUST))


@dataclasses.dataclass(frozen=True)
class LinearizePlan:
    """Where the kernel writes, from ``assemble.build_layout``, which owns
    the triplet order: the pose-landmark blocks from ``pl_base`` (the
    pose-pose blocks from 0), the gauge prior's entries from
    ``prior_base``, λ on the n diagonals last, ``nnz`` values in all.

    And where each dof's right-hand side comes from. The per-edge parts of
    a graph are one vector, in the order of ``system_values``' index_add_
    sources: pose-pose b_i (3, E_pp) and b_j (3, E_pp), then pose-landmark
    b_i (3, E_pl) and b_j (2, E_pl), each entry-major. Dof d sums the parts
    ``src[ptr[d]:ptr[d + 1]]`` in that order. numpy int32 on the host;
    ``to(device)`` gives int32 tensors."""

    ptr: object  # (n + 1,)
    src: object  # (6 E_pp + 5 E_pl,)
    max_degree: int  # the most parts a dof sums
    pl_base: int
    prior_base: int
    nnz: int

    def to(self, device) -> "LinearizePlan":
        device = torch.device(device)
        if torch.is_tensor(self.ptr) and self.ptr.device == device:
            return self
        return dataclasses.replace(
            self, ptr=torch.as_tensor(np.asarray(self.ptr), device=device),
            src=torch.as_tensor(np.asarray(self.src), device=device))


def _robust_args(robust, robust_edges):
    """Whether the kernels weigh edges (``robust`` of ``KERNEL_ROBUST``),
    and whether odometry keeps weight 1 (robust_edges="closures"); any
    other robust kernel raises."""
    if robust is not None and robust not in KERNEL_ROBUST:
        raise ValueError(f"the SE2 kernels take robust None or one of "
                         f"{KERNEL_ROBUST}, got {robust!r}")
    return robust is not None, int(robust_edges == "closures")


def se2_linearize_plain(graph, lam, prior_weight, plan: LinearizePlan,
                        robust=None, robust_delta=1.0, mu=None,
                        robust_edges="closures"):
    """The kernel's function in plain PyTorch: the edge terms of
    ``linearize.edge_terms_pp_soa`` / ``edge_terms_pl_soa``, each weighted
    edge's scaled by its GNC weight as ``system_values_plain`` scales them,
    written at the plan's offsets, and b gathered by ``plan`` (on the
    graph's device), each dof's parts summed from 0 in plan order. Returns
    (vals, -b, χ²) as ``system_values``."""
    weigh, _ = _robust_args(robust, robust_edges)
    batch, n = graph.batch_shape, graph.total_dof
    dtype, device = graph.dtype, graph.device
    _, hii, hij, hjj, bi, bj, c2_pp = linearize.edge_terms_pp_soa(
        graph.poses2, graph.pp_from, graph.pp_to, graph.pp_z, graph.pp_omega)
    _, lii, lij, ljj, li, lj, c2_pl = linearize.edge_terms_pl_soa(
        graph.poses2, graph.landmarks2, graph.pl_pose, graph.pl_lm,
        graph.pl_z, graph.pl_omega)
    pp, pl = [hii, hij, hij.transpose(-3, -2), hjj], [lii, lij,
                                                      lij.transpose(-3, -2),
                                                      ljj]
    rhs = [bi, bj, li, lj]
    if weigh:
        from rustrobotics_tpu_torch.mapping import assemble

        w_pp = assemble.robust_weight(robust, c2_pp, robust_delta, mu=mu)
        if robust_edges == "closures":
            w_pp = torch.where(assemble.odometry(graph.pp_from, graph.pp_to),
                               torch.ones_like(w_pp), w_pp)
        w_pl = assemble.robust_weight(robust, c2_pl, robust_delta, mu=mu)
        pp = [h * w_pp[..., None, None, :] for h in pp]
        pl = [h * w_pl[..., None, None, :] for h in pl]
        rhs = [r * w[..., None, :] for r, w in zip(rhs, (w_pp, w_pp, w_pl,
                                                         w_pl))]
    pl_base, prior_base, nnz = plan.pl_base, plan.prior_base, plan.nnz
    vals = torch.empty(batch + (nnz,), dtype=dtype, device=device)
    for base, blocks in ((0, pp), (pl_base, pl)):
        for h in blocks:
            size = h.shape[-3] * h.shape[-2] * h.shape[-1]
            vals[..., base:base + size] = h.reshape(batch + (size,))
            base += size
    vals[..., prior_base:nnz - n] = prior_weight
    vals[..., nnz - n:] = (lam.to(dtype)[..., None] if torch.is_tensor(lam)
                           else float(lam))

    parts = torch.cat([p.reshape(batch + (-1,)) for p in rhs], -1)
    ptr, src = plan.ptr.long(), plan.src.long()
    start, end = ptr[:-1], ptr[1:]
    bvec = torch.zeros(batch + (n,), dtype=dtype, device=device)
    for k in range(plan.max_degree):
        at = start + k
        part = parts[..., src[torch.clamp(at, max=src.shape[0] - 1)]]
        bvec = bvec + torch.where(at < end, part, torch.zeros_like(part))
    return vals, -bvec, c2_pp.sum(-1) + c2_pl.sum(-1)


def _device_tensor(t, dtype, device):
    if t.device != device:
        raise ValueError(f"every tensor of the graph must be on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"expected {dtype}, got {t.dtype}")
    return t.contiguous()


def _per_graph(t, dims, batch, device):
    """An f32 input as a contiguous tensor and its stride between graphs:
    0 for one copy every graph shares."""
    t = _device_tensor(t, torch.float32, device)
    if t.dim() == dims:
        return t, 0
    base = t.shape[-dims:]
    return t.expand(batch + base).contiguous(), math.prod(base)


def _per_row(x, batch, device):
    """A number or a tensor of the batch shape as the kernels read it:
    (f32 tensor a graph or None, its stride, the number where there is no
    tensor). The tensor is returned to be kept alive over the launch."""
    if not torch.is_tensor(x):
        return None, 0, float(x)
    t = x.to(device=device, dtype=torch.float32).expand(batch).reshape(-1)
    return t, t.stride(0), 0.0


def _gnc_scale(mu, delta, batch, device, weights):
    """(μ tensor or None, stride, value, factor): GNC's scale s as the
    kernels read it. The weights' s is (μ δ) δ (``assemble.robust_weight``),
    the costs' μ δ² (``robust_rho``). From a μ tensor the kernels form it in
    f32, (μ factor) factor with factor δ or μ factor with factor δ², as the
    tensor code multiplies a tensor by numbers. A μ that is a number or
    None (1) is s formed here in double, as the tensor code multiplies
    Python numbers, and the kernels take it as it is (factor 1)."""
    if torch.is_tensor(mu):
        return (*_per_row(mu, batch, device),
                delta if weights else delta * delta)
    mu = 1.0 if mu is None else mu
    s = mu * delta * delta if weights else mu * (delta * delta)
    return None, 0, s, 1.0


def _graph_inputs(graph, device, batch):
    """The edge kernels' graph arguments, in the C entries' order, and the
    tensors they point into."""
    poses, pose_stride = _per_graph(graph.poses2, 2, batch, device)
    lms, lm_stride = _per_graph(graph.landmarks2, 2, batch, device)
    pp_z, pp_z_stride = _per_graph(graph.pp_z, 2, batch, device)
    pp_om, pp_om_stride = _per_graph(graph.pp_omega, 3, batch, device)
    pl_z, pl_z_stride = _per_graph(graph.pl_z, 2, batch, device)
    pl_om, pl_om_stride = _per_graph(graph.pl_omega, 3, batch, device)
    pp_from, pp_to, pl_pose, pl_lm = (
        _device_tensor(t, torch.int64, device)
        for t in (graph.pp_from, graph.pp_to, graph.pl_pose, graph.pl_lm))
    keep = (poses, lms, pp_z, pp_om, pl_z, pl_om, pp_from, pp_to, pl_pose,
            pl_lm)
    args = (poses.data_ptr(), pose_stride, lms.data_ptr(), lm_stride,
            pp_from.data_ptr(), pp_to.data_ptr(), pp_z.data_ptr(),
            pp_z_stride, pp_om.data_ptr(), pp_om_stride, pp_from.shape[0],
            pl_pose.data_ptr(), pl_lm.data_ptr(), pl_z.data_ptr(),
            pl_z_stride, pl_om.data_ptr(), pl_om_stride, pl_pose.shape[0])
    return args, keep


def _ptr(t):
    return None if t is None else t.data_ptr()


def se2_linearize_kernel(graph, lam, prior_weight, plan: LinearizePlan,
                         robust=None, robust_delta=1.0, mu=None,
                         robust_edges="closures"):
    """``system_values(graph, lam, prior_weight, robust=robust, ...)`` for
    an SE2 graph (f32 on the card; a fleet's batch axis rides in front) by
    the kernel, writing where ``plan`` (the graph's
    ``build_layout(graph).linearize_plan``, on the host or on the graph's
    device) says: (vals (..., nnz), -b (..., n), χ² (...)). ``robust`` is
    None or "gnc-gm"; ``mu`` a number, None (1) or a tensor of the batch
    shape, read on the device. vals equal the plain CUDA path's bit for
    bit; b and χ² are summed in a fixed order (so are the same every run),
    where the plain path's order differs (see ``csrc/se2_linearize.cu``).
    ``lam`` is a number or a tensor of the batch shape. On the CPU it runs
    ``se2_linearize_plain``."""
    weigh, closures_only = _robust_args(robust, robust_edges)
    plan = plan.to(graph.device)
    n_pp, n_pl, n = (graph.pp_from.shape[0], graph.pl_pose.shape[0],
                     graph.total_dof)
    if (plan.ptr.shape[0] != n + 1
            or plan.src.shape[0] != 6 * n_pp + 5 * n_pl
            or plan.ptr.dtype != torch.int32
            or plan.src.dtype != torch.int32):
        raise ValueError("the plan is not this graph's: build it with "
                         "build_layout(graph)")
    if graph.device.type == "cpu":
        return se2_linearize_plain(graph, lam, prior_weight, plan, robust,
                                   robust_delta, mu, robust_edges)
    if graph.qq_from.shape[0]:
        raise ValueError("the SE2 kernel takes no SE3 edges")
    device, batch = graph.device, graph.batch_shape
    graphs = math.prod(batch)
    inputs, _keep = _graph_inputs(graph, device, batch)
    pl_base, prior_base, nnz = plan.pl_base, plan.prior_base, plan.nnz
    prior = nnz - n - prior_base
    edge_blocks = max(1, -(-(n_pp + n_pl) // EDGE_THREADS))
    scratch_floats = graphs * (6 * n_pp + 5 * n_pl + edge_blocks)
    lam_t, lam_stride, lam_value = _per_row(lam, batch, device)
    mu_t, mu_stride, mu_value, delta = _gnc_scale(mu, robust_delta, batch,
                                                  device, weights=True)

    f32 = dict(dtype=torch.float32, device=device)
    vals = torch.empty(graphs, nnz, **f32)
    b = torch.empty(graphs, n, **f32)
    chi2 = torch.empty(graphs, **f32)
    scratch = torch.empty(scratch_floats, **f32)
    lib = cuda_lib.load("se2_linearize", _SIGNATURES)
    status = lib.se2_linearize_f32(
        device.index, graphs, *inputs, plan.ptr.data_ptr(),
        plan.src.data_ptr(), n, pl_base, prior_base, prior, prior_weight,
        _ptr(lam_t), lam_stride, lam_value, int(weigh), _ptr(mu_t),
        mu_stride, mu_value, delta, closures_only, vals.data_ptr(), nnz,
        b.data_ptr(), chi2.data_ptr(), scratch.data_ptr(), scratch_floats,
        cuda_lib.stream(vals))
    cuda_lib.check(lib, status, "se2_linearize_f32")
    LAUNCHES["se2_linearize"] += 1
    return (vals.view(batch + (nnz,)), b.view(batch + (n,)),
            chi2.view(batch))


def se2_cost_plain(graph, robust=None, robust_delta=1.0, mu=None,
                   robust_edges="closures", current=None):
    """The cost kernel's function in plain PyTorch, each edge's e^T Ω e as
    ``linearize.edge_terms_*_soa`` give it: (Σ e^T Ω e, Σ ρ_μ or None, Σ ρ_μ
    at ``current``'s nodes or None), each of the batch shape. ρ_μ is
    ``assemble.robust_rho``'s, odometry quadratic under
    robust_edges="closures", as ``pgo.robust_global_cost`` takes it."""
    from rustrobotics_tpu_torch.mapping import assemble

    weigh, _ = _robust_args(robust, robust_edges)

    def costs(g):
        *_, c2_pp = linearize.edge_terms_pp_soa(
            g.poses2, g.pp_from, g.pp_to, g.pp_z, g.pp_omega)
        *_, c2_pl = linearize.edge_terms_pl_soa(
            g.poses2, g.landmarks2, g.pl_pose, g.pl_lm, g.pl_z, g.pl_omega)
        if not weigh:
            return c2_pp.sum(-1) + c2_pl.sum(-1), None
        rho_pp = assemble.robust_rho(robust, c2_pp, robust_delta, mu=mu)
        if robust_edges == "closures":
            rho_pp = torch.where(assemble.odometry(g.pp_from, g.pp_to),
                                 c2_pp, rho_pp)
        rho_pl = assemble.robust_rho(robust, c2_pl, robust_delta, mu=mu)
        return (c2_pp.sum(-1) + c2_pl.sum(-1),
                rho_pp.sum(-1) + rho_pl.sum(-1))

    chi2, rho = costs(graph)
    rho_cur = costs(current)[1] if current is not None else None
    return chi2, rho, rho_cur


def se2_cost_kernel(graph, robust=None, robust_delta=1.0, mu=None,
                    robust_edges="closures", current=None):
    """LM's accept test for an SE2 graph (f32 on the card; a fleet's batch
    axis in front) by one launch of the cost kernel: (Σ e^T Ω e, Σ ρ_μ or
    None, Σ ρ_μ at ``current``'s nodes or None), each of the batch shape.
    ``graph`` is the trial; ``current``, a graph of the same structure and
    measurements (the one the step started from), is costed in the same
    launch and in the same order, so equal nodes give equal sums. ρ_μ
    needs ``robust`` "gnc-gm"; ``mu`` as ``se2_linearize_kernel`` takes
    it. The sums run in a fixed order, not torch.sum's. On the CPU it runs
    ``se2_cost_plain``."""
    weigh, closures_only = _robust_args(robust, robust_edges)
    if current is not None and not weigh:
        raise ValueError("the current graph is costed for a robust run only")
    if graph.device.type == "cpu":
        return se2_cost_plain(graph, robust, robust_delta, mu, robust_edges,
                              current)
    if graph.qq_from.shape[0]:
        raise ValueError("the SE2 kernel takes no SE3 edges")
    device, batch = graph.device, graph.batch_shape
    graphs = math.prod(batch)
    inputs, _keep = _graph_inputs(graph, device, batch)
    cur_poses = cur_lms = None
    if current is not None:
        if current.batch_shape != batch:
            raise ValueError("the current graph must have the trial's batch "
                             "shape")
        cur_poses = _per_graph(current.poses2, 2, batch, device)[0]
        cur_lms = _per_graph(current.landmarks2, 2, batch, device)[0]
    mu_t, mu_stride, mu_value, d2 = _gnc_scale(mu, robust_delta, batch,
                                               device, weights=False)
    out = torch.empty(3 if current is not None else 2 if weigh else 1,
                      graphs, dtype=torch.float32, device=device)
    lib = cuda_lib.load("se2_linearize", _SIGNATURES)
    status = lib.se2_lm_cost_f32(
        device.index, graphs, *inputs, _ptr(cur_poses), _ptr(cur_lms),
        _ptr(mu_t), mu_stride, mu_value, d2, closures_only,
        out[0].data_ptr(), out[1].data_ptr() if weigh else None,
        out[2].data_ptr() if current is not None else None,
        cuda_lib.stream(out))
    cuda_lib.check(lib, status, "se2_lm_cost_f32")
    LAUNCHES["se2_lm_cost"] += 1
    rows = [r.view(batch) for r in out] + [None] * (3 - out.shape[0])
    return tuple(rows)
