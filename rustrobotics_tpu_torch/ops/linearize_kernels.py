"""SE2 linearization: the CUDA kernel for Hopper and its plain PyTorch
version.

It replaces no TPU kernel: the JAX package leaves
``mapping/assemble.py::system_values`` to XLA's fusion. The port's plain
version of it is a chain of ~224 small PyTorch operations whose host time
kept the card idle; ``csrc/se2_linearize.cu`` does the same work in two
launches and says what bounds it on an H100. What it computes is
``assemble.system_values(graph, lam, prior_weight)`` for a graph whose
edges are all SE2 (pose-pose and pose-landmark) with no robust kernel: the
triplet values in ``build_layout``'s order (pose-pose blocks, pose-landmark
blocks, the gauge prior, λ on every diagonal), the negated right-hand side
and χ², for one graph or a batch of graphs.

Where it writes comes from the layout: ``build_layout`` builds a
``LinearizePlan`` with the triplet offsets and the incidence plan of the
right-hand side, once a graph structure, and the optimizer loops move it
to the card once. The right-hand side is gathered, not scattered: the
plan lists the per-edge parts that land on each dof in the order the
CPU's ``index_add_`` adds them, so each dof sums its parts from 0 in a
fixed order and needs no zero-fill.

``takes_kernel`` says which graphs take the kernel. The wrapper takes the
plain version for a graph on the CPU, and only then; for a CUDA graph it
launches the kernel or raises. ``LAUNCHES["se2_linearize"]`` counts its
calls (two kernel launches each).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from rustrobotics_tpu_torch.mapping import linearize
from rustrobotics_tpu_torch.ops import cuda_lib

LAUNCHES = {"se2_linearize": 0}
# threads a CTA of the edge kernel: csrc/se2_linearize.cu's THREADS, which
# sets how many χ² partial sums the scratch buffer holds
EDGE_THREADS = 256

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # (device, graphs, poses, pose_stride, lms, lm_stride, pp_from, pp_to,
    #  pp_z, pp_z_stride, pp_om, pp_om_stride, n_pp, pl_pose, pl_lm, pl_z,
    #  pl_z_stride, pl_om, pl_om_stride, n_pl, ptr, src, n, pl_base,
    #  prior_base, prior, prior_weight, lam, lam_stride, lam_value, vals,
    #  nnz, b, chi2, scratch, scratch_floats, stream)
    "se2_linearize_f32": [_I, _I, _P, _L, _P, _L, _P, _P, _P, _L, _P, _L, _L,
                          _P, _P, _P, _L, _P, _L, _L, _P, _P, _L, _L, _L, _L,
                          _F, _P, _L, _F, _P, _L, _P, _P, _P, _L, _P],
}


def takes_kernel(device: torch.device, dtype, se3_edges: int, robust) -> bool:
    """Whether ``system_values`` runs the kernel: a CUDA f32 graph with no
    SE3 edge and no robust kernel. SE3 edges, robust or GNC weights, f64
    and the CPU take the plain code."""
    return (device.type == "cuda" and dtype == torch.float32
            and se3_edges == 0 and robust is None)


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


def se2_linearize_plain(graph, lam, prior_weight, plan: LinearizePlan):
    """The kernel's function in plain PyTorch: the edge terms of
    ``linearize.edge_terms_pp_soa`` / ``edge_terms_pl_soa`` written at
    the plan's offsets, and b gathered by ``plan`` (on the graph's
    device), each dof's parts summed from 0 in plan order. Returns (vals,
    -b, χ²) as ``system_values``."""
    batch, n = graph.batch_shape, graph.total_dof
    dtype, device = graph.dtype, graph.device
    _, hii, hij, hjj, bi, bj, c2_pp = linearize.edge_terms_pp_soa(
        graph.poses2, graph.pp_from, graph.pp_to, graph.pp_z, graph.pp_omega)
    _, lii, lij, ljj, li, lj, c2_pl = linearize.edge_terms_pl_soa(
        graph.poses2, graph.landmarks2, graph.pl_pose, graph.pl_lm,
        graph.pl_z, graph.pl_omega)
    pl_base, prior_base, nnz = plan.pl_base, plan.prior_base, plan.nnz
    vals = torch.empty(batch + (nnz,), dtype=dtype, device=device)
    for base, blocks in ((0, (hii, hij, hij.transpose(-3, -2), hjj)),
                         (pl_base, (lii, lij, lij.transpose(-3, -2), ljj))):
        for h in blocks:
            size = h.shape[-3] * h.shape[-2] * h.shape[-1]
            vals[..., base:base + size] = h.reshape(batch + (size,))
            base += size
    vals[..., prior_base:nnz - n] = prior_weight
    vals[..., nnz - n:] = (lam.to(dtype)[..., None] if torch.is_tensor(lam)
                           else float(lam))

    parts = torch.cat([p.reshape(batch + (-1,)) for p in (bi, bj, li, lj)],
                      -1)
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


def se2_linearize_kernel(graph, lam, prior_weight, plan: LinearizePlan):
    """``system_values(graph, lam, prior_weight)`` for an SE2 graph (f32 on
    the card; a fleet's batch axis rides in front) by the kernel, writing
    where ``plan`` (the graph's ``build_layout(graph).linearize_plan``, on
    the host or on the graph's device) says: (vals
    (..., nnz), -b (..., n), χ² (...)). vals equal the plain CUDA path's
    bit for bit; b and χ² are summed in a fixed order (so are the same
    every run), where the plain path's order differs (see
    ``csrc/se2_linearize.cu``). ``lam`` is a number or a tensor of the
    batch shape. On the CPU it runs ``se2_linearize_plain``."""
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
        return se2_linearize_plain(graph, lam, prior_weight, plan)
    if graph.qq_from.shape[0]:
        raise ValueError("the SE2 kernel takes no SE3 edges")
    device, batch = graph.device, graph.batch_shape
    graphs = math.prod(batch)
    poses, pose_stride = _per_graph(graph.poses2, 2, batch, device)
    lms, lm_stride = _per_graph(graph.landmarks2, 2, batch, device)
    pp_z, pp_z_stride = _per_graph(graph.pp_z, 2, batch, device)
    pp_om, pp_om_stride = _per_graph(graph.pp_omega, 3, batch, device)
    pl_z, pl_z_stride = _per_graph(graph.pl_z, 2, batch, device)
    pl_om, pl_om_stride = _per_graph(graph.pl_omega, 3, batch, device)
    pp_from, pp_to, pl_pose, pl_lm = (
        _device_tensor(t, torch.int64, device)
        for t in (graph.pp_from, graph.pp_to, graph.pl_pose, graph.pl_lm))
    pl_base, prior_base, nnz = plan.pl_base, plan.prior_base, plan.nnz
    prior = nnz - n - prior_base
    edge_blocks = max(1, -(-(n_pp + n_pl) // EDGE_THREADS))
    scratch_floats = graphs * (6 * n_pp + 5 * n_pl + edge_blocks)
    if torch.is_tensor(lam):
        lam_t = lam.to(device=device, dtype=torch.float32).expand(
            batch).reshape(-1)
        lam_ptr, lam_stride, lam_value = lam_t.data_ptr(), lam_t.stride(0), 0.0
    else:
        lam_ptr, lam_stride, lam_value = None, 0, float(lam)

    f32 = dict(dtype=torch.float32, device=device)
    vals = torch.empty(graphs, nnz, **f32)
    b = torch.empty(graphs, n, **f32)
    chi2 = torch.empty(graphs, **f32)
    scratch = torch.empty(scratch_floats, **f32)
    lib = cuda_lib.load("se2_linearize", _SIGNATURES)
    status = lib.se2_linearize_f32(
        device.index, graphs, poses.data_ptr(), pose_stride, lms.data_ptr(),
        lm_stride, pp_from.data_ptr(), pp_to.data_ptr(), pp_z.data_ptr(),
        pp_z_stride, pp_om.data_ptr(), pp_om_stride, n_pp,
        pl_pose.data_ptr(), pl_lm.data_ptr(), pl_z.data_ptr(), pl_z_stride,
        pl_om.data_ptr(), pl_om_stride, n_pl, plan.ptr.data_ptr(),
        plan.src.data_ptr(), n, pl_base, prior_base, prior, prior_weight,
        lam_ptr, lam_stride, lam_value, vals.data_ptr(), nnz, b.data_ptr(),
        chi2.data_ptr(), scratch.data_ptr(), scratch_floats,
        cuda_lib.stream(vals))
    cuda_lib.check(lib, status, "se2_linearize_f32")
    LAUNCHES["se2_linearize"] += 1
    return (vals.view(batch + (nnz,)), b.view(batch + (n,)),
            chi2.view(batch))
