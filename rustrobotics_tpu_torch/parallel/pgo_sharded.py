"""Distributed pose-graph optimization: edge-sharded Gauss-Newton over a
mesh of ranks (counterpart of ``rustrobotics_tpu/parallel/pgo_sharded.py``).

Edges are partitioned across the mesh axis; nodes and the dx vector are
replicated. Every rank holds the whole graph and takes the contiguous
edge shard that JAX's ``P(axis)`` gives its position r on the axis: rows
[r E / D, (r + 1) E / D) of each (padded) edge family. It linearizes its
shard into normal-equation triplets (``mapping.triplets``); the RHS, χ²,
the 6x6 block-Jacobi blocks and every PCG matrix-vector product are
summed over the axis with ``all_reduce`` (JAX's ``psum``). The solve is
matrix-free PCG (``solvers.pcg``, the stop test of
``jax.scipy.sparse.linalg.cg``) whose SpMV is an edge-parallel
gather/scatter: no global factorization exists anywhere. All-reduced
results are the same on every rank, so each runs the same PCG.

Zero-padded edges (Ω = 0) contribute nothing, so shards are padded to
equal size without masks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rustrobotics_tpu_torch.mapping.assemble import (
    PRIOR_WEIGHT,
    apply_update,
    block_maps,
)
from rustrobotics_tpu_torch.mapping.g2o import PoseGraphData
from rustrobotics_tpu_torch.mapping import solvers
from rustrobotics_tpu_torch.mapping.triplets import edge_triplets

_NODE_FIELDS = ("poses2", "landmarks2", "poses3",
                "pose2_offsets", "lm2_offsets", "pose3_offsets")
_EDGE_FAMILIES = (("pp_from", "pp_to", "pp_z", "pp_omega"),
                  ("pl_pose", "pl_lm", "pl_z", "pl_omega"),
                  ("qq_from", "qq_to", "qq_z", "qq_omega"))


def pad_edges_for_sharding(graph: PoseGraphData,
                           num_shards: int) -> PoseGraphData:
    """Pad every edge family to a multiple of num_shards with zero-Ω edges
    (indices point at node 0; all contributions vanish)."""
    updates = {}
    for fields in _EDGE_FAMILIES:
        count = -getattr(graph, fields[0]).shape[0] % num_shards
        for f in fields:
            arr = getattr(graph, f)
            if count:
                pad = arr.new_zeros((count,) + arr.shape[1:])
                arr = torch.cat([arr, pad])
            updates[f] = arr
    return graph.replace(**updates)


def make_distributed_step_fns(
    mesh,
    graph_template: PoseGraphData,
    prior_weight: float = PRIOR_WEIGHT,
    cg_tol: float = 1e-10,
    cg_maxiter: int | None = None,
):
    """Build the sharded step for graphs of this (padded) shape.

    Returns (solve, error):
    - ``solve(graph, lam) -> (dx, chi2)``: the all-reduced PCG solve of
      (H + λI + prior) dx = -b, and the current χ².
    - ``error(graph) -> chi2``: the all-reduced global error.
    """
    # this rank's place on the mesh's axis, the axis's size and group
    rank, size, group = mesh.get_local_rank(0), mesh.size(0), mesh.get_group(0)
    g = graph_template
    dtype, device = g.dtype, g.device
    n = g.total_dof
    prior2, prior3 = g.prior2, g.prior3
    maxiter = cg_maxiter if cg_maxiter is not None else 2 * n
    dof_block_np, dof_pos_np, pad_eye_np, n_blocks = block_maps(
        g.pose2_offsets.cpu().numpy(), g.lm2_offsets.cpu().numpy(),
        g.pose3_offsets.cpu().numpy(), n)
    dof_block = torch.as_tensor(dof_block_np, dtype=torch.long,
                                device=device)
    dof_pos = torch.as_tensor(dof_pos_np, dtype=torch.long, device=device)
    pad_eye = torch.as_tensor(pad_eye_np, dtype=dtype, device=device)
    slot = dof_block * 6 + dof_pos
    diag_entry = slot * 6 + dof_pos  # each dof's diagonal in the blocks

    spans = []
    for fields in _EDGE_FAMILIES:
        count = getattr(g, fields[0]).shape[0]
        if count % size:
            raise ValueError(f"{fields[0]} has {count} edges, not a "
                             f"multiple of the mesh's {size}: pad the "
                             "graph (pad_edges_for_sharding)")
        per = count // size
        spans.append((rank * per, (rank + 1) * per))

    def local_triplets(graph):
        edges = [getattr(graph, f)[lo:hi]
                 for fields, (lo, hi) in zip(_EDGE_FAMILIES, spans)
                 for f in fields]
        nodes = [getattr(graph, f) for f in _NODE_FIELDS]
        return edge_triplets(*nodes, *edges, n)

    def psum(t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    # replicated diagonal additions: the gauge prior here, λ on every dof
    # at each call
    prior_diag = torch.zeros(n, dtype=dtype, device=device)
    if prior2 >= 0:
        off = int(g.pose2_offsets[prior2])
        prior_diag[off:off + 3] = prior_weight
    elif prior3 >= 0:
        off = int(g.pose3_offsets[prior3])
        prior_diag[off:off + 6] = prior_weight

    def solve(graph, lam):
        rows, cols, vals, b_local, chi2_local = local_triplets(graph)
        b = psum(b_local)
        chi2 = psum(chi2_local)
        extra = prior_diag + float(lam)

        # block-Jacobi preconditioner: the per-node diagonal blocks of H,
        # all-reduced, identity-padded to 6x6, the diagonal additions on
        # their diagonals, batch-inverted
        br, bc = dof_block[rows], dof_block[cols]
        entry = (br * 6 + dof_pos[rows]) * 6 + dof_pos[cols]
        blocks = vals.new_zeros(n_blocks * 36).index_add_(
            0, entry, torch.where(br == bc, vals, 0.0))
        blocks = psum(blocks) + pad_eye.view(-1)
        blocks = blocks.index_add_(0, diag_entry, extra)
        precond = solvers.block_precond(blocks.view(n_blocks, 6, 6), slot)

        def matvec(x):
            y = vals.new_zeros(n).index_add_(0, rows, vals * x[cols])
            return psum(y) + extra * x

        dx, _ = solvers.pcg(matvec, precond, -b, cg_tol, maxiter)
        return dx, chi2

    def error(graph):
        return psum(local_triplets(graph)[4])

    return solve, error


def distributed_gn_step(mesh, graph, lam=0.0, **kw):
    """One-off convenience wrapper: (dx, chi2) for one GN iteration."""
    graph = pad_edges_for_sharding(graph, mesh.size(0))
    solve, _ = make_distributed_step_fns(mesh, graph, **kw)
    return solve(graph, lam)


def distributed_global_error(mesh, graph):
    graph = pad_edges_for_sharding(graph, mesh.size(0))
    _, error = make_distributed_step_fns(mesh, graph)
    return error(graph)


def distributed_optimize(
    mesh,
    graph: PoseGraphData,
    num_iterations: int = 50,
    solver: str = "gauss_newton",
    tolerance: float = 1e-4,
    prior_weight: float = PRIOR_WEIGHT,
    cg_tol: float = 1e-10,
    log: bool = False,
):
    """Host-driven distributed GN/LM loop (reference semantics, with
    assembly and solve sharded over the mesh). Returns (graph, errors,
    norms); the graph keeps its padding edges."""
    graph = pad_edges_for_sharding(graph, mesh.size(0))
    solve, error_fn = make_distributed_step_fns(
        mesh, graph, prior_weight=prior_weight, cg_tol=cg_tol
    )
    lm = solver in ("lm", "levenberg_marquardt")
    lam = 0.01
    last_error = float(error_fn(graph))
    errors = [last_error]
    norms = []
    for it in range(1, num_iterations + 1):
        dx, _ = solve(graph, lam if lm else 0.0)
        new_graph = apply_update(graph, dx)
        norm_dx = float(torch.linalg.vector_norm(dx))
        error = float(error_fn(new_graph))
        if lm and last_error < error:
            lam *= 2.0  # reject: keep the old graph
        else:
            graph = new_graph
            if lm:
                lam /= 2.0
        last_error = error
        errors.append(error)
        norms.append(norm_dx)
        if log:
            print(f"step {it:3} : |dx| = {norm_dx:3.5f}, error = {error:3.5f}")
        if norm_dx < tolerance:
            break
    return graph, errors, norms
