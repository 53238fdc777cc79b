"""Triplet generation (rows, cols, vals) for the normal equations on the
device (counterpart of ``rustrobotics_tpu/mapping/triplets.py``): the twin
of ``assemble.build_layout`` / ``system_values`` whose row and column
indices are computed from the edge set it is given, for the matrix-free
paths that hold an arbitrary share of the edges. One graph, no batch
axis.

The order is edge-major within each block family (edge e's nr x nc block
row by row), as in the JAX package, so both give the same rows and cols.
"""

from __future__ import annotations

import torch

from rustrobotics_tpu_torch.mapping import linearize
from rustrobotics_tpu_torch.mapping.assemble import _add_rhs, _quad_blocks


def _block_idx(off_r, off_c, nr, nc):
    """Row and column ids of an (E, nr, nc) stack of blocks at offsets
    (off_r[e], off_c[e]), flattened edge-major."""
    ar = torch.arange(nr, device=off_r.device)
    ac = torch.arange(nc, device=off_c.device)
    shape = (off_r.shape[0], nr, nc)
    r = off_r[:, None, None] + ar[None, :, None]
    c = off_c[:, None, None] + ac[None, None, :]
    return r.expand(shape).reshape(-1), c.expand(shape).reshape(-1)


def edge_triplets(
    poses2, landmarks2, poses3,
    pose2_offsets, lm2_offsets, pose3_offsets,
    pp_from, pp_to, pp_z, pp_omega,
    pl_pose, pl_lm, pl_z, pl_omega,
    qq_from, qq_to, qq_z, qq_omega,
    n,
):
    """Returns (rows, cols, vals, b, chi2) for the given edge set.

    b is the un-negated gradient accumulation Σ Aᵀ Ω e scattered to
    length n; no gauge prior and no λ: callers add those (they are
    diagonal). Padded edges with Ω = 0 contribute nothing."""
    dtype = poses2.dtype if poses2.numel() else poses3.dtype
    device = poses2.device
    rows, cols, vals = [], [], []
    b = torch.zeros(n, dtype=dtype, device=device)
    chi2 = torch.zeros((), dtype=dtype, device=device)
    families = (
        (linearize.edge_terms_pp(poses2, pp_from, pp_to, pp_z, pp_omega),
         pp_omega, pose2_offsets[pp_from], pose2_offsets[pp_to], 3, 3),
        (linearize.edge_terms_pl(poses2, landmarks2, pl_pose, pl_lm, pl_z,
                                 pl_omega),
         pl_omega, pose2_offsets[pl_pose], lm2_offsets[pl_lm], 3, 2),
        (linearize.edge_terms_qq(poses3, qq_from, qq_to, qq_z, qq_omega),
         qq_omega, pose3_offsets[qq_from], pose3_offsets[qq_to], 6, 6),
    )
    for (e, a, bb, c2), omega, off_i, off_j, di, dj in families:
        h_ii, h_ij, h_ji, h_jj, b_i, b_j = _quad_blocks(e, a, bb, omega)
        for orow, ocol, block, nr, nc in (
                (off_i, off_i, h_ii, di, di), (off_i, off_j, h_ij, di, dj),
                (off_j, off_i, h_ji, dj, di), (off_j, off_j, h_jj, dj, dj)):
            r, c = _block_idx(orow, ocol, nr, nc)
            rows.append(r)
            cols.append(c)
            vals.append(block.movedim(-1, 0).reshape(-1))  # edge-major
        _add_rhs(b, off_i, b_i)
        _add_rhs(b, off_j, b_j)
        chi2 = chi2 + c2.sum()
    return torch.cat(rows), torch.cat(cols), torch.cat(vals), b, chi2


def graph_edge_triplets(graph):
    """``edge_triplets`` of a PoseGraphData."""
    return edge_triplets(
        graph.poses2, graph.landmarks2, graph.poses3,
        graph.pose2_offsets, graph.lm2_offsets, graph.pose3_offsets,
        graph.pp_from, graph.pp_to, graph.pp_z, graph.pp_omega,
        graph.pl_pose, graph.pl_lm, graph.pl_z, graph.pl_omega,
        graph.qq_from, graph.qq_to, graph.qq_z, graph.qq_omega,
        graph.total_dof,
    )
