"""Normal-equation assembly for pose-graph optimization (counterpart of
``rustrobotics_tpu/mapping/assemble.py``).

Accumulate per-edge ``A^T Ω A`` blocks into H and ``A^T Ω e`` into b, add
the gauge prior (+1e7 on the first SE2 edge's from-pose diagonal, or the
first SE3 edge's for a pure 3D graph), negate b, and add the LM damping λ
to every diagonal.

- the sparsity pattern (triplet rows/cols in the reference dof layout) is
  planned once per graph on the host in numpy (``SystemLayout``);
- the values are one pass of tensor code per iteration
  (``system_values``), a flat value vector aligned with the layout plus
  the RHS and χ²; SE2 edges in component form, SE3 edges through the
  forward-mode Jacobians of ``linearize.edge_terms_qq``;
- the robust kernels (Huber, Cauchy, Barron, GNC Geman-McClure) scale
  each edge's contribution by its IRLS weight (``robust_weight``);
  ``robust_rho`` is the matching loss of the LM accept test;
- a fleet of same-structure graphs (``pgo.stack_graphs``) runs the same
  code with a leading batch axis on every value (and on the GNC μ);
- on the card an f32 graph with no SE3 edge, by least squares or under
  GNC Geman-McClure (one graph or a fleet), is linearized by one CUDA
  kernel (``ops/linearize_kernels.py``); every other graph runs the tensor
  code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rustrobotics_tpu_torch.geometry import se2, se3
from rustrobotics_tpu_torch.mapping import linearize
from rustrobotics_tpu_torch.mapping.g2o import PoseGraphData
from rustrobotics_tpu_torch.ops import linearize_kernels
from rustrobotics_tpu_torch.utils.metrics import spanned

PRIOR_WEIGHT = 1e7  # gauge prior


def _block_indices(off_row, off_col, nr, nc):
    """Triplet indices for per-edge (nr, nc) blocks, in entry-major order
    (nr, nc, E): all edges' (0, 0) entries first, then (0, 1), ... The
    matching values are an (nr, nc, E) tensor flattened."""
    e = off_row.shape[0]
    r = np.broadcast_to(
        off_row[None, None, :] + np.arange(nr)[:, None, None], (nr, nc, e)
    )
    c = np.broadcast_to(
        off_col[None, None, :] + np.arange(nc)[None, :, None], (nr, nc, e)
    )
    return r.ravel(), c.ravel()


@dataclasses.dataclass(frozen=True)
class SystemLayout:
    """Triplet layout; value order matches ``system_values``. Arrays are
    numpy on the host; ``to(device)`` gives a copy whose index arrays are
    int64 tensors on that device.

    Besides the triplets it carries the static structures of the CG and
    Schur backends:
    - ELL: the duplicate-summed CSR pattern padded to ``ell_width`` slots
      a row, so the SpMV is a gather and a row sum;
    - block maps: dof -> (node block, position in the block) with
      identity padding to 6x6, for the block-Jacobi preconditioner;
    - Schur maps: which dofs are 2D landmarks', the pose and landmark
      dofs, and each dof's index within its own group.
    """

    rows: np.ndarray  # (nnz,)
    cols: np.ndarray  # (nnz,)
    n: int  # total dof
    prior_slice: slice  # where the prior diagonal values live
    lam_slice: slice  # where the λ diagonal values live
    # ELL structure (duplicates summed)
    ell_order: np.ndarray  # (nnz,) permutation sorting triplets by (r, c)
    ell_seg: np.ndarray  # (nnz,) segment id of each sorted triplet
    ell_nnz: int  # number of deduped entries
    ell_pos: np.ndarray  # (ell_nnz,) flat position row*width+slot
    ell_nbr: np.ndarray  # (n, width) column index per slot (0-padded)
    ell_width: int
    # block-Jacobi maps
    dof_block: np.ndarray  # (n,) node of each dof
    dof_pos: np.ndarray  # (n,) position of each dof in its node's block
    pad_eye: np.ndarray  # (n_blocks, 6, 6) ones past each block's size
    n_blocks: int
    # Schur split: pose dofs vs 2D-landmark dofs (host arrays only)
    dof_is_lm: np.ndarray  # (n,) bool
    pose_dofs: np.ndarray  # (n_pose_dof,) reference-layout indices
    lm_dofs: np.ndarray  # (n_lm_dof,) reference-layout indices
    dof_compact: np.ndarray  # (n,) index within its own group
    # where the SE2 linearization kernel writes, and b's incidence plan
    linearize_plan: linearize_kernels.LinearizePlan

    _INDEX_FIELDS = ("rows", "cols", "ell_order", "ell_seg", "ell_pos",
                     "ell_nbr", "dof_block", "dof_pos")

    def to(self, device) -> "SystemLayout":
        moved = {f: torch.as_tensor(np.asarray(getattr(self, f), np.int64),
                                    device=device)
                 for f in self._INDEX_FIELDS}
        return dataclasses.replace(
            self, pad_eye=torch.as_tensor(np.asarray(self.pad_eye),
                                          device=device),
            linearize_plan=self.linearize_plan.to(device), **moved)


def _np(t):
    return t.detach().cpu().numpy()


def block_maps(p2, l2, p3, n: int):
    """Block-Jacobi maps from the nodes' dof offsets (numpy): each dof's
    node block and place in it, (n,) each, the identity padding of the
    blocks narrower than 6 dof (n_blocks, 6, 6), and n_blocks."""
    dof_block = np.zeros(n, np.int32)
    dof_pos = np.zeros(n, np.int32)
    sizes = []
    bid = 0
    for offs, size in [(p2, 3), (l2, 2), (p3, 6)]:
        for o in offs:
            dof_block[o:o + size] = bid
            dof_pos[o:o + size] = np.arange(size)
            sizes.append(size)
            bid += 1
    n_blocks = max(bid, 1)
    pad_eye = np.zeros((n_blocks, 6, 6))
    for k, size in enumerate(sizes):
        idx = np.arange(size, 6)
        pad_eye[k, idx, idx] = 1.0
    return dof_block, dof_pos, pad_eye, n_blocks


def build_layout(graph: PoseGraphData) -> SystemLayout:
    p2 = _np(graph.pose2_offsets)
    l2 = _np(graph.lm2_offsets)
    p3 = _np(graph.pose3_offsets)
    empty = np.zeros(0, np.int64)
    pp_i = p2[_np(graph.pp_from)] if p2.size else empty
    pp_j = p2[_np(graph.pp_to)] if p2.size else empty
    pl_i = p2[_np(graph.pl_pose)] if p2.size else empty
    pl_j = l2[_np(graph.pl_lm)] if l2.size else empty
    qq_i = p3[_np(graph.qq_from)] if p3.size else empty
    qq_j = p3[_np(graph.qq_to)] if p3.size else empty

    rows, cols = [], []
    for off_r, off_c, nr, nc in [
        (pp_i, pp_i, 3, 3), (pp_i, pp_j, 3, 3),
        (pp_j, pp_i, 3, 3), (pp_j, pp_j, 3, 3),
        (pl_i, pl_i, 3, 3), (pl_i, pl_j, 3, 2),
        (pl_j, pl_i, 2, 3), (pl_j, pl_j, 2, 2),
        (qq_i, qq_i, 6, 6), (qq_i, qq_j, 6, 6),
        (qq_j, qq_i, 6, 6), (qq_j, qq_j, 6, 6),
    ]:
        r, c = _block_indices(off_r, off_c, nr, nc)
        rows.append(r)
        cols.append(c)

    nnz_edges = sum(r.size for r in rows)

    # gauge prior diagonal (first SE2 edge's from pose; for pure-3D graphs
    # the first SE3 edge's from pose)
    if graph.prior2 >= 0:
        pr = p2[graph.prior2] + np.arange(3)
    elif graph.prior3 >= 0:
        pr = p3[graph.prior3] + np.arange(6)
    else:
        pr = np.zeros(0, np.int64)
    rows.append(pr)
    cols.append(pr)
    prior_slice = slice(nnz_edges, nnz_edges + pr.size)

    # λ damping on every diagonal; always present, 0 for GN
    diag = np.arange(graph.total_dof)
    rows.append(diag)
    cols.append(diag)
    lam_slice = slice(prior_slice.stop, prior_slice.stop + diag.size)

    plan = _linearize_plan(((pp_i, 3), (pp_j, 3), (pl_i, 3), (pl_j, 2)),
                           graph.total_dof,
                           pl_base=sum(r.size for r in rows[:4]),
                           prior_base=prior_slice.start,
                           nnz=lam_slice.stop)

    rows_all = np.concatenate(rows).astype(np.int32)
    cols_all = np.concatenate(cols).astype(np.int32)
    n = graph.total_dof

    # ELL structure: sort by (row, col), group duplicates
    order = np.lexsort((cols_all, rows_all))
    rs, cs = rows_all[order], cols_all[order]
    new_group = np.ones(len(rs), bool)
    new_group[1:] = (rs[1:] != rs[:-1]) | (cs[1:] != cs[:-1])
    seg = np.cumsum(new_group) - 1
    uniq_r, uniq_c = rs[new_group], cs[new_group]
    # slot within row (unique entries are row-sorted)
    row_start = np.searchsorted(uniq_r, np.arange(n), side="left")
    slot = np.arange(len(uniq_r)) - row_start[uniq_r]
    width = int(slot.max()) + 1 if len(slot) else 1
    nbr = np.zeros((n, width), np.int32)
    nbr[uniq_r, slot] = uniq_c
    ell_pos = uniq_r.astype(np.int64) * width + slot

    dof_block, dof_pos, pad_eye, n_blocks = block_maps(p2, l2, p3, n)

    # Schur split maps
    dof_is_lm = np.zeros(n, bool)
    for o in l2:
        dof_is_lm[o:o + 2] = True
    pose_dofs = np.where(~dof_is_lm)[0].astype(np.int32)
    lm_dofs = np.where(dof_is_lm)[0].astype(np.int32)
    dof_compact = np.zeros(n, np.int32)
    dof_compact[pose_dofs] = np.arange(len(pose_dofs))
    dof_compact[lm_dofs] = np.arange(len(lm_dofs))

    return SystemLayout(
        rows=rows_all,
        cols=cols_all,
        n=n,
        prior_slice=prior_slice,
        lam_slice=lam_slice,
        ell_order=order,
        ell_seg=seg.astype(np.int32),
        ell_nnz=int(len(uniq_r)),
        ell_pos=ell_pos,
        ell_nbr=nbr,
        ell_width=width,
        dof_block=dof_block,
        dof_pos=dof_pos,
        pad_eye=pad_eye,
        n_blocks=n_blocks,
        dof_is_lm=dof_is_lm,
        pose_dofs=pose_dofs,
        lm_dofs=lm_dofs,
        dof_compact=dof_compact,
        linearize_plan=plan,
    )


def _linearize_plan(ends, n: int, pl_base: int, prior_base: int, nnz: int):
    """The SE2 kernel's plan: the triplet offsets, and b's incidence
    plan over ``ends``, the (first-dof offsets, dofs) of the pose-pose b_i,
    b_j and pose-landmark b_i, b_j parts in ``system_values_plain``'s
    index_add_ order. Every endpoint's dofs appear once, each in its dof's
    row; a row lists its parts in ascending order (a stable sort of their
    destinations), the order index_add_ adds them on the CPU."""
    dest = np.concatenate([
        (offsets[None, :] + np.arange(d)[:, None]).ravel()
        for offsets, d in ends]).astype(np.int64)
    counts = np.bincount(dest, minlength=n)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    return linearize_kernels.LinearizePlan(
        ptr=ptr.astype(np.int32),
        src=np.argsort(dest, kind="stable").astype(np.int32),
        max_degree=int(counts.max(initial=0)), pl_base=pl_base,
        prior_base=prior_base, nnz=nnz)


def _add_rhs(bvec, offsets, comp):
    """bvec[..., offsets + k] += comp[..., k, :] for every component k of
    comp (..., d, E)."""
    d = comp.shape[-2]
    idx = offsets[None, :] + torch.arange(d, device=offsets.device)[:, None]
    bvec.index_add_(-1, idx.reshape(-1),
                    comp.reshape(comp.shape[:-2] + (-1,)))


def _quad_blocks(e, a, b, omega):
    """(H_ii, H_ij, H_ji, H_jj, b_i, b_j) of a batch of edges: e (..., E,
    d), a, b, omega (..., E, d, d) in; entry-major (..., d, d, E) blocks
    and (..., d, E) RHS parts out, the order of ``_block_indices``. The
    products are elementwise multiply-adds, not matmuls, so no
    reduced-precision (TF32) pass can touch them: the 1e7 gauge prior
    makes a TF32 system go NaN."""
    a, b, om = (t.movedim(-3, -1) for t in (a, b, omega))
    om_a = linearize._mat_tmul(om, a)  # Ω A (Ω symmetric)
    om_b = linearize._mat_tmul(om, b)
    h_ii = linearize._mat_tmul(a, om_a)  # Aᵀ Ω A
    h_ij = linearize._mat_tmul(a, om_b)  # Aᵀ Ω B
    h_jj = linearize._mat_tmul(b, om_b)  # Bᵀ Ω B
    om_e = linearize._mat_tvec(om, e.movedim(-2, -1))
    b_i = linearize._mat_tvec(a, om_e)  # Aᵀ Ω e
    b_j = linearize._mat_tvec(b, om_e)
    return h_ii, h_ij, h_ij.transpose(-3, -2), h_jj, b_i, b_j


ROBUST_KERNELS = {
    # weight(chi2) for iteratively-reweighted least squares; chi2 is the
    # edge's squared Mahalanobis error
    "huber": lambda c2, d: torch.clamp(
        d / torch.sqrt(torch.clamp(c2, min=1e-20)), max=1.0),
    "cauchy": lambda c2, d: 1.0 / (1.0 + c2 / (d * d)),
}

# Adaptive kernels, as in the JAX package:
# - "barron": Barron's general robust loss (alpha sweeps L2 -> Charbonnier
#   -> Cauchy -> Geman-McClure -> Welsch); IRLS weight
#   w = ((r/c)^2 / |alpha - 2| + 1) ^ (alpha/2 - 1);
# - "gnc-gm": graduated non-convexity over Geman-McClure, weight
#   w = (mu c^2 / (r^2 + mu c^2))^2, mu annealed mu0 -> 1 by the optimizer
#   loop (mapping.pgo); assembly only evaluates the weight at the given mu.
ADAPTIVE_KERNELS = ("barron", "gnc-gm")
# mu0 ceiling of the GNC continuation (the JAX package's swept value)
GNC_MU0_CAP = 1e3


def _mu(mu, c2):
    """The GNC parameter as a value that broadcasts against c2: None is 1;
    a tensor carries the graph's batch shape (0-d for one graph) and gains
    the edge axis."""
    if mu is None:
        return 1.0
    if torch.is_tensor(mu):
        return mu.to(c2.dtype)[..., None]
    return mu


def robust_weight(robust, c2, delta, alpha=-2.0, mu=None):
    """Per-edge IRLS weight for the given kernel at squared error c2
    (..., E).

    ``robust`` in {None, "huber", "cauchy", "barron", "gnc-gm"};
    ``delta`` is the kernel scale c, ``alpha`` the Barron shape, ``mu``
    the GNC continuation parameter (None -> 1; a tensor of the graph's
    batch shape for a fleet, one μ a row).
    """
    if robust is None:
        return torch.ones_like(c2)
    if robust in ROBUST_KERNELS:
        return ROBUST_KERNELS[robust](c2, delta)
    if robust == "barron":
        alpha = float(alpha)
        if alpha >= 2.0:
            return torch.ones_like(c2)
        base = c2 / (delta * delta) / (2.0 - alpha) + 1.0
        return base ** (alpha / 2.0 - 1.0)
    if robust == "gnc-gm":
        s = _mu(mu, c2) * delta * delta
        return (s / (c2 + s)) ** 2
    raise ValueError(f"unknown robust kernel {robust!r}")


def robust_rho(robust, c2, delta, alpha=-2.0, mu=None):
    """Per-edge robust loss rho(c2) matching ``robust_weight`` (the IRLS
    weights are 2 d rho / d c2 normalized to 1 at 0): the LM accept test's
    objective in a robust run."""
    if robust is None:
        return c2
    d2 = delta * delta
    if robust == "huber":
        r = torch.sqrt(torch.clamp(c2, min=1e-20))
        return torch.where(c2 <= d2, c2, 2.0 * delta * r - d2)
    if robust == "cauchy":
        return d2 * torch.log1p(c2 / d2)
    if robust == "barron":
        alpha = float(alpha)
        if alpha >= 2.0:
            return c2
        if alpha == 0.0:
            return 2.0 * d2 * torch.log1p(c2 / (2.0 * d2))
        b = 2.0 - alpha
        return (2.0 * d2 * b / alpha) * (
            (c2 / (d2 * b) + 1.0) ** (alpha / 2.0) - 1.0)
    if robust == "gnc-gm":
        s = _mu(mu, c2) * d2
        return s * c2 / (s + c2)
    raise ValueError(f"unknown robust kernel {robust!r}")


def odometry(fr, to):
    """Pose-pose edges between consecutive poses (|to - from| = 1): the
    ones ``robust_edges="closures"`` keeps at L2."""
    return (to - fr).abs() == 1


@spanned("linearize")
def system_values(graph: PoseGraphData, lam, prior_weight=PRIOR_WEIGHT,
                  robust=None, robust_delta=1.0, robust_alpha=-2.0,
                  mu=None, robust_edges="closures", plan=None):
    """Flat triplet values (aligned with build_layout) + RHS b (negated)
    + total χ². ``lam`` is a number or a tensor of the graph's batch shape
    (0-d for one graph). A fleet gives vals (B, nnz), b (B, n) and χ²
    (B,).

    ``robust``: optional M-estimator ("huber", "cauchy", "barron",
    "gnc-gm"); every edge's contribution is scaled by the IRLS weight of
    its current squared error. ``robust_alpha`` is the Barron shape,
    ``mu`` the GNC continuation parameter (a number, or a tensor of the
    batch shape). ``robust_edges="closures"`` keeps odometry pose-pose
    edges (|to - from| = 1) at L2; "all" robustifies every edge. The
    returned χ² stays the raw quadratic error.

    A CUDA f32 graph with no SE3 edge and ``robust`` None or "gnc-gm"
    takes the SE2 kernel (``linearize_kernels.takes_kernel``; μ read on the
    device): the same vals bit for bit, b and χ² summed in a fixed order.
    It writes where ``plan`` says, the
    graph's ``build_layout(graph).linearize_plan``: a caller that
    linearizes one structure many times passes it (moved to the card
    once); without it this call builds the layout. Every other graph
    takes ``system_values_plain`` and ignores ``plan``."""
    if linearize_kernels.takes_kernel(graph.device, graph.dtype,
                                      graph.qq_from.shape[0], robust):
        if plan is None:
            plan = build_layout(graph).linearize_plan
        return linearize_kernels.se2_linearize_kernel(
            graph, lam, prior_weight, plan, robust=robust,
            robust_delta=robust_delta, mu=mu, robust_edges=robust_edges)
    return system_values_plain(graph, lam, prior_weight, robust,
                               robust_delta, robust_alpha, mu, robust_edges)


def system_values_plain(graph: PoseGraphData, lam, prior_weight=PRIOR_WEIGHT,
                        robust=None, robust_delta=1.0, robust_alpha=-2.0,
                        mu=None, robust_edges="closures"):
    """``system_values`` in tensor code, on any device and dtype, every
    edge type and robust kernel: the plain version the CPU runs and the
    SE2 kernel is held to on the card."""
    dtype, device = graph.dtype, graph.device
    batch = graph.batch_shape
    n = graph.total_dof
    bvec = torch.zeros(batch + (n,), dtype=dtype, device=device)

    def weight(c2, fr=None, to=None):
        w = robust_weight(robust, c2, robust_delta, alpha=robust_alpha,
                          mu=mu)
        if robust and robust_edges == "closures" and fr is not None:
            w = torch.where(odometry(fr, to), torch.ones_like(w), w)
        return w

    def weighted(blocks, rhs, w):
        if not robust:
            return blocks, rhs
        return ([h * w[..., None, None, :] for h in blocks],
                [r * w[..., None, :] for r in rhs])

    # SE2-SE2 edges
    _, hii, hij, hjj, b_i, b_j, c2_pp = linearize.edge_terms_pp_soa(
        graph.poses2, graph.pp_from, graph.pp_to, graph.pp_z, graph.pp_omega)
    blocks, (b_i, b_j) = weighted(
        [hii, hij, hij.transpose(-3, -2), hjj], [b_i, b_j],
        weight(c2_pp, graph.pp_from, graph.pp_to))
    vals = list(blocks)
    _add_rhs(bvec, graph.pose2_offsets[graph.pp_from], b_i)
    _add_rhs(bvec, graph.pose2_offsets[graph.pp_to], b_j)

    # SE2-XY edges
    _, hii, hij, hjj, b_i, b_j, c2_pl = linearize.edge_terms_pl_soa(
        graph.poses2, graph.landmarks2,
        graph.pl_pose, graph.pl_lm, graph.pl_z, graph.pl_omega)
    blocks, (b_i, b_j) = weighted(
        [hii, hij, hij.transpose(-3, -2), hjj], [b_i, b_j], weight(c2_pl))
    vals += blocks
    _add_rhs(bvec, graph.pose2_offsets[graph.pl_pose], b_i)
    _add_rhs(bvec, graph.lm2_offsets[graph.pl_lm], b_j)
    chi2 = c2_pp.sum(-1) + c2_pl.sum(-1)

    # SE3-SE3 edges
    if graph.qq_from.shape[0]:
        e, a, b, c2_qq = linearize.edge_terms_qq(
            graph.poses3, graph.qq_from, graph.qq_to, graph.qq_z,
            graph.qq_omega)
        *blocks, b_i, b_j = _quad_blocks(e, a, b, graph.qq_omega)
        blocks, (b_i, b_j) = weighted(
            blocks, [b_i, b_j], weight(c2_qq, graph.qq_from, graph.qq_to))
        vals += blocks
        _add_rhs(bvec, graph.pose3_offsets[graph.qq_from], b_i)
        _add_rhs(bvec, graph.pose3_offsets[graph.qq_to], b_j)
        chi2 = chi2 + c2_qq.sum(-1)
    vals = [v.reshape(batch + (-1,)) for v in vals]

    # gauge prior values
    prior = 3 if graph.prior2 >= 0 else 6 if graph.prior3 >= 0 else 0
    vals.append(torch.full(batch + (prior,), prior_weight, dtype=dtype,
                           device=device))
    if torch.is_tensor(lam):
        vals.append(lam.to(dtype)[..., None].expand(batch + (n,)))
    else:
        vals.append(torch.full(batch + (n,), float(lam), dtype=dtype,
                               device=device))
    return torch.cat(vals, -1), -bvec, chi2


def dense_hessian(layout: SystemLayout, vals):
    """Scatter triplets into a dense (..., n, n) H."""
    n = layout.n
    rows = torch.as_tensor(layout.rows, dtype=torch.long, device=vals.device)
    cols = torch.as_tensor(layout.cols, dtype=torch.long, device=vals.device)
    h = vals.new_zeros(vals.shape[:-1] + (n * n,))
    h.index_add_(-1, rows * n + cols, vals)
    return h.view(vals.shape[:-1] + (n, n))


@spanned("update")
def apply_update(graph: PoseGraphData, dx) -> PoseGraphData:
    """Manifold retraction of every node from a reference-layout dx
    (..., n), batched as the graph."""
    updates = {}
    if graph.pose2_offsets.shape[0]:
        idx = graph.pose2_offsets[:, None] + torch.arange(3, device=dx.device)
        updates["poses2"] = se2.retract(graph.poses2, dx[..., idx])
    if graph.lm2_offsets.shape[0]:
        idx = graph.lm2_offsets[:, None] + torch.arange(2, device=dx.device)
        updates["landmarks2"] = graph.landmarks2 + dx[..., idx]
    if graph.pose3_offsets.shape[0]:
        idx = graph.pose3_offsets[:, None] + torch.arange(6, device=dx.device)
        updates["poses3"] = se3.retract(graph.poses3, dx[..., idx])
    return graph.replace(**updates)
