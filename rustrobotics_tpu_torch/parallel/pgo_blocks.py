"""Map-block distributed pose-graph optimization over ``torch.distributed``
(counterpart of ``rustrobotics_tpu/parallel/pgo_blocks.py``).

Nodes AND edges are partitioned over the blocks axis of a mesh by the
static ``block_layout`` (node-RCM contiguous dof chunks); rank d of the
axis holds row d of the layout's stacked arrays, and every collective of
an iteration moves only SEPARATOR-sized data:

- assembly: each rank linearizes its own edges and scatters local ELL
  values; exactly ``h`` boundary rows (h = the RCM band, independent of
  n) are sent to the right neighbour(s) and added there once per GN
  iteration (``batch_isend_irecv``, JAX's ``ppermute``);
- solve: preconditioned CG whose matvec exchanges ``h`` halo values of x
  with the neighbours and whose dot products are ``all_reduce``d (JAX's
  ``psum``). The matvec is OVERLAPPED when the halo is small: the halo
  receives are posted, the interior product runs on the owned values,
  and only 2h boundary rows take corrections after the receives land.
  Three preconditioners behind a D-aware ``auto`` default: ``jacobi``
  (per-node 6x6 blocks), ``schwarz`` (additive Schwarz: each rank
  factors its owned banded diagonal block by cyclic reduction once per
  GN iteration, ``ops.band_chol.cr_factorize``, and applies it without
  communication) and ``schwarz2`` (two-level: Schwarz plus a Galerkin
  coarse correction over per-block translation/rotation rigid modes, one
  (D, nc) all-reduce a round). ``auto`` takes Schwarz whenever D > 1;
- update: dx halo exchange (h values) + local manifold retraction of the
  owned and halo node copies (the same arithmetic on both sides, so the
  copies never drift).

JAX runs the whole GN/LM loop as one ``lax.while_loop`` inside a
``shard_map``; here the loops run on the host, each stop test reading one
all-reduced scalar (one host read a CG round and one a GN iteration).
Every rank of the blocks axis reads the same all-reduced value, so all
stop together. On a 2-D (replica x blocks) mesh each replica row runs its
own optimization; the only traffic on the replica axis is the MAX of the
stop flags, which keeps the rows' trip counts equal (a converged row
loops on with its CG state frozen).
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch
import torch.distributed as dist

from rustrobotics_tpu_torch.geometry import se2, se3
from rustrobotics_tpu_torch.mapping import linearize
from rustrobotics_tpu_torch.mapping.assemble import PRIOR_WEIGHT, _quad_blocks
from rustrobotics_tpu_torch.mapping.solvers import block_precond
from rustrobotics_tpu_torch.ops.band_chol import (
    cr_factorize,
    cr_invert,
    cr_substitute_inv,
)
from rustrobotics_tpu_torch.parallel.block_layout import (  # noqa: F401
    BlockLayout,
    build_block_layout,
)


# ------------------------------------------------------------- the mesh

@dataclasses.dataclass(frozen=True)
class _Comm:
    """This rank's place on a 1-D (blocks) or 2-D (replica x blocks)
    mesh and the process groups of its axes."""
    group: object            # the blocks axis's group
    d: int                   # place on the blocks axis
    peers: tuple             # global rank of each place on the blocks axis
    order: tuple             # group-rank position of each place
    rep_group: object = None  # the replica axis's group (2-D mesh)
    r: int = 0               # place on the replica axis
    rep_peers: tuple = ()    # global rank of each replica row, my column

    def psum(self, t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def post(self, sends, recvs):
        """Start point-to-point messages: sends and recvs are lists of
        (tensor, place on the blocks axis). Returns the requests."""
        ops = [dist.P2POp(dist.isend, t, self.peers[p], self.group)
               for t, p in sends]
        ops += [dist.P2POp(dist.irecv, t, self.peers[p], self.group)
                for t, p in recvs]
        return dist.batch_isend_irecv(ops) if ops else []

    def gather(self, t):
        """(D, *t.shape): every place's t on the blocks axis, in place
        order."""
        size = len(self.peers)
        out = t.new_empty(size * t.numel())
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, t.reshape(-1).contiguous(), group=self.group)
        out = out.view((size,) + tuple(t.shape))
        return out[list(self.order)] if list(self.order) != list(
            range(size)) else out


def _comm(mesh) -> _Comm:
    grid = mesh.mesh
    coord = mesh.get_coordinate()
    blocks_group = mesh.get_group(mesh.ndim - 1)
    group_ranks = dist.get_process_group_ranks(blocks_group)
    if mesh.ndim == 1:
        peers = tuple(int(p) for p in grid.tolist())
        return _Comm(blocks_group, int(coord[0]), peers,
                     tuple(group_ranks.index(p) for p in peers))
    r, d = int(coord[0]), int(coord[1])
    peers = tuple(int(p) for p in grid[r].tolist())
    return _Comm(blocks_group, d, peers,
                 tuple(group_ranks.index(p) for p in peers),
                 rep_group=mesh.get_group(0), r=r,
                 rep_peers=tuple(int(p) for p in grid[:, d].tolist()))


# ----------------------------------------------------------------- halos

def _halo_post(x, cm: _Comm, D, ndof, h):
    """Post the halo exchange of the owned (ndof, ...) x: returns
    (x_ext, requests), x_ext (ndof + 2h, ...) receiving only the
    neighbour-halo values (the owned slots stay zero) once the requests
    are waited on.

    The exchange moves exactly h values per side, split into
    ceil(h/ndof) hops when the halo spans several chunks (tiny graphs on
    wide meshes). Ranks at the ring ends receive nothing: those ext slots
    stay zero (dofs outside [0, n_pad), never referenced)."""
    x_ext = x.new_zeros((ndof + 2 * h,) + tuple(x.shape[1:]))
    if h == 0 or D == 1:
        return x_ext, []
    x = x.contiguous()
    d = cm.d
    sends, recvs = [], []
    for k in range(1, -(-h // ndof) + 1):
        lo = max(0, k * ndof - h)
        ln = ndof - lo
        if ln > 0:  # left halo: place i sends to i + k
            if d + k < D:
                sends.append((x[lo:lo + ln], d + k))
            if d - k >= 0:
                dst = h - k * ndof + lo
                recvs.append((x_ext[dst:dst + ln], d - k))
        rn = min(ndof, h - (k - 1) * ndof)
        if rn > 0:  # right halo: place i + k sends to i
            if d - k >= 0:
                sends.append((x[:rn], d - k))
            if d + k < D:
                dst = h + k * ndof
                recvs.append((x_ext[dst:dst + rn], d + k))
    return x_ext, cm.post(sends, recvs)


def _wait(requests):
    for req in requests:
        req.wait()


def _halo_only(x, cm, D, ndof, h):
    """The (ndof + 2h, ...) vector holding only the neighbour-halo values
    of x (the owned slots zero)."""
    x_ext, reqs = _halo_post(x, cm, D, ndof, h)
    _wait(reqs)
    return x_ext


def _halo_exchange(x, cm, D, ndof, h):
    """Owned (ndof, ...) x -> ext (ndof + 2h, ...) with neighbour
    halos."""
    x_ext = _halo_only(x, cm, D, ndof, h)
    x_ext[h:h + ndof] = x
    return x_ext


def _halo_reduce(buf, cm, D, ndof, h, two_sided=False):
    """Ext-row buffer (ndof + 2h, ...) -> owned (ndof, ...) with the
    bottom-halo contributions added into their owning rank. Min-endpoint
    edge assignment writes only rows >= h, so the default reduction is
    one-sided; schur mode (pl edges on the landmark's owner + clique
    fill) also writes TOP-halo rows owned by left neighbours:
    ``two_sided`` adds the mirrored reduction."""
    owned = buf[h:h + ndof].clone()
    if h == 0 or D == 1:
        return owned
    buf = buf.contiguous()
    d = cm.d
    sends, recvs, adds = [], [], []
    for k in range(1, -(-h // ndof) + 1):
        ln = min(ndof, h - (k - 1) * ndof)
        if ln <= 0:
            break
        if d + k < D:
            sends.append((buf[h + k * ndof:h + k * ndof + ln], d + k))
        if d - k >= 0:
            recv = buf.new_empty((ln,) + tuple(buf.shape[1:]))
            recvs.append((recv, d - k))
            adds.append((0, recv))
        if two_sided:
            # my ext rows [lo_e, hi_e) belong to place d - k; it adds
            # them at the TAIL of its owned range
            lo_e = max(0, h - k * ndof)
            hi_e = max(0, h - (k - 1) * ndof)
            if hi_e > lo_e:
                if d - k >= 0:
                    sends.append((buf[lo_e:hi_e], d - k))
                if d + k < D:
                    recv = buf.new_empty((hi_e - lo_e,)
                                         + tuple(buf.shape[1:]))
                    recvs.append((recv, d + k))
                    adds.append((k * ndof - h + lo_e, recv))
    _wait(cm.post(sends, recvs))
    for dst, recv in adds:
        owned[dst:dst + recv.shape[0]] += recv
    return owned


# ------------------------------------------------------- local assembly

def _em(blocks):
    """Entry-major flatten of (E, nr, nc) dense blocks."""
    return blocks.permute(1, 2, 0).reshape(-1)


def _local_values(st, ed, ndof, h, lam=0.0, schur_pairs=None):
    """Per-rank linearization: (vals (T,), b_ext (ndof+2h,), chi2,
    schur_state).

    Emission order MUST match block_layout's triplet construction:
    families [pp, pl, qq] (quadrants [ii, ij, ji, jj], entries k-major),
    plus -- in schur mode -- the landmark-clique fill products appended
    last (pl emits only its pose-diagonal ii quadrant there). Mirrors
    assemble.system_values.

    ``schur_pairs``: (pair_a, pair_b) observation-pair index lists
    enabling per-rank Schur elimination of the 2D landmark blocks;
    ``lam`` enters the eliminated Hll (LM damping must be applied BEFORE
    the complement). schur_state = (w_dense (E,3,2), hll_inv (NL,2,2),
    gl (NL,2), off_i (E,), pl_lm (E,)) for back-substitution. A
    component (r, c, E) matrix flattens entry-major by ``reshape(-1)``.
    """
    p2, l2, p3 = st
    (p2_dof, l2_dof, p3_dof,
     pp_from, pp_to, pp_z, pp_omega,
     pl_pose, pl_lm, pl_z, pl_omega,
     qq_from, qq_to, qq_z, qq_omega) = ed
    schur = schur_pairs is not None
    dtype = p2.dtype
    bvec = p2.new_zeros(ndof + 2 * h)
    vals = []
    pair_vals = []
    schur_state = None

    # SE2-SE2
    _, hii, hij, hjj, b_i, b_j, c2 = linearize.edge_terms_pp_soa(
        p2, pp_from, pp_to, pp_z, pp_omega)
    vals += [hii.reshape(-1), hij.reshape(-1),
             hij.transpose(0, 1).reshape(-1), hjj.reshape(-1)]
    off_i = p2_dof[pp_from]
    off_j = p2_dof[pp_to]
    for k in range(3):
        bvec.index_add_(0, off_i + k, b_i[k])
        bvec.index_add_(0, off_j + k, b_j[k])
    chi2 = torch.sum(c2)

    # SE2-XY
    _, hii, hij, hjj, b_i, b_j, c2 = linearize.edge_terms_pl_soa(
        p2, l2, pl_pose, pl_lm, pl_z, pl_omega)
    off_i = p2_dof[pl_pose]
    off_j = l2_dof[pl_lm]
    for k in range(3):
        bvec.index_add_(0, off_i + k, b_i[k])
    chi2 = chi2 + torch.sum(c2)
    if not schur:
        vals += [hii.reshape(-1), hij.reshape(-1),
                 hij.transpose(0, 1).reshape(-1), hjj.reshape(-1)]
        for k in range(2):
            bvec.index_add_(0, off_j + k, b_j[k])
    else:
        # per-rank Schur elimination of the 2D landmark blocks: only the
        # pose-diagonal ii quadrant enters H directly; the landmark
        # coupling returns as clique-fill products below
        vals.append(hii.reshape(-1))
        nl = l2.shape[0]
        w_dense = hij.permute(2, 0, 1)                         # (E, 3, 2)
        hjj_dense = hjj.permute(2, 0, 1)                       # (E, 2, 2)
        bj_dense = b_j.transpose(0, 1)                         # (E, 2)
        hll = p2.new_zeros(nl, 2, 2).index_add_(0, pl_lm, hjj_dense)
        hll = hll + torch.eye(2, dtype=dtype, device=p2.device) * (
            lam + 1e-10)
        gl = p2.new_zeros(nl, 2).index_add_(0, pl_lm, bj_dense)
        hll_inv = torch.linalg.inv_ex(hll).inverse  # singular: inf/NaN
        a_e = torch.einsum("eik,ekl->eil", w_dense, hll_inv[pl_lm])
        # reduced gradient: gp' = gp - sum_o A_o gl_l(o)
        corr = torch.einsum("eik,ek->ei", a_e, gl[pl_lm])
        for k in range(3):
            bvec.index_add_(0, off_i + k, -corr[:, k])
        pair_a, pair_b = schur_pairs
        prod = -torch.einsum("qik,qjk->qij", a_e[pair_a],
                             w_dense[pair_b])                  # (Q, 3, 3)
        pair_vals = [_em(prod)]
        schur_state = (w_dense, hll_inv, gl, off_i, pl_lm)

    # SE3-SE3
    e, a, b, c2 = linearize.edge_terms_qq(p3, qq_from, qq_to, qq_z, qq_omega)
    h_ii, h_ij, h_ji, h_jj, b_i, b_j = _quad_blocks(e, a, b, qq_omega)
    vals += [h_ii.reshape(-1), h_ij.reshape(-1), h_ji.reshape(-1),
             h_jj.reshape(-1)]
    six = torch.arange(6, device=p3.device)
    idx_i = (p3_dof[qq_from][:, None] + six[None, :]).reshape(-1)
    idx_j = (p3_dof[qq_to][:, None] + six[None, :]).reshape(-1)
    bvec.index_add_(0, idx_i, b_i.transpose(0, 1).reshape(-1))
    bvec.index_add_(0, idx_j, b_j.transpose(0, 1).reshape(-1))
    chi2 = chi2 + torch.sum(c2)

    vals += pair_vals  # schur fill LAST (matches block_layout order)
    return torch.cat(vals), bvec, chi2, schur_state


def _local_chi2(st, ed):
    """Residual-only χ² of the local edge shard (for LM accept/reject)."""
    p2, l2, p3 = st
    (_, _, _, pp_from, pp_to, pp_z, pp_omega,
     pl_pose, pl_lm, pl_z, pl_omega,
     qq_from, qq_to, qq_z, qq_omega) = ed
    e = linearize.residual_pp(p2[pp_from], p2[pp_to], pp_z)
    chi2 = linearize.quad_form(e, pp_omega).sum()
    e = linearize.residual_pl(p2[pl_pose], l2[pl_lm], pl_z)
    chi2 = chi2 + linearize.quad_form(e, pl_omega).sum()
    e = linearize.residual_qq(p3[qq_from], p3[qq_to], qq_z)
    return chi2 + linearize.quad_form(e, qq_omega).sum()


def _retract(st, dx_ext, p2_dof, l2_dof, p3_dof):
    """Manifold retraction of ALL local node copies (owned + halo) from
    the halo-exchanged dx. Halo copies see the same dx values as their
    owners, so the copies stay bit-identical."""
    p2, l2, p3 = st
    dev = dx_ext.device
    if p2.shape[0]:
        p2 = se2.retract(p2, dx_ext[p2_dof[:, None]
                                    + torch.arange(3, device=dev)])
    if l2.shape[0]:
        l2 = l2 + dx_ext[l2_dof[:, None] + torch.arange(2, device=dev)]
    if p3.shape[0]:
        p3 = se3.retract(p3, dx_ext[p3_dof[:, None]
                                    + torch.arange(6, device=dev)])
    return (p2, l2, p3)


# ------------------------------------------------------------ optimizer

_STATE_FIELDS = ("p2_state0", "l2_state0", "p3_state0")
_EDGE_FIELDS = (
    "p2_dof", "l2_dof", "p3_dof",
    "pp_from", "pp_to", "pp_z", "pp_omega",
    "pl_pose", "pl_lm", "pl_z", "pl_omega",
    "qq_from", "qq_to", "qq_z", "qq_omega",
)
_MAP_FIELDS = (
    "ell_order", "ell_seg", "ell_pos", "nbr", "diag_pos",
    "pad_diag", "prior_diag", "dof_block", "dof_pos",
    "blk_idx", "blk_mask", "pad_eye", "band_idx", "band_mask",
    "pair_a", "pair_b", "lm_ind",
)


@dataclasses.dataclass(frozen=True)
class _Dims:
    """Static dimensions shared by the per-rank functions."""
    D: int
    ndof: int
    h: int
    W: int
    nseg: int
    nb: int         # block-Jacobi blocks
    kb_loc: int     # Schwarz local band
    nb_loc: int
    precond: str
    prior_weight: float
    cg_tol: float
    maxiter: int
    dtype: object
    band_pad: object  # (nb_loc, kb_loc, 2kb_loc) np identity pad rows
    schur: bool = False
    replicated: bool = False  # a 2-D (replica x blocks) mesh
    nc: int = 3  # coarse-space columns per block (schwarz2): max node dof
    cg_variant: str = "single"  # "single" (1 all-reduce/round) | "classic"


def _dims_from(layout, precond, prior_weight, cg_tol, cg_maxiter, dtype,
               mesh, cg_variant: str = "auto"):
    if precond == "auto":
        # Schwarz on a multi-rank mesh: each CG round costs two
        # sequential collectives, and the local banded factor cuts round
        # counts ~10x. Jacobi on one rank, where rounds are cheap and the
        # factorization is not amortized. Not schwarz2: its rigid-mode
        # coarse correction was round-neutral on the JAX package's
        # bundled graphs, so its extra all-reduce a round is not paid by
        # default.
        precond = "schwarz" if layout.num_devices > 1 else "jacobi"
    if precond == "schwarz2" and (layout.h > layout.ndof
                                  or layout.num_devices == 1):
        # the Galerkin coarse build splits each block's halo coupling
        # into exactly one left + one right neighbour; a halo wider than
        # the owned chunk (more than one hop) reaches d±2 blocks and
        # would scatter couplings into the wrong A_c entries. Narrow
        # partitions drop to plain Schwarz.
        precond = "schwarz"
    if cg_variant == "auto":
        # single-reduction (Chronopoulos-Gear) CG: the two dot all-reduces
        # of a round fuse into ONE, for one extra AXPY a round
        cg_variant = "single"
    assert cg_variant in ("single", "classic"), cg_variant
    return _Dims(
        D=layout.num_devices, ndof=layout.ndof,
        h=layout.h, W=layout.ell_width, nseg=layout.n_segments,
        nb=layout.n_blocks, kb_loc=layout.kb_loc, nb_loc=layout.nb_loc,
        precond=precond, prior_weight=prior_weight, cg_tol=cg_tol,
        maxiter=(cg_maxiter if cg_maxiter is not None
                 else 2 * layout.n_pad),
        dtype=dtype, band_pad=layout.band_pad, schur=layout.schur,
        replicated=mesh.ndim == 2,
        nc=(int(layout.dof_pos.max()) + 1 if layout.dof_pos.size else 3),
        cg_variant=cg_variant,
    )


def _uniform_over_replicas(dm: _Dims, cm: _Comm, go) -> bool:
    """Loop-continuation flag made identical ACROSS replica rows, read on
    the host.

    The data-dependent loops (CG rounds, GN iterations) run collectives on
    the blocks axis; if replica rows disagreed on trip counts, one row
    would stop issuing collectives while another continues. A MAX over
    the replica axis makes every row run until the LAST row converges
    (converged rows run a few harmless extra rounds). ``go`` is a bool
    tensor or a Python bool."""
    if not dm.replicated:
        return bool(go)
    flag = torch.as_tensor(go, device=_device(cm)).to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=cm.rep_group)
    return bool(flag.item() > 0)


def _device(cm: _Comm):
    """The device of this rank's collectives (its group's backend)."""
    backend = dist.get_backend(cm.group)
    return torch.device("cuda") if backend == "nccl" else torch.device("cpu")


def _assemble(dm: _Dims, cm: _Comm, maps, edges, st, lam, band_pad):
    """Linearize + scatter + halo-reduce + diag adds + preconditioner.

    Returns (tbl (ndof, W), b (ndof,), chi2_global, precond_state,
    schur_state).
    """
    (ell_order, ell_seg, ell_pos, nbr, diag_pos, pad_diag,
     prior_diag, dof_block, dof_pos, blk_idx, blk_mask,
     pad_eye, band_idx, band_mask, pair_a, pair_b, lm_ind) = maps
    ndof, h, W, dtype = dm.ndof, dm.h, dm.W, dm.dtype

    vals, b_ext, chi2_loc, schur_state = _local_values(
        st, edges, ndof, h, lam=lam,
        schur_pairs=(pair_a, pair_b) if dm.schur else None)
    seg_vals = vals.new_zeros(dm.nseg).index_add_(0, ell_seg,
                                                  vals[ell_order])
    flat = vals.new_zeros((ndof + 2 * h) * W + 1).index_add_(0, ell_pos,
                                                             seg_vals)
    # the table and b cross the halo as one (ndof + 2h, W + 1) buffer
    buf = torch.cat([flat[:-1].view(ndof + 2 * h, W), b_ext[:, None]], 1)
    red = _halo_reduce(buf, cm, dm.D, ndof, h, two_sided=dm.schur)
    tbl, b = red[:, :W], red[:, W].contiguous()
    # diagonal additions: LM damping + unit pad + gauge prior; schur
    # mode gives eliminated landmark rows an identity diagonal instead
    # of damping (their dx comes from back-substitution, CG keeps 0)
    extra = (lam * (1.0 - lm_ind) + lm_ind + pad_diag
             + dm.prior_weight * prior_diag)
    tbl_flat = tbl.reshape(-1).index_add_(0, diag_pos, extra)
    tbl = tbl_flat.view(ndof, W)
    chi2 = cm.psum(chi2_loc.reshape(1))[0]

    if dm.precond == "jacobi":
        blocks = torch.where(blk_mask, tbl_flat[blk_idx], 0.0) + pad_eye
        pstate = (blocks,)
    else:  # additive Schwarz: local banded Cholesky of the owned block
        kb, nbl = dm.kb_loc, dm.nb_loc
        npad_loc = nbl * kb
        d_own = tbl_flat[diag_pos]
        dinv = torch.rsqrt(torch.clamp(d_own, min=1e-12))
        dinv_pad = torch.cat([dinv, dinv.new_ones(npad_loc - ndof)])
        r_blocks = torch.where(band_mask, tbl_flat[band_idx], 0.0) \
            + band_pad
        row_scale = dinv_pad.view(nbl, kb)
        dinv_ext = torch.cat([dinv.new_zeros(kb), dinv_pad])
        col_scale = torch.cat(
            [dinv_ext[:npad_loc].view(nbl, kb),
             dinv_ext[kb:].view(nbl, kb)], 1)
        r_blocks = r_blocks * row_scale[:, :, None] * col_scale[:, None, :]
        # cyclic-reduction local factorization, its factors inverted ONCE
        # here (cr_invert) so every application in a CG round is batched
        # matrix-vector products only
        levels, f_root = cr_factorize(r_blocks)
        inv_levels, root_inv = cr_invert(levels, f_root)
        pstate = (inv_levels, root_inv, dinv)
        if dm.precond == "schwarz2":
            pstate = pstate + _coarse_state(dm, cm, maps, tbl, st, edges)
    return tbl, b, chi2, pstate, schur_state


def _coarse_basis(dm: _Dims, maps, st, edges):
    """Per-rank coarse basis R (ndof, nc [+1]): column c is the
    indicator of component c (dof_pos) on this block's REAL dofs -- the
    per-block translation / per-component constant modes -- plus, on SE2
    graphs, the block's RIGID-ROTATION mode about its centroid evaluated
    at the current linearization point (x-dof: -(py - cy), y-dof: px -
    cx, th-dof: 1; the same for landmarks without th). Padded dofs and
    (in Schur mode) eliminated landmark rows are masked out so the
    correction never writes rows CG holds at zero. Columns are locally
    normalized for A_c conditioning (span unchanged)."""
    pad_diag, dof_pos, lm_ind = maps[5], maps[8], maps[16]
    real = 1.0 - pad_diag
    if dm.schur:
        real = real * (1.0 - lm_ind)
    real = real.to(dm.dtype)
    comp = (torch.arange(dm.nc, device=dof_pos.device)[None, :]
            == dof_pos[:, None])
    r = comp.to(dm.dtype) * real[:, None]
    if dm.nc == 3:  # SE2-only graph: append the rigid-rotation column
        p2, l2, _ = st
        p2_dof, l2_dof = edges[0], edges[1]
        ndof, h = dm.ndof, dm.h
        col = r.new_zeros(ndof + 1)   # extra slot: halo dump
        nodes = r.new_zeros(ndof + 1)

        def scat(col, nodes, dof_ext, xy, nd):
            off = dof_ext - h                  # ext -> owned indexing
            ok = (off >= 0) & (off < ndof)     # nodes live wholly in/out
            base = torch.where(ok, off, ndof)  # halo nodes -> dump slot
            val = ok.to(dm.dtype)
            nodes = nodes.index_add(0, base, val)
            col = col.index_add(0, base, torch.where(ok, -xy[:, 1], 0.0))
            col = col.index_add(0, torch.clamp(base + 1, max=ndof),
                                torch.where(ok, xy[:, 0], 0.0))
            if nd == 3:
                col = col.index_add(0, torch.clamp(base + 2, max=ndof), val)
            return col, nodes

        if p2.shape[0]:
            col, nodes = scat(col, nodes, p2_dof, p2[:, :2], 3)
        if l2.shape[0]:
            col, nodes = scat(col, nodes, l2_dof, l2[:, :2], 2)
        col, cnt = col[:ndof], torch.clamp(nodes[:ndof].sum(), min=1.0)
        # subtract the block centroid: rot col = (-(py-cy), px-cx, 1);
        # x rows of col hold -py and y rows hold px, so the centroid is
        # recoverable from the masked constant columns already in r
        cy = -torch.sum(col * r[:, 0]) / cnt
        cx = torch.sum(col * r[:, 1]) / cnt
        col = (col + cy * r[:, 0] - cx * r[:, 1]) * real
        norm = torch.clamp(torch.linalg.vector_norm(col), min=1.0)
        r = torch.cat([r, (col / norm)[:, None]], 1)
    return r


def _coarse_state(dm: _Dims, cm: _Comm, maps, tbl, st, edges):
    """Galerkin coarse operator A_c = Rᵀ A R over the (D, nc) block-
    diagonal basis, built from the assembled band table: one halo
    exchange of the basis and three masked band matvecs a column split
    the row's contribution by source block (own / left / right
    neighbour), so the (D·nc)² matrix keeps its block-tridiagonal
    structure exactly. All-reduced to every rank and inverted once per GN
    iteration; per CG round the correction costs one (D, nc)-float
    all-reduce and two small GEMVs."""
    nbr = maps[3]
    ndof, h, dtype = dm.ndof, dm.h, dm.dtype
    R = _coarse_basis(dm, maps, st, edges)
    nc = R.shape[1]
    d = cm.d

    def mv(x_ext):
        return torch.sum(tbl * x_ext[nbr], 1)

    halo = _halo_only(R, cm, dm.D, ndof, h)         # (ndof + 2h, nc)
    ent = []  # nc' columns x (left, own, right) x (nc,) row dots
    for c in range(nc):
        own_ext = R.new_zeros(ndof + 2 * h)
        own_ext[h:h + ndof] = R[:, c]
        left_ext = halo[:, c].clone()
        left_ext[h:] = 0.0
        right_ext = halo[:, c].clone()
        right_ext[:h + ndof] = 0.0
        ent.append(torch.stack(
            [R.T @ mv(left_ext), R.T @ mv(own_ext),
             R.T @ mv(right_ext)], 0))  # (3, nc rows)
    # ent[c'][which, c] -> A_c[(d, c), (d + which - 1, c')]
    blocks = torch.stack(ent, -1)  # (3, nc rows c, nc cols c')
    ar = torch.arange(nc, device=R.device)
    rows = (d * nc + ar)[:, None].expand(nc, nc)
    ac = R.new_zeros(dm.D * nc, dm.D * nc)
    for which in range(3):
        cols = (((d + which - 1) % dm.D) * nc + ar)[None, :].expand(nc, nc)
        ac.index_put_((rows, cols), blocks[which], accumulate=True)
    ac = cm.psum(ac)
    # ridge keeps absent components (zero columns) harmlessly invertible
    eye = torch.eye(dm.D * nc, dtype=dtype, device=R.device)
    ridge = 1e-8 * torch.trace(ac) / (dm.D * nc) + 1e-30
    ac_inv = torch.linalg.inv_ex(ac + ridge * eye).inverse
    return (R, ac_inv)


def _make_precond(dm: _Dims, cm: _Comm, maps, pstate):
    dof_block, dof_pos = maps[7], maps[8]
    if dm.precond == "jacobi":
        (blocks,) = pstate
        return block_precond(blocks, dof_block * 6 + dof_pos)
    inv_levels, root_inv, dinv = pstate[:3]
    kb, nbl = dm.kb_loc, dm.nb_loc
    npad_loc = nbl * kb

    def local_solve(r):
        rp = torch.cat([r * dinv, r.new_zeros(npad_loc - dm.ndof)])
        xs = cr_substitute_inv(inv_levels, root_inv, rp.view(nbl, kb))
        return xs.reshape(-1)[:dm.ndof] * dinv

    if dm.precond != "schwarz2":
        return local_solve
    R, ac_inv = pstate[3:]
    nc = R.shape[1]

    def precond(r):
        # additive two-level: local subdomain solve + Galerkin coarse
        # correction (one (D, nc) all-reduce + two small GEMVs)
        z = local_solve(r)
        rc_all = r.new_zeros(dm.D, nc)
        rc_all[cm.d] = R.T @ r
        y = ac_inv @ cm.psum(rc_all).reshape(-1)
        return z + R @ y[cm.d * nc:(cm.d + 1) * nc]

    return precond


def _schur_backsub(dm: _Dims, sstate, l2_dof, dx, dx_ext):
    """Local landmark back-substitution: dx_l = -Hll^-1 (gl + W^T dx_p).

    Landmark dofs are rank-owned, so the recovered dx_l is ADDED into
    the owned dx (CG left those slots at 0) and into this rank's ext
    view; no second halo exchange is needed (no other rank reads a
    foreign landmark's dx). Halo/pad landmark rows have gl = 0 and no
    edges, hence dx_l = 0: the scatter-adds leave them as they were."""
    w_dense, hll_inv, gl, off_i, pl_lm = sstate
    dev = dx.device
    dxp_e = dx_ext[off_i[:, None] + torch.arange(3, device=dev)]  # (E, 3)
    wt_dx = torch.zeros_like(gl).index_add_(
        0, pl_lm, torch.einsum("eik,ei->ek", w_dense, dxp_e))
    dx_l = -torch.einsum("lij,lj->li", hll_inv, gl + wt_dx)  # (NL, 2)
    own_pos = torch.clamp(l2_dof - dm.h, 0, dm.ndof - 2)
    # halo lm rows resolve to clipped positions with dx_l = 0: no-ops
    dx, dx_ext = dx.clone(), dx_ext.clone()
    for k in range(2):
        dx.index_add_(0, own_pos + k, dx_l[:, k])
        dx_ext.index_add_(0, l2_dof + k, dx_l[:, k])
    return dx, dx_ext


def _pcg(dm: _Dims, cm: _Comm, tbl, nbr, precond, b, eta=None, bb=None):
    """Distributed preconditioned CG: halo-exchange matvec + all-reduced
    dots. Returns (x, rounds).

    ``eta`` (optional 0-d tensor) overrides the static relative tolerance
    (Eisenstat-Walker forcing); ``bb`` passes the all-reduced |b|^2 so the
    forcing caller pays no second reduction.

    When the halo is SMALL relative to the owned chunk (8h <= ndof) the
    matvec is OVERLAPPED: the halo receives are posted, the product runs
    on the owned values, and only the 2h boundary rows receive halo
    corrections once the receives land. A wide halo would nearly double
    every round's work in corrections, so it takes the plain
    exchange-then-multiply matvec."""
    ndof, h = dm.ndof, dm.h
    overlap = dm.D > 1 and h > 0 and 8 * h <= ndof

    def matvec(x):
        if not overlap:
            x_ext = _halo_exchange(x, cm, dm.D, ndof, h)
            return torch.sum(tbl * x_ext[nbr], 1)
        x_halo, reqs = _halo_post(x, cm, dm.D, ndof, h)  # in flight ...
        x_own = x.new_zeros(ndof + 2 * h)
        x_own[h:h + ndof] = x
        y = torch.sum(tbl * x_own[nbr], 1)               # ... meanwhile
        _wait(reqs)
        y[:h] += torch.sum(tbl[:h] * x_halo[nbr[:h]], 1)
        y[ndof - h:] += torch.sum(tbl[ndof - h:] * x_halo[nbr[ndof - h:]],
                                  1)
        return y

    x0 = torch.zeros_like(b)
    z0 = precond(b)
    if dm.cg_variant == "single":
        return _pcg_single(dm, cm, matvec, precond, b, x0, z0, eta, bb)

    if bb is None:
        d0 = cm.psum(torch.stack([torch.dot(b, z0), torch.dot(b, b)]))
        rz0, bb = d0[0], d0[1]
    else:  # the caller all-reduced |b|^2 already (adaptive forcing)
        rz0 = cm.psum(torch.dot(b, z0).reshape(1))[0]
    tol = dm.cg_tol if eta is None else eta
    atol2 = (tol * tol) * bb

    x, r, z, p, rz, rr, k = x0, b, z0, z0, rz0, bb, 0
    while _uniform_over_replicas(dm, cm, k < dm.maxiter
                                 and bool(rr > atol2)):
        # on a replicated mesh, rows that already converged keep looping
        # (uniform trip counts) but FREEZE their state: the collectives
        # still run, the results are discarded
        done = rr <= atol2
        ap = matvec(p)
        pap = cm.psum(torch.dot(p, ap).reshape(1))[0]
        alpha = rz / pap
        x2 = x + alpha * p
        r2 = r - alpha * ap
        z2 = precond(r2)
        d = cm.psum(torch.stack([torch.dot(r2, z2), torch.dot(r2, r2)]))
        beta = d[0] / rz
        p2 = z2 + beta * p
        rz2, rr2 = d[0], d[1]
        if dm.replicated:
            def keep(new, old):
                return torch.where(done, old, new)
            x2, r2, z2, p2 = (keep(x2, x), keep(r2, r), keep(z2, z),
                              keep(p2, p))
            rz2, rr2 = keep(rz2, rz), keep(rr2, rr)
        x, r, z, p, rz, rr, k = x2, r2, z2, p2, rz2, rr2, k + 1
    return x, k


def _pcg_single(dm: _Dims, cm: _Comm, matvec, precond, b, x0, z0, eta, bb):
    """Single-reduction PCG (Chronopoulos & Gear 1989).

    Classic PCG pays two sequentially dependent scalar reductions a
    round -- (p, Ap) before the state update and (r, z) after. Recurring
    s_k = A p_k beside p_k moves the matvec to the preconditioned
    residual z and lets ALL three dots of a round -- (r, z), (Az, z),
    (r, r) -- ride ONE fused all-reduce:

        x+ = x + alpha p        r+ = r - alpha s
        z+ = M^-1 r+            w+ = A z+
        [gamma+, delta+, rr+] = all_reduce([(r+,z+), (w+,z+), (r+,r+)])
        beta+  = gamma+ / gamma
        alpha+ = gamma+ / (delta+ - beta+ gamma+ / alpha)
        p+ = z+ + beta+ p       s+ = w+ + beta+ s

    The same Krylov iterates as classic CG in exact arithmetic, for one
    extra AXPY a round.
    """
    w0 = matvec(z0)
    if bb is None:
        d0 = cm.psum(torch.stack([torch.dot(b, z0), torch.dot(w0, z0),
                                  torch.dot(b, b)]))
        rz0, wz0, bb = d0[0], d0[1], d0[2]
    else:  # the caller all-reduced |b|^2 already (adaptive forcing)
        d0 = cm.psum(torch.stack([torch.dot(b, z0), torch.dot(w0, z0)]))
        rz0, wz0 = d0[0], d0[1]
    tol = dm.cg_tol if eta is None else eta
    atol2 = (tol * tol) * bb
    alpha0 = rz0 / wz0

    x, r, z, p, sv, rz, alpha, rr, k = x0, b, z0, z0, w0, rz0, alpha0, bb, 0
    while _uniform_over_replicas(dm, cm, k < dm.maxiter
                                 and bool(rr > atol2)):
        done = rr <= atol2
        x2 = x + alpha * p
        r2 = r - alpha * sv
        z2 = precond(r2)
        w2 = matvec(z2)
        d = cm.psum(torch.stack([torch.dot(r2, z2), torch.dot(w2, z2),
                                 torch.dot(r2, r2)]))
        beta = d[0] / rz
        alpha2 = d[0] / (d[1] - beta * d[0] / alpha)
        p2 = z2 + beta * p
        s2 = w2 + beta * sv
        rz2, rr2 = d[0], d[2]
        if dm.replicated:
            def keep(new, old):
                return torch.where(done, old, new)
            x2, r2, z2, p2, s2 = (keep(x2, x), keep(r2, r), keep(z2, z),
                                  keep(p2, p), keep(s2, sv))
            rz2, alpha2, rr2 = keep(rz2, rz), keep(alpha2, alpha), \
                keep(rr2, rr)
        x, r, z, p, sv, rz, alpha, rr, k = (x2, r2, z2, p2, s2, rz2, alpha2,
                                           rr2, k + 1)
    return x, k


def layout_device_arrays(layout: BlockLayout, dtype, device=None):
    """The stacked (D, ...) arrays the per-rank functions read, as tensors
    on ``device`` (None: the card) with the float fields cast to
    ``dtype``: (state, edges, maps) tuples. Every rank holds them all, as
    JAX's global arrays; rank d reads row d."""
    from rustrobotics_tpu_torch.device import resolve_device

    device = resolve_device(device)

    def cast(name):
        arr = getattr(layout, name)
        t = torch.as_tensor(np.ascontiguousarray(arr), device=device)
        return t.to(dtype) if arr.dtype == np.float64 else t

    state = tuple(cast(n) for n in _STATE_FIELDS)
    edges = tuple(cast(n) for n in _EDGE_FIELDS)
    maps = tuple(cast(n) for n in _MAP_FIELDS)
    return state, edges, maps


def _local_row(arrays, d):
    """Row d of stacked arrays, index fields as int64."""
    out = []
    for a in arrays:
        a = a[d]
        if not a.is_floating_point() and a.dtype != torch.bool:
            a = a.long()
        out.append(a)
    return tuple(out)


def _check_mesh(mesh, layout):
    if mesh.ndim == 2:
        if mesh.shape[-1] != layout.num_devices:
            raise ValueError(f"the mesh's blocks axis has {mesh.shape[-1]} "
                             f"ranks, the layout {layout.num_devices}")
    elif mesh.size() != layout.num_devices:
        raise ValueError(f"the mesh has {mesh.size()} ranks, the layout "
                         f"{layout.num_devices}")


def make_block_optimize(
    mesh,
    layout: BlockLayout,
    num_iterations: int = 50,
    solver: str = "gauss_newton",
    tolerance: float = 1e-4,
    prior_weight: float = PRIOR_WEIGHT,
    cg_tol: float = 1e-10,
    cg_maxiter: int | None = None,
    precond: str = "auto",
    dtype=torch.float64,
    cg_forcing: str = "fixed",
    cg_variant: str = "auto",
):
    """Build the distributed optimizer.

    ``cg_forcing`` selects the inexact-Newton forcing policy (cg_tol
    becomes the tolerance FLOOR in the adaptive modes):

    - ``"fixed"`` (default): the static cg_tol every round.
    - ``"ew"``: Eisenstat-Walker choice 2 -- per-iteration tolerance
      0.9·(|b_k|/|b_{k-1}|)², capped by (|b_k|/|b_0|)^(1/2) so the trace
      still reaches the exact optimum.
    - ``"ew-fast"``: no absolute cap; fewer rounds, plateaus at the loose
      solve's resolution.

    The adaptive modes assume a trustworthy linearization (odometry or
    chordal initialization): on a strongly nonlinear cold start the loose
    early directions wander.

    ``cg_variant``: ``"single"`` (default via ``"auto"``) is the
    Chronopoulos-Gear single-reduction CG, one fused all-reduce a round;
    ``"classic"`` the textbook two-reduction loop. The same Krylov
    iterates in exact arithmetic.

    Returns ``run(state, edges, maps) -> (state', errors, iters,
    cg_rounds)`` where the tuples come from ``layout_device_arrays`` and
    ``state'`` is stacked (D, ...) on every rank of the blocks axis
    (all-gathered at the end). ``errors`` follows the reference trace
    layout (``mapping.pgo.make_optimize`` semantics); iters and
    cg_rounds are ints.

    On a 2-D ``make_mesh_2d`` (replica x blocks) mesh the state tuple
    carries a leading replica axis (R, D, ...): R independent
    optimizations (multi-start initializations) run at once, each sharded
    over the blocks axis; edges/maps stay (D, ...). Each rank returns ITS
    replica row's results (state (D, ...), errors, iters, rounds): the
    replica axis carries nothing but the stop flags' MAX.
    """
    _check_mesh(mesh, layout)
    cm = _comm(mesh)
    dm = _dims_from(layout, precond, prior_weight, cg_tol, cg_maxiter,
                    dtype, mesh, cg_variant=cg_variant)
    lm = solver in ("lm", "levenberg_marquardt")
    ew = cg_forcing in ("ew", "adaptive", "ew-fast")
    ew_cap = cg_forcing != "ew-fast"

    def run(state, edges, maps):
        st0 = tuple((a[cm.r] if dm.replicated else a)[cm.d] for a in state)
        edges_l = _local_row(edges, cm.d)
        maps_l = _local_row(maps, cm.d)
        device = st0[0].device
        band_pad = (torch.as_tensor(dm.band_pad, dtype=dtype, device=device)
                    if dm.precond != "jacobi" else None)
        nbr = maps_l[3]
        p2_dof, l2_dof, p3_dof = edges_l[0], edges_l[1], edges_l[2]

        def scalar(v):
            return torch.tensor(v, dtype=dtype, device=device)

        def do_step(st, lam, bb_prev, bb0):
            tbl, b, chi2, pstate, sstate = _assemble(
                dm, cm, maps_l, edges_l, st, lam, band_pad)
            precond_fn = _make_precond(dm, cm, maps_l, pstate)
            if ew:
                bb = cm.psum(torch.dot(b, b).reshape(1))[0]
                bb0 = torch.where(torch.isfinite(bb0), bb0, bb)
                # Eisenstat-Walker choice 2 (gamma = 0.9, alpha = 2): the
                # CG tolerance tracks GN progress -- loose far from the
                # optimum, tightening as the gradient norm falls. The cap
                # on |b|/|b_0| breaks the loose-solve limit cycle near the
                # optimum (ratio ~1 there, |b|/|b_0| tiny).
                tiny = scalar(1e-300)
                ratio = torch.where(torch.isfinite(bb_prev),
                                    bb / torch.maximum(bb_prev, tiny),
                                    scalar(1.0))
                eta = 0.9 * ratio
                if ew_cap:  # "ew": (|b|/|b0|)^(1/2) on norms
                    eta = torch.minimum(eta, torch.sqrt(torch.sqrt(
                        bb / torch.maximum(bb0, tiny))))
                eta = torch.clamp(eta, dm.cg_tol, 0.1)
                dx, cg_k = _pcg(dm, cm, tbl, nbr, precond_fn, -b, eta=eta,
                                bb=bb)
            else:
                bb = bb_prev
                dx, cg_k = _pcg(dm, cm, tbl, nbr, precond_fn, -b)
            dx_ext = _halo_exchange(dx, cm, dm.D, dm.ndof, dm.h)
            if dm.schur:
                dx, dx_ext = _schur_backsub(dm, sstate, l2_dof, dx, dx_ext)
            new_st = _retract(st, dx_ext, p2_dof, l2_dof, p3_dof)
            norm2 = cm.psum(torch.dot(dx, dx).reshape(1))[0]
            return new_st, norm2, chi2, cg_k, bb, bb0

        def chi2_of(st):
            return cm.psum(_local_chi2(st, edges_l).reshape(1))[0]

        errors = torch.full((num_iterations + 1,), float("nan"),
                            dtype=dtype, device=device)
        if lm:
            errors[0] = chi2_of(st0)
        st = st0
        lam = scalar(0.01)
        last = errors[0].clone() if lm else scalar(float("inf"))
        it, norm_dx, cg_total = 0, float("inf"), 0
        bb_prev, bb0 = scalar(float("inf")), scalar(float("inf"))
        while _uniform_over_replicas(
                dm, cm, it < num_iterations and not norm_dx < tolerance):
            if lm:
                new_st, norm2, chi2, cg_k, bb_prev, bb0 = do_step(
                    st, lam, bb_prev, bb0)
                error = chi2_of(new_st)
                reject = torch.logical_not(error <= last)
                st = tuple(torch.where(reject, a, b_)
                           for a, b_ in zip(st, new_st))
                lam = torch.where(reject, lam * 2.0, lam / 2.0)
                errors[it + 1] = error
                last = torch.where(torch.isnan(error), last, error)
            else:
                st, norm2, chi2, cg_k, bb_prev, bb0 = do_step(
                    st, scalar(0.0), bb_prev, bb0)
                errors[it] = chi2
            it += 1
            norm_dx = float(torch.sqrt(norm2))
            cg_total += cg_k
        if not lm:
            errors[it] = chi2_of(st)
        st = tuple(cm.gather(a) for a in st)
        return st, errors, it, cg_total

    return run


def make_block_step(
    mesh,
    layout: BlockLayout,
    prior_weight: float = PRIOR_WEIGHT,
    cg_tol: float = 1e-12,
    cg_maxiter: int | None = None,
    precond: str = "auto",
    dtype=torch.float64,
    cg_variant: str = "auto",
):
    """One distributed GN step for oracle tests: returns
    ``solve(state, edges, maps, lam) -> (dx (D, ndof), chi2)`` with dx in
    the PADDED global layout (``dx_to_reference`` maps it back),
    all-gathered over the blocks axis."""
    _check_mesh(mesh, layout)
    cm = _comm(mesh)
    dm = _dims_from(layout, precond, prior_weight, cg_tol, cg_maxiter,
                    dtype, mesh, cg_variant=cg_variant)

    def solve(state, edges, maps, lam):
        st = tuple(a[cm.d] for a in state)
        edges_l = _local_row(edges, cm.d)
        maps_l = _local_row(maps, cm.d)
        device = st[0].device
        band_pad = (torch.as_tensor(dm.band_pad, dtype=dtype, device=device)
                    if dm.precond != "jacobi" else None)
        lam = torch.as_tensor(lam, dtype=dtype, device=device)
        tbl, b, chi2, pstate, sstate = _assemble(
            dm, cm, maps_l, edges_l, st, lam, band_pad)
        precond_fn = _make_precond(dm, cm, maps_l, pstate)
        dx, _ = _pcg(dm, cm, tbl, maps_l[3], precond_fn, -b)
        if dm.schur:
            dx_ext = _halo_exchange(dx, cm, dm.D, dm.ndof, dm.h)
            dx, _ = _schur_backsub(dm, sstate, edges_l[1], dx, dx_ext)
        return cm.gather(dx), chi2

    return solve


# -------------------------------------------------------- conveniences

def extract_graph(layout: BlockLayout, graph, state):
    """Owned node rows (stacked (D, ...)) -> the graph in the original
    node order, on the graph's device."""
    p2, l2, p3 = (s.detach().cpu().numpy() for s in state)
    poses2 = graph.poses2.detach().cpu().numpy().copy()
    landmarks2 = graph.landmarks2.detach().cpu().numpy().copy()
    poses3 = graph.poses3.detach().cpu().numpy().copy()
    m = layout.p2_owned
    poses2[layout.p2_orig[m]] = p2[m]
    m = layout.l2_owned
    landmarks2[layout.l2_orig[m]] = l2[m]
    m = layout.p3_owned
    poses3[layout.p3_orig[m]] = p3[m]
    dev = graph.device
    return graph.replace(
        poses2=torch.as_tensor(poses2.astype(p2.dtype), device=dev),
        landmarks2=torch.as_tensor(landmarks2.astype(l2.dtype), device=dev),
        poses3=torch.as_tensor(poses3.astype(p3.dtype), device=dev),
    )


def dx_to_reference(layout: BlockLayout, dx_stacked):
    """(D, ndof) padded dx -> (ref_n,) reference-layout dx (numpy)."""
    if isinstance(dx_stacked, torch.Tensor):
        dx_stacked = dx_stacked.detach().cpu().numpy()
    flat = np.asarray(dx_stacked).reshape(-1)
    ref = layout.padded_to_ref
    out = np.zeros(int(ref.max()) + 1, flat.dtype)
    m = ref >= 0
    out[ref[m]] = flat[m]
    return out


def _graph_dtype(graph):
    return graph.poses2.dtype if graph.poses2.numel() else graph.poses3.dtype


def _check_device(mesh, graph):
    if mesh.device_type != graph.device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot optimize a graph "
                         f"on {graph.device}")


def block_optimize(
    mesh,
    graph,
    num_iterations: int = 50,
    solver: str = "gauss_newton",
    tolerance: float = 1e-4,
    prior_weight: float = PRIOR_WEIGHT,
    cg_tol: float = 1e-10,
    cg_maxiter: int | None = None,
    precond: str = "auto",
    schur: bool = False,
    return_stats: bool = False,
    cg_forcing: str = "fixed",
    cg_variant: str = "auto",
    slice_size: int | None = None,
):
    """End to end: build the layout, run the distributed optimization on
    the 1-D mesh, return (graph', errors list, iterations) on every rank.
    ``schur=True`` eliminates 2D landmark blocks per rank before the
    distributed CG (see build_block_layout). ``return_stats=True``
    appends ``comm_budget``'s dict: total CG rounds, collectives and
    exchanged bytes per GN iteration."""
    _check_device(mesh, graph)
    dtype = _graph_dtype(graph)
    layout = build_block_layout(graph, mesh.size(), schur=schur)
    state, edges, maps = layout_device_arrays(layout, dtype, graph.device)
    run = make_block_optimize(
        mesh, layout, num_iterations=num_iterations, solver=solver,
        tolerance=tolerance, prior_weight=prior_weight, cg_tol=cg_tol,
        cg_maxiter=cg_maxiter, precond=precond, dtype=dtype,
        cg_forcing=cg_forcing, cg_variant=cg_variant,
    )
    out_state, errors, it, cg_total = run(state, edges, maps)
    new_graph = extract_graph(layout, graph, out_state)
    errs = [float(e) for e in errors.cpu().numpy() if not np.isnan(e)]
    if not return_stats:
        return new_graph, errs, it
    stats = comm_budget(layout, dtype, it, cg_total, cg_variant=cg_variant,
                        slice_size=slice_size)
    return new_graph, errs, it, stats


def block_optimize_multistart(
    mesh,
    graph,
    num_iterations: int = 50,
    jitter: float = 0.1,
    seed: int = 0,
    solver: str = "gauss_newton",
    tolerance: float = 1e-4,
    prior_weight: float = PRIOR_WEIGHT,
    cg_tol: float = 1e-10,
    cg_maxiter: int | None = None,
    precond: str = "auto",
    cg_forcing: str = "fixed",
    cg_variant: str = "auto",
):
    """Data-parallel MULTI-START on a 2-D (replica x blocks) mesh: R
    independent optimizations from jittered initializations run at once
    (replica 0 keeps the unperturbed init), each sharded over the blocks
    axis; the best final χ² wins. PGO is non-convex: restarts escape the
    local minima a single descent can land in.

    Node jitter is drawn per ORIGINAL node id (numpy ``default_rng(seed)``,
    the JAX package's draws) and scattered through the layout's
    owned/halo copies, so the copies of a node never desynchronize. After
    the runs, the traces are all-gathered over the replica axis and the
    best replica's state is broadcast over it. Returns (best graph',
    per-replica errors list-of-lists, best replica index) on every
    rank."""
    _check_device(mesh, graph)
    replicas, blocks = mesh.shape
    dtype = _graph_dtype(graph)
    layout = build_block_layout(graph, blocks)
    state, edges, maps = layout_device_arrays(layout, dtype, graph.device)
    rng = np.random.default_rng(seed)

    def jittered(arr, orig, n_orig, comps):
        # (D, rows, c) -> (R, D, rows, c); noise keyed by original node
        # id so owned and halo copies of a node move together
        a = arr.cpu().numpy()
        noise = rng.normal(size=(replicas, max(n_orig, 1), a.shape[-1]))
        noise[0] = 0.0
        noise[..., comps:] = 0.0
        if n_orig == 0 or a.size == 0:
            out = np.broadcast_to(a, (replicas,) + a.shape).copy()
        else:
            per = noise[:, np.asarray(orig), :]  # (R, D, rows, c)
            out = (a[None] + jitter * per).astype(a.dtype)
        return torch.as_tensor(out, device=arr.device)

    p2, l2, p3 = state
    state_r = (
        jittered(p2, layout.p2_orig, graph.poses2.shape[0], 2),
        jittered(l2, layout.l2_orig, graph.landmarks2.shape[0], 2),
        jittered(p3, layout.p3_orig, graph.poses3.shape[0], 3),
    )
    run = make_block_optimize(
        mesh, layout, num_iterations=num_iterations, solver=solver,
        tolerance=tolerance, prior_weight=prior_weight, cg_tol=cg_tol,
        cg_maxiter=cg_maxiter, precond=precond, dtype=dtype,
        cg_forcing=cg_forcing, cg_variant=cg_variant,
    )
    out_state, errors, _, _ = run(state_r, edges, maps)
    cm = _comm(mesh)
    # every replica's trace, gathered over the replica axis
    gathered = errors.new_empty(replicas * errors.numel())
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(gathered, errors.contiguous(), group=cm.rep_group)
    rep_ranks = dist.get_process_group_ranks(cm.rep_group)
    order = [rep_ranks.index(p) for p in cm.rep_peers]
    all_errors = gathered.view(replicas, -1)[order].cpu().numpy()
    finals = np.asarray([
        e[~np.isnan(e)][-1] if np.any(~np.isnan(e)) else np.inf
        for e in all_errors
    ])
    best = int(np.argmin(finals))
    best_state = []
    for a in out_state:
        a = a.contiguous()
        dist.broadcast(a, src=cm.rep_peers[best], group=cm.rep_group)
        best_state.append(a)
    new_graph = extract_graph(layout, graph, best_state)
    traces = [[float(v) for v in e[~np.isnan(e)]] for e in all_errors]
    return new_graph, traces, best


def comm_budget(layout: BlockLayout, dtype, gn_iters: int, cg_total: int,
                cg_variant: str = "auto", slice_size: int | None = None):
    """Analytic per-iteration communication budget of the block program
    (measured CG round counts x static per-round volumes). ``bytes``
    figures are per rank per GN iteration.

    Per CG round: one halo exchange of the search direction (2 messages x
    h values) + 1 fused scalar all-reduce ("single" variant; "classic"
    pays 2 sequential ones). Per GN iteration: the table halo reduce (h
    rows x (W+1) values) + dx exchange + χ²/norm all-reduces.

    ``slice_size`` (ranks per fast-interconnect island: an NVLink domain
    here, an ICI pod slice in the JAX package) adds the budget across
    islands under the JAX package's key ``dcn``. Block ranks are an
    RCM-ordered 1-D chain, so with contiguous ranks per island every halo
    message is nearest-neighbour: only the ``slices - 1`` chain
    boundaries at island edges cross the slow network, each carrying 2
    messages of h values a CG round. The scalar all-reduce spans every
    island: it pays at least one slow-network traversal a round whatever
    D or its payload, so the round-count levers (Schwarz, Eisenstat-
    Walker forcing, single-reduction CG) are the scaling levers across
    islands.
    """
    itemsize = 4 if dtype == torch.float32 else 8
    h, W = layout.h, layout.ell_width
    gn = max(gn_iters, 1)
    cg_per_gn = cg_total / gn
    halo_bytes = h * itemsize
    psums_per_round = 2 if cg_variant == "classic" else 1
    out = {
        "gn_iters": gn_iters,
        "cg_rounds_total": cg_total,
        "cg_rounds_per_gn": round(cg_per_gn, 1),
        "halo_dofs_h": int(h),
        "collectives_per_gn": round(
            cg_per_gn * (2 + psums_per_round) + 6, 1),
        "ppermute_bytes_per_gn": int(
            cg_per_gn * 2 * halo_bytes            # CG halo exchanges
            + h * (W + 1) * itemsize              # assembly halo reduce
            + 2 * halo_bytes),                    # dx exchange
        "note": "per device per GN iteration; psums are scalar",
    }
    if slice_size:
        D = layout.num_devices
        slices = -(-D // slice_size)  # ceil
        dcn_boundaries = max(slices - 1, 0)
        # bytes crossing EACH island boundary per GN iteration (both
        # directions): CG halo exchanges + assembly halo reduce + dx
        per_boundary = int(
            cg_per_gn * 2 * halo_bytes
            + h * (W + 1) * itemsize
            + 2 * halo_bytes) if dcn_boundaries else 0
        out["dcn"] = {
            "slice_size": int(slice_size),
            "slices": int(slices),
            "dcn_boundaries": int(dcn_boundaries),
            "ici_boundaries": int(max(D - 1 - dcn_boundaries, 0)),
            "dcn_bytes_per_boundary_per_gn": per_boundary,
            # sequential slow-network traversals on the critical path per
            # GN: every scalar all-reduce spans the islands; a halo
            # message crosses only at the (slices-1) edge boundaries, in
            # parallel -> at most 1 a round
            "dcn_traversals_per_gn": round(
                cg_per_gn * (psums_per_round
                             + (1 if dcn_boundaries else 0)) + 6, 1),
            "note": "halo traffic is boundary-local (RCM chain -> "
                    "contiguous ranks per slice); psum latency x "
                    "round count dominates DCN cost",
        }
    return out


def block_optimize_elastic(
    mesh,
    graph,
    num_iterations: int = 50,
    segment: int = 10,
    checkpoint_dir=None,
    resume: bool = True,
    solver: str = "gauss_newton",
    tolerance: float = 1e-4,
    prior_weight: float = PRIOR_WEIGHT,
    cg_tol: float = 1e-10,
    cg_maxiter: int | None = None,
    precond: str = "auto",
    cg_forcing: str = "fixed",
    cg_variant: str = "auto",
):
    """Preemption-safe distributed optimization.

    The optimization runs as SEGMENTS of ``segment`` iterations; between
    segments the stacked node state + error trace snapshot to
    ``checkpoint_dir`` (``utils.checkpoint``'s ``.npz``, the JAX
    package's format: a JAX snapshot resumes here and the reverse; the
    blocks axis's rank 0 writes it). After a crash or preemption, calling
    again with ``resume=True`` restores the newest snapshot and
    continues. (In LM mode the damping λ re-adapts at each segment
    boundary from λ0 = 0.01; LM's accept/reject makes that safe, costing
    at most a few rejected trials per resume.)

    Returns (graph', errors list, iterations_done).
    """
    from rustrobotics_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    _check_device(mesh, graph)
    dtype = _graph_dtype(graph)
    layout = build_block_layout(graph, mesh.size())
    state, edges, maps = layout_device_arrays(layout, dtype, graph.device)
    run = make_block_optimize(
        mesh, layout, num_iterations=segment, solver=solver,
        tolerance=tolerance, prior_weight=prior_weight, cg_tol=cg_tol,
        cg_maxiter=cg_maxiter, precond=precond, dtype=dtype,
        cg_forcing=cg_forcing, cg_variant=cg_variant,
    )
    cm = _comm(mesh)

    start = 0
    errors: list = []
    ckdir = pathlib.Path(checkpoint_dir) if checkpoint_dir else None
    if ckdir is not None and resume and ckdir.exists():
        snaps = sorted(ckdir.glob("block_*.npz"))
        if snaps:
            template = (state, np.zeros(0))
            (state, errs), step = restore_checkpoint(snaps[-1], template)
            errors = [float(e) for e in np.asarray(errs)]
            start = int(step or 0)

    while start < num_iterations:
        state, errs_seg, it_seg, _ = run(state, edges, maps)
        seg = [float(e) for e in errs_seg.cpu().numpy() if not np.isnan(e)]
        # the segment's first recorded χ² equals the previous segment's
        # final one: drop the duplicate when stitching
        errors.extend(seg if not errors else seg[1:])
        start += it_seg
        if ckdir is not None:
            if cm.d == 0:
                save_checkpoint(ckdir / f"block_{start:06d}.npz",
                                (state, np.asarray(errors)), step=start)
            if len(cm.peers) > 1:  # the others read it only after this
                dist.barrier(group=cm.group)
        if it_seg < segment:
            break  # |dx| < tolerance inside the segment
    return extract_graph(layout, graph, state), errors, start
