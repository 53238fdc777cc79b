"""Banded blocked Cholesky direct solver (counterpart of
``rustrobotics_tpu/ops/band_chol.py``).

RCM-reordered pose graphs have a small scalar bandwidth, so H is stored as
block rows R[j] = H[jK:(j+1)K, (j-1)K:(j+1)K] of shape (K, 2K), K the
bandwidth rounded up to 128. With K >= bandwidth the factorization is a
strict chain over block rows that carries explicit inverse factors:

    lp_j    = L_j ldinv_{j-1}^T          (L_j = R[j][:, :K], lp_0 = 0)
    D̂_j     = D_j - lp_j lp_j^T          (D_j = R[j][:, K:], mirrored)
    ldinv_j = chol(D̂_j)^-1

and both substitution sweeps are chains of GEMVs through ldinv and lp.
That chain is ``band_chol_kernels.factorize_plain`` and
``substitute_plain`` (the JAX package's ``_factorize_inv`` and
``band_substitute_inv``), the plain versions of the CUDA kernels.

The RCM permutation, the scatter indices and the block size are planned
once per graph on the host (``build_band_chol``); the symmetric Jacobi
scaling is applied to the block rows every solve (``_prepare_blocks``).
The plan also holds the JAX package's sorted-scatter plan (each unique
band destination one segment of source triplets, in a fixed order) and
its cut into tiles of ``ASSEMBLE_TILE`` band floats (``tile_ptr``): the
job list of the CUDA band assembly K4/K5
(``band_assemble_kernels.band_assemble_kernel``), which takes the place
of the plain scatter on the ``banded-kernel`` path.

Two more factorizations of the same scaled band:

- block cyclic reduction (``cr_factorize``, ``cr_substitute``,
  ``cr_invert``, ``cr_substitute_inv``, ``solve_band_cr``): the
  block-tridiagonal system is reduced by eliminating its odd blocks, a
  batched level at a time, at the chain's native length (a level of m
  blocks keeps its ceil(m/2) even ones);
- the selected inverse (``marginal_covariances``,
  ``marginal_node_blocks``): the backward recursion
  C_jj = G_j + Ld_j^-T S_j^T C_{j+1,j+1} S_j Ld_j^-1 through the chain's
  inverse factors, the diagonal blocks of H^-1 without forming it. Its
  factorization is an argument: the plain chain, or K4 + K1 on the card.

Every function takes a fleet's leading batch axis: vals (B, nnz) and b
(B, n) give block rows (B, nb, kb, 2kb) and x (B, n); the plan is the
graphs' shared one.

Two switches select among the plain versions, as in the JAX package:

- ``BAND_SCATTER_MODE`` (``RUSTROBOTICS_BAND_SCATTER`` at import, default
  "add"): the plain band assembly of ``_prepare_blocks``. "add" is one
  scatter-add of the kept triplets; "sorted" sums each unique destination's
  segment and writes the unique targets once; "strips" merges duplicate
  contributions into 3-wide node-column strips of band rows, places the
  strips by column compare and sums them into their rows (when the plan's
  node-grouped order was adopted, ``strips_ok``; "add" otherwise). All
  three give the same band. On the card's ``banded-kernel`` path the
  assembly is K4/K5 whatever the mode: the modes choose among plain
  versions only.
- ``SUBSTITUTE_MODE`` of ``solve_band_chol``: "inv" (default) is the chain
  with explicit inverse factors of K1/K2; "trsm" keeps the classic
  triangular-solve chain (``_factorize`` and ``band_substitute``, their
  list forms ``_factorize_unrolled`` and ``_substitute_unrolled`` below
  ``UNROLL_MAX_NB`` block rows) by ``torch.linalg.solve_triangular``, for
  verification.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from rustrobotics_tpu_torch.ops.band_chol_kernels import (
    factorize_plain,
    substitute_plain,
)
from rustrobotics_tpu_torch.ops.batched_tri import (
    _cholesky,
    _sym,
    chol_blocked,
    tril_inv,
)
from rustrobotics_tpu_torch.utils.metrics import span

# The plain band assembly's scatter: "add", "sorted" or "strips".
BAND_SCATTER_MODE = os.environ.get("RUSTROBOTICS_BAND_SCATTER", "add")

# Band floats a tile of the assembly's plan: one CTA of K4/K5 owns a tile
# (32 KB, eight rows at kb = 512). It divides every band, nb kb 2kb with
# kb a multiple of 128; csrc/band_assemble.cu's TILE must equal it.
ASSEMBLE_TILE = 8192


@dataclasses.dataclass(frozen=True)
class BandCholLayout:
    """Arrays are numpy on the host; ``to(device)`` gives a copy whose
    index arrays are int64 tensors on that device."""

    n: int          # original dof count
    kb: int         # block size (>= scalar bandwidth, multiple of 128)
    nb: int         # number of block rows (npad = nb * kb)
    q: int          # scalar half-bandwidth after RCM
    perm: np.ndarray       # H_perm[a, b] = H[perm[a], perm[b]]
    inv_perm: np.ndarray   # x = y[inv_perm]
    sel: np.ndarray        # triplet indices kept (lower triangle incl diag)
    flat_idx: np.ndarray   # destination into the (nb*kb*2kb,) block-row buf
    pad_rows: np.ndarray   # padded row ids in [n, nb*kb)
    strips_ok: bool        # node-grouped order adopted
    # sorted-scatter plan: triplets ordered by destination, duplicate
    # destinations segment-summed into the unique sorted target list
    sel_sorted: np.ndarray  # sel reordered by flat_idx (stable)
    seg_sorted: np.ndarray  # nondecreasing segment id per sorted triplet
    uniq_idx: np.ndarray    # unique destinations (sorted)
    seg_ptr: np.ndarray     # (len(uniq_idx) + 1,) segment starts in sel_sorted
    # (tiles + 1,) starts in uniq_idx of the ASSEMBLE_TILE-float tiles:
    # tile t's destinations are uniq_idx[tile_ptr[t]:tile_ptr[t + 1]]
    tile_ptr: np.ndarray
    # strip plan ("strips" scatter mode): one strip = (band row, 3
    # contiguous columns starting at a node block's first permuted
    # column); duplicate contributions merge in a segment sum over 3*S
    # slots. Empty when strips_ok is False.
    strip_src: np.ndarray   # kept-triplet indices sorted by slot id
    strip_seg: np.ndarray   # nondecreasing slot id (strip*3 + offset)
    strip_count: int        # S
    strip_row: np.ndarray   # (S,) destination row in permuted order
    strip_c0: np.ndarray    # (S,) local column start within the 2kb panel

    _INDEX_FIELDS = ("perm", "inv_perm", "sel", "flat_idx", "pad_rows",
                     "sel_sorted", "seg_sorted", "uniq_idx", "seg_ptr",
                     "tile_ptr", "strip_src", "strip_seg", "strip_row",
                     "strip_c0")

    def to(self, device) -> "BandCholLayout":
        return dataclasses.replace(self, **{
            f: torch.as_tensor(np.asarray(getattr(self, f), np.int64),
                               device=device)
            for f in self._INDEX_FIELDS})


def build_band_chol(layout, max_bandwidth: int = 2048) -> BandCholLayout | None:
    """Plan the banded layout, or None if the RCM bandwidth is too large
    for the banded path to win (the caller falls back to dense)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = layout.n
    rows = np.asarray(layout.rows).astype(np.int64)
    cols = np.asarray(layout.cols).astype(np.int64)
    pattern = sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n)
    ).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(pattern, symmetric_mode=True))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    rp = inv[rows]
    cp = inv[cols]
    q = int(np.abs(rp - cp).max()) if len(rp) else 0

    # Node-grouped variant of the scalar-RCM order: pull each node's dofs
    # together at the node's first permuted position; adopted only when it
    # does not widen the padded bandwidth (same rule as the JAX package,
    # so both pick the same permutation).
    db_all = np.asarray(layout.dof_block, dtype=np.int64)
    node_min = np.full(int(db_all.max()) + 1, n, dtype=np.int64)
    np.minimum.at(node_min, db_all, inv)
    key_g = node_min[db_all] * np.int64(n) + inv
    inv_g = np.empty(n, np.int64)
    inv_g[np.argsort(key_g, kind="stable")] = np.arange(n)
    q_g = int(np.abs(inv_g[rows] - inv_g[cols]).max()) if len(rows) else 0
    strips_ok = -(-q_g // 128) <= max(2, -(-q // 128))
    if strips_ok:
        q, inv = q_g, inv_g
        perm = np.empty(n, np.int64)
        perm[inv] = np.arange(n)
        rp, cp = inv[rows], inv[cols]

    kb = max(256, int(-(-q // 128)) * 128)
    if kb > max_bandwidth:
        return None
    nb = int(-(-n // kb))

    # lower triangle only; the symmetric triplet list carries each
    # off-diagonal entry twice ((r,c) and (c,r)) -- keep the lower copy
    sel = np.where(rp >= cp)[0]
    rs, cs = rp[sel], cp[sel]
    j = rs // kb
    local_col = cs - (j - 1) * kb
    flat_idx = (rs * 2 * kb + local_col).astype(np.int64)

    order = np.argsort(flat_idx, kind="stable")
    uniq_idx, inv_u = np.unique(flat_idx, return_inverse=True)
    seg_sorted = inv_u[order].astype(np.int32)
    seg_ptr = np.searchsorted(seg_sorted, np.arange(len(uniq_idx) + 1))
    tiles = nb * kb * 2 * kb // ASSEMBLE_TILE
    tile_ptr = np.searchsorted(
        uniq_idx, np.arange(tiles + 1, dtype=np.int64) * ASSEMBLE_TILE)

    # strip plan: group kept triplets by (row, col-node start)
    if strips_ok:
        node_start = np.full(int(db_all.max()) + 1, n, dtype=np.int64)
        np.minimum.at(node_start, db_all, inv)
        ns = node_start[db_all[cols[sel]]]   # permuted col start of node
        off = cs - ns                        # 0..dim-1 within the node
        assert off.min() >= 0, "node dofs not contiguous"
        # chunk wide nodes (SE3: 6 dof) into 3-wide sub-strips
        s_c = ns + 3 * (off // 3)
        key = rs * np.int64(n) + s_c         # lexicographic (row, c0)
        uniq_key, strip_of = np.unique(key, return_inverse=True)
        slot_id = strip_of.astype(np.int64) * 3 + off % 3
        sorder = np.argsort(slot_id, kind="stable")
        strip_src = sel[sorder].astype(np.int64)
        strip_seg = slot_id[sorder].astype(np.int32)
        strip_row = (uniq_key // n).astype(np.int32)
        strip_c0 = (uniq_key % n - (strip_row.astype(np.int64) // kb - 1)
                    * kb).astype(np.int32)
    else:
        strip_src = np.zeros(0, np.int64)
        strip_seg = strip_row = strip_c0 = np.zeros(0, np.int32)

    return BandCholLayout(
        n=n, kb=kb, nb=nb, q=q,
        perm=perm.astype(np.int32), inv_perm=inv.astype(np.int32),
        sel=sel.astype(np.int64),
        flat_idx=flat_idx,
        pad_rows=np.arange(n, nb * kb, dtype=np.int64),
        strips_ok=strips_ok,
        sel_sorted=sel[order].astype(np.int64),
        seg_sorted=seg_sorted,
        uniq_idx=uniq_idx.astype(np.int64),
        seg_ptr=seg_ptr.astype(np.int64),
        tile_ptr=tile_ptr.astype(np.int64),
        strip_src=strip_src,
        strip_seg=strip_seg,
        strip_count=len(strip_row),
        strip_row=strip_row,
        strip_c0=strip_c0,
    )


def _index(a, device):
    return torch.as_tensor(a, dtype=torch.long, device=device)


def scatter_add(bl: BandCholLayout, vals):
    """The plain band assembly: the kept triplets of vals (..., nnz)
    scatter-added into flat block rows (..., nb*kb*2kb), unscaled."""
    flat = vals.new_zeros(vals.shape[:-1] + (bl.nb * bl.kb * 2 * bl.kb,))
    return flat.index_add_(-1, _index(bl.flat_idx, vals.device),
                           vals[..., _index(bl.sel, vals.device)])


def scatter_sorted(bl: BandCholLayout, vals):
    """``scatter_add`` by the sorted plan: each unique destination's
    segment summed, then the unique targets written once."""
    dev, batch = vals.device, vals.shape[:-1]
    u = vals.new_zeros(batch + (len(bl.uniq_idx),)).index_add_(
        -1, _index(bl.seg_sorted, dev), vals[..., _index(bl.sel_sorted, dev)])
    flat = vals.new_zeros(batch + (bl.nb * bl.kb * 2 * bl.kb,))
    flat[..., _index(bl.uniq_idx, dev)] = u
    return flat


def scatter_strips(bl: BandCholLayout, vals):
    """``scatter_add`` by the strip plan: duplicate contributions merged
    into (S, 3) strips, each strip placed at its column offset of a 2kb
    row by column compare, and the rows summed into the band."""
    dev, batch = vals.device, vals.shape[:-1]
    kb, count = bl.kb, bl.strip_count
    sv = vals.new_zeros(batch + (3 * count,)).index_add_(
        -1, _index(bl.strip_seg, dev), vals[..., _index(bl.strip_src, dev)])
    sv = sv.view(batch + (count, 3))
    col = torch.arange(2 * kb, device=dev)
    c0 = _index(bl.strip_c0, dev)[:, None]
    strips = sum(torch.where(col == c0 + k, sv[..., k:k + 1], 0.0)
                 for k in range(3))
    flat = vals.new_zeros(batch + (bl.nb * kb, 2 * kb)).index_add_(
        -2, _index(bl.strip_row, dev), strips)
    return flat.view(batch + (-1,))


def plain_scatter(bl: BandCholLayout):
    """The plain band assembly ``BAND_SCATTER_MODE`` selects."""
    if BAND_SCATTER_MODE == "strips" and bl.strips_ok:
        return scatter_strips
    if BAND_SCATTER_MODE == "sorted":
        return scatter_sorted
    return scatter_add


def _prepare_blocks(bl: BandCholLayout, vals, assemble=None):
    """Assemble triplets into scaled block rows. Returns
    (r_blocks (..., nb, kb, 2kb), dinv_p (..., npad)): the Jacobi-scaled
    banded matrix and the scaling vector, in permuted order. Diagonal
    blocks hold their lower triangle only. ``assemble(bl, vals)`` gives the
    unscaled flat block rows: the CUDA kernel, or by default the plain
    scatter of ``BAND_SCATTER_MODE``."""
    kb, nb = bl.kb, bl.nb
    npad = nb * kb
    batch = vals.shape[:-1]

    flat = (assemble or plain_scatter(bl))(bl, vals)
    r_blocks = flat.view(batch + (nb, kb, 2 * kb))
    # unit diagonal on padded rows so the last block stays SPD (the padded
    # rows are distinct, so a gather-add-put is exact)
    if len(bl.pad_rows):
        pr = _index(bl.pad_rows, vals.device)
        r_blocks[..., pr // kb, pr % kb, kb + pr % kb] += 1.0

    # Jacobi scale straight off the block-row diagonal (permuted order)
    d_p = torch.diagonal(r_blocks[..., kb:], dim1=-2, dim2=-1)  # (.., nb, kb)
    dinv_p = torch.rsqrt(d_p.reshape(batch + (npad,)).clamp(min=1e-12))
    row_scale = dinv_p.view(batch + (nb, kb))
    # block j holds columns (j-1)*kb .. (j+1)*kb: two shifted views of the
    # zero-extended scale vector give the (nb, 2kb) sliding windows
    dinv_ext = torch.cat([dinv_p.new_zeros(batch + (kb,)), dinv_p], -1)
    col_scale = torch.cat(
        [dinv_ext[..., :npad].view(batch + (nb, kb)),
         dinv_ext[..., kb:].view(batch + (nb, kb))], dim=-1)
    r_blocks = r_blocks * row_scale[..., None] * col_scale[..., None, :]
    return r_blocks, dinv_p


def split_blocks(r_blocks):
    """(..., nb, kb, 2kb) block rows -> (dsym, lcoup), each (..., nb, kb,
    kb) contiguous: the mirrored diagonal blocks and the coupling blocks,
    the inputs of the factorization."""
    kb = r_blocks.shape[-2]
    return _sym(r_blocks[..., kb:]), r_blocks[..., :kb].contiguous()


def scale_rhs(bl: BandCholLayout, b, dinv_p):
    """b (..., n) permuted, zero-padded and Jacobi-scaled into band space:
    (..., nb, kb)."""
    bp = b[..., _index(bl.perm, b.device)]
    bp = torch.cat([bp, bp.new_zeros(bp.shape[:-1] + (bl.nb * bl.kb - bl.n,))],
                   -1)
    return (bp * dinv_p).view(bp.shape[:-1] + (bl.nb, bl.kb))


def unscale(bl: BandCholLayout, xs, dinv_p):
    """The inverse of ``scale_rhs`` for a solution: band-space xs (..., nb,
    kb) -> x (..., n) in the original dof order."""
    y = xs.reshape(dinv_p.shape) * dinv_p
    return y[..., _index(bl.inv_perm, y.device)]


def solve_banded(bl: BandCholLayout, vals, b, factorize, substitute,
                 assemble=None):
    """The banded solve around an assembly, a factorization and a
    substitution: RCM permutation, Jacobi scaling and padding in,
    unscaling and the inverse permutation out. Runs in vals' dtype; vals
    (..., nnz) and b (..., n) share their batch shape. The three stages
    are the spans ``band.assemble`` (block rows, padding, scaling, the
    mirrored diagonal), ``band.factorize`` and ``band.substitute`` (the
    right-hand side scaled in, the substitution, the unscaling), in the
    order the device runs them."""
    with span("band.assemble"):
        r_blocks, dinv_p = _prepare_blocks(bl, vals, assemble)
        dsym, lcoup = split_blocks(r_blocks)
    with span("band.factorize"):
        ldinv, lp = factorize(dsym, lcoup)
    with span("band.substitute"):
        xs = substitute(ldinv, lp, scale_rhs(bl, b, dinv_p))
        return unscale(bl, xs, dinv_p)


# Below this many block rows, the "trsm" chain runs its list form, as in
# the JAX package (there the other form is a scan; here both are loops).
UNROLL_MAX_NB = 64

# Substitution strategy of solve_band_chol: "inv" (default) multiplies by
# the chain's explicit triangular inverses (the math of K1/K2); "trsm"
# keeps the classic triangular-solve chain, for verification.
SUBSTITUTE_MODE = "inv"


def _factorize_unrolled(r_blocks):
    """The triangular-solve chain on block rows (..., nb, kb, 2kb):
    returns ([ld_j], [lp_j]), the diagonal Cholesky factors and the
    subdiagonal panels lp_j = P_{j+1} ld_j^-T."""
    nb, kb = r_blocks.shape[-3], r_blocks.shape[-2]
    lds, lps = [], []
    dcur = r_blocks[..., 0, :, kb:]
    for j in range(nb):
        ld = _cholesky(dcur)  # mirrors the lower triangle first
        lds.append(ld)
        if j + 1 < nb:
            p = r_blocks[..., j + 1, :, :kb]
            lp = torch.linalg.solve_triangular(ld, p.mT, upper=False).mT
            lps.append(lp)
            dcur = r_blocks[..., j + 1, :, kb:] - lp @ lp.mT
    return lds, lps


def _substitute_unrolled(lds, lps, bp):
    """Forward + backward substitution over per-block lists: solves
    L Lᵀ x = bp for bp (..., nb, kb)."""
    nb = len(lds)

    def trsv(ld, rhs, upper):
        a = ld.mT if upper else ld
        return torch.linalg.solve_triangular(a, rhs[..., None],
                                             upper=upper)[..., 0]

    ys = []
    for j in range(nb):
        rhs = bp[..., j, :]
        if j > 0:
            rhs = rhs - _mv(lps[j - 1], ys[j - 1])
        ys.append(trsv(lds[j], rhs, upper=False))
    xs = [None] * nb
    for j in range(nb - 1, -1, -1):
        rhs = ys[j]
        if j + 1 < nb:
            rhs = rhs - _mv(lps[j].mT, xs[j + 1])
        xs[j] = trsv(lds[j], rhs, upper=True)
    return torch.stack(xs, -2)


def _factorize(r_blocks):
    """``_factorize_unrolled`` stacked: (lds (..., nb, kb, kb), lps (...,
    nb-1, kb, kb))."""
    lds, lps = _factorize_unrolled(r_blocks)
    kb = r_blocks.shape[-2]
    return (torch.stack(lds, -3),
            torch.stack(lps, -3) if lps
            else r_blocks.new_zeros(r_blocks.shape[:-3] + (0, kb, kb)))


def band_substitute(lds, lps, bp):
    """Forward + backward substitution through the stacked factor of
    ``_factorize``: solves L Lᵀ x = bp for bp (..., nb, kb)."""
    return _substitute_unrolled(list(lds.unbind(-3)), list(lps.unbind(-3)),
                                bp)


def solve_band_chol(bl: BandCholLayout, vals, b):
    """Jacobi-scaled banded Cholesky solve of the triplet system (vals
    aligned with the SystemLayout that built ``bl``) through the plain
    chain of ``SUBSTITUTE_MODE``, in vals' dtype."""
    if SUBSTITUTE_MODE == "inv":
        return solve_banded(bl, vals, b, factorize_plain, substitute_plain)
    r_blocks, dinv_p = _prepare_blocks(bl, vals)
    bp = scale_rhs(bl, b, dinv_p)
    if bl.nb <= UNROLL_MAX_NB:
        xs = _substitute_unrolled(*_factorize_unrolled(r_blocks), bp)
    else:
        xs = band_substitute(*_factorize(r_blocks), bp)
    return unscale(bl, xs, dinv_p)


# ------------------------------------------------------------------
# Block cyclic reduction. In kb-block form the scaled band is block
# tridiagonal: D_j = r_blocks[j, :, kb:] (lower triangle), L_j =
# r_blocks[j, :, :kb] coupling block j to j-1 (L_0 = 0). A level
# eliminates the odd blocks 2t+1 (F_t = chol(D_{2t+1})):
#
#   A_t = F_t^-1 L_{2t+1}          B_t = F_t^-1 L_{2t+2}^T
#   D'_t = D_2t - A_t^T A_t - B_{t-1}^T B_{t-1}
#   L'_t = -B_{t-1}^T A_{t-1}
#
# and leaves the Schur complement on the even blocks, SPD block
# tridiagonal again. Each level keeps (F, A, B), so a right-hand side is
# reduced down the levels, solved at the root and substituted back up.
# ------------------------------------------------------------------


def _btsolve(f, rhs):
    """F^-1 rhs for lower-triangular F over leading axes."""
    return torch.linalg.solve_triangular(f, rhs, upper=False)


def _btsolve_t(f, rhs):
    """F^-T rhs for lower-triangular F over leading axes."""
    return torch.linalg.solve_triangular(f.mT, rhs, upper=True)


def _mv(m, v):
    """(..., k, k) @ (..., k) -> (..., k)."""
    return (m @ v[..., None])[..., 0]


def _zero_row(v):
    """One zero block vector (..., 1, kb) for block vectors v (..., m,
    kb)."""
    return v.new_zeros(v.shape[:-2] + (1, v.shape[-1]))


def cr_factorize(r_blocks):
    """Cyclic-reduction factorization of the block-tridiagonal band
    (..., nb, kb, 2kb). Returns (levels, f_root): per level (F, A, B), each
    (..., h, kb, kb) with h the level's eliminated odd blocks, and the
    (..., kb, kb) Cholesky factor of the reduced root block."""
    nb, kb = r_blocks.shape[-3], r_blocks.shape[-2]
    # the band holds lower triangles: mirror once; every later diagonal is
    # a Schur complement and symmetric
    d = _sym(r_blocks[..., kb:])
    lo = r_blocks[..., :kb]
    zero = d.new_zeros(d.shape[:-3] + (1, kb, kb))
    m = nb
    levels = []
    while m > 1:
        h = m // 2              # eliminated odd blocks 2t+1, t in [0, h)
        he = m - h              # surviving even blocks 2s, s in [0, he)
        l_odd = lo[..., 1::2, :, :]
        l_next = lo[..., 2::2, :, :]        # L_{2t+2}; zero past the end
        if l_next.shape[-3] < h:
            l_next = torch.cat([l_next, zero], -3)
        f = chol_blocked(d[..., 1::2, :, :])
        finv = tril_inv(f)
        a = finv @ l_odd
        b = finv @ l_next.mT
        ata = a.mT @ a                      # hits even 2t
        btb = b.mT @ b                      # hits even 2t+2
        if h < he:                          # m odd: the last even has no odd above
            ata = torch.cat([ata, zero], -3)
        btb_prev = torch.cat([zero, btb[..., :he - 1, :, :]], -3)
        d = d[..., 0::2, :, :] - ata - btb_prev
        c = b.mT @ a                        # B_t^T A_t
        lo = torch.cat([zero, -c[..., :he - 1, :, :]], -3)
        levels.append((f, a, b))
        m = he
    return levels, _cholesky(d[..., 0, :, :])


def _cr_interleave(x_even, x_odd):
    """Interleave (..., he, kb) evens with (..., h, kb) odds, he - h in
    {0, 1}."""
    h = x_odd.shape[-2]
    pairs = torch.stack([x_even[..., :h, :], x_odd], -2).flatten(-3, -2)
    return torch.cat([pairs, x_even[..., h:, :]], -2)


def _cr_reduce(levels, bp, solve_odd):
    """Reduce the right-hand side bp (..., nb, kb) down the levels: returns
    the root's right-hand side (..., kb) and each level's u = F^-1 b_odd
    (``solve_odd(level, b_odd)``)."""
    b = bp
    us = []
    for level in levels:
        _, a, bt = level
        he = b.shape[-2] - b.shape[-2] // 2
        u = solve_odd(level, b[..., 1::2, :])            # (..., h, kb)
        corr_a = _mv(a.mT, u)                             # at even 2t
        if corr_a.shape[-2] < he:                         # m odd
            corr_a = torch.cat([corr_a, _zero_row(corr_a)], -2)
        corr_b = _mv(bt.mT, u)                            # at even 2t+2
        corr_b = torch.cat([_zero_row(corr_b), corr_b[..., :he - 1, :]],
                           -2)
        b = b[..., 0::2, :] - corr_a - corr_b
        us.append(u)
    return b[..., 0, :], us


def _cr_back(levels, us, x_root, solve_odd_t):
    """Substitute back up the levels from the root's solution (..., kb):
    x_{2t+1} = F^-T (u_t - A_t x_2t - B_t x_{2t+2})."""
    x = x_root[..., None, :]
    for level, u in zip(reversed(levels), reversed(us)):
        _, a, bt = level
        h = u.shape[-2]
        x_up = x[..., 1:h + 1, :]
        if x_up.shape[-2] < h:                            # m even
            x_up = torch.cat([x_up, _zero_row(x_up)], -2)
        rhs = u - _mv(a, x[..., :h, :]) - _mv(bt, x_up)
        x = _cr_interleave(x, solve_odd_t(level, rhs))
    return x


def cr_substitute(levels, f_root, bp):
    """Solve through a cyclic-reduction factor: bp (..., nb, kb) -> x
    (..., nb, kb), by triangular solves."""
    root, us = _cr_reduce(levels, bp,
                          lambda lv, r: _btsolve(lv[0], r[..., None])[..., 0])
    x_root = _btsolve_t(f_root, _btsolve(f_root, root[..., None]))[..., 0]
    return _cr_back(levels, us, x_root,
                    lambda lv, r: _btsolve_t(lv[0], r[..., None])[..., 0])


def cr_invert(levels, f_root):
    """Explicit inverses of every CR triangular factor, so that a
    substitution is batched matrix-vector products only (the
    preconditioner apply of ``make_banded_mixed``, once a CG round).
    Returns (inv_levels, root_inv): per level (F^-1, A, B), and the root's
    inverse factor."""
    return [(tril_inv(f), a, b) for f, a, b in levels], tril_inv(f_root)


def cr_substitute_inv(inv_levels, root_inv, bp):
    """``cr_substitute`` on precomputed inverse factors."""
    root, us = _cr_reduce(inv_levels, bp, lambda lv, r: _mv(lv[0], r))
    x_root = _mv(root_inv.mT, _mv(root_inv, root))
    return _cr_back(inv_levels, us, x_root, lambda lv, r: _mv(lv[0].mT, r))


def solve_band_cr(bl: BandCholLayout, vals, b):
    """Banded solve by cyclic reduction: the contract of
    ``solve_band_chol`` (plain scatter, Jacobi scaling, vals' dtype) with a
    log-depth batched factorization."""
    r_blocks, dinv_p = _prepare_blocks(bl, vals)
    levels, f_root = cr_factorize(r_blocks)
    return unscale(bl, cr_substitute(levels, f_root,
                                     scale_rhs(bl, b, dinv_p)), dinv_p)


# ------------------------------------------------------------------
# Selected inversion: the marginal covariances.
# ------------------------------------------------------------------


def _selected_inverse(bl: BandCholLayout, vals, factorize=factorize_plain,
                      assemble=None):
    """The backward selected-inverse recursion on the Jacobi-scaled band.
    With the chain's inverse factors ldinv_j = Ld_j^-1 and panels S_j =
    lp[j + 1] (the coupling of block j + 1 to j, times ldinv_j^T):

        C_NN = G_N,   G_j = Ld_j^-T Ld_j^-1
        C_jj = G_j + (S_j Ld_j^-1)^T C_{j+1,j+1} (S_j Ld_j^-1)
        C_{j+1,j} = -C_{j+1,j+1} S_j Ld_j^-1

    ``factorize(dsym, lcoup) -> (ldinv, lp)`` and ``assemble(bl, vals)``
    are the chain's factorization and band assembly (default: the plain
    ones). Returns (covs (..., nb, kb, kb), offs (..., max(nb - 1, 1), kb,
    kb), dinv_p): covs[j] = C_jj and offs[j] = C_{j+1,j}. The recursion's
    products are full f32 on the card: the package turns TF32 off when it
    is imported."""
    r_blocks, dinv_p = _prepare_blocks(bl, vals, assemble)
    ldinv, lp = factorize(*split_blocks(r_blocks))
    cov = ldinv[..., -1, :, :].mT @ ldinv[..., -1, :, :]
    covs, offs = [cov], []
    for j in reversed(range(bl.nb - 1)):
        ld_inv = ldinv[..., j, :, :]
        s_ld_inv = lp[..., j + 1, :, :] @ ld_inv           # S_j Ld_j^-1
        offs.append(-cov @ s_ld_inv)                       # C_{j+1,j}
        cov = ld_inv.mT @ ld_inv + s_ld_inv.mT @ cov @ s_ld_inv
        covs.append(cov)
    covs = torch.stack(covs[::-1], -3)
    offs = torch.stack(offs[::-1], -3) if offs else torch.zeros_like(covs)
    return covs, offs, dinv_p


def marginal_covariances(bl: BandCholLayout, vals, factorize=factorize_plain,
                         assemble=None):
    """Marginal variances diag(H^-1) (..., n) in the original dof order,
    from the selected inverse's diagonal blocks (O(nb kb^3), no dense
    inverse). ``factorize``/``assemble`` as in ``_selected_inverse``."""
    covs, _, dinv_p = _selected_inverse(bl, vals, factorize, assemble)
    var_p = torch.diagonal(covs, dim1=-2, dim2=-1).reshape(dinv_p.shape)
    return (var_p * dinv_p ** 2)[..., _index(bl.inv_perm, var_p.device)]


def marginal_node_blocks(bl: BandCholLayout, vals, node_offsets, node_sizes,
                         pad_size=6, factorize=factorize_plain, assemble=None):
    """Per-node marginal covariance blocks of H^-1, (..., N, pad_size,
    pad_size) with identity padding past each node's size. node_offsets
    and node_sizes (N,) are each node's first original dof and its size.
    Any dof pair within the band is at most one kb-block apart, so every
    within-node entry lies in a diagonal block C_jj or in C_{j+1,j}."""
    n, kb = bl.n, bl.kb
    covs, offs, dinv_p = _selected_inverse(bl, vals, factorize, assemble)
    batch = dinv_p.shape[:-1]
    diag_buf = covs.reshape(batch + (-1,))
    off_buf = offs.reshape(batch + (-1,))

    # host plan: entry (a, b) of node k -> which buffer, flat index
    inv = torch.as_tensor(bl.inv_perm).cpu().numpy().astype(np.int64)
    offsets = np.asarray(node_offsets, np.int64)
    sizes = np.asarray(node_sizes, np.int64)
    n_nodes = len(offsets)
    where = np.zeros((n_nodes, pad_size, pad_size), np.int8)  # 0 diag, 1 off, 3 pad
    idx = np.zeros((n_nodes, pad_size, pad_size), np.int64)
    for a in range(pad_size):
        for b_ in range(pad_size):
            in_node = (a < sizes) & (b_ < sizes)
            pa = inv[np.minimum(offsets + a, n - 1)]
            pb = inv[np.minimum(offsets + b_, n - 1)]
            ja, jb = pa // kb, pb // kb
            ra, rb = pa % kb, pb % kb
            same = ja == jb
            a_hi = ja == jb + 1   # entry of C_{ja, jb} = offs[jb]
            flat = np.where(same, ja * kb * kb + ra * kb + rb,
                            np.where(a_hi, jb * kb * kb + ra * kb + rb,
                                     ja * kb * kb + rb * kb + ra))
            where[:, a, b_] = np.where(in_node, np.where(same, 0, 1), 3)
            idx[:, a, b_] = np.where(in_node, flat, 0)

    dev = dinv_p.device
    where_t = torch.as_tensor(where, device=dev)
    idx_t = torch.as_tensor(idx, device=dev)
    from_diag = diag_buf[..., idx_t]
    from_off = off_buf[..., idx_t.clamp(max=off_buf.shape[-1] - 1)]
    scaled = torch.where(where_t == 0, from_diag,
                         torch.where(where_t == 3, 0.0, from_off))
    # undo the Jacobi scaling: C = dinv_a C_scaled dinv_b
    dinv_orig = dinv_p[..., _index(inv, dev)]
    cols = np.minimum(offsets[:, None] + np.arange(pad_size)[None, :], n - 1)
    da = dinv_orig[..., _index(cols, dev)]                      # (..., N, pad)
    inside = torch.as_tensor(np.arange(pad_size)[None, :] < sizes[:, None],
                             device=dev)
    da = torch.where(inside, da, 1.0)
    pad_eye = torch.as_tensor(
        (np.arange(pad_size)[None, :, None] == np.arange(pad_size)[None, None, :])
        & (np.arange(pad_size)[None, :, None] >= sizes[:, None, None]),
        dtype=dinv_p.dtype, device=dev)
    return scaled * da[..., :, None] * da[..., None, :] + pad_eye
