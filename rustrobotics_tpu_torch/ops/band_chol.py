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

Every function takes a fleet's leading batch axis: vals (B, nnz) and b
(B, n) give block rows (B, nb, kb, 2kb) and x (B, n); the plan is the
graphs' shared one.

Not ported yet: block cyclic reduction, selected inversion and marginals,
the triangular-solve ("trsm") substitution mode, and the "strips" scatter
mode with its plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rustrobotics_tpu_torch.ops.band_chol_kernels import (
    factorize_plain,
    substitute_plain,
)
from rustrobotics_tpu_torch.ops.batched_tri import _sym

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

    _INDEX_FIELDS = ("perm", "inv_perm", "sel", "flat_idx", "pad_rows",
                     "sel_sorted", "seg_sorted", "uniq_idx", "seg_ptr",
                     "tile_ptr")

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
    )


def _index(a, device):
    return torch.as_tensor(a, dtype=torch.long, device=device)


def scatter_add(bl: BandCholLayout, vals):
    """The plain band assembly: the kept triplets of vals (..., nnz)
    scatter-added into flat block rows (..., nb*kb*2kb), unscaled."""
    flat = vals.new_zeros(vals.shape[:-1] + (bl.nb * bl.kb * 2 * bl.kb,))
    return flat.index_add_(-1, _index(bl.flat_idx, vals.device),
                           vals[..., _index(bl.sel, vals.device)])


def _prepare_blocks(bl: BandCholLayout, vals, assemble=None):
    """Assemble triplets into scaled block rows. Returns
    (r_blocks (..., nb, kb, 2kb), dinv_p (..., npad)): the Jacobi-scaled
    banded matrix and the scaling vector, in permuted order. Diagonal
    blocks hold their lower triangle only. ``assemble(bl, vals)`` gives the
    unscaled flat block rows: the CUDA kernel, or by default the plain
    ``scatter_add``."""
    kb, nb = bl.kb, bl.nb
    npad = nb * kb
    batch = vals.shape[:-1]

    flat = (assemble or scatter_add)(bl, vals)
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


def solve_banded(bl: BandCholLayout, vals, b, factorize, substitute,
                 assemble=None):
    """The banded solve around an assembly, a factorization and a
    substitution: RCM permutation, Jacobi scaling and padding in,
    unscaling and the inverse permutation out. Runs in vals' dtype; vals
    (..., nnz) and b (..., n) share their batch shape."""
    n, kb, nb = bl.n, bl.kb, bl.nb
    npad = nb * kb
    batch = vals.shape[:-1]
    r_blocks, dinv_p = _prepare_blocks(bl, vals, assemble)
    bp = b[..., _index(bl.perm, b.device)]
    bp = torch.cat([bp, bp.new_zeros(batch + (npad - n,))], -1)
    bp = (bp * dinv_p).view(batch + (nb, kb))
    ldinv, lp = factorize(*split_blocks(r_blocks))
    xs = substitute(ldinv, lp, bp)
    y = xs.reshape(batch + (npad,)) * dinv_p
    return y[..., _index(bl.inv_perm, y.device)]


def solve_band_chol(bl: BandCholLayout, vals, b):
    """Jacobi-scaled banded Cholesky solve of the triplet system (vals
    aligned with the SystemLayout that built ``bl``) through the plain
    chain, in vals' dtype."""
    return solve_banded(bl, vals, b, factorize_plain, substitute_plain)
