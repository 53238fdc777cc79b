"""Block-banded SpMV (counterpart of ``rustrobotics_tpu/ops/banded.py``).

After RCM reordering, pose-graph normal equations are narrow-banded, so
P H P^T is stored as a block-banded tensor of 128x128 tiles,
(nb, 2*half+1, 128, 128), and the SpMV is a batch of dense tile products
over 128-aligned windows of x:

    y_I = sum_d hb[I, d] @ xp[I + d]

with xp the band-space x in (nb + 2*half, 128) blocks, zero-padded by
``half`` blocks at each end. The pattern is planned once per graph on the
host (``build_banded``); the band values are one scatter per GN step
(``band_values``), amortized over every CG round.

Every function takes a fleet's leading batch axis: vals (B, nnz) gives
hb (B, nb, kb, 128, 128), and x, xp and y gain the same axis; the plan is
the graphs' shared one.

``banded_matvec_plain`` is the plain version of the CUDA kernel K3
(``banded_kernels.banded_matvec_kernel``); ``make_banded_matvec`` takes
one or the other.

Naming trap: here ``kb`` counts block diagonals (2*half + 1). In
``band_chol.py`` ``kb`` is the block size.

The permutation is plain scalar RCM of the deduplicated pattern, not
``build_band_chol``'s node-grouped order: the two layouts do not share
their permutations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LANE = 128  # tile edge


@dataclasses.dataclass(frozen=True)
class BandedLayout:
    """Block-band structure of P H P^T for a fixed pattern. Arrays are
    numpy on the host; ``to(device)`` gives a copy whose index arrays are
    int64 tensors on that device."""

    n: int  # logical dimension
    nb: int  # number of 128-row blocks
    half: int  # block half-bandwidth: |I - J| <= half
    kb: int  # 2*half + 1 block diagonals
    perm: np.ndarray  # (n,) RCM permutation: band index -> dof index
    inv_perm: np.ndarray  # (n,)
    ell_to_block: np.ndarray  # (ell_nnz,) flat position into the band tensor

    def to(self, device) -> "BandedLayout":
        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        return dataclasses.replace(self, perm=t(self.perm),
                                   inv_perm=t(self.inv_perm),
                                   ell_to_block=t(self.ell_to_block))


def build_banded(layout) -> BandedLayout:
    """Block-band structure from a host ``SystemLayout``'s deduplicated
    ELL pattern."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = layout.n
    order = layout.ell_order
    rows_s = layout.rows[order]
    cols_s = layout.cols[order]
    first = np.ones(len(rows_s), bool)
    first[1:] = (rows_s[1:] != rows_s[:-1]) | (cols_s[1:] != cols_s[:-1])
    ur, uc = rows_s[first], cols_s[first]

    h = sp.coo_matrix((np.ones(len(ur)), (ur, uc)), shape=(n, n)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(h, symmetric_mode=True))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    bi = inv[ur]
    bj = inv[uc]
    blk_i = bi // LANE
    blk_j = bj // LANE
    half = int(np.abs(blk_i - blk_j).max()) if len(bi) else 0
    kb = 2 * half + 1
    nb = -(-n // LANE)
    dj = blk_j - blk_i + half
    flat = ((blk_i * kb + dj) * LANE + bi % LANE) * LANE + bj % LANE
    return BandedLayout(
        n=n, nb=int(nb), half=half, kb=kb,
        perm=perm.astype(np.int32), inv_perm=inv.astype(np.int32),
        ell_to_block=flat.astype(np.int64),
    )


def as_index(a, device):
    """An index array (numpy or tensor) as an int64 tensor on device."""
    return torch.as_tensor(a, dtype=torch.long, device=device)


def summed_values(layout, vals):
    """Triplet values (..., nnz) with duplicates summed, one per ELL entry
    in (row, col) order: (..., ell_nnz). The sum is an ``index_add_``,
    atomic on the card, so there the order of a duplicate's terms varies
    from run to run."""
    seg = as_index(layout.ell_seg, vals.device)
    order = as_index(layout.ell_order, vals.device)
    return vals.new_zeros(vals.shape[:-1] + (layout.ell_nnz,)).index_add_(
        -1, seg, vals[..., order])


def band_values(blayout: BandedLayout, layout, vals):
    """Triplet values (..., nnz) -> (..., nb, kb, 128, 128) band tensor:
    the summed values, then one unique scatter into the band."""
    batch = vals.shape[:-1]
    flat = vals.new_zeros(batch + (blayout.nb * blayout.kb * LANE * LANE,))
    pos = as_index(blayout.ell_to_block, vals.device)
    flat[..., pos] = summed_values(layout, vals)
    return flat.view(batch + (blayout.nb, blayout.kb, LANE, LANE))


def _pad_x_blocks(blayout: BandedLayout, xb):
    """Band-space x (..., n) -> (..., nb + 2*half, 128) zero-padded block
    stack."""
    before = blayout.half * LANE
    after = (blayout.nb + blayout.half) * LANE - blayout.n
    return torch.nn.functional.pad(xb, (before, after)).view(
        xb.shape[:-1] + (-1, LANE))


def banded_matvec_plain(hb, xp_blocks):
    """Plain version of K3 (the JAX package's ``banded_matvec_jnp``):
    y_I = sum_d hb[..., I, d] @ xp_blocks[..., I + d], returned flat
    (..., nb*128)."""
    nb, kb = hb.shape[-4], hb.shape[-3]
    idx = (torch.arange(nb, device=hb.device)[:, None]
           + torch.arange(kb, device=hb.device)[None, :])  # (nb, kb)
    windows = xp_blocks[..., idx, :]  # (..., nb, kb, LANE)
    return torch.einsum("...ndij,...ndj->...ni", hb, windows).reshape(
        hb.shape[:-4] + (-1,))


def make_banded_matvec(blayout: BandedLayout, layout, vals, use_kernel=True):
    """Closure mapping dof-space x (..., n) -> dof-space H @ x through band
    space, x's batch shape that of vals. ``use_kernel=True`` takes K3's
    wrapper, which launches K3 for values on the card and runs the plain
    version on the CPU; ``False`` takes the plain version everywhere."""
    from rustrobotics_tpu_torch.ops.banded_kernels import banded_matvec_kernel

    hb = band_values(blayout, layout, vals)
    perm = as_index(blayout.perm, vals.device)
    inv = as_index(blayout.inv_perm, vals.device)
    spmv = banded_matvec_kernel if use_kernel else banded_matvec_plain

    def matvec(x):
        return spmv(hb, _pad_x_blocks(blayout, x[..., perm]))[..., inv]

    return matvec
