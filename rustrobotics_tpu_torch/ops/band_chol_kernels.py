"""Banded inverse-Cholesky factorization and substitution: CUDA kernels for
Hopper and their plain PyTorch versions.

Counterpart of ``rustrobotics_tpu/ops/band_chol_pallas.py``:

- K1 ``factorize_kernel`` replaces ``factorize_pallas`` (its kernel
  ``_factor_kernel`` with ``_blocked_chol_inv``/``_panel_chol_inv``):
  sequential over block rows j, ``lp_j = Lcoup_j ldinv_{j-1}^T``,
  ``D̂_j = Dsym_j - lp_j lp_j^T``, ``ldinv_j = chol(D̂_j)^-1``.
- K2 ``substitute_kernel`` replaces ``substitute_pallas`` (``_fwd_kernel``
  and ``_bwd_kernel``): ``y_j = ldinv_j (b_j - lp_j y_{j-1})``, then
  ``x_j = ldinv_j^T (y_j - lp_{j+1}^T x_{j+1})``.

The sources are ``csrc/band_chol.cu``, which says what bounds each kernel
on an H100 and what its design does about it. All arithmetic inside is
IEEE f32 with FMA on the CUDA cores.

Each wrapper takes the plain version for a tensor on the CPU, and only
then; for a CUDA tensor it launches the kernel or raises. ``LAUNCHES``
counts the calls of each wrapper that launch its kernel: one a call,
whatever the batch. ``K1_WORK`` tallies the items of K1's trailing-update
launches as its host loop issues them, and ``K1_STRIP_ROWS`` its calls at
each strip height, which the source chooses (``k1_work`` computes the
items from the shapes and that height).

Both take a fleet's leading batch axis: every kernel of K1's launch
sequence covers all the graphs, so B chains cost one host loop;
K2 is one launch with a cluster of CTAs per graph.

``solve_band_kernel`` keeps the contract of ``solve_band_pallas``: RCM,
Jacobi scaling, symmetrization and padding in torch outside the kernels,
f32 inside, the result cast back to the input dtype. Its band assembly is
the CUDA kernel K4/K5 (``band_assemble_kernels``).
"""

from __future__ import annotations

import ctypes

import torch

from rustrobotics_tpu_torch.ops import cuda_lib
from rustrobotics_tpu_torch.ops.batched_tri import chol_blocked, tril_inv

PANEL = 128  # the kernels' panel width; kb must be a multiple of it
MAX_KB = 2048  # K2 has a kernel for each kb = 128, 256, .., 2048
OFFDIAG_COLS = 16  # columns of K1's off-diagonal inverse tiles (OT)

LAUNCHES = {"factorize": 0, "substitute": 0}
K1_WORK = {"strips": 0, "update_tiles": 0, "offdiag_tiles": 0}
K1_STRIP_ROWS = {32: 0, 64: 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # (device, dsym, lcoup, ldinv, lp, work, work_floats, nb, kb, batch,
    #  items, stream)
    "band_factorize_f32": [_I, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P, _P],
    # (device, ldinv, lp, bp, y, x, nb, kb, batch, stream)
    "band_substitute_f32": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _lib():
    return cuda_lib.load("band_chol", _SIGNATURES)


def k1_panel_items(kb, i, rows):
    """The items of K1's trailing-update launch after diagonal panel i of
    a block row, for one graph, with strips of ``rows`` rows
    (``trail_offdiag``'s work list): the first rows of its strips of L, the
    (row, column) corners of its lower update tiles, the first columns of
    its off-diagonal inverse tiles."""
    o = PANEL * i
    strips = list(range(o + PANEL, kb, rows))
    tiles = [(m, n) for k, m in enumerate(strips) for n in strips[:k + 1]]
    return strips, tiles, list(range(0, o, OFFDIAG_COLS))


def k1_work(nb, kb, batch, rows):
    """What one K1 call on (batch, nb, kb, kb) with strips of ``rows``
    rows adds to ``K1_WORK``."""
    if rows not in K1_STRIP_ROWS:
        raise ValueError(f"K1's strips have 32 or 64 rows, not {rows}")
    counts = dict.fromkeys(K1_WORK, 0)
    for i in range(kb // PANEL):
        for key, items in zip(K1_WORK, k1_panel_items(kb, i, rows)):
            counts[key] += nb * batch * len(items)
    return counts


# ------------------------------------------------------------ plain versions


def factorize_plain(dsym, lcoup):
    """The chain of K1 in plain PyTorch: (dsym, lcoup) (..., nb, kb, kb)
    -> (ldinv, lp) (..., nb, kb, kb), lp[..., 0] = 0."""
    nb = dsym.shape[-3]
    ldinv = torch.empty_like(dsym)
    lp = torch.zeros_like(dsym)
    a = dsym[..., 0, :, :]
    for j in range(nb):
        if j > 0:
            lp[..., j, :, :] = lcoup[..., j, :, :] @ ldinv[..., j - 1, :, :].mT
            a = dsym[..., j, :, :] - lp[..., j, :, :] @ lp[..., j, :, :].mT
        ldinv[..., j, :, :] = tril_inv(chol_blocked(a))
    return ldinv, lp


def _mv(m, v):
    """(..., k, k) @ (..., k) -> (..., k)."""
    return (m @ v[..., None])[..., 0]


def substitute_plain(ldinv, lp, bp):
    """The two sweeps of K2 in plain PyTorch: solve L L^T x = bp through
    the inverse factors; bp and x are (..., nb, kb)."""
    nb = bp.shape[-2]
    y = torch.empty_like(bp)
    for j in range(nb):
        rhs = bp[..., 0, :] if j == 0 else (
            bp[..., j, :] - _mv(lp[..., j, :, :], y[..., j - 1, :]))
        y[..., j, :] = _mv(ldinv[..., j, :, :], rhs)
    x = torch.empty_like(bp)
    for j in reversed(range(nb)):
        rhs = y[..., j, :] if j == nb - 1 else (
            y[..., j, :] - _mv(lp[..., j + 1, :, :].mT, x[..., j + 1, :]))
        x[..., j, :] = _mv(ldinv[..., j, :, :].mT, rhs)
    return x


# ------------------------------------------------------------ kernel wrappers


def _lead(t, ndim):
    """t with a leading batch axis: a (1, ...) view of an unbatched tensor
    of ``ndim`` dims."""
    return t if t.dim() > ndim else t[None]


def _check_inputs(*tensors, shapes):
    cuda_lib.check_tensors(*tensors, shapes=shapes)
    kb = shapes[0][-1]
    if kb % PANEL:
        raise ValueError(f"kb={kb} is not a multiple of {PANEL}")


def factorize_kernel(dsym, lcoup):
    """K1: (dsym, lcoup) f32 (nb, kb, kb), or (B, nb, kb, kb) for B chains
    in one launch sequence -> (ldinv, lp) of the same shape, lp[..., 0] =
    0. Graph i of a batch gets the unbatched kernel's result bit for bit."""
    if dsym.device.type == "cpu":
        return factorize_plain(dsym, lcoup)
    d4, l4 = _lead(dsym, 3), _lead(lcoup, 3)
    batch, nb, kb = d4.shape[:3]
    _check_inputs(d4, l4, shapes=[(batch, nb, kb, kb)] * 2)
    ldinv = torch.empty_like(dsym)
    lp = torch.empty_like(dsym)
    # per graph the running block and L's sub-diagonal panels; then a
    # ticket a trailing-update launch and a flag a strip (of 32 rows at
    # least), which K1 clears
    work = torch.empty(batch * 2 * kb * kb + nb * (kb // PANEL)
                       + batch * ((kb - PANEL) // 32),
                       dtype=torch.float32, device=dsym.device)
    items = (ctypes.c_longlong * 4)()
    lib = _lib()
    status = lib.band_factorize_f32(
        dsym.device.index, dsym.data_ptr(), lcoup.data_ptr(),
        ldinv.data_ptr(), lp.data_ptr(), work.data_ptr(), work.numel(), nb,
        kb, batch, items, cuda_lib.stream(dsym))
    cuda_lib.check(lib, status, "band_factorize_f32")
    LAUNCHES["factorize"] += 1
    for key, n in zip(K1_WORK, items):
        K1_WORK[key] += n
    K1_STRIP_ROWS[items[3]] += 1
    return ldinv, lp


def substitute_kernel(ldinv, lp, bp):
    """K2: solve L L^T x = bp through (ldinv, lp); bp f32 (nb, kb), or
    (B, nb, kb) with (B, nb, kb, kb) factors, all B in one launch, kb up
    to MAX_KB. ldinv must be lower triangular with zeros above the
    diagonal, as K1 writes it: the kernel skips the 16-byte groups that
    lie wholly above it."""
    if bp.device.type == "cpu":
        return substitute_plain(ldinv, lp, bp)
    b3 = _lead(bp, 2)
    batch, nb, kb = b3.shape
    if kb > MAX_KB:
        raise ValueError(f"kb={kb} is above K2's {MAX_KB}")
    _check_inputs(_lead(ldinv, 3), _lead(lp, 3), b3,
                  shapes=[(batch, nb, kb, kb)] * 2 + [(batch, nb, kb)])
    y = torch.empty_like(bp)
    x = torch.empty_like(bp)
    lib = _lib()
    status = lib.band_substitute_f32(
        bp.device.index, ldinv.data_ptr(), lp.data_ptr(), bp.data_ptr(),
        y.data_ptr(), x.data_ptr(), nb, kb, batch, cuda_lib.stream(bp))
    cuda_lib.check(lib, status, "band_substitute_f32")
    LAUNCHES["substitute"] += 1
    return x


def solve_band_kernel(bl, vals, b):
    """Banded solve through K4/K5, K1 and K2, f32 inside, returned in
    vals' dtype (the contract of the JAX package's ``solve_band_pallas``).
    vals (..., nnz) and b (..., n): one graph or a fleet."""
    from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
        band_assemble_kernel,
    )
    from rustrobotics_tpu_torch.ops.band_chol import solve_banded

    x = solve_banded(bl, vals.float(), b.float(), factorize_kernel,
                     substitute_kernel, band_assemble_kernel)
    return x.to(vals.dtype)
