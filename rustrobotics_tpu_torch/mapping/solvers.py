"""Linear solvers for the Gauss-Newton normal equations H dx = b
(counterpart of ``rustrobotics_tpu/mapping/solvers.py``).

- ``dense``          : Cholesky of the Jacobi-scaled dense H;
- ``host``           : scipy SuperLU on the host in f64 (the UMFPACK role,
                       the oracle for parity runs);
- ``banded-direct``  : the RCM-banded chain in plain PyTorch
                       (``make_banded_direct``);
- ``banded-kernel``  : the same chain through the hand-written CUDA
                       kernels (band assembly, factorization,
                       substitution), f32 inside (``make_banded_kernel``,
                       the counterpart of ``make_banded_pallas``);
- ``cg``             : block-Jacobi preconditioned CG on the gather-form
                       ELL operator (``solve_cg``);
- ``cg-banded``      : the same PCG on the block-banded operator, whose
                       SpMV is the CUDA kernel K3 on the card
                       (``solve_cg_banded``).

The dense and banded solvers take a fleet's leading batch axis on vals
and b (``pgo.make_optimize_batch``); the host and CG solvers take one
graph.

Not ported yet: Schur, block cyclic reduction, the mixed-precision solve
and the native LDL^T solver.
"""

from __future__ import annotations

import numpy as np
import torch

from rustrobotics_tpu_torch.device import resolve_device
from rustrobotics_tpu_torch.mapping.assemble import SystemLayout, dense_hessian
from rustrobotics_tpu_torch.ops.banded import (
    as_index,
    make_banded_matvec,
    summed_values,
)
from rustrobotics_tpu_torch.ops.batched_tri import _cholesky


def solve_dense(layout: SystemLayout, vals, b):
    """Dense Cholesky solve with symmetric Jacobi scaling: scaling by
    D^-1/2 (D = diag H) brings every diagonal to 1, which keeps the f32
    factorization of the 1e7 gauge-prior system stable. vals (..., nnz)
    and b (..., n): a fleet is one batched Cholesky."""
    h = dense_hessian(layout, vals)
    d = torch.sqrt(torch.diagonal(h, dim1=-2, dim2=-1).clamp(min=1e-12))
    hs = h / (d[..., :, None] * d[..., None, :])
    l = _cholesky(hs)
    return torch.cholesky_solve((b / d)[..., None], l)[..., 0] / d


def solve_host(layout: SystemLayout, vals, b):
    """Host sparse direct solve (SuperLU, f64; duplicate triplets are
    summed). Returns dx on vals' device in vals' dtype."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    vals_np = vals.detach().cpu().numpy().astype(np.float64)
    b_np = b.detach().cpu().numpy().astype(np.float64)
    h = sp.coo_matrix((vals_np, (np.asarray(layout.rows),
                                 np.asarray(layout.cols))),
                      shape=(layout.n, layout.n))
    x = spla.splu(h.tocsc()).solve(b_np)
    return torch.as_tensor(x).to(device=vals.device, dtype=vals.dtype)


def make_banded_direct(layout: SystemLayout, device=None):
    """Banded blocked Cholesky through the plain chain. Returns
    solve(vals, b), or None when the RCM bandwidth is too large for the
    banded path."""
    from rustrobotics_tpu_torch.ops.band_chol import (
        build_band_chol,
        solve_band_chol,
    )

    bl = build_band_chol(layout)
    if bl is None:
        return None
    bl = bl.to(resolve_device(device))
    return lambda vals, b: solve_band_chol(bl, vals, b)


def make_banded_kernel(layout: SystemLayout, device=None):
    """Banded solve through the CUDA factorization and substitution
    kernels (plain versions on the CPU). Returns solve(vals, b), or None
    when the RCM bandwidth is too large for the banded path. The kernels
    work from global memory at every kb that ``build_band_chol`` gives
    (a multiple of 128), so the band's existence is their only gate."""
    from rustrobotics_tpu_torch.ops.band_chol import build_band_chol
    from rustrobotics_tpu_torch.ops.band_chol_kernels import solve_band_kernel

    bl = build_band_chol(layout)
    if bl is None:
        return None
    bl = bl.to(resolve_device(device))
    return lambda vals, b: solve_band_kernel(bl, vals, b)


def ell_values(layout: SystemLayout, vals):
    """Duplicate-summed triplet values scattered into the padded ELL value
    table (n, width). One scatter per GN step, amortized over every CG
    round, which is then a gather."""
    flat = vals.new_zeros(layout.n * layout.ell_width)
    flat[as_index(layout.ell_pos, vals.device)] = summed_values(layout, vals)
    return flat.view(layout.n, layout.ell_width)


def make_ell_matvec(layout: SystemLayout, vals):
    """Gather-based SpMV: y = sum_d ell_vals[:, d] * x[nbr[:, d]]."""
    ell_vals = ell_values(layout, vals)
    nbr = as_index(layout.ell_nbr, vals.device)

    def matvec(x):
        return (ell_vals * x[nbr]).sum(dim=1)

    return matvec


def make_block_jacobi(layout: SystemLayout, vals):
    """Per-node block-Jacobi preconditioner: the 3x3 / 2x2 diagonal blocks
    of H, identity-padded to 6x6 and batch-inverted in vals' dtype."""
    dev = vals.device
    dof_block = as_index(layout.dof_block, dev)
    dof_pos = as_index(layout.dof_pos, dev)
    rows = as_index(layout.rows, dev)
    cols = as_index(layout.cols, dev)
    br, bc = dof_block[rows], dof_block[cols]
    blocks = vals.new_zeros(layout.n_blocks, 6, 6).index_put_(
        (br, dof_pos[rows], dof_pos[cols]),
        torch.where(br == bc, vals, 0.0), accumulate=True)
    blocks = blocks + torch.as_tensor(layout.pad_eye, dtype=vals.dtype,
                                      device=dev)
    binv = torch.linalg.inv(blocks)
    slot = dof_block * 6 + dof_pos  # each dof's place in (n_blocks, 6)

    def precond(r):
        rb = r.new_zeros(layout.n_blocks * 6).index_copy_(0, slot, r)
        yb = torch.bmm(binv, rb.view(-1, 6, 1))
        return yb.view(-1)[slot]

    return precond


def pcg(matvec, precond, b, tol, maxiter):
    """Preconditioned CG with the semantics of
    ``jax.scipy.sparse.linalg.cg`` (and of the JAX package's
    ``solvers._pcg_counted``): x0 = 0, r0 = b, and a round runs while
    ‖r‖² > tol²·‖b‖² and fewer than maxiter rounds ran. Returns
    (x, rounds).

    The host reads the stop test before every round, which waits for the
    device. The round is bound by the host's launches, so the device has
    drained by then and the wait is short."""
    z = precond(b)
    bb = torch.dot(b, b)
    atol2 = tol * tol * bb
    x, r, p = torch.zeros_like(b), b, z
    rz, rr = torch.dot(b, z), bb
    rounds = 0
    while rounds < maxiter and bool(rr > atol2):
        ap = matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz, rr = rz_new, torch.dot(r, r)
        rounds += 1
    return x, rounds


def solve_cg(layout: SystemLayout, vals, b, tol=1e-10, maxiter=None):
    """Block-Jacobi PCG on the gather-form ELL operator; maxiter=None
    means 4·n rounds."""
    x, _ = pcg(make_ell_matvec(layout, vals), make_block_jacobi(layout, vals),
               b, tol, 4 * layout.n if maxiter is None else maxiter)
    return x


def solve_cg_banded(layout: SystemLayout, blayout, vals, b, tol=1e-6,
                    maxiter=400, use_kernel=True):
    """Block-Jacobi PCG on the block-banded operator: K3 for values on
    the card (f32 only) and the plain SpMV on the CPU; ``use_kernel=False``
    takes the plain SpMV everywhere."""
    matvec = make_banded_matvec(blayout, layout, vals, use_kernel=use_kernel)
    x, _ = pcg(matvec, make_block_jacobi(layout, vals), b, tol, maxiter)
    return x
