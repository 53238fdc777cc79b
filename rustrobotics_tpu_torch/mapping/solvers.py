"""Linear solvers for the Gauss-Newton normal equations H dx = b
(counterpart of ``rustrobotics_tpu/mapping/solvers.py``).

- ``dense``          : Cholesky of the Jacobi-scaled dense H;
- ``host``           : scipy SuperLU on the host in f64 (the UMFPACK role,
                       the oracle for parity runs);
- ``native``         : the native C++ sparse LDL^T on the host in f64
                       (``solve_native``; SuperLU where it cannot be built);
- ``schur``          : dense Cholesky of the pose system after eliminating
                       the 2D landmarks' 2x2 blocks (``solve_schur``);
- ``banded-direct``  : the RCM-banded chain in plain PyTorch
                       (``make_banded_direct``);
- ``banded-kernel``  : the same chain through the hand-written CUDA
                       kernels (band assembly, factorization,
                       substitution), f32 inside (``make_banded_kernel``,
                       the counterpart of ``make_banded_pallas``);
- ``banded-cr``      : the band by block cyclic reduction
                       (``make_banded_cr``);
- ``banded-mixed``   : CG on the exact scaled band, preconditioned by a
                       cyclic-reduction factor taken at low precision
                       (``make_banded_mixed``);
- ``cg``             : block-Jacobi preconditioned CG on the gather-form
                       ELL operator (``solve_cg``);
- ``cg-banded``      : the same PCG on the block-banded operator, whose
                       SpMV is the CUDA kernel K3 on the card
                       (``solve_cg_banded``).

Every device solver takes a fleet's leading batch axis on vals and b
(``pgo.make_optimize_batch``); the PCG then runs every graph's own stop
test. The host solvers (``host``, ``native``) take one graph.
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
from rustrobotics_tpu_torch.ops.batched_tri import _cholesky, _sym


def _cholesky_solve_scaled(h, b):
    """Solve h x = b (..., n) by Cholesky with symmetric Jacobi scaling:
    scaling by D^-1/2 (D = diag h) brings every diagonal to 1, which keeps
    the f32 factorization of the 1e7 gauge-prior system stable."""
    d = torch.sqrt(torch.diagonal(h, dim1=-2, dim2=-1).clamp(min=1e-12))
    hs = h / (d[..., :, None] * d[..., None, :])
    l = _cholesky(hs)
    return torch.cholesky_solve((b / d)[..., None], l)[..., 0] / d


def solve_dense(layout: SystemLayout, vals, b):
    """Dense Cholesky solve with symmetric Jacobi scaling. vals (..., nnz)
    and b (..., n): a fleet is one batched Cholesky."""
    return _cholesky_solve_scaled(dense_hessian(layout, vals), b)


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


def solve_native(layout: SystemLayout, vals, b):
    """Native C++ sparse LDL^T direct solve (RCM + elimination-tree
    up-looking factorization) in f64 on the host, the framework's own
    UMFPACK-role solver; SuperLU (``solve_host``) when the library cannot
    be built or ``RUSTROBOTICS_NO_NATIVE`` is set. Returns dx on vals'
    device in vals' dtype."""
    from rustrobotics_tpu_torch.ops.native_solver import (
        native_available,
        solve_coo_native,
    )

    if not native_available():
        return solve_host(layout, vals, b)
    x = solve_coo_native(
        layout.n, np.asarray(layout.rows), np.asarray(layout.cols),
        vals.detach().cpu().numpy().astype(np.float64),
        b.detach().cpu().numpy().astype(np.float64))
    return torch.as_tensor(x).to(device=vals.device, dtype=vals.dtype)


def solve_schur(layout: SystemLayout, vals, b):
    """Schur-complement elimination of the 2D landmarks' blocks. With
    H = [[Hpp, Hpl], [Hlp, Hll]] and Hll block diagonal (2x2 a landmark:
    landmarks never connect to each other), solve the reduced pose system
    S dxp = bp - Hpl Hll^-1 bl, S = Hpp - Hpl Hll^-1 Hlp, by Jacobi-scaled
    dense Cholesky, then dxl = Hll^-1 (bl - Hlp dxp). A graph without
    landmarks takes ``solve_dense``. ``layout`` is the host layout: the
    triplets are split by quadrant on the host every call. vals (..., nnz)
    and b (..., n); S is a dense (..., P, P) tensor, P the pose dofs."""
    lm_dofs = np.asarray(layout.lm_dofs)
    if len(lm_dofs) == 0:
        return solve_dense(layout, vals, b)
    dev, batch = vals.device, vals.shape[:-1]
    pose_dofs = np.asarray(layout.pose_dofs)
    np_dof, nl_dof = len(pose_dofs), len(lm_dofs)
    n_lm = nl_dof // 2

    # host partition of the triplets by quadrant: each scatter below
    # touches only its own values
    rows, cols = np.asarray(layout.rows), np.asarray(layout.cols)
    lm_r, lm_c = layout.dof_is_lm[rows], layout.dof_is_lm[cols]
    cr, cc = layout.dof_compact[rows].astype(np.int64), \
        layout.dof_compact[cols].astype(np.int64)
    sel_pp = np.flatnonzero(~lm_r & ~lm_c)
    sel_pl = np.flatnonzero(~lm_r & lm_c)
    sel_ll = np.flatnonzero(lm_r & lm_c)

    def scatter(sel, flat, size):
        return vals.new_zeros(batch + (size,)).index_add_(
            -1, as_index(flat, dev), vals[..., as_index(sel, dev)])

    h_pp = scatter(sel_pp, cr[sel_pp] * np_dof + cc[sel_pp],
                   np_dof * np_dof).view(batch + (np_dof, np_dof))
    h_pl = scatter(sel_pl, cr[sel_pl] * nl_dof + cc[sel_pl],
                   np_dof * nl_dof).view(batch + (np_dof, nl_dof))
    ll_r, ll_c = cr[sel_ll], cc[sel_ll]
    h_ll = scatter(sel_ll, (ll_r // 2) * 4 + (ll_r % 2) * 2 + ll_c % 2,
                   n_lm * 4).view(batch + (n_lm, 2, 2))

    bp = b[..., as_index(pose_dofs, dev)]
    bl = b[..., as_index(lm_dofs, dev)].reshape(batch + (n_lm, 2))
    h_ll_inv = torch.linalg.inv_ex(h_ll).inverse  # singular: inf/NaN
    # W = Hll^-1 Hlp, (..., L, 2, P)
    w = h_ll_inv @ h_pl.mT.reshape(batch + (n_lm, 2, np_dof))
    s = h_pp - h_pl @ w.reshape(batch + (nl_dof, np_dof))
    hll_inv_bl = (h_ll_inv @ bl[..., None]).reshape(batch + (nl_dof,))
    rhs = bp - (h_pl @ hll_inv_bl[..., None])[..., 0]
    dxp = _cholesky_solve_scaled(s, rhs)
    resid = bl - (h_pl.mT @ dxp[..., None]).reshape(batch + (n_lm, 2))
    dxl = (h_ll_inv @ resid[..., None]).reshape(batch + (nl_dof,))

    dx = vals.new_zeros(batch + (layout.n,))
    dx[..., as_index(pose_dofs, dev)] = dxp
    dx[..., as_index(lm_dofs, dev)] = dxl
    return dx


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


def make_banded_cr(layout: SystemLayout, device=None):
    """Banded solve by block cyclic reduction (``band_chol.solve_band_cr``):
    the contract of ``make_banded_direct`` with a log-depth factorization
    whose every level is one batched Cholesky, inverse and product over
    the level's odd blocks. Returns solve(vals, b), or None when the RCM
    bandwidth is too large for the banded path."""
    from rustrobotics_tpu_torch.ops.band_chol import (
        build_band_chol,
        solve_band_cr,
    )

    bl = build_band_chol(layout)
    if bl is None:
        return None
    bl = bl.to(resolve_device(device))
    return lambda vals, b: solve_band_cr(bl, vals, b)


def make_banded_mixed(layout: SystemLayout, tol=None, maxiter=256,
                      lp="high", lift=None, return_rounds=False, device=None):
    """Mixed-precision banded solve: factor the Jacobi-scaled band once
    by cyclic reduction at low precision, and use that factor as the
    preconditioner of full-precision CG on the exact scaled band. The
    answer is exact to the CG tolerance (None: 1e-6 in f32, 1e-10 in
    f64); the low precision only shapes the round count.

    - ``lp="high"``: the JAX package's HIGH matmul precision (bf16_3x
      passes on a TPU) for the factorization alone, with a +2^-16
      diagonal lift. Its torch analog, TF32 for the cyclic reduction's
      products, breaks the lifted factor on the card (NaN from the second
      Gauss-Newton step on corridor-1728 on an H100; ``PERF.md`` § 6), so the
      factorization runs at full f32 precision, as the JAX package's does
      off the TPU.
    - ``lp="bf16"``: the band's values truncated to bfloat16 storage,
      factored at full precision, with a +2^-8 lift.

    The CG runs in the scaled band-permuted space: the operator is the
    block-tridiagonal band itself (y_j = D_j x_j + L_j x_{j-1} + L_{j+1}^T
    x_{j+1}) and the preconditioner a CR substitution through explicit
    inverse factors (``cr_invert``). It is ``pcg``, so a fleet's rows stop
    on their own tests.

    Returns solve(vals, b) (``return_rounds``: (x, rounds), rounds an int
    for one graph and a (B,) tensor for a fleet), or None when the RCM
    bandwidth is too large for the banded path."""
    from rustrobotics_tpu_torch.ops.band_chol import (
        _prepare_blocks,
        build_band_chol,
        cr_factorize,
        cr_invert,
        cr_substitute_inv,
        scale_rhs,
        unscale,
    )

    if lp not in ("high", "bf16"):
        raise ValueError(f"lp must be 'high' or 'bf16', got {lp!r}")
    bl = build_band_chol(layout)
    if bl is None:
        return None
    bl = bl.to(resolve_device(device))
    kb, nb = bl.kb, bl.nb
    lift_v = lift if lift is not None else (
        2.0 ** -8 if lp == "bf16" else 2.0 ** -16)

    def solve(vals, b):
        dtype, batch = vals.dtype, vals.shape[:-1]
        cg_tol = tol if tol is not None else (
            1e-6 if dtype == torch.float32 else 1e-10)
        r_blocks, dinv_p = _prepare_blocks(bl, vals)
        low = (r_blocks.to(torch.bfloat16).to(dtype) if lp == "bf16"
               else r_blocks)
        eye = torch.eye(kb, dtype=dtype, device=vals.device)
        low = torch.cat([low[..., :kb], low[..., kb:] + lift_v * eye], -1)
        levels, f_root = cr_factorize(low)
        inv_levels, root_inv = cr_invert(levels, f_root)

        # the exact scaled operator: the band holds lower triangles, so
        # the diagonal blocks are mirrored once here
        dsym = _sym(r_blocks[..., kb:])              # (..., nb, kb, kb)
        lo = r_blocks[..., :kb]                      # L_j (L_0 = 0)
        lo_next = torch.cat([lo[..., 1:, :, :],
                             torch.zeros_like(lo[..., :1, :, :])], -3)
        shape = batch + (nb, kb)

        def matvec(x):                               # x (..., nb*kb)
            xs = x.view(shape)
            zero = xs.new_zeros(batch + (1, kb))
            x_prev = torch.cat([zero, xs[..., :-1, :]], -2)
            x_next = torch.cat([xs[..., 1:, :], zero], -2)
            y = (dsym @ xs[..., None] + lo @ x_prev[..., None]
                 + lo_next.mT @ x_next[..., None])
            return y.reshape(x.shape)

        def precond(r):
            return cr_substitute_inv(inv_levels, root_inv,
                                     r.view(shape)).reshape(r.shape)

        bp = scale_rhs(bl, b, dinv_p).reshape(batch + (nb * kb,))
        xs, rounds = pcg(matvec, precond, bp, cg_tol, maxiter)
        x = unscale(bl, xs, dinv_p)
        return (x, rounds) if return_rounds else x

    return solve


def ell_values(layout: SystemLayout, vals):
    """Duplicate-summed triplet values (..., nnz) scattered into the padded
    ELL value table (..., n, width). One scatter per GN step, amortized
    over every CG round, which is then a gather."""
    batch = vals.shape[:-1]
    flat = vals.new_zeros(batch + (layout.n * layout.ell_width,))
    flat[..., as_index(layout.ell_pos, vals.device)] = summed_values(layout,
                                                                     vals)
    return flat.view(batch + (layout.n, layout.ell_width))


def make_ell_matvec(layout: SystemLayout, vals):
    """Gather-based SpMV: y = sum_d ell_vals[..., :, d] * x[..., nbr[:, d]],
    x's batch shape that of vals."""
    ell_vals = ell_values(layout, vals)
    nbr = as_index(layout.ell_nbr, vals.device)

    def matvec(x):
        return (ell_vals * x[..., nbr]).sum(dim=-1)

    return matvec


def make_block_jacobi(layout: SystemLayout, vals):
    """Per-node block-Jacobi preconditioner: the 3x3 / 2x2 / 6x6 diagonal
    blocks of H (..., n_blocks, 6, 6), identity-padded to 6x6 and
    batch-inverted in vals' dtype."""
    dev, batch = vals.device, vals.shape[:-1]
    dof_block = as_index(layout.dof_block, dev)
    dof_pos = as_index(layout.dof_pos, dev)
    rows = as_index(layout.rows, dev)
    cols = as_index(layout.cols, dev)
    br, bc = dof_block[rows], dof_block[cols]
    entry = (br * 6 + dof_pos[rows]) * 6 + dof_pos[cols]
    blocks = vals.new_zeros(batch + (layout.n_blocks * 36,)).index_add_(
        -1, entry, torch.where(br == bc, vals, 0.0))
    blocks = blocks.view(batch + (layout.n_blocks, 6, 6)) + torch.as_tensor(
        layout.pad_eye, dtype=vals.dtype, device=dev)
    return block_precond(blocks, dof_block * 6 + dof_pos)


def block_precond(blocks, slot):
    """Apply of the inverses of (..., n_blocks, 6, 6) diagonal blocks;
    ``slot`` (n,) is each dof's place in (n_blocks, 6). A singular block's
    inverse is inf/NaN, as ``jnp.linalg.inv`` gives it."""
    n_blocks = blocks.shape[-3]
    binv = torch.linalg.inv_ex(blocks).inverse

    def precond(r):
        rb = r.new_zeros(r.shape[:-1] + (n_blocks * 6,)).index_copy_(
            -1, slot, r)
        yb = binv @ rb.view(r.shape[:-1] + (n_blocks, 6, 1))
        return yb.view(r.shape[:-1] + (-1,))[..., slot]

    return precond


def pcg(matvec, precond, b, tol, maxiter):
    """Preconditioned CG with the semantics of
    ``jax.scipy.sparse.linalg.cg`` (and of the JAX package's
    ``solvers._pcg_counted``): x0 = 0, r0 = b, and a round runs while
    ‖r‖² > tol²·‖b‖² and fewer than maxiter rounds ran. Returns
    (x, rounds).

    b (n,) is one system and rounds an int. b (B, n) is a fleet, the
    semantics of JAX's batched ``while_loop``: every row has its own rr,
    rz and stop test, rounds run while any row's test holds, and a row
    whose test has failed keeps x, r, z, p, rz and rr by ``torch.where``
    (a stopped row's pᵀAp may be 0 and its step NaN; the select drops it).
    rounds is then a (B,) tensor, each row's count.

    The host reads the any-row-active test before every round, which waits
    for the device. The round is bound by the host's launches, so the
    device has drained by then and the wait is short."""
    def dot(u, v):  # one product a row
        return torch.dot(u, v) if u.dim() == 1 else torch.linalg.vecdot(u, v)

    batched = b.dim() > 1
    z = precond(b)
    bb = dot(b, b)
    atol2 = tol * tol * bb
    x, r, p = torch.zeros_like(b), b, z
    rz, rr = dot(b, z), bb
    rounds = torch.zeros(b.shape[:-1], dtype=torch.long, device=b.device)
    k = 0
    while k < maxiter:
        active = rr > atol2
        if not bool(active.any()):
            break
        ap = matvec(p)
        alpha = (rz / dot(p, ap))[..., None]
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        p_new = z_new + (rz_new / rz)[..., None] * p
        rr_new = dot(r_new, r_new)
        if batched:
            keep = active[:, None]
            x, r, z, p = (torch.where(keep, new, old) for new, old in (
                (x_new, x), (r_new, r), (z_new, z), (p_new, p)))
            rz = torch.where(active, rz_new, rz)
            rr = torch.where(active, rr_new, rr)
            rounds += active
        else:
            # one system runs only while its test holds: no selects, which
            # would add launches to a launch-bound round
            x, r, z, p, rz, rr = x_new, r_new, z_new, p_new, rz_new, rr_new
        k += 1
    return x, (rounds if batched else k)


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
    takes the plain SpMV everywhere. A fleet's SpMV is one K3 launch a
    round."""
    matvec = make_banded_matvec(blayout, layout, vals, use_kernel=use_kernel)
    x, _ = pcg(matvec, make_block_jacobi(layout, vals), b, tol, maxiter)
    return x


SOLVERS = {
    "dense": solve_dense,
    "host": solve_host,
    "native": solve_native,
    "cg": solve_cg,
    "schur": solve_schur,
}
