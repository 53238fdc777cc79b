"""Linear solvers for the Gauss-Newton normal equations H dx = b
(counterpart of ``rustrobotics_tpu/mapping/solvers.py``).

- ``dense``          : Cholesky of the Jacobi-scaled dense H;
- ``host``           : scipy SuperLU on the host in f64 (the UMFPACK role,
                       the oracle for parity runs);
- ``banded-direct``  : the RCM-banded chain in plain PyTorch
                       (``make_banded_direct``);
- ``banded-kernel``  : the same chain through the hand-written CUDA
                       kernels, f32 inside (``make_banded_kernel``, the
                       counterpart of ``make_banded_pallas``).

Not ported yet: CG, Schur, block cyclic reduction, the mixed-precision
solve, the native LDL^T solver and ``cg-banded``.
"""

from __future__ import annotations

import numpy as np
import torch

from rustrobotics_tpu_torch.device import resolve_device
from rustrobotics_tpu_torch.mapping.assemble import SystemLayout, dense_hessian
from rustrobotics_tpu_torch.ops.batched_tri import _cholesky


def solve_dense(layout: SystemLayout, vals, b):
    """Dense Cholesky solve with symmetric Jacobi scaling: scaling by
    D^-1/2 (D = diag H) brings every diagonal to 1, which keeps the f32
    factorization of the 1e7 gauge-prior system stable."""
    h = dense_hessian(layout, vals)
    d = torch.sqrt(torch.diagonal(h).clamp(min=1e-12))
    hs = h / (d[:, None] * d[None, :])
    l = _cholesky(hs)
    return torch.cholesky_solve((b / d)[:, None], l)[:, 0] / d


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
