"""Factorizations that give NaN for a non-finite operand, as JAX's do.

``jnp.linalg.svd`` and ``jnp.linalg.lstsq`` return NaN for a problem whose
operand holds a NaN or an inf and carry on with the rest of a batch;
``torch.linalg.svd`` and ``torch.linalg.lstsq`` raise for the whole batch
(LAPACK's gelsy rejects it on the CPU). Each function here zeroes the
non-finite entries, factors, and sets every output of each problem that
held one to NaN, so a finite problem's result is the plain call's.
"""

from __future__ import annotations

import torch


def _bad_problems(*operands):
    """(...,) True where any entry of a problem's (..., m, n) operands is
    not finite; the operands' batch shapes must broadcast."""
    bad = None
    for a in operands:
        b = ~torch.isfinite(a).flatten(-2).all(-1)
        bad = b if bad is None else bad | b
    return bad


def _zeroed(a):
    return torch.where(torch.isfinite(a), a, torch.zeros_like(a))


def _nan_where(x, bad, core_dims):
    """x with every problem flagged in ``bad`` set to NaN; x has
    ``core_dims`` trailing axes after bad's batch axes."""
    mask = bad.reshape(bad.shape + (1,) * core_dims)
    return torch.where(mask, torch.full_like(x, float("nan")), x)


def svd(a, full_matrices: bool = True):
    """``torch.linalg.svd`` of (..., m, n); a problem with a non-finite
    entry gets U, S and Vᴴ all NaN."""
    bad = _bad_problems(a)
    u, s, vh = torch.linalg.svd(_zeroed(a), full_matrices=full_matrices)
    return (_nan_where(u, bad, 2), _nan_where(s, bad, 1),
            _nan_where(vh, bad, 2))


def lstsq(a, b):
    """``torch.linalg.lstsq(a, b).solution`` for a (..., m, n) and b
    (..., m, k); a problem with a non-finite entry in a or b gets a NaN
    solution."""
    bad = _bad_problems(a, b)
    x = torch.linalg.lstsq(_zeroed(a), _zeroed(b)).solution
    return _nan_where(x, bad, 2)
