"""Batched Cholesky and triangular inversion (counterpart of
``rustrobotics_tpu/ops/batched_tri.py``).

Two forms of each routine:

- native (``blocked=False``, the default here): ``torch.linalg``'s
  Cholesky and triangular solve;
- blocked (``blocked=True``): the JAX package's matmul-only forms, a
  Schur recursion whose triangular-inverse leaves use the nilpotent series
  ``(I + K)^-1 = prod_j (I + M^(2^j))``, ``M = -K``.

The JAX package picks the blocked forms off the CPU because XLA's batched
cholesky/triangular_solve serialize per batch item on a TPU. That reason
does not carry over to PyTorch, so the port defaults to the natives; the
blocked forms are kept for parity and for measurement.

A Cholesky that breaks down returns NaN (as JAX does) instead of raising,
so no check syncs the device.
"""

from __future__ import annotations

import torch

BASE = 128  # leaf size for the nilpotent-series product
CHOL_BASE = 64


def _sym(a):
    """Mirror the lower triangle (callers may fill only that half)."""
    return torch.tril(a) + torch.tril(a, -1).transpose(-1, -2)


def _cholesky(a):
    """Cholesky of the mirrored lower triangle; NaN where it breaks down."""
    l, info = torch.linalg.cholesky_ex(_sym(a))
    return torch.where((info == 0)[..., None, None], l, torch.nan)


def _tril_inv_base(l):
    """(..., n, n) lower-triangular inverse via nilpotent squaring."""
    n = l.shape[-1]
    dinv = 1.0 / torch.diagonal(l, dim1=-2, dim2=-1)  # (..., n)
    eye = torch.eye(n, dtype=l.dtype, device=l.device)
    m = eye - l * dinv[..., :, None]  # -K, strictly lower
    res = eye + m
    p = m
    for _ in range(max((n - 1).bit_length() - 1, 0)):
        p = p @ p
        res = res @ (eye + p)
    return res * dinv[..., None, :]


def chol_blocked(a, base: int = CHOL_BASE, blocked: bool = False):
    """Batched Cholesky. Blocked form: A = [[A11, .], [A21, A22]],
    L11 = chol(A11), L21 = A21 tril_inv(L11)^T,
    L22 = chol(A22 - L21 L21^T), down to ``base``-sized leaves. n must be
    a multiple of base (or <= base). Only the lower triangle of ``a`` is
    read."""
    n = a.shape[-1]
    if n <= base or not blocked:
        return _cholesky(a)
    h = n // 2
    l11 = chol_blocked(a[..., :h, :h], base, blocked)
    l21 = a[..., h:, :h] @ tril_inv(l11, blocked).transpose(-1, -2)
    l22 = chol_blocked(a[..., h:, h:] - l21 @ l21.transpose(-1, -2),
                       base, blocked)
    top = torch.cat([l11, l11.new_zeros(a.shape[:-2] + (h, n - h))], dim=-1)
    bot = torch.cat([l21, l22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def tril_inv(l, blocked: bool = False):
    """Batched lower-triangular inverse. l: (..., n, n); for the blocked
    form n is a multiple of BASE or < BASE."""
    if not blocked:
        eye = torch.eye(l.shape[-1], dtype=l.dtype,
                        device=l.device).expand(l.shape)
        return torch.linalg.solve_triangular(l, eye, upper=False)
    n = l.shape[-1]
    if n <= BASE:
        return _tril_inv_base(l)
    h = n // 2
    i11 = tril_inv(l[..., :h, :h], blocked)
    i22 = tril_inv(l[..., h:, h:], blocked)
    i21 = -(i22 @ (l[..., h:, :h] @ i11))
    top = torch.cat([i11, i11.new_zeros(l.shape[:-2] + (h, n - h))], dim=-1)
    bot = torch.cat([i21, i22], dim=-1)
    return torch.cat([top, bot], dim=-2)
