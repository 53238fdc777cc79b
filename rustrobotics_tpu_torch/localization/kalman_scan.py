"""Parallel (associative-scan) Kalman filtering and smoothing
(counterpart of ``rustrobotics_tpu/localization/kalman_scan.py``).

A linear-Gaussian trajectory of length T is filtered in O(log T) depth
with the five-tuple filtering elements of Särkkä & García-Fernández,
"Temporal Parallelization of Bayesian Smoothers" (2020), and smoothed with
their affine smoothing elements. PyTorch has no public associative scan:
``associative_scan`` is the odd/even recursion of ``lax.associative_scan``
written with batched combines (log2 T levels), so that sums associate as
the JAX package's do.

Model: x_k = F x_{k-1} + q,  q ~ N(0, Q);   y_k = H x_k + r,  r ~ N(0, R),
with prior x_0 ~ N(m0, P0).
"""

from __future__ import annotations

import torch

from rustrobotics_tpu_torch.device import as_tensor
from rustrobotics_tpu_torch.localization.ekf import inv
from rustrobotics_tpu_torch.utils.state import GaussianState


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along axis 0 (len(a) - len(b) in
    {0, 1})."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + a.shape[1:])
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn, elems, reverse=False):
    """Inclusive scan of ``fn`` over axis 0 of the tuple of tensors
    ``elems``: ``lax.associative_scan``'s recursion (combine adjacent
    pairs, scan the half, combine the evens, interleave). ``fn(a, b)``
    takes two tuples batched on axis 0, ``a`` the earlier elements (in
    scan order: with ``reverse``, the later ones in time)."""
    if reverse:
        elems = tuple(torch.flip(e, [0]) for e in elems)

    def scan(elems):
        n = elems[0].shape[0]
        if n < 2:
            return elems
        reduced = fn(tuple(e[0:-1:2] for e in elems),
                     tuple(e[1::2] for e in elems))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(e[:-1] for e in odd),
                      tuple(e[2::2] for e in elems))
        else:
            even = fn(odd, tuple(e[2::2] for e in elems))
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    out = scan(tuple(elems))
    if reverse:
        out = tuple(torch.flip(e, [0]) for e in out)
    return out


def _mv(a, v):
    """(..., I, J) @ (..., J) -> (..., I)."""
    return (a @ v[..., None])[..., 0]


def _combine(elem_a, elem_b):
    """Associative combination of filtering elements (paper eq. 10-11)."""
    a1, b1, c1, j1, e1 = elem_a
    a2, b2, c2, j2, e2 = elem_b
    eye = torch.eye(c1.shape[-1], dtype=c1.dtype, device=c1.device)
    d_inv = inv(eye + c1 @ j2)
    a = a2 @ d_inv @ a1
    b = (a2 @ d_inv @ (b1[..., None] + c1 @ e2[..., None]))[..., 0] + b2
    c = a2 @ d_inv @ c1 @ a2.mT + c2
    dt_inv = d_inv.mT  # (I + J2 C1)^-1 for symmetric C, J
    e = (a1.mT @ dt_inv @ (e2[..., None] - j2 @ b1[..., None]))[..., 0] + e1
    j = a1.mT @ dt_inv @ j2 @ a1 + j1
    return (a, b, c, j, e)


def _tensors(*arrays):
    return tuple(as_tensor(a) for a in arrays)


def parallel_linear_kalman_filter(f, q, h, r, m0, p0, ys) -> GaussianState:
    """Filter T observations ys: (T, Z) in parallel. Returns x (T, S),
    cov (T, S, S): the filtered posterior after each observation."""
    f, q, h, r, m0, p0, ys = _tensors(f, q, h, r, m0, p0, ys)
    t_len = ys.shape[0]
    s_dim = f.shape[-1]
    eye = torch.eye(s_dim, dtype=f.dtype, device=f.device)

    # generic element (k >= 2): prior-independent
    s_inv = inv(h @ q @ h.mT + r)
    k_gain = q @ h.mT @ s_inv
    a_gen = (eye - k_gain @ h) @ f
    c_gen = (eye - k_gain @ h) @ q
    ht_sinv = f.mT @ h.mT @ s_inv
    j_gen = ht_sinv @ h @ f

    def full(m):
        return m.expand((t_len,) + m.shape).clone()

    elems = [full(a_gen), ys @ k_gain.mT, full(c_gen), full(j_gen),
             ys @ ht_sinv.mT]

    # the first element folds in the prior N(m0, P0)
    p_pred = f @ p0 @ f.mT + q
    k1 = p_pred @ h.mT @ inv(h @ p_pred @ h.mT + r)
    m_pred = _mv(f, m0)
    first = (torch.zeros_like(f), m_pred + _mv(k1, ys[0] - _mv(h, m_pred)),
             (eye - k1 @ h) @ p_pred, torch.zeros_like(f),
             torch.zeros(s_dim, dtype=f.dtype, device=f.device))
    for e, v in zip(elems, first):
        e[0] = v
    _, means, covs, _, _ = associative_scan(_combine, tuple(elems))
    return GaussianState(x=means, cov=covs)


def _combine_smooth(elem_a, elem_b):
    """Associative combination of smoothing elements: the smoothing pass
    is affine-function composition m^s_k = E_k m^s_{k+1} + g_k with
    covariance L accumulated under the same map. Under the reverse scan
    the first operand is the accumulated suffix (later in time), the
    second the new earlier element, whose map is applied outermost."""
    e2, g2, l2 = elem_a  # suffix (k+1 .. T)
    e1, g1, l1 = elem_b  # earlier element k
    e = e1 @ e2
    g = _mv(e1, g2) + g1
    ll = e1 @ l2 @ e1.mT + l1
    return (e, g, ll)


def _smoother_gain(f, q, p):
    """(P_pred, P F^T P_pred^-1) for filtered covariances p (..., S, S)."""
    p_pred = f @ p @ f.mT + q
    gain = torch.linalg.solve_ex(p_pred.mT, (p @ f.mT).mT).result.mT
    return p_pred, gain


def parallel_rts_smoother(f, q, h, r, m0, p0, ys) -> GaussianState:
    """Rauch-Tung-Striebel smoother over all T steps in O(log T) depth:
    the parallel filter, per-step smoothing elements
    (E_k = P_k F^T P_pred^{-1}, g_k = m_k - E_k F m_k,
    L_k = P_k - E_k P_pred E_k^T), reduced by a reverse scan."""
    f, q = _tensors(f, q)
    filt = parallel_linear_kalman_filter(f, q, h, r, m0, p0, ys)
    ms, ps = filt.x, filt.cov
    p_pred, gain = _smoother_gain(f, q, ps)
    g = ms - _mv(gain, ms @ f.mT)
    ll = ps - gain @ p_pred @ gain.mT
    # the last element is the identity on the filtered posterior
    gain[-1] = 0.0
    g[-1] = ms[-1]
    ll[-1] = ps[-1]
    _, means, covs = associative_scan(_combine_smooth, (gain, g, ll),
                                      reverse=True)
    return GaussianState(x=means, cov=covs)


def sequential_rts_smoother(f, q, h, r, m0, p0, ys) -> GaussianState:
    """Reference-semantics sequential RTS (oracle for the parallel one)."""
    f, q = _tensors(f, q)
    filt = sequential_linear_kalman_filter(f, q, h, r, m0, p0, ys)
    ms, ps = filt.x, filt.cov
    m_s, p_s = ms[-1], ps[-1]
    sm, sp = [m_s], [p_s]
    for k in range(ms.shape[0] - 2, -1, -1):
        m, p = ms[k], ps[k]
        p_pred, gain = _smoother_gain(f, q, p)
        m_s = m + _mv(gain, m_s - _mv(f, m))
        p_s = p + gain @ (p_s - p_pred) @ gain.mT
        sm.append(m_s)
        sp.append(p_s)
    return GaussianState(x=torch.stack(sm[::-1]), cov=torch.stack(sp[::-1]))


def sequential_linear_kalman_filter(f, q, h, r, m0, p0, ys) -> GaussianState:
    """Reference-semantics sequential filter (oracle for the parallel one)."""
    f, q, h, r, m, p, ys = _tensors(f, q, h, r, m0, p0, ys)
    eye = torch.eye(f.shape[-1], dtype=f.dtype, device=f.device)
    ms, ps = [], []
    for y in ys:
        m_pred = _mv(f, m)
        p_pred = f @ p @ f.mT + q
        k = p_pred @ h.mT @ inv(h @ p_pred @ h.mT + r)
        m = m_pred + _mv(k, y - _mv(h, m_pred))
        p = (eye - k @ h) @ p_pred
        ms.append(m)
        ps.append(p)
    return GaussianState(x=torch.stack(ms), cov=torch.stack(ps))
