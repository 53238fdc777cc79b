"""Infinite-horizon discrete LQR (counterpart of
``rustrobotics_tpu/control/lqr.py``).

DARE by fixed-point iteration to a max-abs tolerance, gain
``K = (R + B^T P B)^-1 B^T P A``. The JAX package's ``while_loop`` is a
Python loop that reads the convergence test on the host every
``_CHECK_EVERY`` iterations; the iterate it returns is the one the
``while_loop`` stops at, since the iterates past it are discarded.
"""

from __future__ import annotations

import dataclasses

import torch

from rustrobotics_tpu_torch.device import as_tensor, tensor_fields

# iterations between host reads of the convergence test
_CHECK_EVERY = 8


@dataclasses.dataclass
class LinearTimeInvariantModel:
    """x' = A x + B u with stage cost x^T Q x + u^T R u."""

    a: torch.Tensor  # (S, S)
    b: torch.Tensor  # (S, U)
    q: torch.Tensor  # (S, S)
    r: torch.Tensor  # (U, U)

    def __post_init__(self):
        tensor_fields(self, "a", "b", "q", "r")


def lti_from_numpy(a, b, q, r, device=None,
                   dtype=None) -> LinearTimeInvariantModel:
    """A ``LinearTimeInvariantModel`` from the JAX package's model carried
    across as numpy arrays."""
    return LinearTimeInvariantModel(*(as_tensor(x, device, dtype)
                                      for x in (a, b, q, r)))


def solve_dare(model: LinearTimeInvariantModel, max_iter: int = 500,
               epsilon: float = 0.01) -> torch.Tensor:
    """Fixed-point DARE iteration: P <- A^T P A - A^T P B (R + B^T P B)^-1
    B^T P A + Q from P = Q, until max|P' - P| < epsilon or max_iter."""
    a, b, q, r = model.a, model.b, model.q, model.r
    at, bt = a.T, b.T
    p = q
    it = 0
    while it < max_iter:
        ps, deltas = [], []
        for _ in range(min(_CHECK_EVERY, max_iter - it)):
            pn = at @ p @ a - at @ p @ b @ torch.linalg.inv_ex(
                r + bt @ p @ b).inverse @ bt @ p @ a + q
            deltas.append(torch.max(torch.abs(pn - p)))
            ps.append(pn)
            p = pn
        # the first iterate whose step is not >= epsilon (NaN included)
        # ends the loop
        stop = (~(torch.stack(deltas) >= epsilon)).tolist()
        if True in stop:
            return ps[stop.index(True)]
        it += len(ps)
    return p


def lqr(model: LinearTimeInvariantModel, max_iter: int = 500,
        epsilon: float = 0.01) -> torch.Tensor:
    """LQR gain K with u = -K x."""
    p = solve_dare(model, max_iter, epsilon)
    return torch.linalg.inv_ex(model.r + model.b.T @ p @ model.b).inverse @ (
        model.b.T @ p @ model.a)
