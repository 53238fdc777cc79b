"""Multivariate normal with Cholesky-backed pdf/logpdf/sample
(counterpart of ``rustrobotics_tpu/utils/mvn.py``).

``create`` factorizes the covariance and raises
``CovarianceNotPositiveDefinite`` where the JAX package raises (its eager
NaN check): one host read, at construction. ``cholesky`` is
``jnp.linalg.cholesky`` for the steps of a filter: it factors the
symmetrized matrix and gives NaN where the matrix is not positive definite,
through ``torch.linalg.cholesky_ex``, which neither raises nor waits for
the card. ``sample(generator, shape)`` draws ``mean + L u``;
``_sample(u)`` takes the standard normals ``u`` directly.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rustrobotics_tpu_torch.device import as_tensor


class CovarianceNotPositiveDefinite(ValueError):
    """Raised when the covariance has no Cholesky factorization."""


def cholesky(a):
    """Lower Cholesky factor of (a + aᵀ) / 2 for (..., D, D) stacks; a
    matrix that is not positive definite gets NaN throughout, as
    ``jnp.linalg.cholesky`` gives it."""
    low, info = torch.linalg.cholesky_ex((a + a.mT) / 2)
    return torch.where((info == 0)[..., None, None], low, torch.nan)


@dataclasses.dataclass
class MultiVariateNormal:
    mean: torch.Tensor  # (D,)
    chol: torch.Tensor  # (D, D) lower-triangular L with cov = L @ L.T
    chol_inv: torch.Tensor  # (D, D) L^-1 (precomputed whitening transform)
    log_norm: torch.Tensor  # scalar: -0.5 * (D*log(2*pi) + log det cov)

    @classmethod
    def create(cls, mean, covariance, device=None,
               dtype=None) -> "MultiVariateNormal":
        mean = as_tensor(mean, device, dtype)
        covariance = as_tensor(covariance, mean.device, dtype)
        chol = cholesky(covariance)
        if bool(torch.isnan(chol).any()):
            raise CovarianceNotPositiveDefinite(
                "covariance is not symmetric positive definite"
            )
        d = mean.shape[-1]
        log_det = 2.0 * torch.log(torch.diagonal(chol, 0, -2, -1)).sum(-1)
        log_norm = -0.5 * (d * math.log(2.0 * math.pi) + log_det)
        eye = torch.eye(d, dtype=chol.dtype, device=chol.device)
        chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
        return cls(mean=mean, chol=chol, chol_inv=chol_inv, log_norm=log_norm)

    def logpdf(self, x) -> torch.Tensor:
        """Log density at x: (..., D) -> (...)."""
        y = (x - self.mean) @ self.chol_inv.mT
        return self.log_norm - 0.5 * torch.square(y).sum(-1)

    def pdf(self, x) -> torch.Tensor:
        return torch.exp(self.logpdf(x))

    def sample(self, generator, shape=()) -> torch.Tensor:
        """Draw samples of shape ``shape + (D,)`` as mean + L @ u."""
        u = torch.randn(tuple(shape) + (self.mean.shape[-1],),
                        generator=generator, dtype=self.mean.dtype,
                        device=self.mean.device)
        return self._sample(u)

    def _sample(self, u) -> torch.Tensor:
        """mean + L @ u for standard normals u of shape (..., D)."""
        return self.mean + u @ self.chol.mT
