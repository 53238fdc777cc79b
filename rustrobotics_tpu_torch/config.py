"""Configuration layer (counterpart of ``rustrobotics_tpu/config.py``).

The knobs of the pose-graph optimizer and the filters live in frozen,
hashable dataclasses with the reference's defaults (tolerance 1e-4,
λ0 = 0.01, gauge prior 1e7), overridable from flags or dicts.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PGOConfig:
    """Pose-graph optimizer knobs (defaults = reference behavior)."""

    num_iterations: int = 50
    solver: str = "gauss_newton"  # or "levenberg_marquardt"
    backend: str = "host"  # any name of mapping.pgo.BACKENDS
    tolerance: float = 1e-4  # ‖dx‖ convergence
    lambda0: float = 0.01  # LM initial damping
    prior_weight: float = 1e7  # gauge prior
    cg_tol: float = 1e-10
    cg_maxiter: int | None = None

    def replace(self, **kw) -> "PGOConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Bayesian-filter knobs (defaults = reference examples)."""

    algo: str = "ekf"  # ekf | ukf | pf
    num_particles: int = 300
    resampling: str = "stratified"  # multinomial | stratified | systematic
    ukf_alpha: float = 0.1
    ukf_beta: float = 2.0
    ukf_kappa: float = 0.0

    def replace(self, **kw) -> "FilterConfig":
        return dataclasses.replace(self, **kw)


def from_dict(cls, d: dict):
    """Build a config from a (possibly partial) dict, rejecting unknown
    keys: the flag entry point."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**d)
