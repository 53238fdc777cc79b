"""Bayesian state estimators (counterpart of
``rustrobotics_tpu/localization``).

Filters are dataclasses of parameters whose ``step`` maps (state, control,
measurement, dt) -> state; trajectories are replayed with Python loops
over steps, and particle / sigma-point batches are tensor axes. Stochastic
steps take a ``torch.Generator``.
"""

from rustrobotics_tpu_torch.localization.ekf import (  # noqa: F401
    ExtendedKalmanFilter,
    ExtendedKalmanFilterKnownCorrespondences,
)
from rustrobotics_tpu_torch.localization.ukf import (  # noqa: F401
    UnscentedKalmanFilter,
    UnscentedKalmanFilterKnownCorrespondences,
)
from rustrobotics_tpu_torch.localization.pf import (  # noqa: F401
    AdaptiveParticleFilter,
    ParticleFilter,
    ParticleFilterKnownCorrespondences,
    effective_sample_size,
    gaussian_estimate,
    weighted_gaussian_estimate,
    resample_multinomial,
    resample_stratified,
    resample_systematic,
)
from rustrobotics_tpu_torch.localization.landmark_table import (  # noqa: F401
    LandmarkTable,
)
from rustrobotics_tpu_torch.localization.kalman_scan import (  # noqa: F401
    parallel_linear_kalman_filter,
)
from rustrobotics_tpu_torch.localization.banked import (  # noqa: F401
    BankedEKF,
    BankedEKFKC,
    BankedUKF,
    BankedUKFKC,
    velocity_banked_ekf_kc,
    velocity_banked_ukf_kc,
)
