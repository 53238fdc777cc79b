"""Math/state primitives (counterpart of ``rustrobotics_tpu/utils``):
Gaussian state containers, MVN and angle helpers (plotting in
``utils.plot``)."""

from rustrobotics_tpu_torch.utils.angles import (  # noqa: F401
    deg2rad,
    rad2deg,
    wrap_angle,
)
from rustrobotics_tpu_torch.utils.state import GaussianState  # noqa: F401
from rustrobotics_tpu_torch.utils.mvn import MultiVariateNormal  # noqa: F401
