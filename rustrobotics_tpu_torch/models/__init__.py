"""Motion and measurement models (counterpart of
``rustrobotics_tpu/models``): dataclasses of parameters whose methods are
pure functions of tensors with any leading batch axes."""

from rustrobotics_tpu_torch.models.motion import (  # noqa: F401
    OdometryMotionModel,
    SimpleProblemMotionModel,
    VelocityMotionModel,
)
from rustrobotics_tpu_torch.models.measurement import (  # noqa: F401
    RangeBearingMeasurementModel,
    SimpleProblemMeasurementModel,
)
