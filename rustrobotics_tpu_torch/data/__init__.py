"""Dataset loaders (counterpart of ``rustrobotics_tpu/data``): the UTIAS
multi-robot localization dataset and the Freiburg SLAM-course log."""

from rustrobotics_tpu_torch.data.utias import (  # noqa: F401
    EventArrays,
    UtiasDataset,
    load_utias,
)
from rustrobotics_tpu_torch.data.slam_course import (  # noqa: F401
    SlamCourseArrays,
    SlamCourseDataset,
    load_slam_course,
)
