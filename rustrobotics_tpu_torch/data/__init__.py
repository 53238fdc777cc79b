"""Dataset loaders (counterpart of ``rustrobotics_tpu/data``). Ported so
far: the Freiburg SLAM-course log."""

from rustrobotics_tpu_torch.data.slam_course import (  # noqa: F401
    SlamCourseArrays,
    SlamCourseDataset,
    load_slam_course,
)
