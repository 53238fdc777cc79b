"""Dataset loaders (counterpart of ``rustrobotics_tpu/data``): the UTIAS
multi-robot localization dataset and the Freiburg SLAM-course log."""

import os

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


def dataset_root() -> str:
    """Where datasets are looked up by name (``g2o/<name>.g2o``,
    ``utias0/``, ``slam_course/``): $RUSTROBOTICS_DATASET, else
    ./dataset."""
    return os.environ.get("RUSTROBOTICS_DATASET", "dataset")
