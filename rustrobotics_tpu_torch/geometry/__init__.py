"""SE(2)/SE(3) helpers over trailing dims (counterpart of
``rustrobotics_tpu/geometry``)."""

from rustrobotics_tpu_torch.geometry import se2, se3  # noqa: F401
