"""Low-level compute tier: the native C++ solver and the hand-written CUDA
kernels (counterpart of ``rustrobotics_tpu/ops``)."""

from rustrobotics_tpu_torch.ops.native_solver import (  # noqa: F401
    native_available,
    solve_coo_native,
)
