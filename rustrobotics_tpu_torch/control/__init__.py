"""Optimal control (counterpart of ``rustrobotics_tpu/control``): LQR,
LQG and the LQR-stabilized inverted pendulum."""

from rustrobotics_tpu_torch.control.lqr import (  # noqa: F401
    LinearTimeInvariantModel,
    lqr,
    solve_dare,
)
from rustrobotics_tpu_torch.control.inverted_pendulum import (  # noqa: F401
    InvertedPendulumModel,
    simulate_inverted_pendulum,
)
