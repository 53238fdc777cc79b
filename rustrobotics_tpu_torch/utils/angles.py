"""Angle utilities (counterpart of ``rustrobotics_tpu/utils/angles.py``).

``wrap_angle`` is a total wrap to [-pi, pi) by floor-modulo, branch-free.
"""

import math

import torch

_DEG2RAD = math.pi / 180.0
_RAD2DEG = 180.0 / math.pi


def deg2rad(x):
    return x * _DEG2RAD


def rad2deg(x):
    return x * _RAD2DEG


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi)."""
    return torch.remainder(theta + math.pi, 2.0 * math.pi) - math.pi
