"""Freiburg SLAM-course dataset loader, sensor_data.dat + world.dat
(counterpart of ``rustrobotics_tpu/data/slam_course.py``).

ODOMETRY lines [rot1, trans, rot2] each start a timestep; SENSOR lines
[id, range, bearing] attach to the current timestep; world.dat provides
landmarks. Parsing is host-side numpy; ``SlamCourseDataset.arrays`` gives
fixed-shape padded tensors on a device.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from rustrobotics_tpu_torch.device import resolve_device


@dataclasses.dataclass
class SlamCourseArrays:
    """Per-timestep tensors: odometry (T, 3) [rot1, trans, rot2];
    padded sensor blocks ids (T, M) int32, z (T, M, 2), mask (T, M)."""

    odometry: torch.Tensor
    meas_ids: torch.Tensor
    meas_z: torch.Tensor
    meas_mask: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.odometry.shape[0]


@dataclasses.dataclass
class SlamCourseDataset:
    odometry: np.ndarray  # (T, 3)
    sensors: list  # length T of (k_i, 3) arrays [id, range, bearing]
    landmark_ids: np.ndarray  # (K,)
    landmarks: np.ndarray  # (K, 2)

    def arrays(self, max_measurements: int | None = None,
               dtype=torch.float64, device=None) -> SlamCourseArrays:
        """The log as padded tensors on ``device`` (None: the card): at
        most ``max_measurements`` sightings a step (None: the most any step
        has)."""
        device = resolve_device(device)
        m_max = max_measurements or max((len(s) for s in self.sensors),
                                        default=1)
        t_len = len(self.odometry)
        ids = np.zeros((t_len, m_max), np.int32)
        z = np.zeros((t_len, m_max, 2))
        mask = np.zeros((t_len, m_max), bool)
        for k, s in enumerate(self.sensors):
            cnt = min(len(s), m_max)
            if cnt:
                arr = np.asarray(s)
                ids[k, :cnt] = arr[:cnt, 0].astype(np.int32)
                z[k, :cnt] = arr[:cnt, 1:3]
                mask[k, :cnt] = True
        return SlamCourseArrays(
            odometry=torch.tensor(self.odometry, dtype=dtype, device=device),
            meas_ids=torch.tensor(ids, device=device),
            meas_z=torch.tensor(z, dtype=dtype, device=device),
            meas_mask=torch.tensor(mask, device=device),
        )


def load_slam_course(base: str | pathlib.Path) -> SlamCourseDataset:
    base = pathlib.Path(base)
    odometry = []
    sensors = []
    current = None
    with open(base / "sensor_data.dat", encoding="utf-8") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "ODOMETRY":
                if current is not None:
                    sensors.append(current)
                current = []
                odometry.append([float(v) for v in parts[1:4]])
            elif parts[0] == "SENSOR":
                current.append([float(parts[1]), float(parts[2]), float(parts[3])])
            else:
                raise ValueError(f"unknown record {parts[0]!r}")
    if current is not None:
        sensors.append(current)

    lm_ids, lms = [], []
    with open(base / "world.dat", encoding="utf-8") as fh:
        for line in fh:
            parts = line.split()
            if parts:
                lm_ids.append(int(parts[0]))
                lms.append([float(parts[1]), float(parts[2])])

    return SlamCourseDataset(
        odometry=np.asarray(odometry, dtype=np.float64),
        sensors=sensors,
        landmark_ids=np.asarray(lm_ids, dtype=np.int32),
        landmarks=np.asarray(lms, dtype=np.float64),
    )
