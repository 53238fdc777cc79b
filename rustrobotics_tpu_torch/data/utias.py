"""UTIAS multi-robot localization dataset loader (counterpart of
``rustrobotics_tpu/data/utias.py``).

Reads the five CSVs, keys landmarks by barcode id, sorts streams by time
and clips everything before the first groundtruth stamp, and merges
odometry and measurement streams into one time-ordered event sequence of
fixed shape (``EventArrays``): per event dt, control (+ valid flag) and a
padded block of (landmark id, range, bearing) measurements with a mask.

Merge semantics: an odometry sample and a measurement group merge into
one event iff they carry the same timestamp.
"""

from __future__ import annotations

import csv
import dataclasses
import pathlib

import numpy as np
import torch

from rustrobotics_tpu_torch.device import resolve_device


@dataclasses.dataclass
class EventArrays:
    """Fixed-shape merged event stream, tensors on one device.

    times: (T,) stamps RELATIVE to the groundtruth start (absolute UTIAS
    stamps are ~1.24e9 epoch seconds, where f32 resolution is ~128 s, so
    the origin moves before any cast); dt: (T,) since the previous event;
    control: (T, 2) [v, omega]; has_control: (T,) bool; meas_ids: (T, M)
    int32; meas_z: (T, M, 2) [range, bearing]; meas_mask: (T, M) bool.
    ``has_control_np``, ``meas_ids_np`` and ``meas_mask_np`` are the same
    flags and ids on the host, for a replay loop that decides on them
    without reading the card.
    """

    times: torch.Tensor
    dt: torch.Tensor
    control: torch.Tensor
    has_control: torch.Tensor
    meas_ids: torch.Tensor
    meas_z: torch.Tensor
    meas_mask: torch.Tensor
    has_control_np: np.ndarray
    meas_ids_np: np.ndarray
    meas_mask_np: np.ndarray

    @property
    def num_events(self) -> int:
        return self.times.shape[0]


@dataclasses.dataclass
class UtiasDataset:
    """Host-side container."""

    groundtruth: np.ndarray  # (G, 4) [time, x, y, orientation]
    landmark_ids: np.ndarray  # (K,) barcode ids
    landmarks: np.ndarray  # (K, 5) [x, y, x_std, y_std, subject_nb]
    measurements: np.ndarray  # (Nm, 4) [time, barcode, range, bearing]
    odometry: np.ndarray  # (No, 3) [time, v, omega]

    def events(self, max_measurements_per_event: int | None = None,
               max_events: int | None = None, dtype=torch.float64,
               device=None) -> EventArrays:
        """Merge odometry/measurement streams into fixed-shape events on
        ``device`` (None: the card)."""
        device = resolve_device(device)
        me, od = self.measurements, self.odometry
        # group measurements by identical timestamp
        groups = []
        i = 0
        while i < len(me):
            j = i + 1
            while j < len(me) and me[j, 0] == me[i, 0]:
                j += 1
            groups.append((me[i, 0], i, j))
            i = j
        events = []  # (time, od_idx or -1, group or None)
        gi, oi = 0, 0
        while gi < len(groups) or oi < len(od):
            g_t = groups[gi][0] if gi < len(groups) else np.inf
            o_t = od[oi, 0] if oi < len(od) else np.inf
            if o_t < g_t:
                events.append((o_t, oi, None))
                oi += 1
            elif g_t < o_t:
                events.append((g_t, -1, groups[gi]))
                gi += 1
            else:  # identical stamp: merged event
                events.append((o_t, oi, groups[gi]))
                gi += 1
                oi += 1
        if max_events is not None:
            events = events[:max_events]

        m_max = max_measurements_per_event
        if m_max is None:
            # a short prefix can be all odometry: keep one masked slot
            m_max = max(((g[2] - g[1]) for _, _, g in events if g),
                        default=1)

        t_len = len(events)
        times = np.zeros(t_len)
        control = np.zeros((t_len, 2))
        has_control = np.zeros(t_len, bool)
        meas_ids = np.zeros((t_len, m_max), np.int32)
        meas_z = np.zeros((t_len, m_max, 2))
        meas_mask = np.zeros((t_len, m_max), bool)
        for k, (t, oi_, grp) in enumerate(events):
            times[k] = t
            if oi_ >= 0:
                control[k] = od[oi_, 1:3]
                has_control[k] = True
            if grp is not None:
                _, i0, i1 = grp
                cnt = min(i1 - i0, m_max)
                meas_ids[k, :cnt] = me[i0:i0 + cnt, 1].astype(np.int32)
                meas_z[k, :cnt] = me[i0:i0 + cnt, 2:4]
                meas_mask[k, :cnt] = True
        dt = np.diff(times, prepend=times[0])
        times = times - self.groundtruth[0, 0]  # f32-safe relative stamps

        def t(a, dt_=dtype):
            return torch.as_tensor(a, dtype=dt_, device=device)

        return EventArrays(
            times=t(times), dt=t(dt), control=t(control),
            has_control=t(has_control, torch.bool),
            meas_ids=t(meas_ids, torch.int32), meas_z=t(meas_z),
            meas_mask=t(meas_mask, torch.bool),
            has_control_np=has_control, meas_ids_np=meas_ids,
            meas_mask_np=meas_mask,
        )


def _read_csv(path):
    with open(path, newline="", encoding="utf-8") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = [[float(v) for v in row] for row in reader if row]
    return header, np.asarray(rows, dtype=np.float64)


def load_utias(base: str | pathlib.Path) -> UtiasDataset:
    """Load one UTIAS dataset directory."""
    base = pathlib.Path(base)
    _, barcodes = _read_csv(base / "Barcodes.csv")  # subject_nb, barcode_nb
    _, lms = _read_csv(base / "Landmark_Groundtruth.csv")
    _, gt = _read_csv(base / "Groundtruth.csv")
    _, me = _read_csv(base / "Measurement.csv")
    _, od = _read_csv(base / "Odometry.csv")

    subject_to_barcode = {int(s): int(b) for s, b in barcodes}
    landmark_ids = np.asarray(
        [subject_to_barcode[int(row[0])] for row in lms], dtype=np.int32
    )
    landmarks = np.concatenate([lms[:, 1:5], lms[:, :1]], axis=1)

    gt = gt[np.argsort(gt[:, 0], kind="stable")]
    min_time = gt[0, 0]
    me = me[me[:, 0] >= min_time]
    me = me[np.argsort(me[:, 0], kind="stable")]
    od = od[od[:, 0] >= min_time]
    od = od[np.argsort(od[:, 0], kind="stable")]

    return UtiasDataset(
        groundtruth=gt,
        landmark_ids=landmark_ids,
        landmarks=landmarks,
        measurements=me,
        odometry=od,
    )
