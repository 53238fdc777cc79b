"""Static landmark lookup table (counterpart of
``rustrobotics_tpu/localization/landmark_table.py``).

A sorted id array and a dense position array; ids resolve with
``searchsorted``, clip and compare, and a validity mask replaces the
reference's hash-map membership test. ``ids_np`` keeps the sorted ids on
the host, so a replay can tell valid measurement slots from padding and
unknown ids without reading the card (``lookup_np``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rustrobotics_tpu_torch.device import resolve_device


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@dataclasses.dataclass
class LandmarkTable:
    ids: torch.Tensor  # (K,) sorted int32
    positions: torch.Tensor  # (K, D)
    ids_np: np.ndarray  # (K,) the sorted ids on the host

    @classmethod
    def create(cls, ids, positions, device=None, dtype=None) -> "LandmarkTable":
        """The table on ``device`` (None: the card)."""
        device = resolve_device(device)
        ids = _host(ids).astype(np.int32)
        positions = _host(positions)
        order = np.argsort(ids)
        return cls(ids=torch.as_tensor(ids[order], device=device),
                   positions=torch.as_tensor(positions[order], dtype=dtype,
                                             device=device),
                   ids_np=ids[order])

    def lookup(self, query_ids):
        """query_ids (...,) -> (positions (..., D), valid (...,) bool)."""
        query_ids = query_ids.to(self.ids.dtype)
        idx = torch.searchsorted(self.ids, query_ids)
        idx = torch.clamp(idx, 0, self.ids.shape[0] - 1)
        valid = self.ids[idx] == query_ids
        return self.positions[idx], valid

    def lookup_np(self, query_ids):
        """``lookup`` on the host: query_ids (...,) numpy -> (row index
        into ``positions`` (...,), valid (...,) bool)."""
        idx = np.clip(np.searchsorted(self.ids_np, query_ids), 0,
                      len(self.ids_np) - 1)
        return idx, self.ids_np[idx] == query_ids
