"""Device meshes over ``torch.distributed`` process groups (counterpart of
``rustrobotics_tpu/parallel/mesh.py``).

A JAX mesh names devices of one process; here each rank of an initialized
process group is one device, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks. On the card
the group is NCCL, one GPU a rank; ``device_type="cpu"`` takes a gloo
group. Nothing falls back: a CUDA mesh without a card, or over a group
that is not NCCL, raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rustrobotics_tpu_torch.device import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _world(device_type: str) -> int:
    """The world size of the initialized group, checked against the
    device type."""
    if device_type not in _BACKEND:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    resolve_device(device_type)  # a CUDA mesh needs the card
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "init_process_group (NCCL on the card, gloo for 'cpu') first")
    backend = dist.get_backend()
    if backend != _BACKEND[device_type]:
        raise ValueError(f"a {device_type} mesh needs a "
                         f"{_BACKEND[device_type]} process group, this one "
                         f"is {backend}")
    return dist.get_world_size()


def make_mesh(num_devices: int | None = None, axis: str = "shard",
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the first ``num_devices`` ranks (all by default)."""
    have = _world(device_type)
    if num_devices is not None and have < num_devices:
        raise ValueError(f"requested {num_devices} devices, have {have}")
    ranks = torch.arange(have if num_devices is None else num_devices)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis,))


def make_mesh_2d(blocks: int, replicas: int, axes=("replica", "blocks"),
                 devices=None, device_type: str = "cuda") -> DeviceMesh:
    """2-D (replica x blocks) mesh over ranks ``devices`` (all by
    default). The BLOCKS axis is the fast (innermost) one, so ring
    exchanges between neighbouring blocks stay on neighbouring ranks; the
    replica axis, which carries only replica-level traffic, is the slow
    one."""
    have = _world(device_type)
    if devices is None:
        devices = list(range(have))
    need = blocks * replicas
    if len(devices) < need:
        raise ValueError(
            f"requested {blocks}x{replicas} devices, have {len(devices)}"
        )
    grid = torch.as_tensor(list(devices)[:need]).reshape(replicas, blocks)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axes))
