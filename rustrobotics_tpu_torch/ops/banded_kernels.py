"""Block-banded SpMV: the CUDA kernel K3 for Hopper.

``banded_matvec_kernel`` replaces ``banded_matvec_pallas`` of
``rustrobotics_tpu/ops/banded.py``: y_I = sum_d hb[I, d] @ xp[I + d] over
(nb, kb, 128, 128) f32 tiles. The source is ``csrc/banded_matvec.cu``,
which says what bounds the kernel on an H100 (the bytes of hb) and what
its design does about it. Its plain version is
``banded.banded_matvec_plain``.

The wrapper takes the plain version for a tensor on the CPU, and only
then; for a CUDA tensor it launches the kernel or raises. ``LAUNCHES``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from rustrobotics_tpu_torch.ops import cuda_lib
from rustrobotics_tpu_torch.ops.banded import LANE, banded_matvec_plain

MAX_KB = 232448 // (LANE * 4)  # the x window fits 227 KB of shared memory
ALIGN = 16  # bytes: the kernel loads float4s

LAUNCHES = {"banded_matvec": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (device, hb, xp, y, nb, kb, stream)
    "banded_matvec_f32": [_I, _P, _P, _P, _I, _I, _P],
}


def banded_matvec_kernel(hb, xp_blocks):
    """K3: hb f32 (nb, kb, 128, 128), xp_blocks f32 (nb + kb - 1, 128) ->
    y (nb*128,)."""
    if hb.device.type == "cpu":
        return banded_matvec_plain(hb, xp_blocks)
    nb, kb = hb.shape[0], hb.shape[1]
    cuda_lib.check_tensors(hb, xp_blocks, shapes=[
        (nb, kb, LANE, LANE), (nb + kb - 1, LANE)])
    if kb % 2 == 0 or kb > MAX_KB:
        raise ValueError(f"kb={kb} block diagonals: expected an odd count "
                         f"<= {MAX_KB}")
    if hb.data_ptr() % ALIGN or xp_blocks.data_ptr() % ALIGN:
        raise ValueError("hb and xp_blocks must be 16-byte aligned")
    y = torch.empty(nb * LANE, dtype=torch.float32, device=hb.device)
    lib = cuda_lib.load("banded_matvec", _SIGNATURES)
    status = lib.banded_matvec_f32(
        hb.device.index, hb.data_ptr(), xp_blocks.data_ptr(), y.data_ptr(),
        nb, kb, cuda_lib.stream(hb))
    cuda_lib.check(lib, status, "banded_matvec_f32")
    LAUNCHES["banded_matvec"] += 1
    return y
