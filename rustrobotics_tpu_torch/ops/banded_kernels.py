"""Block-banded SpMV: the CUDA kernel K3 for Hopper.

``banded_matvec_kernel`` replaces ``banded_matvec_pallas`` of
``rustrobotics_tpu/ops/banded.py``: y_I = sum_d hb[I, d] @ xp[I + d] over
(nb, kb, 128, 128) f32 tiles. The source is ``csrc/banded_matvec.cu``,
which says what bounds the kernel on an H100 (the bytes of hb) and what
its design does about it. Its plain version is
``banded.banded_matvec_plain``.

It takes one graph or a fleet: a leading batch axis B on hb, xp and y is
a third grid axis of the same launch, and graph i of a batch gets the
one-graph result bit for bit.

The wrapper takes the plain version for a tensor on the CPU, and only
then; for a CUDA tensor it launches the kernel or raises. ``LAUNCHES``
counts the kernel's launches: one a call, whatever B is.
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
    # (device, hb, xp, y, nb, kb, batch, stream)
    "banded_matvec_f32": [_I, _P, _P, _P, _I, _I, _I, _P],
}


def banded_matvec_kernel(hb, xp_blocks):
    """K3: hb f32 (nb, kb, 128, 128), xp_blocks f32 (nb + kb - 1, 128) ->
    y (nb*128,); or a fleet, hb (B, nb, kb, 128, 128) and xp_blocks (B,
    nb + kb - 1, 128) -> y (B, nb*128), in one launch."""
    if hb.device.type == "cpu":
        return banded_matvec_plain(hb, xp_blocks)
    batch = hb.shape[:-4]
    nb, kb = hb.shape[-4], hb.shape[-3]
    if len(batch) > 1:
        raise ValueError(f"expected at most one batch axis, got hb of shape "
                         f"{tuple(hb.shape)}")
    cuda_lib.check_tensors(hb, xp_blocks, shapes=[
        batch + (nb, kb, LANE, LANE), batch + (nb + kb - 1, LANE)])
    if kb % 2 == 0 or kb > MAX_KB:
        raise ValueError(f"kb={kb} block diagonals: expected an odd count "
                         f"<= {MAX_KB}")
    if hb.data_ptr() % ALIGN or xp_blocks.data_ptr() % ALIGN:
        raise ValueError("hb and xp_blocks must be 16-byte aligned")
    y = torch.empty(batch + (nb * LANE,), dtype=torch.float32,
                    device=hb.device)
    lib = cuda_lib.load("banded_matvec", _SIGNATURES)
    status = lib.banded_matvec_f32(
        hb.device.index, hb.data_ptr(), xp_blocks.data_ptr(), y.data_ptr(),
        nb, kb, batch[0] if batch else 1, cuda_lib.stream(hb))
    cuda_lib.check(lib, status, "banded_matvec_f32")
    LAUNCHES["banded_matvec"] += 1
    return y
