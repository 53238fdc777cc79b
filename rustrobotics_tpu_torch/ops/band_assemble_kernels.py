"""Band assembly: the CUDA kernel K4/K5 for Hopper and its plain PyTorch
version.

Counterpart of the TPU band-assembly kernels
``tools/tpu_pallas_scatter_probe.py::make_kernel`` (K4, one graph) and
``tools/tpu_pallas_fleet_scatter_probe.py::make_kernel`` (K5, a fleet of B
graphs): the kept triplet values of the normal equations, vals (nnz,) or
(B, nnz), summed into the unscaled flat block rows (nb·kb·2kb,) or (B,
nb·kb·2kb,) that ``band_chol._prepare_blocks`` scales. The job plan is the
band layout's sorted-scatter plan (``sel_sorted``, ``seg_ptr``,
``uniq_idx``) cut into tiles of ``band_chol.ASSEMBLE_TILE`` band floats
(``tile_ptr``). The source is ``csrc/band_assemble.cu``, which says what
bounds the kernel on an H100 and what its design does about it: one CTA a
(tile, graph) writes its tile once, so a call is one kernel launch.

The wrapper takes the plain version for a tensor on the CPU, and only
then; for a CUDA tensor it launches the kernel or raises. ``LAUNCHES``
counts its launches: ``assemble_b1`` for one graph (K4, the
``banded-kernel`` path) and ``assemble_batch`` for a fleet (K5).
"""

from __future__ import annotations

import ctypes

import torch

from rustrobotics_tpu_torch.ops import cuda_lib

LAUNCHES = {"assemble_b1": 0, "assemble_batch": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # (device, vals, nnz, src, seg_ptr, dest, tile_ptr, tiles, out, band,
    #  batch, stream)
    "band_assemble_f32": [_I, _P, _L, _P, _P, _P, _P, _L, _P, _L, _I, _P],
}


def band_assemble_plain(bl, vals):
    """The assembly in plain PyTorch, by the same plan: vals (..., nnz) ->
    flat block rows (..., nb·kb·2kb), each destination the sum of its
    segment (one ``index_add_``; in plan order on the CPU)."""
    src, seg, dest = (torch.as_tensor(a, dtype=torch.long, device=vals.device)
                      for a in (bl.sel_sorted, bl.seg_sorted, bl.uniq_idx))
    flat = vals.new_zeros(vals.shape[:-1] + (bl.nb * bl.kb * 2 * bl.kb,))
    return flat.index_add_(-1, dest[seg], vals[..., src])


def band_assemble_kernel(bl, vals):
    """K4 (vals f32 (nnz,)) or K5 (vals f32 (B, nnz)): the flat block rows
    as ``band_assemble_plain`` gives them on the CPU, bit for bit. On the
    card ``bl`` is the layout moved there (``bl.to(device)``), whose plan
    the kernel reads in place: a call is one device operation."""
    if vals.device.type == "cpu":
        return band_assemble_plain(bl, vals)
    batched = vals.dim() == 2
    v = vals if batched else vals[None]
    batch, nnz = v.shape
    cuda_lib.check_tensors(v, shapes=[(batch, nnz)])
    plan = (bl.sel_sorted, bl.seg_ptr, bl.uniq_idx, bl.tile_ptr)
    if not all(isinstance(a, torch.Tensor) and a.device == vals.device
               and a.dtype == torch.long for a in plan):
        raise ValueError("the band plan must be int64 tensors on vals' "
                         "device: pass bl.to(device)")
    src, seg_ptr, dest, tile_ptr = plan
    band = bl.nb * bl.kb * 2 * bl.kb
    out = torch.empty(batch, band, dtype=torch.float32, device=vals.device)
    lib = cuda_lib.load("band_assemble", _SIGNATURES)
    status = lib.band_assemble_f32(
        vals.device.index, v.data_ptr(), nnz, src.data_ptr(),
        seg_ptr.data_ptr(), dest.data_ptr(), tile_ptr.data_ptr(),
        tile_ptr.shape[0] - 1, out.data_ptr(), band, batch,
        cuda_lib.stream(vals))
    cuda_lib.check(lib, status, "band_assemble_f32")
    LAUNCHES["assemble_batch" if batched else "assemble_b1"] += 1
    return out if batched else out[0]
