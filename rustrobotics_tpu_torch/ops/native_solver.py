"""ctypes binding for the native C++ sparse LDL^T solver (counterpart of
``rustrobotics_tpu/ops/native_solver.py``).

The source is the repository's ``native/ldl_solver.cpp``: RCM ordering and
an elimination-tree up-looking LDL^T factorization in f64 on the host. It is
built with ``g++`` at first use into ``rustrobotics_tpu_torch/_build/``,
under a name hashed from the source and the flags (the JAX package's loader
builds ``native/libldl.so`` beside the source; this one never writes
there). The build targets the generic x86-64 ISA, not ``-march=native``:
a build directory copied to another host must still load. Set
``RUSTROBOTICS_NO_NATIVE=1`` to disable it: callers then take the SuperLU
host solve.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from rustrobotics_tpu_torch._native_build import (
    BUILD_DIR,
    NATIVE_DIR,
    build_shared,
)

SOURCE = NATIVE_DIR / "ldl_solver.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB: dict = {}


def _build():
    return build_shared(SOURCE, "ldl", GXX_FLAGS)


def _load():
    if os.environ.get("RUSTROBOTICS_NO_NATIVE"):
        return None
    if "lib" not in _LIB:
        path = _build()
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                lib = None
        if lib is not None:
            i32 = ctypes.POINTER(ctypes.c_int32)
            f64 = ctypes.POINTER(ctypes.c_double)
            lib.ldl_solve_coo.restype = ctypes.c_int
            lib.ldl_solve_coo.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                          i32, i32, f64, f64, f64]
        _LIB["lib"] = lib
    return _LIB["lib"]


def native_available() -> bool:
    return _load() is not None


def solve_coo_native(n: int, rows, cols, vals, b) -> np.ndarray:
    """Solve the SPD system given as COO triplets (duplicates summed), in
    f64. The triplets must cover the full symmetric pattern (both
    triangles), as the pose-graph assembly emits them."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native LDL solver unavailable (no g++, or "
                           "RUSTROBOTICS_NO_NATIVE is set)")
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    if not (len(rows) == len(cols) == len(vals)) or b.shape != (n,):
        raise ValueError("rows, cols and vals must have one length and b "
                         "shape (n,)")
    if len(rows) and (min(rows.min(), cols.min()) < 0
                      or max(rows.max(), cols.max()) >= n):
        raise ValueError(f"triplet indices must lie in [0, {n})")
    x = np.zeros(n, dtype=np.float64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    f64 = ctypes.POINTER(ctypes.c_double)
    status = lib.ldl_solve_coo(
        ctypes.c_int64(n), ctypes.c_int64(len(vals)),
        rows.ctypes.data_as(i32), cols.ctypes.data_as(i32),
        vals.ctypes.data_as(f64), b.ctypes.data_as(f64), x.ctypes.data_as(f64))
    if status != 0:
        raise RuntimeError(f"native LDL solve failed with status {status}")
    return x
