"""ctypes binding for the native C++ g2o parser (counterpart of
``rustrobotics_tpu/mapping/g2o_native.py``).

The source is the repository's ``native/g2o_parser.cpp``: a single-pass
buffer parser with locale-independent ``std::from_chars`` conversion,
bit-identical to the Python tokenizer's ``float()`` results (both give
correctly rounded IEEE doubles). It is built with ``g++`` at first use
into ``rustrobotics_tpu_torch/_build/``, under a name hashed from the
source and the flags, for the generic x86-64 ISA (no ``-march=native``),
and never beside the source. Any failure (no g++, a parse error, an
unknown record) gives ``None``, and the caller takes the Python parser,
which owns the error messages. Set ``RUSTROBOTICS_NO_NATIVE=1`` to disable
it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from rustrobotics_tpu_torch._native_build import NATIVE_DIR, build_shared

SOURCE = NATIVE_DIR / "g2o_parser.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# the arrays g2o_fill writes, in its argument order, with their dtypes
_FIELDS = (
    ("poses2", np.float64), ("landmarks2", np.float64),
    ("poses3", np.float64), ("pp_from", np.int32), ("pp_to", np.int32),
    ("pp_z", np.float64), ("pp_omega", np.float64), ("pl_pose", np.int32),
    ("pl_lm", np.int32), ("pl_z", np.float64), ("pl_omega", np.float64),
    ("qq_from", np.int32), ("qq_to", np.int32), ("qq_z", np.float64),
    ("qq_omega", np.float64), ("pose2_offsets", np.int32),
    ("lm2_offsets", np.int32), ("pose3_offsets", np.int32),
    ("pp_file_index", np.int64), ("pl_file_index", np.int64),
    ("qq_file_index", np.int64),
)

_LIB: dict = {}


def _build():
    return build_shared(SOURCE, "g2o", GXX_FLAGS)


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
            lib.g2o_parse.restype = ctypes.c_void_p
            lib.g2o_parse.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int64)]
            lib.g2o_fill.restype = None
            lib.g2o_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 21
            lib.g2o_free.restype = None
            lib.g2o_free.argtypes = [ctypes.c_void_p]
        _LIB["lib"] = lib
    return _LIB["lib"]


def native_available() -> bool:
    return _load() is not None


def parse_native(path: str):
    """Parse ``path`` with the C++ parser. Returns the Python tokenizer's
    numpy dict (``g2o._parse_python``), or None when the native parser is
    unavailable or rejects the file."""
    lib = _load()
    if lib is None:
        return None
    counts = (ctypes.c_int64 * 10)()
    handle = lib.g2o_parse(os.fsencode(path), counts)
    if not handle or counts[9] != 0:
        if handle:
            lib.g2o_free(handle)
        return None
    n2, l2, n3, e_pp, e_pl, e_qq = (int(counts[i]) for i in range(6))
    shapes = {
        "poses2": (n2, 3), "landmarks2": (l2, 2), "poses3": (n3, 7),
        "pp_from": e_pp, "pp_to": e_pp, "pp_z": (e_pp, 3),
        "pp_omega": (e_pp, 3, 3), "pl_pose": e_pl, "pl_lm": e_pl,
        "pl_z": (e_pl, 2), "pl_omega": (e_pl, 2, 2), "qq_from": e_qq,
        "qq_to": e_qq, "qq_z": (e_qq, 7), "qq_omega": (e_qq, 6, 6),
        "pose2_offsets": n2, "lm2_offsets": l2, "pose3_offsets": n3,
        "pp_file_index": e_pp, "pl_file_index": e_pl, "qq_file_index": e_qq,
    }
    out = {name: np.empty(shapes[name], dtype) for name, dtype in _FIELDS}
    lib.g2o_fill(handle, *(out[name].ctypes.data_as(ctypes.c_void_p)
                           for name, _ in _FIELDS))
    lib.g2o_free(handle)
    out["total_dof"] = int(counts[6])
    out["prior2"] = int(counts[7])
    out["prior3"] = int(counts[8])
    return out
