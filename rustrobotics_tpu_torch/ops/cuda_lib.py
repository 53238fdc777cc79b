"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. The library is named after a hash of its source and flags and
kept in ``rustrobotics_tpu_torch/_build/``, so an edited source is built
again. A failed build raises with nvcc's stderr.

Each C entry point returns a ``cudaError_t`` (0 on success); ``check``
turns a non-zero code into an exception that names the CUDA error.
``check_tensors`` and ``stream`` serve the wrappers that launch them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless this source is already built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    # build under a private name, then rename: a concurrent loader sees
    # either no library or a whole one
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build if needed and load ``lib<name>``; ``signatures`` maps each C
    entry point to its ctypes argtypes (all return an int status)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str):
    if status != 0:
        msg = lib.cuda_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({msg})")


def check_tensors(*tensors, shapes):
    """Raise ValueError unless every tensor is a contiguous f32 CUDA
    tensor of its shape, all on one device."""
    for t, shape in zip(tensors, shapes):
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"expected float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
        if t.device != tensors[0].device:
            raise ValueError("all tensors must be on one device")


def stream(t):
    """The handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
