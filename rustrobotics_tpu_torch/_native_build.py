"""g++ builds of the repository's native C++ sources (``native/*.cpp``)
into ``rustrobotics_tpu_torch/_build/``, shared by the LDL^T solver and
the g2o parser bindings. The JAX package's loaders build beside the
sources; these builds never write there."""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"


def build_shared(source: pathlib.Path, stem: str, flags) -> pathlib.Path | None:
    """Compile ``source`` into ``BUILD_DIR/lib<stem>-<hash>.so`` unless that
    version is built (the hash covers the source and the flags); None
    when there is no source or no working g++."""
    if not source.exists():
        return None
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    # build under a private name, then rename: a concurrent loader sees
    # either no library or a whole one
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *flags, str(source), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out
