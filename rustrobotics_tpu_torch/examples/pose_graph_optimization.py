#!/usr/bin/env python
"""Pose-graph optimization on a g2o file (``cli pgo``), 2D or 3D.

    python rustrobotics_tpu_torch/examples/pose_graph_optimization.py \
        --file intel --solver gn --backend banded-kernel"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rustrobotics_tpu_torch import cli  # noqa: E402


def main(argv=None):
    args = sys.argv[1:] if argv is None else list(argv)
    args = args or ["--file", "intel"]
    return cli.main(["pgo", *args])


if __name__ == "__main__":
    sys.exit(main())
