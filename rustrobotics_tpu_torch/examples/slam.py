#!/usr/bin/env python
"""SLAM on a slam_course log (``cli slam``): online EKF-SLAM (--method
ekf), FastSLAM (fastslam, fastslam2) or the graph-SLAM front end and
pose-graph optimization (--method pgo)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rustrobotics_tpu_torch import cli  # noqa: E402


def main(argv=None):
    args = sys.argv[1:] if argv is None else list(argv)
    return cli.main(["slam", *args])


if __name__ == "__main__":
    sys.exit(main())
