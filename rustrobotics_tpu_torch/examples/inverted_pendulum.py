#!/usr/bin/env python
"""LQR inverted pendulum (``cli pendulum``)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rustrobotics_tpu_torch import cli  # noqa: E402


def main(argv=None):
    args = sys.argv[1:] if argv is None else list(argv)
    return cli.main(["pendulum", *args])


if __name__ == "__main__":
    sys.exit(main())
