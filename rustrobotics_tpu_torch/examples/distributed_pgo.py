#!/usr/bin/env python
"""Map-block distributed pose-graph optimization over the ranks of a
process group (``cli pgo --distributed``): nodes and edges partitioned by
node-RCM chunks, halo exchange between neighbouring ranks, all-reduced
CG.

    python rustrobotics_tpu_torch/examples/distributed_pgo.py \
        --file intel --distributed 1
    torchrun --nproc-per-node 4 rustrobotics_tpu_torch/examples/distributed_pgo.py \
        --file intel --distributed 4

Alone it runs one rank (the card, or ``--cpu``); under torchrun one rank a
card."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rustrobotics_tpu_torch import cli  # noqa: E402


def main(argv=None):
    args = sys.argv[1:] if argv is None else list(argv)
    args = args or ["--file", "intel", "--distributed", "1"]
    return cli.main(["pgo", *args])


if __name__ == "__main__":
    sys.exit(main())
