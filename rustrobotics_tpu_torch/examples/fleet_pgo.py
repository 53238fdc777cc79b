#!/usr/bin/env python
"""Fleet pose-graph optimization: B same-structure graphs (one map, many
robots' initializations) optimized by one batched loop
(``mapping.make_optimize_batch``), each kernel launch covering the fleet.

    python rustrobotics_tpu_torch/examples/fleet_pgo.py --file intel \
        --batch 8 --iterations 10
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rustrobotics_tpu_torch.device import resolve_device  # noqa: E402
from rustrobotics_tpu_torch.mapping import (  # noqa: E402
    global_error,
    load_g2o,
    make_optimize_batch,
    stack_graphs,
)
from rustrobotics_tpu_torch.utils.devtime import fetch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--file", default="intel",
                    help="a g2o path, or a name under the dataset's g2o/")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--jitter", type=float, default=0.01)
    ap.add_argument(
        "--dataset",
        default=os.environ.get("RUSTROBOTICS_DATASET", "dataset"),
        help="the dataset root ($RUSTROBOTICS_DATASET, else ./dataset)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the card otherwise)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    path = args.file if os.path.exists(args.file) else os.path.join(
        args.dataset, "g2o", f"{args.file}.g2o")
    g = load_g2o(path, dtype=torch.float32, device=device)
    graphs = [g]
    for i in range(1, args.batch):
        gen = torch.Generator(device).manual_seed(i)
        noise = args.jitter * torch.randn(g.poses2.shape, generator=gen,
                                          dtype=g.dtype, device=device)
        graphs.append(g.replace(poses2=g.poses2 + noise))

    run = make_optimize_batch(g, num_iterations=args.iterations,
                              tolerance=0.0, backend="banded-direct",
                              device=device)
    batched = stack_graphs(graphs)
    fetch(run(batched)[1])  # warm-up
    t0 = time.perf_counter()
    out, errs, _ = run(batched)
    fetch(errs)
    dt = time.perf_counter() - t0

    finals = global_error(out).double().cpu().numpy()
    print(f"{args.file} x{args.batch}: {dt * 1e3:.1f} ms "
          f"({args.batch / dt:.2f} graphs/s, "
          f"{args.batch * args.iterations / dt:.1f} GN iters/s aggregate)")
    print("final chi2 per robot:", np.round(finals, 2).tolist())


if __name__ == "__main__":
    main()
