#!/usr/bin/env python
"""Online fixed-lag smoothing of a simulated odometry stream: the
streaming deployment shape, one ``FixedLagSmoother.advance`` a step with
a fixed window and closure capacity, no host read inside a step.

    python rustrobotics_tpu_torch/examples/online_slam.py --steps 400 \
        --window 32 [--cpu]
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
from rustrobotics_tpu_torch.mapping.fixed_lag import (  # noqa: E402
    FixedLagSmoother,
)
from rustrobotics_tpu_torch.utils.devtime import fetch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    # noisy unicycle odometry around a circle (ground truth closes it)
    rng = np.random.default_rng(args.seed)
    dtheta = 2 * np.pi / args.steps
    odo_true = np.tile([1.0 * dtheta * 8, 0.0, dtheta], (args.steps, 1))
    sig = np.array([0.02, 0.02, 0.005], np.float32)
    odos = torch.as_tensor(
        (odo_true + rng.normal(0, sig, odo_true.shape)).astype(np.float32),
        device=device)

    fls = FixedLagSmoother.create(
        window=args.window, closure_capacity=16,
        chain_omega=torch.diag(torch.as_tensor(1.0 / sig**2)),
        clos_omega=torch.eye(3) * 100.0, device=device,
    )
    state0 = fls.init_state(torch.zeros(3, dtype=torch.float32,
                                        device=device))

    def session():
        state = state0
        for u in odos:
            state = fls.advance(state, u)
        return state

    fetch(session().poses)  # warm-up
    t0 = time.perf_counter()
    out = session()
    fetch(out.poses)
    dt = time.perf_counter() - t0

    poses = out.poses.double().cpu().numpy()
    print(f"{args.steps} odometry steps through a W={args.window} "
          f"fixed-lag smoother on {device.type}: "
          f"{args.steps / dt:.0f} steps/s ({dt * 1e3:.1f} ms total)")
    print(f"window head pose: {np.round(poses[0], 3).tolist()}, "
          f"tail pose: {np.round(poses[-1], 3).tolist()}")


if __name__ == "__main__":
    main()
