#!/usr/bin/env python
"""Camera calibration demo: Zhang's method + radial distortion on a
synthetic planar target.

    python rustrobotics_tpu_torch/examples/camera_calibration.py [--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rustrobotics_tpu_torch.device import resolve_device  # noqa: E402
from rustrobotics_tpu_torch.vision import (  # noqa: E402
    distort_points,
    estimate_radial_distortion,
    project,
    projection_matrix,
    zhang_calibrate,
)


def rot(rx, ry, rz):
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    k_true = np.array([[800.0, 0.5, 320.0], [0, 780.0, 240.0], [0, 0, 1]])
    k1, k2 = -0.2, 0.05
    gx, gy = np.meshgrid(np.arange(9) * 0.03, np.arange(7) * 0.03)
    obj = np.stack([gx.ravel(), gy.ravel()], -1)
    obj3 = np.concatenate([obj, np.zeros((len(obj), 1))], 1)
    rng = np.random.default_rng(0)

    views = []
    for spec in [(0.15, -0.2, 0.05, 0.02, 0.01, 0.45),
                 (-0.25, 0.1, -0.1, -0.05, 0.03, 0.5),
                 (0.1, 0.3, 0.2, 0.03, -0.04, 0.4),
                 (-0.1, -0.15, 0.3, -0.02, -0.02, 0.55)]:
        p = projection_matrix(t(k_true), t(rot(*spec[:3])),
                              t(np.array(spec[3:])))
        uv = distort_points(t(k_true), k1, k2, project(p, t(obj3)))
        uv = uv.cpu().numpy()
        views.append(uv + rng.normal(size=uv.shape) * 0.05)

    k_est, rs, ts, _ = zhang_calibrate(t(obj), t(np.stack(views)))
    d = estimate_radial_distortion(k_est, rs, ts, t(obj),
                                   t(np.stack(views)))
    print("true K:\n", k_true)
    print("estimated K:\n", k_est.cpu().numpy().round(2))
    print(f"true distortion (k1, k2) = ({k1}, {k2}); "
          f"estimated = {d.cpu().numpy().round(4)}")


if __name__ == "__main__":
    main()
