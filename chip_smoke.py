#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rustrobotics_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; any failure ends the script with a non-zero exit code:

1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA sources in csrc/ with nvcc, one process per
   source, all started together;
3. kernel parity, f32 on the card. K1 (banded factorization) and K2
   (substitution) against their plain PyTorch versions on a
   well-conditioned random band at kb=512, nb=11, with tight tolerances;
   then on the normal equations of two synthetic corridor graphs
   (corridor-1728: n=5248, kb=512, nb=11, the shape of intel.g2o;
   corridor-4096: n=12544, kb=512, nb=25) at the first Levenberg-Marquardt
   step's damping, where f32 resolves the system: K1, K2 and the whole
   solve_band_kernel against their plain f32 versions (PARITY_TOL), and
   the kernel solve against f64 within 4x the plain f32 solve's error (the
   rule of tests/test_band_pallas.py). The undamped Gauss-Newton system is
   at f32's edge (the 1e7 gauge prior); its errors are printed only.
   K3 (block-banded SpMV) against its plain version on a random band and
   on corridor-1728's band (nb=41 block rows, kb=9 block diagonals), each
   row within K3_ULPS of its f32 rounding unit; the plain version with its
   operands rounded to TF32 must fall outside that limit.
   K4 (band assembly, one graph) on corridor-1728's λ = 0.01 triplets and
   K5 (the same for a fleet) on the fleet's: corridor-1728 and 7 copies
   with poses jittered by N(0, 0.05²) (numpy seed FLEET_SEED); each band
   entry within ASSEMBLE_ULPS f32 units of the sum of its |contributions|
   from the plain index_add_, bit-equal between two launches, and one
   device operation a call (torch.profiler: one kernel, no memset or
   copy); whether the band equals the plain index_add_ on the CPU bit for
   bit is printed. K1/K2 over the fleet's batch axis against the unbatched
   K1/K2 on each graph (bit-equal expected; gated at PARITY_TOL).
   The same for sphere-2500 (sphere_graph: sphere2500's shape, 2500 SE3
   poses, 4949 edges, n=15000, kb=384, nb=40): K1, K2 and the solve at
   λ = 0.01 (SPHERE_PARITY_TOL), K4 on its triplets, K5 and batched K1/K2
   on its fleet of SPHERE_FLEET (the graph and jittered copies). K3 over
   the fleet of 8's bands at λ = 0.01: one launch bit-equal to eight
   one-graph calls, and within K3_ULPS of the plain version;
4. main paths, each with every launch counter set to 0 just before it and
   read just after:
   a. make_optimize(backend="banded-kernel") on corridor-1728 in f32,
      Gauss-Newton 10 iterations and Levenberg-Marquardt 6, held to the χ²
      trace of the f64 reference and to the plain banded-direct trace;
      K4's, K1's and K2's counters must move;
   b. make_optimize(backend="cg-banded") on corridor-1728 in f32, GN 10 and
      LM 10, cg_tol=1e-6 and cg_maxiter=400 (solve_cg_banded's own
      defaults: f32 never reaches make_optimize's 1e-10), held to the f64
      χ² anchors and to the plain cg-banded-jnp trace; K3's counter must
      move and the plain SpMV must not run; the CG rounds of every solve
      are printed;
   c. make_optimize_batch(backend="banded-kernel") on the fleet of 8 in
      f32, GN 10 and LM 6: row 0 held to the f64 anchors; every row's LM
      entries above 1 within 1e-2 of the unbatched banded-kernel run on
      that graph, of the batched banded-direct run and of its f64 run;
      every row's GN errors[0] within 1e-4 of those, errors[1] within
      1e-2 of the unbatched banded-kernel run, errors[10] < 1e-2 (GN past
      the first step is at f32's edge: the rest is printed); K5's counter
      and one K1 and one K2 launch per fleet iteration, and no plain
      scatter;
   d. sphere-2500 in f32 on banded-kernel, GN 10 and LM 6: errors[0] and
      errors[1] held to the JAX package's f64 anchors, entries above 1 to
      banded-direct on the card, GN errors[10] < 1e-2, the band plan kb=384
      and nb=40 and no plain band scatter (no dense fallback); K4's, K1's
      and K2's counters must move. Then its fleet of SPHERE_FLEET
      (make_optimize_batch, LM 6): every row held to its unbatched run,
      one K5, K1 and K2 launch a fleet iteration;
   e. corridor-1728-gnc (corridor-1728 with 10% of its loop closures'
      measurements garbage) in f32, robust="gnc-gm", LM 20 on banded-kernel:
      errors[0] held to the f64 anchor, the trace to banded-direct on the
      card, the χ² of the clean edges at the final poses to the JAX f64
      run's; K4's, K1's and K2's counters must move;
   f. make_optimize_batch(backend="cg-banded") on the fleet of 8, GN 10:
      each row against make_optimize(backend="cg-banded") on its graph
      (FLEET_CG_RTOL), one K3 launch a fleet PCG round and no plain SpMV;
      CG rounds per row per solve and graph-iterations/s printed;
   g. marginal_variances and pose_covariances through K4 + K1 (f32) on
      corridor-1728, marginal_variances on sphere-2500, against the plain
      f32 chain and the f64 run on the card (MARGINAL_RULE,
      MARGINAL_TOL), with their launches and times;
   h. GN 10 on corridor-1728 with banded-cr, banded-mixed (lp "high" and
      "bf16", CG rounds printed), schur and native (f64 on the host, no
      SuperLU solve), each held to the banded-kernel path's χ² anchors;
   i. auto-measure on corridor-1728 and sphere-2500: each candidate's time
      and the winner;
5. times from CUDA events: each kernel, its plain version and a library
   yardstick, each beside its bound, as device time a call with the calls
   queued behind a sleep kernel (K1's and K2's back to back, L2 warm as
   in the solve; K3's, K4's and K5's with L2 flushed before each call, as
   their bounds count every byte through HBM; their L2-warm times are
   printed beside them); the stages of one GN iteration
   of each main path; GN iterations/s end to end for each, and the
   fleets' graph-iterations/s against one graph's; K1, K2, K4 and K5 again
   at sphere-2500's kb = 384;
6. trace: one GN run of each main path under torch.profiler, device time
   by kernel and the device's idle share; K1's device launches per
   factorization and the panel kernel's µs per launch;
7. one JSON line describing the kernels (K1, K2, K4 and K5 with their
   kb = 384 readings under *_3d keys, K3 with its fleet-of-8 readings
   under *_b8 keys), then the contract line {"ok": true, "device": {...}}
   last.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# f64 χ² of corridor-1728 (banded-direct, tolerance 0), from the JAX
# package on the CPU; the port's f64 run reproduces them.
GN_CHI2 = (90550.8425, 120.634033)
LM_CHI2_1 = 112.265843

LM_LAMBDA0 = 0.01  # make_optimize's first Levenberg-Marquardt damping

# Kernel against plain f32 on the corridor systems at λ = LM_LAMBDA0:
# about 10x the plain f32 chain's own distance from f64 there (the port on
# the CPU, corridor-1728: K1 9.1e-5, lp 5.3e-6, K2 3.3e-5, solve 2.7e-4).
PARITY_TOL = {"k1": 1e-3, "lp": 1e-4, "k2": 3e-4, "solve": 3e-3}

# K3 against plain f32: each row's difference, in units of kb * 128 * 2^-24
# * sum_j |hb_ij| |x_j| (the recursive-summation bound of one f32 dot
# product), at most K3_ULPS. K3 reads 0.0032 on corridor-1728's band and
# 0.00048 on the random band (H100); the plain f32 version reads 0.0025 and
# 0.0016 against f64 (CPU). Operands rounded to TF32 read 10.5 and 0.82
# (CPU), and a wrong tile or window O(1).
K3_ULPS = 0.05

# cg-banded on corridor-1728 (tolerance 0, cg_tol 1e-6, cg_maxiter 400).
# The f64 anchors are the JAX package's cg-banded-jnp trace on the CPU,
# which the port's f64 run reproduces (120.780789, 112.268295). The limits
# come from f32 readings on the CPU before any card run: the port's f32
# errors[1] are 2.8e-6 (GN) and 3.0e-6 (LM) from f64, the JAX package's
# 2.9e-5 and 3.3e-6, so CG_CHI2_1_RTOL is ~30x the largest; errors[10] is
# the f32 floor of χ² (rounding of the poses), 2.33e-5 (GN) and 1.29e-5
# (LM) in the port, so CG_CHI2_10_MAX is ~40x the larger.
CG_TOL, CG_MAXITER = 1e-6, 400
CG_GN_CHI2_1 = 120.780789
CG_LM_CHI2_1 = 112.268295
CG_CHI2_1_RTOL = 1e-3
CG_CHI2_10_MAX = 1e-3

# K4/K5 against the plain index_add_ on the card: each band entry's
# difference in units of 2^-24 * the sum of its |contributions| (both sum
# the same f32 values in other orders). The plain f32 sum against the
# exact one reads 1.63 units at corridor-1728 (the port on the CPU); a
# dropped or doubled term reads ~2^24.
ASSEMBLE_ULPS = 16.0

# The fleet: corridor-1728 and FLEET - 1 copies with poses jittered by
# N(0, FLEET_JITTER²) from numpy's default_rng(FLEET_SEED).
FLEET, FLEET_JITTER, FLEET_SEED = 8, 0.05, 0

SOURCES = ("band_chol", "banded_matvec", "band_assemble")

# sphere-2500: sphere2500's shape (sphere_graph), its band plan and fleet.
SPHERE_RINGS, SPHERE_PER_RING = 50, 50
SPHERE_KB, SPHERE_NB, SPHERE_FLEET = 384, 40, 4
# f64 χ² of sphere-2500 (banded-direct, tolerance 0), from the JAX package
# on the CPU: GN errors[0], errors[1] and LM errors[1]; the port's f64 run
# reproduces them.
SPHERE_GN_CHI2 = (12412.446086764812, 3.963550376289926)
SPHERE_LM_CHI2_1 = 3.9606378869001357

# corridor-1728-gnc: corridor-1728 with GNC_SHARE of its loop closures'
# measurements replaced by garbage (corrupt_closures), LM with gnc-gm.
GNC_SEED, GNC_SHARE, GNC_ITERS = 3, 0.1, 20
# The JAX package's f64 run on the CPU (banded-direct, LM 20, tolerance
# 0): errors[0], and the χ² of the clean edges at the final poses.
GNC_CHI2_0 = 3178818.171102247
GNC_INLIER_CHI2 = 2.711029692967923e-12
# Limits about 10x the readings on an H100 (NVIDIA H100 80GB HBM3, 700 W;
# the kernels against their plain f32 versions at λ = LM_LAMBDA0 on
# sphere-2500: K1 7.5e-4, lp 2.2e-4, K2 2.9e-5, solve 3.7e-4, kernel
# solve against f64 3.4e-4; errors[1] 9.3e-5 (GN) and 2.8e-5 (LM) from
# f64 and 7.8e-5 from banded-direct; fleet rows 8.5e-6 from their
# unbatched runs; corridor-1728-gnc: trace 3.2e-7 from banded-direct,
# inlier χ² 2.8e-7). On sphere-2500 K1's chain loses more accuracy than
# the plain chain's (its last block rows; the parity phase prints both
# against f64), so its f64 gate is a limit, not 4x the plain solve's.
SPHERE_PARITY_TOL = {"k1": 7.5e-3, "lp": 2.2e-3, "k2": 3e-4, "solve": 4e-3,
                     "f64": 3.5e-3}
SPHERE_CHI2_1_RTOL = 1e-3
SPHERE_DIRECT_RTOL = 1e-3
SPHERE_FLEET_RTOL = 1e-4
GNC_TRACE_RTOL = 3e-6
GNC_INLIER_ATOL = 3e-6

# The fleet's cg-banded (the fleet of 8, GN 10, CG_TOL and CG_MAXITER):
# every row's χ² entries above 1 against its one-graph cg-banded run, about
# 10x the first H100 reading (4.28e-3: band_values' atomic order differs).
FLEET_CG_RTOL = 5e-2
# Marginals in f32 through K4 + K1: the largest per-dof relative
# difference of the variances (and of each pose block's entries relative to
# its largest) from the f64 run of the same function on the card and from
# the plain f32 chain on the card. corridor-1728's undamped H is beyond
# f32: its Jacobi-scaled condition number is ~2e8 (the port in f64 on the
# CPU), and its f32 variances read 0.65 per dof from f64 on the plain chain
# (a dense f32 inverse 0.46). There the kernel chain is held to the plain
# f32 chain's own distance from f64, within MARGINAL_RULE x (the rule of
# tests/test_band_pallas.py). sphere-2500 is well conditioned: the first
# H100 run read 0.171 (K4 + K1 against f64), 0.137 (against the plain
# chain) and 0.039 (plain against f64); its limits are about 3x those, as
# 10x would pass a relative error above 1.
MARGINAL_RULE = 4.0
MARGINAL_TOL = {"sphere-2500": {"f64": 0.5, "plain": 0.5}}
# Solver backends on corridor-1728, GN 10 (f32; native in f64 on the host):
# held to GN_CHI2 as the banded-kernel path is.
BACKEND_RUNS = ("banded-cr", "banded-mixed high", "banded-mixed bf16",
                "schur", "native")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond, msg):
    if not cond:
        fail(msg)
    print(f"  ok: {msg}", flush=True)


def cuda_ms(fn, repeats=7, warmup=2):
    """Median device time of fn() in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, calls=50, repeats=5, flush=None):
    """Device ms per call of fn for a short kernel, with the calls queued
    behind a sleep kernel so that the host's enqueue time stays out of
    the timed windows (median of `repeats`). Without flush: CUDA events
    around `calls` back-to-back calls. With flush: flush() before every
    call, and events around each call alone."""
    import torch

    def event():
        return torch.cuda.Event(enable_timing=True)

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(50_000_000)
        if flush is None:
            pairs = [(event(), event())]
            pairs[0][0].record()
            for _ in range(calls):
                fn()
            pairs[0][1].record()
        else:
            pairs = []
            for _ in range(calls):
                flush()
                pairs.append((event(), event()))
                pairs[-1][0].record()
                fn()
                pairs[-1][1].record()
        torch.cuda.synchronize()
        times.append(sum(a.elapsed_time(b) for a, b in pairs) / calls)
    return statistics.median(times)


def tf32(t):
    """t (f32) rounded to TF32's 10-bit mantissa, to nearest."""
    import torch

    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _counters():
    from rustrobotics_tpu_torch.ops import band_assemble_kernels as bak
    from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
    from rustrobotics_tpu_torch.ops import banded_kernels as bmk

    return (bk.LAUNCHES, bmk.LAUNCHES, bak.LAUNCHES)


def reset_counts():
    for counts in _counters():
        for key in counts:
            counts[key] = 0


def read_counts():
    return {k: v for counts in _counters() for k, v in counts.items()}


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def corridor(num_poses, device):
    from rustrobotics_tpu_torch.mapping.synthetic import (
        synthetic_corridor_graph_2d,
    )

    if num_poses == 1728:
        return synthetic_corridor_graph_2d(1728, num_landmarks=32,
                                           closure_span=112, device=device)
    return synthetic_corridor_graph_2d(4096, num_landmarks=128,
                                       closure_span=96, device=device)


def _qmul(a, b):
    """Hamilton product of (..., 4) wxyz quaternions (numpy)."""
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], axis=-1)


def _qrot(q, v):
    """Rotate (..., 3) vectors by (..., 4) quaternions (numpy)."""
    t = 2.0 * np.cross(q[..., 1:], v)
    return v + q[..., :1] * t + np.cross(q[..., 1:], t)


def _qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _qnorm(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _retract3(pose, dt, dw):
    """pose (..., 7) boxplus [dt, dw]: t + dt, q ∘ exp(dw) (numpy)."""
    theta = np.linalg.norm(dw, axis=-1, keepdims=True)
    half = 0.5 * theta
    k = np.where(theta > 0, np.sin(half) / np.where(theta > 0, theta, 1.0),
                 0.5)
    dq = np.concatenate([np.cos(half), k * dw], axis=-1)
    return np.concatenate([pose[..., :3] + dt,
                           _qnorm(_qmul(pose[..., 3:], dq))], axis=-1)


def sphere_graph(rings=SPHERE_RINGS, per_ring=SPHERE_PER_RING, seed=0):
    """sphere2500's shape as numpy arrays (the fields of PoseGraphData and
    total_dof, prior2, prior3). Ground truth: poses on a sphere of radius
    10 m, ring r at latitude -π/2 + π(r + ½)/rings, pose k of a ring at
    longitude 2πk/per_ring, heading along the ring (x east, z outward).
    Odometry i -> i+1, a closure i - per_ring -> i for every i >= per_ring;
    exact relative-pose measurements with information diag(100, 100, 100,
    400, 400, 400). Initial guess: ground truth retracted by N(0, 0.05²)
    on translation and N(0, 0.02²) on rotation (numpy default_rng(seed),
    translation noise drawn first), pose 0 exact."""
    n = rings * per_ring
    lat = np.repeat(-np.pi / 2 + np.pi * (np.arange(rings) + 0.5) / rings,
                    per_ring)
    lon = np.tile(2.0 * np.pi * np.arange(per_ring) / per_ring, rings)
    normal = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                       np.sin(lat)], axis=-1)
    # R = Rz(lon + π/2) Rx(π/2 - lat): x east, z along the outward normal
    yaw, tilt = 0.5 * (lon + np.pi / 2), 0.5 * (np.pi / 2 - lat)
    zero = np.zeros(n)
    q = _qmul(np.stack([np.cos(yaw), zero, zero, np.sin(yaw)], -1),
              np.stack([np.cos(tilt), np.sin(tilt), zero, zero], -1))
    gt = np.concatenate([10.0 * normal, q], axis=-1)

    fr = np.concatenate([np.arange(n - 1), np.arange(n - per_ring)])
    to = np.concatenate([np.arange(1, n), np.arange(per_ring, n)])
    inv_t = -_qrot(_qconj(gt[fr, 3:]), gt[fr, :3])
    z = np.concatenate([inv_t + _qrot(_qconj(gt[fr, 3:]), gt[to, :3]),
                        _qnorm(_qmul(_qconj(gt[fr, 3:]), gt[to, 3:]))], -1)
    omega = np.broadcast_to(np.diag([100.0] * 3 + [400.0] * 3),
                            (len(fr), 6, 6)).copy()

    rng = np.random.default_rng(seed)
    dt = rng.normal(0.0, 0.05, (n, 3))
    dw = rng.normal(0.0, 0.02, (n, 3))
    dt[0] = dw[0] = 0.0
    empty = np.zeros(0, np.int64)
    fields = dict(
        poses2=np.zeros((0, 3)), landmarks2=np.zeros((0, 2)),
        poses3=_retract3(gt, dt, dw), pp_from=empty, pp_to=empty,
        pp_z=np.zeros((0, 3)), pp_omega=np.zeros((0, 3, 3)), pl_pose=empty,
        pl_lm=empty, pl_z=np.zeros((0, 2)), pl_omega=np.zeros((0, 2, 2)),
        qq_from=fr, qq_to=to, qq_z=z, qq_omega=omega, pose2_offsets=empty,
        lm2_offsets=empty, pose3_offsets=6 * np.arange(n))
    return dict(fields=fields, total_dof=6 * n, prior2=-1, prior3=0)


def jitter_poses3(poses3, rng):
    """Poses retracted by N(0, 0.05²) on translation and N(0, 0.02²) on
    rotation (translation drawn first), pose 0 unchanged: a fleet copy."""
    dt = rng.normal(0.0, 0.05, (len(poses3), 3))
    dw = rng.normal(0.0, 0.02, (len(poses3), 3))
    dt[0] = dw[0] = 0.0
    return _retract3(poses3, dt, dw)


def corrupt_closures(pp_from, pp_to, pp_z, seed=GNC_SEED, share=GNC_SHARE):
    """pp_z with the measurements of ``share`` of the loop closures
    (|to - from| != 1, chosen by numpy default_rng(seed)) replaced by
    garbage: uniform ±15 m, ±π. Returns (new pp_z, outlier mask)."""
    closures = np.flatnonzero(np.abs(pp_to - pp_from) != 1)
    rng = np.random.default_rng(seed)
    bad = rng.choice(closures, size=int(round(share * len(closures))),
                     replace=False)
    z = np.array(pp_z, dtype=np.float64)
    z[bad] = np.stack([rng.uniform(-15.0, 15.0, len(bad)),
                       rng.uniform(-15.0, 15.0, len(bad)),
                       rng.uniform(-np.pi, np.pi, len(bad))], axis=-1)
    mask = np.zeros(len(z), bool)
    mask[bad] = True
    return z, mask


def port_graph(spec, device):
    """A sphere_graph spec as the port's f64 PoseGraphData."""
    from rustrobotics_tpu_torch.mapping.g2o import graph_from_numpy

    return graph_from_numpy(spec["fields"], spec["total_dof"], spec["prior2"],
                            spec["prior3"], device=device)


def system(graph, lam):
    """Layout, device band layout and the f64 normal equations at λ."""
    from rustrobotics_tpu_torch.mapping.assemble import (
        build_layout,
        system_values,
    )
    from rustrobotics_tpu_torch.ops.band_chol import build_band_chol

    layout = build_layout(graph)
    bl = build_band_chol(layout).to(graph.device)
    vals, b, _ = system_values(graph, lam)
    return layout, bl, vals, b


def eye_residual_rows(ldinv, l_fac):
    """|ldinv[j] l_fac[j] - I| for each block row j (its largest entry),
    in f64."""
    import torch

    eye = torch.eye(ldinv.shape[-1], dtype=torch.float64, device=ldinv.device)
    return (ldinv.double() @ l_fac.double() - eye).abs().amax((-1, -2))


def max_eye_residual(ldinv, l_fac):
    """max_j |ldinv[j] l_fac[j] - I| in f64."""
    return float(eye_residual_rows(ldinv, l_fac).max())


def factor_of(ldinv):
    """The Cholesky factors whose inverses are ldinv (f64)."""
    import torch

    eye = torch.eye(ldinv.shape[-1], dtype=torch.float64, device=ldinv.device)
    return torch.linalg.solve_triangular(ldinv.double(),
                                         eye.expand(ldinv.shape), upper=False)


def parity_random(nb, kb, device):
    """K1 and K2 against their plain versions on a well-conditioned random
    band at the main path's shapes (block-diagonal dominance: cond ~ 2),
    where f32 rounding is not amplified and the tolerances are tight."""
    import torch

    from rustrobotics_tpu_torch.ops import band_chol_kernels as bk

    gen = torch.Generator(device=device).manual_seed(0)
    noise = torch.randn(nb, kb, kb, generator=gen, device=device) * (
        0.1 / math.sqrt(kb))
    dsym = 2.0 * torch.eye(kb, device=device) + noise + noise.transpose(1, 2)
    lcoup = torch.randn(nb, kb, kb, generator=gen, device=device) * (
        0.2 / math.sqrt(kb))
    bp = torch.randn(nb, kb, generator=gen, device=device)
    print(f"[parity] random band: kb={kb} nb={nb}", flush=True)
    ld_k, lp_k = bk.factorize_kernel(dsym, lcoup)
    ld_p, lp_p = bk.factorize_plain(dsym, lcoup)
    prod = max_eye_residual(ld_k, factor_of(ld_p))
    require(prod <= 1e-4, f"random K1 max|ldinv_k L_plain - I| {prod:.3g} "
            f"<= 1e-4")
    lp_err = float((lp_k - lp_p).abs().max())
    require(lp_err <= 1e-5, f"random K1 max|lp_k - lp_plain| {lp_err:.3g} "
            f"<= 1e-5")
    x_k = bk.substitute_kernel(ld_p, lp_p, bp)
    x_p = bk.substitute_plain(ld_p, lp_p, bp)
    rel = float((x_k - x_p).abs().max() / x_p.abs().max())
    require(rel <= 1e-5, f"random K2 relative error {rel:.3g} <= 1e-5")


def kernel_errors(bl, vals, b):
    """K1, K2 and the whole kernel solve against their plain versions on
    one system: returns the inputs and outputs with the errors."""
    import torch

    from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
    from rustrobotics_tpu_torch.ops.band_chol import (
        _prepare_blocks,
        scale_rhs,
        solve_band_chol,
        split_blocks,
    )

    r_blocks, dinv_p = _prepare_blocks(bl, vals.float())
    dsym, lcoup = split_blocks(r_blocks)
    ld_k, lp_k = bk.factorize_kernel(dsym, lcoup)
    ld_p, lp_p = bk.factorize_plain(dsym, lcoup)
    # K2 on the plain factor, with this system's scaled right-hand side
    bp = scale_rhs(bl, b.float(), dinv_p)
    x_k = bk.substitute_kernel(ld_p, lp_p, bp)
    x_p = bk.substitute_plain(ld_p, lp_p, bp)
    x_kern = bk.solve_band_kernel(bl, vals, b)
    x_32 = solve_band_chol(bl, vals.float(), b.float()).double()
    x_64 = solve_band_chol(bl, vals, b)
    # both f32 factors against the f64 chain's, block row by block row
    l_64 = factor_of(bk.factorize_plain(
        *split_blocks(_prepare_blocks(bl, vals.double())[0]))[0])
    rows_k, rows_p = (eye_residual_rows(ld, l_64) for ld in (ld_k, ld_p))
    torch.cuda.synchronize()
    return dict(
        k1_rows_64=[float(r[i]) for r in (rows_k, rows_p) for i in (0, -1)]
        + [float(rows_k.max()), float(rows_p.max())],
        dsym=dsym, lcoup=lcoup, ld_p=ld_p, lp_p=lp_p, bp=bp,
        finite=bool(torch.isfinite(ld_k).all() and torch.isfinite(lp_k).all()
                    and torch.isfinite(x_k).all()
                    and torch.isfinite(x_kern).all()),
        lp0=float(lp_k[0].abs().max()),
        k1=max_eye_residual(ld_k, factor_of(ld_p)),
        lp=float((lp_k - lp_p).abs().max()),
        k2_abs=float((x_k - x_p).abs().max()),
        k2=float((x_k - x_p).abs().max() / x_p.abs().max()),
        solve=float((x_kern - x_32).abs().max() / x_32.abs().max()),
        kern_64=float((x_kern - x_64).abs().max() / x_64.abs().max()),
        plain_64=float((x_32 - x_64).abs().max() / x_64.abs().max()))


def parity(name, graph, tol=PARITY_TOL):
    """Phase 3 on one graph; returns the numbers for the kernels line.

    The gate is the system of the first Levenberg-Marquardt step
    (λ = 0.01), which f32 resolves: the plain f32 solve is ~3e-4 of
    max|x| from f64 there (the port on the CPU). The Gauss-Newton system
    (λ = 0) is at f32's edge (~0.1 at corridor-1728, ~1 at corridor-4096),
    so its errors are printed as readings and gate nothing."""
    from rustrobotics_tpu_torch.mapping.assemble import system_values

    layout, bl, vals, b = system(graph, LM_LAMBDA0)
    print(f"[parity] {name}: n={bl.n} kb={bl.kb} nb={bl.nb}, "
          f"λ={LM_LAMBDA0}", flush=True)
    e = kernel_errors(bl, vals, b)
    print(f"  K1 max|ldinv_k L_plain - I| {e['k1']:.6g}, max|lp_k - lp_plain|"
          f" {e['lp']:.6g}; K2 max|x_k - x_plain| / max|x_plain| "
          f"{e['k2']:.6g}; solve against plain f32 {e['solve']:.6g}; "
          f"against f64: kernel solve {e['kern_64']:.6g}, plain f32 solve "
          f"{e['plain_64']:.6g}", flush=True)
    k0, kl, p0, pl, km, pm = e["k1_rows_64"]
    print(f"  K1 and the plain f32 chain against the f64 chain, max|ldinv "
          f"L_64 - I| in block row 0, in the last and at most: kernel "
          f"{k0:.3g}, {kl:.3g}, {km:.3g}; plain {p0:.3g}, {pl:.3g}, {pm:.3g}",
          flush=True)
    require(e["finite"], f"{name} kernel outputs finite")
    require(e["lp0"] == 0.0, f"{name} K1 lp[0] == 0")
    require(e["k1"] <= tol["k1"],
            f"{name} K1 max|ldinv_k L_plain - I| <= {tol['k1']}")
    require(e["lp"] <= tol["lp"],
            f"{name} K1 max|lp_k - lp_plain| <= {tol['lp']}")
    require(e["k2"] <= tol["k2"],
            f"{name} K2 relative error against plain <= {tol['k2']}")
    require(e["solve"] <= tol["solve"],
            f"{name} solve_band_kernel against the plain f32 solve <= "
            f"{tol['solve']}")
    if "f64" in tol:
        require(e["kern_64"] <= tol["f64"],
                f"{name} solve_band_kernel against f64 <= {tol['f64']}")
    else:
        require(e["kern_64"] <= max(4.0 * e["plain_64"], 1e-4),
                f"{name} solve_band_kernel against f64 <= max(4 x plain f32 "
                f"solve's error, 1e-4)")

    vals0, b0, _ = system_values(graph, 0.0)
    g = kernel_errors(bl, vals0, b0)
    print(f"  readings at λ=0: K1 max|ldinv_k L_plain - I| {g['k1']:.6g}; "
          f"K2 relative {g['k2']:.6g}; against f64: kernel solve "
          f"{g['kern_64']:.6g}, plain f32 solve {g['plain_64']:.6g}",
          flush=True)
    return dict(layout=layout, bl=bl, vals=vals, b=b, **e)


def main_path(device):
    """Phase 4: returns the GN runner and the graph it runs on."""
    import torch

    from rustrobotics_tpu_torch.mapping.pgo import make_optimize

    g32 = corridor(1728, device).to(dtype=torch.float32)
    gn = make_optimize(g32, num_iterations=10, backend="banded-kernel",
                       tolerance=0.0, device=device)
    lm = make_optimize(g32, num_iterations=6, solver="lm",
                       backend="banded-kernel", tolerance=0.0, device=device)
    reset_counts()
    _, err_gn, it_gn = gn(g32)
    _, err_lm, it_lm = lm(g32)
    torch.cuda.synchronize()
    launches = read_counts()

    direct = make_optimize(g32, num_iterations=10, backend="banded-direct",
                           tolerance=0.0, device=device)
    _, err_direct, _ = direct(g32)
    err_gn = err_gn.double().cpu()
    err_lm = err_lm.double().cpu()
    err_direct = err_direct.double().cpu()
    print(f"[main] GN banded-kernel   {err_gn.tolist()}", flush=True)
    print(f"[main] GN banded-direct   {err_direct.tolist()}", flush=True)
    print(f"[main] LM banded-kernel   {err_lm.tolist()}", flush=True)
    print(f"[main] launches during the banded-kernel path: {launches}",
          flush=True)
    require(it_gn == 10 and it_lm == 6, "iteration counts 10 and 6")
    require(bool(torch.isfinite(err_gn).all() and torch.isfinite(err_lm).all()),
            "χ² traces finite")
    require(abs(err_gn[0] / GN_CHI2[0] - 1) <= 1e-4,
            f"GN errors[0] {err_gn[0]:.6f} within 1e-4 of {GN_CHI2[0]}")
    require(abs(err_gn[1] / GN_CHI2[1] - 1) <= 1e-2,
            f"GN errors[1] {err_gn[1]:.6f} within 1% of {GN_CHI2[1]}")
    require(err_gn[10] < 1e-2, f"GN errors[10] {err_gn[10]:.3g} < 1e-2")
    big = err_direct > 1.0
    rel = ((err_gn[big] - err_direct[big]).abs() / err_direct[big]).max()
    require(float(rel) <= 1e-2,
            f"GN entries above 1 within 1e-2 of banded-direct ({float(rel):.3g})")
    require(abs(err_lm[1] / LM_CHI2_1 - 1) <= 1e-2,
            f"LM errors[1] {err_lm[1]:.6f} within 1% of {LM_CHI2_1}")
    for key in ("assemble_b1", "factorize", "substitute"):
        require(launches[key] > 0, f"{key} kernel launched on the main path")
    return gn, g32, launches


def times(p, gn, g32, name="corridor-1728"):
    """Phase 5: kernel times with bounds and yardsticks, GN stage
    breakdown and GN iterations/s."""
    import torch

    from rustrobotics_tpu_torch.mapping.assemble import (
        apply_update,
        dense_hessian,
        system_values,
    )
    from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
    from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
        band_assemble_kernel,
    )
    from rustrobotics_tpu_torch.ops.band_chol import _prepare_blocks

    nb, kb, n = p["bl"].nb, p["bl"].kb, p["bl"].n
    out = {}

    dsym, lcoup = p["dsym"], p["lcoup"]
    ld_p, lp_p, bp = p["ld_p"], p["lp_p"], p["bp"]
    # dense yardstick: the Jacobi-scaled n x n H of the same system
    h = dense_hessian(p["layout"].to(dsym.device), p["vals"].float())
    d = torch.sqrt(torch.diagonal(h).clamp(min=1e-12))
    hs = h / (d[:, None] * d[None, :])
    l_dense = torch.linalg.cholesky(hs)
    b_dense = (p["b"].float() / d)[:, None]

    # What the function needs, not what the kernels do. Every block row
    # takes chol(D̂_j) and its triangular inverse, kb³/3 FLOP each; rows
    # j > 0 also take lp_j = Lcoup_j ldinv_{j-1}ᵀ against a triangle (kb³)
    # and the symmetric lp_j lp_jᵀ (kb³). dsym and ldinv count by their
    # lower triangles, lcoup and lp from row 1 (lcoup_0 is never read,
    # lp_0 is 0).
    tri, sq = kb * (kb + 1) // 2, kb * kb
    k1_flops = (nb * 2.0 / 3.0 + (nb - 1) * 2.0) * kb ** 3
    k1_bytes = 4 * (2 * nb * tri + 2 * (nb - 1) * sq)
    # each sweep: a triangular GEMV with ldinv_j (kb² FLOP), and for
    # j > 0 a full one with lp_j (2 kb²); ldinv, lp, bp in, x out
    k2_flops = 2.0 * (nb + 2 * (nb - 1)) * sq
    k2_bytes = 4 * (nb * tri + (nb - 1) * sq + 2 * nb * kb)
    k1_bound, k1_by = bound_ms(k1_bytes, k1_flops)
    k2_bound, k2_by = bound_ms(k2_bytes, k2_flops)
    # device time per call, the calls queued back to back behind a sleep
    # kernel so that the host's enqueue time stays out (L2 warm, as in the
    # solve, where K2 reads the factor K1 just wrote); cholesky_ex is the
    # library factorization without its host-side error check
    out["factorize"] = dict(
        ms=queued_ms(lambda: bk.factorize_kernel(dsym, lcoup), calls=10),
        plain_ms=queued_ms(lambda: bk.factorize_plain(dsym, lcoup), calls=10),
        library_ms=queued_ms(lambda: torch.linalg.cholesky_ex(hs), calls=10),
        bound_ms=k1_bound, bound_by=k1_by)
    out["substitute"] = dict(
        ms=queued_ms(lambda: bk.substitute_kernel(ld_p, lp_p, bp), calls=20),
        plain_ms=queued_ms(lambda: bk.substitute_plain(ld_p, lp_p, bp),
                           calls=20),
        library_ms=queued_ms(lambda: torch.cholesky_solve(b_dense, l_dense),
                             calls=20),
        bound_ms=k2_bound, bound_by=k2_by)
    for key, t, flops, nbytes in (
            ("factorize", out["factorize"], k1_flops, k1_bytes),
            ("substitute", out["substitute"], k2_flops, k2_bytes)):
        print(f"[times] {key} ({name}, kb={kb}): kernel {t['ms']:.4f} ms, "
              f"plain "
              f"{t['plain_ms']:.4f} ms, dense yardstick {t['library_ms']:.4f}"
              f" ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}; "
              f"{flops:.4g} FLOP, {nbytes:.4g} B), kernel/bound "
              f"{t['ms'] / t['bound_ms']:.1f}", flush=True)

    # stages of one GN iteration on the f32 main path
    vals32, b32, _ = system_values(g32, 0.0)
    bl = p["bl"]
    dx = bk.solve_band_kernel(bl, vals32, b32)
    stages = {
        "system_values (linearize + assemble)":
            lambda: system_values(g32, 0.0),
        "band assembly (_prepare_blocks with K4)":
            lambda: _prepare_blocks(bl, vals32, band_assemble_kernel),
        "K1 factorize": lambda: bk.factorize_kernel(dsym, lcoup),
        "K2 substitute": lambda: bk.substitute_kernel(ld_p, lp_p, bp),
        "whole solve_band_kernel": lambda: bk.solve_band_kernel(bl, vals32, b32),
        "apply_update": lambda: apply_update(g32, dx),
    }
    for label, fn in stages.items():
        out.setdefault("stages", {})[label] = cuda_ms(fn)
        print(f"[stages] {name} {label}: {out['stages'][label]:.4f} ms",
              flush=True)

    gn(g32)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        gn(g32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    it_s = 10 / wall
    print(f"[times] GN banded-kernel, {name} f32: {it_s:.3f} it/s "
          f"({wall / 10 * 1e3:.4f} ms/iteration, median of 5 runs of 10); "
          f"the solve's bound alone is {k1_bound + k2_bound:.4f} ms/iteration",
          flush=True)
    return out


def k3_errors(hb, xp):
    """K3 against its plain version on one input: the largest row
    difference in units of the row's f32 rounding bound (K3_ULPS), the
    same for the plain version on operands rounded to TF32, and
    max|y_kernel - y_plain|."""
    import torch

    from rustrobotics_tpu_torch.ops import banded_kernels as bmk
    from rustrobotics_tpu_torch.ops.banded import banded_matvec_plain

    y_k = bmk.banded_matvec_kernel(hb, xp)
    y_p = banded_matvec_plain(hb, xp)
    y_t = banded_matvec_plain(tf32(hb), tf32(xp))
    torch.cuda.synchronize()
    kb = hb.shape[1]
    scale = banded_matvec_plain(hb.double().abs(), xp.double().abs())
    unit = kb * 128 * 2.0 ** -24

    def ulps(y):
        diff = (y - y_p).double().abs()
        return float(torch.where(scale > 0, diff / (unit * scale), diff).max())

    return dict(finite=bool(torch.isfinite(y_k).all()),
                ulps=ulps(y_k), tf32_ulps=ulps(y_t),
                max_abs_err=float((y_k - y_p).abs().max()),
                y_max=float(y_p.abs().max()))


def cg_system(graph, lam):
    """Layouts and f32 normal equations of the cg-banded path at λ."""
    from rustrobotics_tpu_torch.mapping.assemble import (
        build_layout,
        system_values,
    )
    from rustrobotics_tpu_torch.ops.banded import build_banded

    layout = build_layout(graph)
    blayout = build_banded(layout)
    vals, b, _ = system_values(graph, lam)
    return layout.to(graph.device), blayout.to(graph.device), vals, b


def k3_parity(g32, device):
    """Phase 3 for K3: a random band at corridor-1728's shapes, then
    corridor-1728's own band with its right-hand side as x. Returns the
    band inputs and their errors for the kernels line and the times."""
    import torch

    from rustrobotics_tpu_torch.ops.banded import _pad_x_blocks, band_values

    layout, blayout, vals, b = cg_system(g32, 0.0)
    nb, kb = blayout.nb, blayout.kb
    gen = torch.Generator(device=device).manual_seed(1)
    hb_r = torch.randn(nb, kb, 128, 128, generator=gen, device=device)
    xp_r = torch.randn(nb + kb - 1, 128, generator=gen, device=device)
    hb = band_values(blayout, layout, vals)
    xp = _pad_x_blocks(blayout, b[blayout.perm])
    print(f"[parity] K3: n={blayout.n} nb={nb} kb={kb} (half="
          f"{blayout.half}); limit {K3_ULPS} x kb*128 f32 units of "
          f"sum|hb||x| per row", flush=True)
    out = {}
    for name, h, x in (("random band", hb_r, xp_r),
                       ("corridor-1728", hb, xp)):
        e = k3_errors(h, x)
        print(f"  K3 {name}: max row error {e['ulps']:.6g} x the bound's "
              f"unit (plain on TF32-rounded operands: {e['tf32_ulps']:.6g});"
              f" max|y_k - y_plain| {e['max_abs_err']:.6g} of max|y| "
              f"{e['y_max']:.6g}", flush=True)
        require(e["finite"], f"K3 {name} output finite")
        require(e["ulps"] <= K3_ULPS,
                f"K3 {name} within {K3_ULPS} x kb*128 f32 units per row")
        require(e["tf32_ulps"] > K3_ULPS,
                f"K3 {name}: TF32-rounded operands fall outside the limit")
        out[name] = e
    return dict(layout=layout, blayout=blayout, vals=vals, b=b, hb=hb,
                xp=xp, err=out["corridor-1728"])


@contextlib.contextmanager
def recorded_rounds():
    """Within the block, every solvers.pcg call appends its round count
    to the list it yields."""
    from rustrobotics_tpu_torch.mapping import solvers

    pcg, rounds = solvers.pcg, []

    def recording(*args, **kwargs):
        x, k = pcg(*args, **kwargs)
        rounds.append(k)
        return x, k

    solvers.pcg = recording
    try:
        yield rounds
    finally:
        solvers.pcg = pcg


def cg_main_path(device, g32):
    """Phase 4b: returns the cg-banded GN runner and the path's counts."""
    import torch

    from rustrobotics_tpu_torch.mapping.pgo import make_optimize
    from rustrobotics_tpu_torch.ops import banded
    from rustrobotics_tpu_torch.ops import banded_kernels as bmk

    kw = dict(tolerance=0.0, cg_tol=CG_TOL, cg_maxiter=CG_MAXITER,
              device=device)
    gn = make_optimize(g32, num_iterations=10, backend="cg-banded", **kw)
    lm = make_optimize(g32, num_iterations=10, solver="lm",
                       backend="cg-banded", **kw)
    plain = banded.banded_matvec_plain
    plain_calls = [0]

    def counted_plain(*args):
        plain_calls[0] += 1
        return plain(*args)

    banded.banded_matvec_plain = counted_plain
    bmk.banded_matvec_plain = counted_plain
    try:
        reset_counts()
        t0 = time.perf_counter()
        with recorded_rounds() as rounds_gn:
            _, err_gn, it_gn = gn(g32)
            torch.cuda.synchronize()
        t_gn = time.perf_counter() - t0
        with recorded_rounds() as rounds_lm:
            _, err_lm, it_lm = lm(g32)
            torch.cuda.synchronize()
        launches = read_counts()
    finally:
        banded.banded_matvec_plain = plain
        bmk.banded_matvec_plain = plain

    ref = {s: make_optimize(g32, num_iterations=10, solver=s,
                            backend="cg-banded-jnp", **kw)(g32)[1]
           for s in ("gauss_newton", "lm")}
    err_gn, err_lm = err_gn.double().cpu(), err_lm.double().cpu()
    print(f"[main] GN cg-banded       {err_gn.tolist()}", flush=True)
    print(f"[main] GN cg-banded-jnp   {ref['gauss_newton'].tolist()}",
          flush=True)
    print(f"[main] LM cg-banded       {err_lm.tolist()}", flush=True)
    print(f"[main] LM cg-banded-jnp   {ref['lm'].tolist()}", flush=True)
    print(f"[main] CG rounds per solve: GN {rounds_gn} (total "
          f"{sum(rounds_gn)}), LM {rounds_lm} (total {sum(rounds_lm)}); GN "
          f"run {t_gn * 1e3:.4f} ms, {t_gn * 1e3 / sum(rounds_gn):.4f} ms "
          f"per round (host clock, first run)", flush=True)
    print(f"[main] launches during the cg-banded path: {launches}; plain "
          f"SpMV calls {plain_calls[0]}", flush=True)
    require(it_gn == 10 and it_lm == 10, "iteration counts 10 and 10")
    require(bool(torch.isfinite(err_gn).all() and torch.isfinite(err_lm).all()),
            "cg-banded χ² traces finite")
    require(abs(err_gn[0] / GN_CHI2[0] - 1) <= 1e-4,
            f"cg-banded GN errors[0] {err_gn[0]:.6f} within 1e-4 of "
            f"{GN_CHI2[0]}")
    for name, err, anchor in (("GN", err_gn, CG_GN_CHI2_1),
                              ("LM", err_lm, CG_LM_CHI2_1)):
        require(abs(err[1] / anchor - 1) <= CG_CHI2_1_RTOL,
                f"cg-banded {name} errors[1] {err[1]:.6f} within "
                f"{CG_CHI2_1_RTOL} of {anchor}")
        require(err[10] < CG_CHI2_10_MAX,
                f"cg-banded {name} errors[10] {err[10]:.3g} < "
                f"{CG_CHI2_10_MAX}")
    for name, err, key in (("GN", err_gn, "gauss_newton"),
                           ("LM", err_lm, "lm")):
        want = ref[key].double().cpu()
        big = want > 1.0
        rel = float(((err[big] - want[big]).abs() / want[big]).max())
        require(rel <= CG_CHI2_1_RTOL,
                f"cg-banded {name} entries above 1 within {CG_CHI2_1_RTOL} "
                f"of cg-banded-jnp ({rel:.3g})")
    require(launches["banded_matvec"] > 0,
            "banded_matvec kernel launched on the cg-banded path")
    require(plain_calls[0] == 0, "no plain SpMV on the cg-banded path")
    return gn, launches


def cg_times(k3, gn, g32):
    """Phase 5 for the cg-banded path: K3's time beside its plain
    version, the library yardstick and its bound, all three with L2
    flushed before each call (the bound reads every byte from HBM), and
    K3's L2-warm time as a reading; the stages of one GN iteration; the
    time per CG round; GN iterations/s."""
    import torch

    from rustrobotics_tpu_torch.mapping import solvers
    from rustrobotics_tpu_torch.mapping.assemble import system_values
    from rustrobotics_tpu_torch.ops import banded_kernels as bmk
    from rustrobotics_tpu_torch.ops.banded import (
        band_values,
        banded_matvec_plain,
        make_banded_matvec,
    )

    hb, xp = k3["hb"], k3["xp"]
    layout, blayout, vals, b = k3["layout"], k3["blayout"], k3["vals"], k3["b"]
    nb, kb = hb.shape[0], hb.shape[1]
    # library yardstick: one bmm of hb laid out as (nb, 128, kb*128)
    # against the (nb, kb*128, 1) windows of xp; the copy is made here,
    # outside the timed region
    hb_rows = hb.permute(0, 2, 1, 3).reshape(nb, 128, kb * 128).contiguous()
    windows = xp.as_strided((nb, kb * 128, 1), (128, 1, 1))
    lib_err = float((torch.bmm(hb_rows, windows).view(-1)
                     - banded_matvec_plain(hb, xp)).abs().max())
    # what the function needs: every hb element read once with two FLOP,
    # xp read once, y written once
    k3_bytes = 4 * (hb.numel() + xp.numel() + nb * 128)
    k3_flops = 2.0 * hb.numel()
    bound, by = bound_ms(k3_bytes, k3_flops)
    # Before each timed call a read of 256 MB leaves L2 holding clean
    # lines of another buffer, so every byte of the call comes from HBM,
    # as the bound counts, with no write-back of dirty lines in its way.
    # The CG loop itself finds hb in L2 (24 MB of the 50 MB, written by
    # band_values and read every round): the warm time is that case, and
    # a zero-fill flush (dirty lines) is printed as a reading.
    junk = torch.empty(64 * 2 ** 20, device=hb.device)
    read_flush = junk.sum
    out = dict(
        ms=queued_ms(lambda: bmk.banded_matvec_kernel(hb, xp), calls=20,
                     flush=read_flush),
        plain_ms=queued_ms(lambda: banded_matvec_plain(hb, xp), calls=20,
                           flush=read_flush),
        library_ms=queued_ms(lambda: torch.bmm(hb_rows, windows), calls=20,
                             flush=read_flush),
        bound_ms=bound, bound_by=by,
        l2_warm_ms=queued_ms(lambda: bmk.banded_matvec_kernel(hb, xp)))
    dirty = queued_ms(lambda: bmk.banded_matvec_kernel(hb, xp), calls=20,
                      flush=junk.zero_)
    print(f"[times] banded_matvec, L2 flushed before each call: kernel "
          f"{out['ms']:.6f} ms, plain {out['plain_ms']:.6f} ms, torch.bmm "
          f"yardstick {out['library_ms']:.6f} ms (max|bmm - plain| "
          f"{lib_err:.3g}), bound {bound:.6f} ms ({by}; {k3_flops:.4g} FLOP,"
          f" {k3_bytes:.4g} B), kernel/bound {out['ms'] / bound:.2f}; "
          f"readings: kernel L2-warm {out['l2_warm_ms']:.6f} ms (50 calls "
          f"back to back), after a zero-fill flush {dirty:.6f} ms; device "
          f"time per call, queued behind a sleep kernel", flush=True)

    matvec = make_banded_matvec(blayout, layout, vals)
    precond = solvers.make_block_jacobi(layout, vals)
    stages = {
        "system_values (linearize + assemble)":
            lambda: system_values(g32, 0.0),
        "band_values": lambda: band_values(blayout, layout, vals),
        "make_block_jacobi": lambda: solvers.make_block_jacobi(layout, vals),
        "one dof-space matvec (permute, pad, K3, unpermute)":
            lambda: matvec(b),
        "one preconditioner apply": lambda: precond(b),
    }
    for label, fn in stages.items():
        print(f"[stages] cg-banded {label}: {cuda_ms(fn):.4f} ms",
              flush=True)
    walls = []
    with recorded_rounds() as rounds:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solvers.solve_cg_banded(layout, blayout, vals, b, tol=CG_TOL,
                                    maxiter=CG_MAXITER)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    rounds = rounds[-1]
    wall = statistics.median(walls)
    print(f"[stages] cg-banded whole solve_cg_banded at λ=0: "
          f"{wall * 1e3:.4f} ms for {rounds} rounds, {wall * 1e3 / rounds:.4f}"
          f" ms per round (host clock, median of 3)", flush=True)

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gn(g32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"[times] GN cg-banded, corridor-1728 f32: {10 / wall:.4f} it/s "
          f"({wall / 10 * 1e3:.4f} ms/iteration, median of 3 runs of 10)",
          flush=True)
    return out


def fleet_graphs(device):
    """Phase 3's and 4c's fleet in f64: corridor-1728 and FLEET - 1 copies
    with poses jittered by N(0, FLEET_JITTER²) (numpy, FLEET_SEED)."""
    import numpy as np
    import torch

    g = corridor(1728, device)
    rng = np.random.default_rng(FLEET_SEED)
    poses = g.poses2.cpu().numpy()
    return [g] + [g.replace(poses2=torch.as_tensor(
        poses + rng.normal(0.0, FLEET_JITTER, poses.shape), device=device))
        for _ in range(FLEET - 1)]


def assemble_errors(bl, vals):
    """K4 (vals (nnz,)) or K5 (vals (B, nnz)) against the plain
    index_add_: the largest band-entry difference in units of 2^-24 * the
    sum of its |contributions|, the plain f32 sum's own distance from the
    exact one in the same units, max|kernel - plain|, whether two launches
    agree bit for bit, and whether the band equals the plain version's on
    the CPU (where index_add_ sums in plan order) bit for bit."""
    import torch

    from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
        band_assemble_kernel,
        band_assemble_plain,
    )

    got = band_assemble_kernel(bl, vals)
    again = band_assemble_kernel(bl, vals)
    want = band_assemble_plain(bl, vals)
    unit = 2.0 ** -24 * band_assemble_plain(bl, vals.double().abs())
    exact = band_assemble_plain(bl, vals.double())
    on_cpu = band_assemble_plain(bl, vals.cpu())
    torch.cuda.synchronize()

    def ulps(y, ref):
        diff = (y.double() - ref).abs()
        return float(torch.where(unit > 0, diff / unit, diff).max())

    return dict(finite=bool(torch.isfinite(got).all()),
                ulps=ulps(got, want.double()), plain_ulps=ulps(want, exact),
                max_abs_err=float((got - want).abs().max()),
                deterministic=torch.equal(got, again),
                cpu_equal=torch.equal(got.cpu().view(torch.int32),
                                      on_cpu.view(torch.int32)))


def device_ops(fn):
    """The names of the device operations (kernels, memsets, copies) that
    one call of fn runs, by torch.profiler, after a warm-up call. The
    profiler once returned no device event at all for such a call on the
    H100 (K5 at B = 8, where every earlier run had read one kernel), so an
    empty reading is taken again, once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    return ops


def assemble_parity(name, bl, vals):
    """Phase 3 for K4 or K5 on one input; returns its errors."""
    from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
        band_assemble_kernel,
    )

    e = assemble_errors(bl, vals)
    ops = device_ops(lambda: band_assemble_kernel(bl, vals))
    print(f"  {name}: max entry error {e['ulps']:.6g} f32 units of "
          f"sum|contributions| (plain f32 against exact: "
          f"{e['plain_ulps']:.6g}); max|kernel - plain| "
          f"{e['max_abs_err']:.6g}; two launches bit-equal: "
          f"{e['deterministic']}; bit-equal to the plain index_add_ on the "
          f"CPU: {e['cpu_equal']}; device operations of one call: {ops}",
          flush=True)
    require(e["finite"], f"{name} output finite")
    require(e["ulps"] <= ASSEMBLE_ULPS,
            f"{name} within {ASSEMBLE_ULPS} f32 units of the plain scatter")
    require(e["deterministic"], f"{name} bit-equal between two launches")
    require(len(ops) == 1 and "band_assemble" in ops[0],
            f"{name} one device operation a call (the kernel; no memset or "
            f"copy)")
    return e


def fleet_parity(bl, graphs64, name="corridor-1728", tol=PARITY_TOL):
    """Phase 3 for a fleet: K5 on the fleet's λ = 0.01 triplets, then
    K1/K2 over the batch axis against the unbatched K1/K2 on each graph.
    Returns the K5 errors and the fleet's f32 inputs."""
    import torch

    from rustrobotics_tpu_torch.mapping.assemble import system_values
    from rustrobotics_tpu_torch.mapping.pgo import stack_graphs
    from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
    from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
        band_assemble_kernel,
    )
    from rustrobotics_tpu_torch.ops.band_chol import (
        _prepare_blocks,
        scale_rhs,
        split_blocks,
    )

    vals, b, _ = system_values(stack_graphs(graphs64), LM_LAMBDA0)
    vals, b = vals.float(), b.float()
    batch = len(graphs64)
    print(f"[parity] fleet: B={batch}, {name} and {batch - 1} jittered "
          f"copies; kb={bl.kb} nb={bl.nb}; λ={LM_LAMBDA0}; {len(bl.sel)} "
          f"kept triplets, {len(bl.uniq_idx)} band entries a graph",
          flush=True)
    e5 = assemble_parity(f"K5 (B={batch}, {name})", bl, vals)

    r_blocks, dinv_p = _prepare_blocks(bl, vals, band_assemble_kernel)
    dsym, lcoup = split_blocks(r_blocks)
    bp = scale_rhs(bl, b, dinv_p)
    ld_b, lp_b = bk.factorize_kernel(dsym, lcoup)
    x_b = bk.substitute_kernel(ld_b, lp_b, bp)
    k1 = lp = k2 = 0.0
    equal = True
    for i in range(batch):
        ld_1, lp_1 = bk.factorize_kernel(dsym[i].contiguous(),
                                         lcoup[i].contiguous())
        x_1 = bk.substitute_kernel(ld_1, lp_1, bp[i].contiguous())
        k1 = max(k1, max_eye_residual(ld_b[i], factor_of(ld_1)))
        lp = max(lp, float((lp_b[i] - lp_1).abs().max()))
        k2 = max(k2, float((x_b[i] - x_1).abs().max() / x_1.abs().max()))
        equal &= (torch.equal(ld_b[i], ld_1) and torch.equal(lp_b[i], lp_1)
                  and torch.equal(x_b[i], x_1))
    print(f"  batched K1/K2 against unbatched, worst graph: K1 max|ldinv_b "
          f"L_1 - I| {k1:.6g}, max|lp_b - lp_1| {lp:.6g}, K2 relative "
          f"{k2:.6g}; every graph bit-equal: {equal}", flush=True)
    require(bool(torch.isfinite(x_b).all()), "batched K1/K2 outputs finite")
    require(k1 <= tol["k1"] and lp <= tol["lp"] and k2 <= tol["k2"],
            f"{name} batched K1/K2 against unbatched within {tol}")
    return dict(e5=e5, vals=vals, dsym=dsym, lcoup=lcoup, ld=ld_b, lp=lp_b,
                bp=bp, b=b)


@contextlib.contextmanager
def counted_plain_scatter():
    """Within the block, every call of the plain band scatters (the
    default of _prepare_blocks and the assembly's plain version) adds one
    to the count it yields."""
    from rustrobotics_tpu_torch.ops import band_assemble_kernels as bak
    from rustrobotics_tpu_torch.ops import band_chol

    calls = [0]
    saved = (band_chol.scatter_add, bak.band_assemble_plain)

    def counted(fn):
        def run(*args):
            calls[0] += 1
            return fn(*args)
        return run

    band_chol.scatter_add = counted(saved[0])
    bak.band_assemble_plain = counted(saved[1])
    try:
        yield calls
    finally:
        band_chol.scatter_add, bak.band_assemble_plain = saved


def max_rel(got, want, sel):
    return float(((got[sel] - want[sel]).abs() / want[sel]).max())


def fleet_path(device, graphs64):
    """Phase 4c: returns the fleet's GN runner, the fleet and the path's
    counts."""
    import torch

    from rustrobotics_tpu_torch.mapping.pgo import (
        make_optimize,
        make_optimize_batch,
        stack_graphs,
    )

    graphs = [g.to(dtype=torch.float32) for g in graphs64]
    fleet = stack_graphs(graphs)
    kw = dict(tolerance=0.0, device=device)
    iters = {"gauss_newton": 10, "lm": 6}
    runners = {s: make_optimize_batch(graphs[0], num_iterations=k, solver=s,
                                      backend="banded-kernel", **kw)
               for s, k in iters.items()}
    out = {}
    with counted_plain_scatter() as plain_calls:
        reset_counts()
        for s, run in runners.items():
            out[s] = run(fleet)
        torch.cuda.synchronize()
        launches = read_counts()
    refs = {}
    fleet64 = stack_graphs(graphs64)
    for s, k in iters.items():
        one = make_optimize(graphs[0], num_iterations=k, solver=s,
                            backend="banded-kernel", **kw)
        direct = make_optimize_batch(graphs[0], num_iterations=k, solver=s,
                                     backend="banded-direct", **kw)
        refs[s] = {"unbatched banded-kernel": torch.stack(
                       [one(g)[1] for g in graphs]).double().cpu(),
                   "batched banded-direct": direct(fleet)[1].double().cpu(),
                   "batched banded-direct f64": direct(fleet64)[1].cpu()}
    err = {s: out[s][1].double().cpu() for s in iters}
    for s in iters:
        for i in range(FLEET):
            print(f"[main] fleet {s} row {i}: {err[s][i].tolist()}",
                  flush=True)
    print(f"[main] launches during the fleet path: {launches}; plain band "
          f"scatters {plain_calls[0]}", flush=True)

    require(all(out[s][2].tolist() == [k] * FLEET for s, k in iters.items()),
            "fleet iteration counts 10 (GN) and 6 (LM) in every row")
    require(all(bool(torch.isfinite(err[s]).all()) for s in iters),
            "fleet χ² traces finite")
    gn, lm = err["gauss_newton"], err["lm"]
    require(abs(gn[0, 0] / GN_CHI2[0] - 1) <= 1e-4
            and abs(gn[0, 1] / GN_CHI2[1] - 1) <= 1e-2
            and abs(lm[0, 1] / LM_CHI2_1 - 1) <= 1e-2,
            f"fleet row 0 at the f64 anchors (GN errors[1] {gn[0, 1]:.6f}, "
            f"LM errors[1] {lm[0, 1]:.6f})")
    # LM's damped systems are resolved in f32: every entry above 1 of
    # every row is held to all three runs. GN's undamped ones are at f32's
    # edge past the first step (on the CPU, f32 errors[1] of the jittered
    # rows is up to 0.46 from f64, and two f32 factorizations disagree by
    # a few %), so GN errors[1] is held to the unbatched run of the same
    # kernels (K1/K2/K5 give each graph the unbatched result bit for bit;
    # only the atomic order of the RHS scatter differs), errors[0] to f64,
    # and the rest is printed as readings.
    for ref in refs["lm"]:
        w_lm, w_gn = refs["lm"][ref], refs["gauss_newton"][ref]
        lm_rel = max(max_rel(lm[i], w_lm[i], w_lm[i] > 1.0)
                     for i in range(FLEET))
        gn_rel = [max(max_rel(gn[i, k:k + 1], w_gn[i, k:k + 1],
                              w_gn[i, k:k + 1] > 1.0) for i in range(FLEET))
                  for k in (0, 1)]
        gn_all = max(max_rel(gn[i], w_gn[i], w_gn[i] > 1.0)
                     for i in range(FLEET))
        print(f"[main] fleet against the {ref} run, worst row: LM entries "
              f"above 1 {lm_rel:.6g}; GN errors[0] {gn_rel[0]:.6g}, "
              f"errors[1] {gn_rel[1]:.6g}, entries above 1 {gn_all:.6g}",
              flush=True)
        require(lm_rel <= 1e-2, f"every fleet LM row within 1e-2 of the "
                                f"{ref} run (entries above 1)")
        require(gn_rel[0] <= 1e-4, f"every fleet GN errors[0] within 1e-4 "
                                   f"of the {ref} run")
        if ref == "unbatched banded-kernel":
            require(gn_rel[1] <= 1e-2, f"every fleet GN errors[1] within "
                                       f"1e-2 of the {ref} run")
    require(float(gn[:, 10].max()) < 1e-2,
            f"every fleet GN row converged: max errors[10] "
            f"{float(gn[:, 10].max()):.3g} < 1e-2")
    steps = sum(iters.values())
    for key in ("assemble_batch", "factorize", "substitute"):
        require(launches[key] == steps,
                f"{key} launched once a fleet iteration ({launches[key]} == "
                f"{steps})")
    require(launches["assemble_b1"] == 0 and plain_calls[0] == 0,
            "no one-graph assembly and no plain scatter on the fleet path")
    return runners["gauss_newton"], fleet, launches


def assemble_times(bl, vals):
    """K4 or K5's time, its plain version's and the library yardstick's,
    each with L2 flushed before the call (the band's write dominates the
    bound), beside the bound: the band written once and the kept values
    read once; one addition a kept value. The kernel's L2-warm time (calls
    back to back, as in the GN loop, where one graph's band stays in L2)
    is the extra key l2_warm_ms."""
    import torch

    from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
        band_assemble_kernel,
        band_assemble_plain,
    )

    batch = vals.shape[:-1]
    graphs = vals.shape[0] if batch else 1
    band = bl.nb * bl.kb * 2 * bl.kb
    kept = len(bl.sel)
    # yardstick: one index_add_ of the values gathered (outside the
    # timing) in plan order into a zeroed band
    pre = vals[..., bl.sel_sorted].contiguous()
    dest = bl.uniq_idx[bl.seg_sorted]
    lib_err = float((torch.zeros(batch + (band,), device=vals.device)
                     .index_add_(-1, dest, pre)
                     - band_assemble_plain(bl, vals)).abs().max())
    nbytes = 4 * graphs * (band + kept)
    bound, by = bound_ms(nbytes, graphs * kept)
    junk = torch.empty(64 * 2 ** 20, device=vals.device)
    out = dict(
        ms=queued_ms(lambda: band_assemble_kernel(bl, vals), calls=20,
                     flush=junk.sum),
        plain_ms=queued_ms(lambda: band_assemble_plain(bl, vals), calls=20,
                           flush=junk.sum),
        library_ms=queued_ms(
            lambda: torch.zeros(batch + (band,), device=vals.device)
            .index_add_(-1, dest, pre), calls=20, flush=junk.sum),
        bound_ms=bound, bound_by=by,
        l2_warm_ms=queued_ms(lambda: band_assemble_kernel(bl, vals)))
    # what writing the band alone takes under the same timing
    fill = torch.empty(batch + (band,), device=vals.device)
    fill_ms = queued_ms(fill.zero_, calls=20, flush=junk.sum)
    fill_warm_ms = queued_ms(fill.zero_)
    print(f"[times] band_assemble B={graphs}, L2 flushed before each call: "
          f"kernel {out['ms']:.6f} ms, plain {out['plain_ms']:.6f} ms, "
          f"zeros + index_add_ yardstick {out['library_ms']:.6f} ms "
          f"(max|yardstick - plain| {lib_err:.3g}), bound {bound:.6f} ms "
          f"({by}; {nbytes:.4g} B), kernel/bound {out['ms'] / bound:.2f}; "
          f"readings: kernel L2-warm {out['l2_warm_ms']:.6f} ms (50 calls "
          f"back to back), the band's fill alone (Tensor.zero_) "
          f"{fill_ms:.6f} ms flushed, {fill_warm_ms:.6f} ms L2-warm",
          flush=True)
    return out


def fleet_times(fp, bl, gn_fleet, fleet, gn_one, g32):
    """Phase 5 for the fleet: the stages of one fleet GN iteration and
    graph-iterations/s at B = FLEET against one graph's GN run, measured
    in turns (median of 5 runs of 10 iterations each)."""
    import torch

    from rustrobotics_tpu_torch.mapping.assemble import (
        apply_update,
        system_values,
    )
    from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
    from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
        band_assemble_kernel,
    )
    from rustrobotics_tpu_torch.ops.band_chol import _prepare_blocks

    vals, b, _ = system_values(fleet, 0.0)
    dx = bk.solve_band_kernel(bl, vals, b)
    stages = {
        "system_values (linearize + assemble)":
            lambda: system_values(fleet, 0.0),
        "band assembly (_prepare_blocks with K5)":
            lambda: _prepare_blocks(bl, vals, band_assemble_kernel),
        "K1 factorize": lambda: bk.factorize_kernel(fp["dsym"], fp["lcoup"]),
        "K2 substitute":
            lambda: bk.substitute_kernel(fp["ld"], fp["lp"], fp["bp"]),
        "whole solve_band_kernel": lambda: bk.solve_band_kernel(bl, vals, b),
        "apply_update": lambda: apply_update(fleet, dx),
    }
    for label, fn in stages.items():
        print(f"[stages] fleet B={FLEET} {label}: {cuda_ms(fn):.4f} ms",
              flush=True)

    fleet_rate("GN banded-kernel, corridor-1728 f32", gn_one, g32, gn_fleet,
               fleet, 10)


def sphere_graphs(device):
    """sphere-2500 and SPHERE_FLEET - 1 copies with jittered poses
    (jitter_poses3, numpy default_rng(FLEET_SEED)), f64."""
    import torch

    g = port_graph(sphere_graph(), device)
    rng = np.random.default_rng(FLEET_SEED)
    poses = g.poses3.cpu().numpy()
    return [g] + [g.replace(poses3=torch.as_tensor(
        jitter_poses3(poses, rng), device=device))
        for _ in range(SPHERE_FLEET - 1)]


def sphere_path(device, graphs64):
    """Phase 4d: sphere-2500 in f32 on banded-kernel, GN 10 and LM 6,
    against banded-direct on the card and the f64 anchors; then the fleet
    of SPHERE_FLEET (make_optimize_batch, LM 6) against each graph's
    unbatched banded-kernel run. Returns the GN runner, the graph, the
    fleet's LM runner, the fleet and both paths' counts."""
    import torch

    from rustrobotics_tpu_torch.mapping.pgo import (
        make_optimize,
        make_optimize_batch,
        stack_graphs,
    )

    graphs = [g.to(dtype=torch.float32) for g in graphs64]
    g32 = graphs[0]
    kw = dict(tolerance=0.0, device=device)
    runs = {}
    for backend in ("banded-kernel", "banded-direct"):
        runs[backend] = (
            make_optimize(g32, num_iterations=10, backend=backend, **kw),
            make_optimize(g32, num_iterations=6, solver="lm",
                          backend=backend, **kw))
    gn, lm = runs["banded-kernel"]
    with counted_plain_scatter() as plain_calls:
        reset_counts()
        _, err_gn, it_gn = gn(g32)
        _, err_lm, it_lm = lm(g32)
        torch.cuda.synchronize()
        launches = read_counts()
    err_gn, err_lm = err_gn.double().cpu(), err_lm.double().cpu()
    direct = [r(g32)[1].double().cpu() for r in runs["banded-direct"]]
    for label, err in (("GN banded-kernel", err_gn), ("GN banded-direct",
                       direct[0]), ("LM banded-kernel", err_lm),
                       ("LM banded-direct", direct[1])):
        print(f"[main] sphere-2500 {label:17} {err.tolist()}", flush=True)
    print(f"[main] launches during the sphere-2500 path: {launches}; plain "
          f"band scatters {plain_calls[0]}", flush=True)
    require(it_gn == 10 and it_lm == 6, "sphere-2500 iteration counts 10, 6")
    require(bool(torch.isfinite(err_gn).all() and torch.isfinite(err_lm).all()),
            "sphere-2500 χ² traces finite")
    require(abs(err_gn[0] / SPHERE_GN_CHI2[0] - 1) <= 1e-4
            and abs(err_lm[0] / SPHERE_GN_CHI2[0] - 1) <= 1e-4,
            f"sphere-2500 errors[0] {err_gn[0]:.6f} within 1e-4 of "
            f"{SPHERE_GN_CHI2[0]}")
    for label, got, want in (("GN", err_gn[1], SPHERE_GN_CHI2[1]),
                             ("LM", err_lm[1], SPHERE_LM_CHI2_1)):
        require(abs(got / want - 1) <= SPHERE_CHI2_1_RTOL,
                f"sphere-2500 {label} errors[1] {got:.6f} within "
                f"{SPHERE_CHI2_1_RTOL} of {want}")
    for label, got, want in (("GN", err_gn, direct[0]),
                             ("LM", err_lm, direct[1])):
        rel = max_rel(got, want, want > 1.0)
        require(rel <= SPHERE_DIRECT_RTOL,
                f"sphere-2500 {label} entries above 1 within "
                f"{SPHERE_DIRECT_RTOL} of banded-direct ({rel:.3g})")
    require(err_gn[10] < 1e-2, f"sphere-2500 GN errors[10] {err_gn[10]:.3g} "
                               f"< 1e-2")
    for key in ("assemble_b1", "factorize", "substitute"):
        require(launches[key] > 0,
                f"{key} kernel launched on the sphere-2500 path")
    require(plain_calls[0] == 0, "no plain band scatter on the sphere-2500 "
                                 "path (no dense fallback)")

    fleet = stack_graphs(graphs)
    batch = len(graphs)
    lm_fleet = make_optimize_batch(g32, num_iterations=6, solver="lm",
                                   backend="banded-kernel", **kw)
    with counted_plain_scatter() as plain_calls:
        reset_counts()
        _, err_f, it_f = lm_fleet(fleet)
        torch.cuda.synchronize()
        fleet_launches = read_counts()
    err_f = err_f.double().cpu()
    rows = torch.stack([lm(g)[1] for g in graphs]).double().cpu()
    worst = max(max_rel(err_f[i], rows[i], rows[i] > 1.0)
                for i in range(batch))
    for i in range(batch):
        print(f"[main] sphere-2500 fleet lm row {i}: {err_f[i].tolist()}",
              flush=True)
    print(f"[main] launches during the sphere-2500 fleet path: "
          f"{fleet_launches}; plain band scatters {plain_calls[0]}; worst "
          f"row against its unbatched run (entries above 1): {worst:.6g}",
          flush=True)
    require(it_f.tolist() == [6] * batch,
            f"sphere-2500 fleet iteration counts 6 in every row")
    require(bool(torch.isfinite(err_f).all()), "sphere-2500 fleet χ² finite")
    require(worst <= SPHERE_FLEET_RTOL,
            f"every sphere-2500 fleet LM row within {SPHERE_FLEET_RTOL} of "
            f"its unbatched banded-kernel run (entries above 1)")
    for key in ("assemble_batch", "factorize", "substitute"):
        require(fleet_launches[key] == 6,
                f"{key} launched once a sphere-2500 fleet iteration "
                f"({fleet_launches[key]} == 6)")
    require(fleet_launches["assemble_b1"] == 0 and plain_calls[0] == 0,
            "no one-graph assembly and no plain scatter on the sphere-2500 "
            "fleet path")
    return gn, g32, lm_fleet, fleet, launches, fleet_launches


def fleet_rate(name, one, g, fleet_run, fleet, iters, repeats=5):
    """Graph-iterations/s of a fleet runner against one graph's, measured
    in turns (median of ``repeats`` runs of ``iters`` iterations each)."""
    import torch

    batch = fleet.batch_shape[0]
    walls = {1: [], batch: []}
    runs = {1: (one, g), batch: (fleet_run, fleet)}
    for run, arg in runs.values():
        run(arg)
    torch.cuda.synchronize()
    for _ in range(repeats):
        for key, (run, arg) in runs.items():
            t0 = time.perf_counter()
            run(arg)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
    ms = {k: statistics.median(w) / iters * 1e3 for k, w in walls.items()}
    rate = {k: k * 1e3 / ms[k] for k in walls}
    print(f"[times] {name}, graph-iterations/s: B={batch} fleet "
          f"{rate[batch]:.4f} ({ms[batch]:.4f} ms a fleet iteration), B=1 "
          f"{rate[1]:.4f} ({ms[1]:.4f} ms an iteration); ratio "
          f"{rate[batch] / rate[1]:.4f} (median of {repeats} runs of "
          f"{iters} iterations each, in turns)", flush=True)


def gnc_graphs(device):
    """corridor-1728-gnc in f32 and its clean graph: the same corridor
    with corrupt_closures' garbage measurements."""
    import torch

    clean = corridor(1728, device).to(dtype=torch.float32)
    z, mask = corrupt_closures(clean.pp_from.cpu().numpy(),
                               clean.pp_to.cpu().numpy(),
                               clean.pp_z.double().cpu().numpy())
    bad = clean.replace(pp_z=torch.as_tensor(z, dtype=torch.float32,
                                             device=device))
    return clean, bad, int(mask.sum())


def gnc_path(device):
    """Phase 4e: corridor-1728-gnc, robust="gnc-gm", LM GNC_ITERS on
    banded-kernel against banded-direct on the card and the f64 anchors.
    Returns the runner, the graph and the path's counts."""
    import torch

    from rustrobotics_tpu_torch.mapping.assemble import build_layout
    from rustrobotics_tpu_torch.mapping.pgo import global_error, make_optimize
    from rustrobotics_tpu_torch.ops.band_chol import build_band_chol

    clean, bad, outliers = gnc_graphs(device)
    bl = build_band_chol(build_layout(bad))
    print(f"[main] corridor-1728-gnc: {outliers} of "
          f"{int((clean.pp_to - clean.pp_from).abs().ne(1).sum())} loop "
          f"closures carry garbage; kb={bl.kb} nb={bl.nb}", flush=True)
    require((bl.kb, bl.nb) == (512, 11), "corridor-1728-gnc band plan kb=512,"
                                         " nb=11")
    kw = dict(num_iterations=GNC_ITERS, solver="lm", tolerance=0.0,
              robust="gnc-gm", device=device)
    lm = make_optimize(bad, backend="banded-kernel", **kw)
    reset_counts()
    out, err, it = lm(bad)
    torch.cuda.synchronize()
    launches = read_counts()
    out_d, err_d, _ = make_optimize(bad, backend="banded-direct", **kw)(bad)
    inlier, inlier_d = (float(global_error(clean.replace(
        poses2=o.poses2, landmarks2=o.landmarks2))) for o in (out, out_d))
    err, err_d = err.double().cpu(), err_d.double().cpu()
    print(f"[main] corridor-1728-gnc LM banded-kernel {err.tolist()}",
          flush=True)
    print(f"[main] corridor-1728-gnc LM banded-direct {err_d.tolist()}",
          flush=True)
    rel = max_rel(err, err_d, err_d > 1.0)
    print(f"[main] corridor-1728-gnc inlier χ² at the final poses: "
          f"banded-kernel {inlier:.6g}, banded-direct {inlier_d:.6g} (JAX "
          f"f64 {GNC_INLIER_CHI2:.6g}); trace against banded-direct "
          f"{rel:.6g}; launches {launches}", flush=True)
    require(it == GNC_ITERS and bool(torch.isfinite(err).all()),
            f"corridor-1728-gnc {GNC_ITERS} iterations, χ² finite")
    require(abs(err[0] / GNC_CHI2_0 - 1) <= 1e-4,
            f"corridor-1728-gnc errors[0] {err[0]:.6f} within 1e-4 of "
            f"{GNC_CHI2_0}")
    require(rel <= GNC_TRACE_RTOL,
            f"corridor-1728-gnc entries above 1 within {GNC_TRACE_RTOL} of "
            f"banded-direct")
    require(abs(inlier - GNC_INLIER_CHI2) <= GNC_INLIER_ATOL,
            f"corridor-1728-gnc inlier χ² within {GNC_INLIER_ATOL} of the "
            f"JAX f64 run's")
    for key in ("assemble_b1", "factorize", "substitute"):
        require(launches[key] > 0,
                f"{key} kernel launched on the corridor-1728-gnc path")
    return lm, bad, launches


def k3_fleet_parity(graphs64):
    """Phase 3 for K3 over a batch axis: the fleet of 8's bands at the
    first LM step's damping, its right-hand sides as x. The batched call
    against eight one-graph calls (bit-equal expected) and against the
    plain version (K3_ULPS). Returns the inputs and the errors."""
    import torch

    from rustrobotics_tpu_torch.mapping.pgo import stack_graphs
    from rustrobotics_tpu_torch.ops import banded_kernels as bmk
    from rustrobotics_tpu_torch.ops.banded import _pad_x_blocks, band_values

    fleet = stack_graphs([g.to(dtype=torch.float32) for g in graphs64])
    layout, blayout, vals, b = cg_system(fleet, LM_LAMBDA0)
    hb = band_values(blayout, layout, vals)
    xp = _pad_x_blocks(blayout, b[..., blayout.perm])
    batch = hb.shape[0]
    y = bmk.banded_matvec_kernel(hb, xp)
    equal = all(torch.equal(y[i], bmk.banded_matvec_kernel(
        hb[i].contiguous(), xp[i].contiguous())) for i in range(batch))
    e = k3_errors(hb, xp)
    print(f"[parity] K3 fleet: B={batch}, hb {tuple(hb.shape)}, λ="
          f"{LM_LAMBDA0}: max row error {e['ulps']:.6g} x the bound's unit "
          f"(TF32-rounded operands: {e['tf32_ulps']:.6g}); max|y_k - "
          f"y_plain| {e['max_abs_err']:.6g} of max|y| {e['y_max']:.6g}; every "
          f"graph bit-equal to its one-graph call: {equal}", flush=True)
    require(e["finite"], "batched K3 output finite")
    require(equal, f"batched K3 bit-equal to {batch} one-graph calls")
    require(e["ulps"] <= K3_ULPS,
            f"batched K3 within {K3_ULPS} x kb*128 f32 units per row")
    return dict(hb=hb, xp=xp, err=e)


def k3_fleet_times(k3b):
    """K3's batched time, the plain version's and one batched torch.bmm's,
    each with L2 flushed before the call, beside the bound: every hb byte
    of the fleet read once (B x 24.23 MB at corridor-1728), xp read once,
    y written once."""
    import torch

    from rustrobotics_tpu_torch.ops import banded_kernels as bmk
    from rustrobotics_tpu_torch.ops.banded import banded_matvec_plain

    hb, xp = k3b["hb"], k3b["xp"]
    batch, nb, kb = hb.shape[:3]
    hb_rows = hb.permute(0, 1, 3, 2, 4).reshape(batch * nb, 128, kb * 128)
    # the windows of each graph's xp, expanded here (1.5 MB), outside the
    # timed region: a strided view across graphs would be copied by bmm
    windows = xp.as_strided((batch, nb, kb * 128),
                            ((nb + kb - 1) * 128, 128, 1)).reshape(
        batch * nb, kb * 128, 1).contiguous()
    lib_err = float((torch.bmm(hb_rows, windows).view(batch, -1)
                     - banded_matvec_plain(hb, xp)).abs().max())
    nbytes = 4 * (hb.numel() + xp.numel() + batch * nb * 128)
    bound, by = bound_ms(nbytes, 2.0 * hb.numel())
    junk = torch.empty(64 * 2 ** 20, device=hb.device)
    out = dict(
        ms_b8=queued_ms(lambda: bmk.banded_matvec_kernel(hb, xp), calls=10,
                        repeats=3, flush=junk.sum),
        plain_ms_b8=queued_ms(lambda: banded_matvec_plain(hb, xp), calls=10,
                              repeats=3, flush=junk.sum),
        library_ms_b8=queued_ms(lambda: torch.bmm(hb_rows, windows),
                                calls=10, repeats=3, flush=junk.sum),
        bound_ms_b8=bound, max_abs_err_b8=k3b["err"]["max_abs_err"])
    print(f"[times] banded_matvec B={batch}, L2 flushed before each call: "
          f"kernel {out['ms_b8']:.6f} ms, plain {out['plain_ms_b8']:.6f} ms, "
          f"batched torch.bmm yardstick {out['library_ms_b8']:.6f} ms "
          f"(max|bmm - plain| {lib_err:.3g}), bound {bound:.6f} ms ({by}; "
          f"{nbytes:.4g} B), kernel/bound {out['ms_b8'] / bound:.2f}",
          flush=True)
    return out


def fleet_cg_path(device, graphs64):
    """Phase 4f: make_optimize_batch(backend="cg-banded") on the fleet of 8
    in f32, GN 10, CG_TOL and CG_MAXITER: each row against
    make_optimize(backend="cg-banded") on that graph; K3 launched once a
    fleet PCG round and the plain SpMV never; rounds per row per solve and
    the fleet's graph-iterations/s against one graph's. Returns the
    fleet's counts."""
    import torch

    from rustrobotics_tpu_torch.mapping.pgo import (
        make_optimize,
        make_optimize_batch,
        stack_graphs,
    )
    from rustrobotics_tpu_torch.ops import banded
    from rustrobotics_tpu_torch.ops import banded_kernels as bmk

    graphs = [g.to(dtype=torch.float32) for g in graphs64]
    fleet = stack_graphs(graphs)
    kw = dict(num_iterations=10, backend="cg-banded", tolerance=0.0,
              cg_tol=CG_TOL, cg_maxiter=CG_MAXITER, device=device)
    run = make_optimize_batch(graphs[0], **kw)
    plain = banded.banded_matvec_plain
    plain_calls = [0]

    def counted_plain(*args):
        plain_calls[0] += 1
        return plain(*args)

    banded.banded_matvec_plain = counted_plain
    bmk.banded_matvec_plain = counted_plain
    try:
        reset_counts()
        t0 = time.perf_counter()
        with recorded_rounds() as rounds:
            _, err, it = run(fleet)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        banded.banded_matvec_plain = plain
        bmk.banded_matvec_plain = plain
    one = make_optimize(graphs[0], **kw)
    rows = torch.stack([one(g)[1] for g in graphs]).double().cpu()
    err = err.double().cpu()
    per_solve = [r.tolist() for r in rounds]
    fleet_rounds = sum(max(r) for r in per_solve)
    worst = max(max_rel(err[i], rows[i], rows[i] > 1.0)
                for i in range(len(graphs)))
    for i in range(len(graphs)):
        print(f"[main] fleet cg-banded GN row {i}: {err[i].tolist()}",
              flush=True)
    print(f"[main] fleet cg-banded CG rounds per solve, one list a solve "
          f"(rows 0..{len(graphs) - 1}): {per_solve}; fleet rounds "
          f"{fleet_rounds}; K3 launches {launches['banded_matvec']}; plain "
          f"SpMV calls {plain_calls[0]}; worst row against its one-graph "
          f"run (entries above 1) {worst:.6g}; errors[10] per row "
          f"{err[:, 10].tolist()}; first run {wall * 1e3:.4f} ms (host "
          f"clock)", flush=True)
    require(it.tolist() == [10] * len(graphs),
            "fleet cg-banded iteration counts 10 in every row")
    require(bool(torch.isfinite(err).all()), "fleet cg-banded χ² finite")
    require(abs(err[0, 0] / GN_CHI2[0] - 1) <= 1e-4
            and abs(err[0, 1] / CG_GN_CHI2_1 - 1) <= CG_CHI2_1_RTOL,
            f"fleet cg-banded row 0 at the f64 anchors (errors[1] "
            f"{err[0, 1]:.6f})")
    require(worst <= FLEET_CG_RTOL,
            f"every fleet cg-banded row within {FLEET_CG_RTOL} of its "
            f"one-graph cg-banded run (entries above 1)")
    require(launches["banded_matvec"] == fleet_rounds > 0,
            "K3 launched once a fleet PCG round, for all 8 graphs")
    require(plain_calls[0] == 0, "no plain SpMV on the fleet cg-banded path")
    fleet_rate("GN cg-banded, corridor-1728 f32", one, graphs[0], run, fleet,
               10, repeats=2)
    return launches


def marginal_errors(got, want, per_dof=True):
    """The largest difference relative to each entry's own magnitude
    (variances), or to each block's largest entry (pose blocks)."""
    diff = (got.double() - want.double()).abs()
    if per_dof:
        return float((diff / want.double().abs()).max())
    scale = want.double().abs().amax((-1, -2), keepdim=True)
    return float((diff / scale).max())


def marginals_phase(name, g32, device, blocks=True):
    """Phase 4g: marginal_variances (and pose_covariances) of an f32 graph
    through K4 + K1, against the plain f32 chain on the card and against
    the f64 run of the same function on the card (the plain chain in
    f64); the counts of the kernel run and its time."""
    import torch

    from rustrobotics_tpu_torch.mapping.assemble import (
        build_layout,
        system_values,
    )
    from rustrobotics_tpu_torch.mapping.pgo import (
        marginal_variances,
        pose_covariances,
    )
    from rustrobotics_tpu_torch.ops.band_chol import (
        build_band_chol,
        marginal_covariances,
        marginal_node_blocks,
    )

    reset_counts()
    var_k = marginal_variances(g32, device=device)
    blk_k = pose_covariances(g32, device=device) if blocks else None
    torch.cuda.synchronize()
    launches = read_counts()
    bl = build_band_chol(build_layout(g32)).to(device)
    vals, _, _ = system_values(g32, 0.0)
    var_p = marginal_covariances(bl, vals)
    g64 = g32.to(dtype=torch.float64)
    var_64 = marginal_variances(g64, device=device)
    err = dict(f64=marginal_errors(var_k, var_64),
               plain=marginal_errors(var_k, var_p),
               plain_f64=marginal_errors(var_p, var_64))
    scale = float(var_64.abs().max())
    norm = [float((a.double() - b.double()).abs().max()) / scale
            for a, b in ((var_k, var_64), (var_k, var_p), (var_p, var_64))]
    if blocks:
        offs = g32.pose2_offsets.cpu().numpy()
        blk_p = marginal_node_blocks(bl, vals, offs, [3] * len(offs),
                                     pad_size=3)
        blk_64 = pose_covariances(g64, device=device)
        err.update(blocks_f64=marginal_errors(blk_k, blk_64, False),
                   blocks_plain=marginal_errors(blk_k, blk_p, False),
                   blocks_plain_f64=marginal_errors(blk_p, blk_64, False))
    ms = cuda_ms(lambda: marginal_variances(g32, device=device), repeats=3,
                 warmup=1)
    ms_plain = cuda_ms(lambda: marginal_covariances(bl, vals), repeats=3,
                       warmup=1)
    print(f"[marginals] {name} (kb={bl.kb}, nb={bl.nb}): variances through "
          f"K4 + K1 against f64 {err['f64']:.6g}, against the plain f32 "
          f"chain {err['plain']:.6g} (plain f32 against f64 "
          f"{err['plain_f64']:.6g}); per-dof relative; relative to the "
          f"largest variance {norm[0]:.6g}, {norm[1]:.6g} ({norm[2]:.6g}); "
          f"variance range {float(var_64.min()):.4g}..{scale:.4g}",
          flush=True)
    if blocks:
        print(f"[marginals] {name} pose blocks (per block's largest entry): "
              f"against f64 {err['blocks_f64']:.6g}, against plain f32 "
              f"{err['blocks_plain']:.6g} (plain against f64 "
              f"{err['blocks_plain_f64']:.6g})", flush=True)
    print(f"[marginals] {name}: launches {launches}; marginal_variances "
          f"{ms:.4f} ms (whole call: system values, K4, K1, recursion; "
          f"median of 3), the plain f32 chain's selected inverse alone "
          f"{ms_plain:.4f} ms", flush=True)
    require(bool(torch.isfinite(var_k).all() and (var_k > 0).all()),
            f"{name} marginal variances finite and positive")
    tol = MARGINAL_TOL.get(name)
    if tol is None:
        for key, what in (("", "variances"), ("blocks_", "pose blocks")
                          )[:2 if blocks else 1]:
            limit = MARGINAL_RULE * err[f"{key}plain_f64"]
            require(err[f"{key}f64"] <= limit and err[f"{key}plain"] <= limit,
                    f"{name} {what} through K4 + K1 within {MARGINAL_RULE}x "
                    f"the plain f32 chain's distance from f64 ({limit:.4g}) "
                    f"of f64 and of the plain chain")
    else:
        require(err["f64"] <= tol["f64"],
                f"{name} variances through K4 + K1 within {tol['f64']} of "
                f"f64")
        require(err["plain"] <= tol["plain"],
                f"{name} variances through K4 + K1 within {tol['plain']} of "
                f"the plain f32 chain")
    want = 2 if blocks else 1
    for key in ("assemble_b1", "factorize"):
        require(launches[key] == want,
                f"{key} launched {want}x by the marginals ({launches[key]})")
    return dict(launches=launches, ms=ms, **err)


@contextlib.contextmanager
def counted_host_solve():
    """Within the block, every SuperLU host solve adds one to the count it
    yields (solve_native falls back to it when the library is missing)."""
    from rustrobotics_tpu_torch.mapping import solvers

    calls = [0]
    saved = solvers.solve_host

    def counted(*args):
        calls[0] += 1
        return saved(*args)

    solvers.solve_host = counted
    try:
        yield calls
    finally:
        solvers.solve_host = saved


def backends_phase(device):
    """Phase 4h: the remaining solver backends on corridor-1728, GN 10,
    each held to the χ² anchors of the banded-kernel path: banded-cr,
    banded-mixed (lp "high": the lifted factor at full f32; "bf16": the
    band truncated to bfloat16) with their CG rounds, schur (f32 on
    the card) and native (the C++ LDL^T on the host, the graph in f64),
    which must run the native library and never SuperLU."""
    import functools

    import torch

    from rustrobotics_tpu_torch.mapping import solvers
    from rustrobotics_tpu_torch.mapping.pgo import make_optimize, optimize
    from rustrobotics_tpu_torch.ops.native_solver import native_available

    g64 = corridor(1728, device)
    g32 = g64.to(dtype=torch.float32)
    mixed = solvers.make_banded_mixed
    out = {}
    for label in BACKEND_RUNS:
        backend, _, lp = label.partition(" ")
        rounds, host_calls = [], [0]
        t0 = time.perf_counter()
        if backend == "native":
            require(native_available(), "the native LDL^T library built")
            with counted_host_solve() as host_calls:
                res = optimize(g64, num_iterations=10, backend="native",
                               tolerance=0.0, device=device)
            err = torch.tensor(res.errors, dtype=torch.float64)
        else:
            if lp:
                solvers.make_banded_mixed = functools.partial(mixed, lp=lp)
            try:
                with recorded_rounds() as rounds:
                    _, err, _ = make_optimize(g32, num_iterations=10,
                                              backend=backend, tolerance=0.0,
                                              device=device)(g32)
                    torch.cuda.synchronize()
            finally:
                solvers.make_banded_mixed = mixed
            err = err.double().cpu()
        wall = time.perf_counter() - t0
        out[label] = err
        extra = f"; CG rounds per solve {rounds}" if rounds else ""
        if backend == "native":
            extra = f"; SuperLU solves {host_calls[0]}"
        print(f"[backends] GN {label:17} {err.tolist()} ({wall * 1e3:.4f} ms "
              f"with set-up, host clock){extra}", flush=True)
        require(bool(torch.isfinite(err).all()) and len(err) == 11,
                f"{label}: 10 iterations, χ² finite")
        require(abs(err[0] / GN_CHI2[0] - 1) <= 1e-4
                and abs(err[1] / GN_CHI2[1] - 1) <= 1e-2 and err[10] < 1e-2,
                f"{label}: errors[0] {err[0]:.6f} within 1e-4 of {GN_CHI2[0]},"
                f" errors[1] {err[1]:.6f} within 1% of {GN_CHI2[1]}, "
                f"errors[10] {err[10]:.3g} < 1e-2")
        if backend == "native":
            require(host_calls[0] == 0, "native ran the native library (no "
                                        "SuperLU solve)")
    return out


def auto_measure_phase(name, g32, device):
    """Phase 4i: make_optimize(backend="auto-measure"): each candidate's
    best of three solve times on the template's system and the winner,
    whose one GN step must be finite."""
    import torch

    from rustrobotics_tpu_torch.mapping.pgo import make_optimize

    run = make_optimize(g32, num_iterations=1, backend="auto-measure",
                        tolerance=0.0, device=device)
    times = ", ".join(f"{k} {v * 1e3:.4f} ms"
                      for k, v in sorted(run.backend_times.items(),
                                         key=lambda kv: kv[1]))
    _, err, _ = run(g32)
    print(f"[auto-measure] {name}: {times}; winner {run.backend}; GN 1 "
          f"errors {err.tolist()}", flush=True)
    require(set(run.backend_times) == {"banded-direct", "banded-cr",
                                        "banded-mixed", "banded-kernel"},
            f"{name} auto-measure timed the four banded candidates")
    require(run.backend in run.backend_times
            and bool(torch.isfinite(err).all()),
            f"{name} auto-measure ran its winner, {run.backend}")
    return run.backend, run.backend_times


K12_GROUPS = {"K4 band_assemble": "band_assemble",
              "K1 panel_chol_inv": "panel_chol_inv", "K1 gemm_nt": "gemm_nt",
              "K1 trail_offdiag": "trail_offdiag",
              "K2 band_substitute": "band_substitute", "other": ""}
FLEET_GROUPS = {("K5" + k[2:] if k.startswith("K4") else k): v
                for k, v in K12_GROUPS.items()}
K3_GROUPS = {"K3 banded_matvec": "banded_matvec", "other": ""}


def trace(label, run, groups):
    """Phase 6: one run of run() under torch.profiler, after a warm-up
    run: device time by kernel group (the first group whose pattern is in
    the kernel's name) and the device's idle share of the traced window
    (first to last event). The profiler's own host cost lengthens the
    window, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    factorizations = read_counts()["factorize"]
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print(f"[trace] {label}: the profiler recorded no device events: "
              "device time by kernel and idle share not measured",
              flush=True)
        return
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    busy, end = 0.0, -math.inf
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    totals = {k: [0.0, 0] for k in groups}
    for e in dev:
        key = next(k for k, pat in groups.items() if pat in e.name)
        totals[key][0] += e.time_range.end - e.time_range.start
        totals[key][1] += 1
    print(f"[trace] {label}: window {window / 1e3:.4f} ms, device "
          f"busy {busy / 1e3:.4f} ms, idle share {1 - busy / window:.4f}",
          flush=True)
    for key, (us, count) in totals.items():
        print(f"[trace] {label}: {key}: {us / 1e3:.4f} ms in {count} "
              f"launches ({us / max(count, 1):.2f} us each)", flush=True)
    if factorizations:
        k1 = sum(c for k, (_, c) in totals.items() if k.startswith("K1"))
        us, count = totals["K1 panel_chol_inv"]
        print(f"[trace] {label}: K1 device launches per factorization "
              f"{k1 / factorizations:.2f} ({k1} in {factorizations} calls); "
              f"panel_chol_inv {us / max(count, 1):.2f} us per launch",
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    device = torch.device("cuda")

    from rustrobotics_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(cuda_lib.build, SOURCES)))
    print(f"[build] {', '.join(f'{n}.cu' for n in built)} built in "
          f"{time.perf_counter() - t_start:.2f} s (in parallel)", flush=True)

    parity_random(11, 512, device)
    p1728 = parity("corridor-1728", corridor(1728, device))
    e4 = assemble_parity("K4 (corridor-1728)", p1728["bl"],
                         p1728["vals"].float())
    parity("corridor-4096", corridor(4096, device))
    spheres64 = sphere_graphs(device)
    p3d = parity("sphere-2500", spheres64[0], SPHERE_PARITY_TOL)
    require((p3d["bl"].kb, p3d["bl"].nb) == (SPHERE_KB, SPHERE_NB),
            f"sphere-2500 band plan kb={SPHERE_KB}, nb={SPHERE_NB}")
    e4_3d = assemble_parity("K4 (sphere-2500)", p3d["bl"],
                            p3d["vals"].float())
    fp3d = fleet_parity(p3d["bl"], spheres64, "sphere-2500",
                        SPHERE_PARITY_TOL)
    k3 = k3_parity(corridor(1728, device).to(dtype=torch.float32), device)
    graphs64 = fleet_graphs(device)
    k3b = k3_fleet_parity(graphs64)
    fp = fleet_parity(p1728["bl"], graphs64)
    gn, g32, launches = main_path(device)
    cg_gn, cg_launches = cg_main_path(device, g32)
    fleet_gn, fleet, fleet_launches = fleet_path(device, graphs64)
    (gn3, g3, lm3_fleet, fleet3, launches3,
     fleet_launches3) = sphere_path(device, spheres64)
    gnc_lm, gnc_g, gnc_launches = gnc_path(device)
    fleet_cg_launches = fleet_cg_path(device, graphs64)
    marg = marginals_phase("corridor-1728", g32, device)
    marg3 = marginals_phase("sphere-2500", g3, device, blocks=False)
    backends_phase(device)
    for name, graph in (("corridor-1728", g32), ("sphere-2500", g3)):
        auto_measure_phase(name, graph, device)
    timed = times(p1728, gn, g32)
    timed["banded_matvec"] = cg_times(k3, cg_gn, g32)
    timed["banded_matvec"].update(k3_fleet_times(k3b))
    timed["assemble_b1"] = assemble_times(p1728["bl"], p1728["vals"].float())
    timed["assemble_batch"] = assemble_times(p1728["bl"], fp["vals"])
    fleet_times(fp, p1728["bl"], fleet_gn, fleet, gn, g32)
    timed3 = times(p3d, gn3, g3, "sphere-2500")
    timed3["assemble_b1"] = assemble_times(p3d["bl"], p3d["vals"].float())
    timed3["assemble_batch"] = assemble_times(p3d["bl"], fp3d["vals"])
    from rustrobotics_tpu_torch.mapping.pgo import make_optimize

    lm3 = make_optimize(g3, num_iterations=6, solver="lm",
                        backend="banded-kernel", tolerance=0.0, device=device)
    fleet_rate("LM banded-kernel, sphere-2500 f32", lm3, g3, lm3_fleet,
               fleet3, 6)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gnc_lm(gnc_g)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"[times] LM gnc-gm banded-kernel, corridor-1728-gnc f32: "
          f"{GNC_ITERS / wall:.4f} it/s ({wall / GNC_ITERS * 1e3:.4f} "
          f"ms/iteration, median of 3 runs of {GNC_ITERS})", flush=True)
    trace("GN banded-kernel, 10 iterations", lambda: gn(g32), K12_GROUPS)
    trace("GN cg-banded, 10 iterations", lambda: cg_gn(g32), K3_GROUPS)
    trace(f"GN banded-kernel fleet B={FLEET}, 10 iterations",
          lambda: fleet_gn(fleet), FLEET_GROUPS)
    trace("GN banded-kernel sphere-2500, 10 iterations", lambda: gn3(g3),
          K12_GROUPS)
    trace(f"LM banded-kernel sphere-2500 fleet B={SPHERE_FLEET}, 6 "
          f"iterations", lambda: lm3_fleet(fleet3), FLEET_GROUPS)
    trace(f"LM gnc-gm banded-kernel corridor-1728-gnc, {GNC_ITERS} "
          f"iterations", lambda: gnc_lm(gnc_g), K12_GROUPS)
    print(f"[total] {time.perf_counter() - t_start:.2f} s from the build's "
          f"start",
          flush=True)

    src = "rustrobotics_tpu_torch/csrc/band_chol.cu"
    asm = "rustrobotics_tpu_torch/csrc/band_assemble.cu"
    kernels = [
        dict(name="band_factorize_f32", route="cuda", source=src,
             replaces="rustrobotics_tpu/ops/band_chol_pallas.py:264",
             launches=launches["factorize"], max_abs_err=p1728["k1"],
             fleet_launches=fleet_launches["factorize"],
             err_measure="max|ldinv_kernel L_plain - I|, corridor-1728 at "
                         "the first LM step's damping",
             ms_measure="device ms a call, 10 calls queued back to back",
             **timed["factorize"]),
        dict(name="band_substitute_f32", route="cuda", source=src,
             replaces="rustrobotics_tpu/ops/band_chol_pallas.py:307",
             launches=launches["substitute"], max_abs_err=p1728["k2_abs"],
             fleet_launches=fleet_launches["substitute"],
             err_measure="max|x_kernel - x_plain|, corridor-1728 at the "
                         "first LM step's damping",
             ms_measure="device ms a call, 20 calls queued back to back "
                        "(L2 warm)",
             **timed["substitute"]),
        dict(name="banded_matvec_f32", route="cuda",
             source="rustrobotics_tpu_torch/csrc/banded_matvec.cu",
             replaces="rustrobotics_tpu/ops/banded.py:110",
             launches=cg_launches["banded_matvec"],
             max_abs_err=k3["err"]["max_abs_err"],
             fleet_launches=fleet_cg_launches["banded_matvec"],
             err_measure="max|y_kernel - y_plain|, corridor-1728's band "
                         "at λ=0 times its right-hand side; *_b8: the fleet "
                         "of 8's bands at the first LM step's damping",
             ms_measure="ms, plain_ms and library_ms with L2 flushed "
                        "before each call; l2_warm_ms 50 calls back to "
                        "back; *_b8 one launch for the fleet of 8, L2 "
                        "flushed",
             **timed["banded_matvec"]),
        dict(name="band_assemble_f32 (K4, B=1)", route="cuda", source=asm,
             replaces="tools/tpu_pallas_scatter_probe.py:44",
             launches=launches["assemble_b1"], max_abs_err=e4["max_abs_err"],
             err_measure="max|band_kernel - band_plain|, corridor-1728's "
                         "triplets at the first LM step's damping",
             ms_measure="ms, plain_ms and library_ms with L2 flushed "
                        "before each call; l2_warm_ms 50 calls back to back",
             **timed["assemble_b1"]),
        dict(name=f"band_assemble_f32 (K5, B={FLEET})", route="cuda",
             source=asm,
             replaces="tools/tpu_pallas_fleet_scatter_probe.py:38",
             launches=fleet_launches["assemble_batch"],
             max_abs_err=fp["e5"]["max_abs_err"],
             err_measure=f"max|band_kernel - band_plain|, the fleet of "
                         f"{FLEET}'s triplets at the first LM step's damping",
             ms_measure="ms, plain_ms and library_ms with L2 flushed "
                        "before each call; l2_warm_ms 50 calls back to back",
             **timed["assemble_batch"]),
    ]
    # the same kernels at sphere-2500's kb = 384 (K5: its fleet of 4)
    for k, err, t, count in (
            (kernels[0], p3d["k1"], timed3["factorize"],
             launches3["factorize"]),
            (kernels[1], p3d["k2_abs"], timed3["substitute"],
             launches3["substitute"]),
            (kernels[3], e4_3d["max_abs_err"], timed3["assemble_b1"],
             launches3["assemble_b1"]),
            (kernels[4], fp3d["e5"]["max_abs_err"], timed3["assemble_batch"],
             fleet_launches3["assemble_batch"])):
        k.update(kb_3d=SPHERE_KB, launches_3d=count, max_abs_err_3d=err,
                 **{f"{key}_3d": t[key] for key in
                    ("ms", "plain_ms", "bound_ms", "library_ms")})
    kernels[0]["gnc_launches"] = gnc_launches["factorize"]
    kernels[1]["gnc_launches"] = gnc_launches["substitute"]
    kernels[3]["gnc_launches"] = gnc_launches["assemble_b1"]
    # the marginals (corridor-1728 and sphere-2500) factor through K4 + K1
    kernels[0]["marginal_launches"] = (marg["launches"]["factorize"]
                                       + marg3["launches"]["factorize"])
    kernels[3]["marginal_launches"] = (marg["launches"]["assemble_b1"]
                                       + marg3["launches"]["assemble_b1"])
    for k in kernels:
        for key in ("ms", "plain_ms", "library_ms", "max_abs_err"):
            for name in (key, f"{key}_3d", f"{key}_b8"):
                if name in k and not math.isfinite(k[name]):
                    fail(f"{k['name']} {name} is not finite")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
