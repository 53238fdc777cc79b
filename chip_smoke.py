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
   K1/K2 on each graph (bit-equal expected; gated at PARITY_TOL);
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
5. times from CUDA events: each kernel, its plain version and a library
   yardstick, each beside its bound, as device time a call with the calls
   queued behind a sleep kernel (K1's and K2's back to back, L2 warm as
   in the solve; K3's, K4's and K5's with L2 flushed before each call, as
   their bounds count every byte through HBM; their L2-warm times are
   printed beside them); the stages of one GN iteration
   of each main path; GN iterations/s end to end for each, and the
   fleet's graph-iterations/s against one graph's;
6. trace: one GN run of each main path under torch.profiler, device time
   by kernel and the device's idle share; K1's device launches per
   factorization and the panel kernel's µs per launch;
7. one JSON line describing the kernels, then the contract line
   {"ok": true, "device": {...}} last.
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


def max_eye_residual(ldinv, l_fac):
    """max_j |ldinv[j] l_fac[j] - I| in f64."""
    import torch

    eye = torch.eye(ldinv.shape[-1], dtype=torch.float64, device=ldinv.device)
    return float((ldinv.double() @ l_fac.double() - eye).abs().max())


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
        solve_band_chol,
        split_blocks,
    )

    r_blocks, dinv_p = _prepare_blocks(bl, vals.float())
    dsym, lcoup = split_blocks(r_blocks)
    ld_k, lp_k = bk.factorize_kernel(dsym, lcoup)
    ld_p, lp_p = bk.factorize_plain(dsym, lcoup)
    # K2 on the plain factor, with this system's scaled right-hand side
    bp = scaled_rhs(bl, b.float(), dinv_p)
    x_k = bk.substitute_kernel(ld_p, lp_p, bp)
    x_p = bk.substitute_plain(ld_p, lp_p, bp)
    x_kern = bk.solve_band_kernel(bl, vals, b)
    x_32 = solve_band_chol(bl, vals.float(), b.float()).double()
    x_64 = solve_band_chol(bl, vals, b)
    torch.cuda.synchronize()
    return dict(
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


def parity(name, graph):
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
    require(e["finite"], f"{name} kernel outputs finite")
    require(e["lp0"] == 0.0, f"{name} K1 lp[0] == 0")
    require(e["k1"] <= PARITY_TOL["k1"],
            f"{name} K1 max|ldinv_k L_plain - I| <= {PARITY_TOL['k1']}")
    require(e["lp"] <= PARITY_TOL["lp"],
            f"{name} K1 max|lp_k - lp_plain| <= {PARITY_TOL['lp']}")
    require(e["k2"] <= PARITY_TOL["k2"],
            f"{name} K2 relative error against plain <= {PARITY_TOL['k2']}")
    require(e["solve"] <= PARITY_TOL["solve"],
            f"{name} solve_band_kernel against the plain f32 solve <= "
            f"{PARITY_TOL['solve']}")
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


def times(p, gn, g32):
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
        print(f"[times] {key}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, dense yardstick {t['library_ms']:.4f}"
              f" ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}; "
              f"{flops:.4g} FLOP, {nbytes:.4g} B), kernel/bound "
              f"{t['ms'] / t['bound_ms']:.1f}", flush=True)

    # stages of one GN iteration on the f32 main path, n = 5248
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
        print(f"[stages] {label}: {cuda_ms(fn):.4f} ms", flush=True)

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
    print(f"[times] GN banded-kernel, corridor-1728 f32: {it_s:.3f} it/s "
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
    one call of fn runs, by torch.profiler, after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


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


def scaled_rhs(bl, b, dinv_p):
    """b (..., n) permuted, padded and Jacobi-scaled: (..., nb, kb)."""
    import torch

    bp = b[..., bl.perm]
    bp = torch.cat([bp, bp.new_zeros(bp.shape[:-1] + (bl.nb * bl.kb - bl.n,))],
                   -1)
    return (bp * dinv_p).view(bp.shape[:-1] + (bl.nb, bl.kb))


def fleet_parity(bl, graphs64):
    """Phase 3 for the fleet: K5 on the fleet's λ = 0.01 triplets, then
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
        split_blocks,
    )

    vals, b, _ = system_values(stack_graphs(graphs64), LM_LAMBDA0)
    vals, b = vals.float(), b.float()
    print(f"[parity] fleet: B={FLEET}, corridor-1728 and {FLEET - 1} copies "
          f"with poses jittered by N(0, {FLEET_JITTER}²); λ={LM_LAMBDA0}; "
          f"{len(bl.sel)} kept triplets, {len(bl.uniq_idx)} band entries a "
          f"graph", flush=True)
    e5 = assemble_parity(f"K5 (B={FLEET})", bl, vals)

    r_blocks, dinv_p = _prepare_blocks(bl, vals, band_assemble_kernel)
    dsym, lcoup = split_blocks(r_blocks)
    bp = scaled_rhs(bl, b, dinv_p)
    ld_b, lp_b = bk.factorize_kernel(dsym, lcoup)
    x_b = bk.substitute_kernel(ld_b, lp_b, bp)
    k1 = lp = k2 = 0.0
    equal = True
    for i in range(FLEET):
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
    require(k1 <= PARITY_TOL["k1"] and lp <= PARITY_TOL["lp"]
            and k2 <= PARITY_TOL["k2"],
            f"batched K1/K2 against unbatched within PARITY_TOL")
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

    walls = {1: [], FLEET: []}
    for run, arg, key in ((gn_one, g32, 1), (gn_fleet, fleet, FLEET)):
        run(arg)
    torch.cuda.synchronize()
    for _ in range(5):
        for run, arg, key in ((gn_one, g32, 1), (gn_fleet, fleet, FLEET)):
            t0 = time.perf_counter()
            run(arg)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
    rate = {k: k * 10 / statistics.median(w) for k, w in walls.items()}
    print(f"[times] GN banded-kernel, corridor-1728 f32, graph-iterations/s:"
          f" B={FLEET} fleet {rate[FLEET]:.4f} ({statistics.median(walls[FLEET]) / 10 * 1e3:.4f}"
          f" ms a fleet iteration), B=1 {rate[1]:.4f} "
          f"({statistics.median(walls[1]) / 10 * 1e3:.4f} ms an iteration);"
          f" ratio {rate[FLEET] / rate[1]:.4f} (median of 5 runs of 10 "
          f"iterations each, in turns)", flush=True)


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

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(cuda_lib.build, SOURCES)))
    print(f"[build] {', '.join(f'{n}.cu' for n in built)} built in "
          f"{time.perf_counter() - t0:.2f} s (in parallel)", flush=True)

    parity_random(11, 512, device)
    p1728 = parity("corridor-1728", corridor(1728, device))
    e4 = assemble_parity("K4 (corridor-1728)", p1728["bl"],
                         p1728["vals"].float())
    parity("corridor-4096", corridor(4096, device))
    k3 = k3_parity(corridor(1728, device).to(dtype=torch.float32), device)
    graphs64 = fleet_graphs(device)
    fp = fleet_parity(p1728["bl"], graphs64)
    gn, g32, launches = main_path(device)
    cg_gn, cg_launches = cg_main_path(device, g32)
    fleet_gn, fleet, fleet_launches = fleet_path(device, graphs64)
    timed = times(p1728, gn, g32)
    timed["banded_matvec"] = cg_times(k3, cg_gn, g32)
    timed["assemble_b1"] = assemble_times(p1728["bl"], p1728["vals"].float())
    timed["assemble_batch"] = assemble_times(p1728["bl"], fp["vals"])
    fleet_times(fp, p1728["bl"], fleet_gn, fleet, gn, g32)
    trace("GN banded-kernel, 10 iterations", lambda: gn(g32), K12_GROUPS)
    trace("GN cg-banded, 10 iterations", lambda: cg_gn(g32), K3_GROUPS)
    trace(f"GN banded-kernel fleet B={FLEET}, 10 iterations",
          lambda: fleet_gn(fleet), FLEET_GROUPS)

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
             err_measure="max|y_kernel - y_plain|, corridor-1728's band "
                         "at λ=0 times its right-hand side",
             ms_measure="ms, plain_ms and library_ms with L2 flushed "
                        "before each call; l2_warm_ms 50 calls back to back",
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
    for k in kernels:
        for key in ("ms", "plain_ms", "library_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                fail(f"{k['name']} {key} is not finite")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
