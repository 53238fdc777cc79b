#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rustrobotics_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; any failure ends the script with a non-zero exit code:

1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels from csrc/ with nvcc;
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
   at f32's edge (the 1e7 gauge prior); its errors are printed only;
4. main path: make_optimize(backend="banded-kernel") on corridor-1728 in
   f32, Gauss-Newton 10 iterations and Levenberg-Marquardt 6, held to
   the χ² trace of the f64 reference and to the plain banded-direct trace;
   both kernels' launch counters must move during this run;
5. times from CUDA events (median of 7 after warm-up): each kernel, its
   plain version and a dense-solve yardstick, each beside its bound; the
   stages of one GN iteration; GN iterations/s end to end;
6. trace: one GN run under torch.profiler, device time by kernel and the
   device's idle share;
7. one JSON line describing the kernels, then the contract line
   {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

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
    bp = torch.cat([b.float()[bl.perm],
                    b.new_zeros(bl.nb * bl.kb - bl.n, dtype=torch.float32)])
    bp = (bp * dinv_p).view(bl.nb, bl.kb)
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
    from rustrobotics_tpu_torch.ops import band_chol_kernels as bk

    g32 = corridor(1728, device).to(dtype=torch.float32)
    gn = make_optimize(g32, num_iterations=10, backend="banded-kernel",
                       tolerance=0.0, device=device)
    lm = make_optimize(g32, num_iterations=6, solver="lm",
                       backend="banded-kernel", tolerance=0.0, device=device)
    for key in bk.LAUNCHES:
        bk.LAUNCHES[key] = 0
    _, err_gn, it_gn = gn(g32)
    _, err_lm, it_lm = lm(g32)
    torch.cuda.synchronize()
    launches = dict(bk.LAUNCHES)

    direct = make_optimize(g32, num_iterations=10, backend="banded-direct",
                           tolerance=0.0, device=device)
    _, err_direct, _ = direct(g32)
    err_gn = err_gn.double().cpu()
    err_lm = err_lm.double().cpu()
    err_direct = err_direct.double().cpu()
    print(f"[main] GN banded-kernel   {err_gn.tolist()}", flush=True)
    print(f"[main] GN banded-direct   {err_direct.tolist()}", flush=True)
    print(f"[main] LM banded-kernel   {err_lm.tolist()}", flush=True)
    print(f"[main] launches during the main path: {launches}", flush=True)
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
    for key in ("factorize", "substitute"):
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
    out["factorize"] = dict(
        ms=cuda_ms(lambda: bk.factorize_kernel(dsym, lcoup)),
        plain_ms=cuda_ms(lambda: bk.factorize_plain(dsym, lcoup)),
        library_ms=cuda_ms(lambda: torch.linalg.cholesky(hs)),
        bound_ms=k1_bound, bound_by=k1_by)
    out["substitute"] = dict(
        ms=cuda_ms(lambda: bk.substitute_kernel(ld_p, lp_p, bp)),
        plain_ms=cuda_ms(lambda: bk.substitute_plain(ld_p, lp_p, bp)),
        library_ms=cuda_ms(lambda: torch.cholesky_solve(b_dense, l_dense)),
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
        "band assembly (_prepare_blocks)":
            lambda: _prepare_blocks(bl, vals32),
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


def trace(gn, g32):
    """Phase 6: one GN run of 10 iterations under torch.profiler, after a
    warm-up run: device time by kernel and the device's idle share of the
    traced window (first to last event). The profiler's own host cost
    lengthens the window, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gn(g32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gn(g32)
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("[trace] the profiler recorded no device events: device time "
              "by kernel and idle share not measured", flush=True)
        return
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    busy, end = 0.0, -math.inf
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    groups = {"K1 panel_chol_inv": "panel_chol_inv", "K1 gemm_f32": "gemm_f32",
              "K2 band_forward": "band_forward",
              "K2 band_backward": "band_backward", "other": ""}
    totals = {k: [0.0, 0] for k in groups}
    for e in dev:
        key = next(k for k, pat in groups.items() if pat in e.name)
        totals[key][0] += e.time_range.end - e.time_range.start
        totals[key][1] += 1
    print(f"[trace] GN 10 iterations: window {window / 1e3:.4f} ms, device "
          f"busy {busy / 1e3:.4f} ms, idle share {1 - busy / window:.4f}",
          flush=True)
    for key, (us, count) in totals.items():
        print(f"[trace] {key}: {us / 1e3:.4f} ms in {count} launches "
              f"({us / max(count, 1):.2f} us each)", flush=True)


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
    cuda_lib.build("band_chol")
    print(f"[build] band_chol.cu built in {time.perf_counter() - t0:.2f} s",
          flush=True)

    parity_random(11, 512, device)
    p1728 = parity("corridor-1728", corridor(1728, device))
    parity("corridor-4096", corridor(4096, device))
    gn, g32, launches = main_path(device)
    timed = times(p1728, gn, g32)
    trace(gn, g32)

    src = "rustrobotics_tpu_torch/csrc/band_chol.cu"
    kernels = [
        dict(name="band_factorize_f32", route="cuda", source=src,
             replaces="rustrobotics_tpu/ops/band_chol_pallas.py:264",
             launches=launches["factorize"], max_abs_err=p1728["k1"],
             err_measure="max|ldinv_kernel L_plain - I|, corridor-1728 at "
                         "the first LM step's damping",
             **timed["factorize"]),
        dict(name="band_substitute_f32", route="cuda", source=src,
             replaces="rustrobotics_tpu/ops/band_chol_pallas.py:307",
             launches=launches["substitute"], max_abs_err=p1728["k2_abs"],
             err_measure="max|x_kernel - x_plain|, corridor-1728 at the "
                         "first LM step's damping",
             **timed["substitute"]),
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
