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
   K1/K2 on each graph (bit-equal expected; gated at PARITY_TOL). K1 on a
   fleet of K1_FLEET = 32 (corridor-1728 and 31 jittered copies; the robust
   fleet cell's kb 512 and B, where K1 takes strips of 64 rows, which it
   must report): against factorize_plain at PARITY_TOL, each graph bit-equal
   to the unbatched K1 (32-row strips), K1_WORK as k1_work counts it, one
   launch a call.
   The same for sphere-2500 (sphere_graph: sphere2500's shape, 2500 SE3
   poses, 4949 edges, n=15000, kb=384, nb=40): K1, K2 and the solve at
   λ = 0.01 (SPHERE_PARITY_TOL), K4 on its triplets, K5 and batched K1/K2
   on its fleet of SPHERE_FLEET (the graph and jittered copies). K3 over
   the fleet of 8's bands at λ = 0.01: one launch bit-equal to eight
   one-graph calls, and within K3_ULPS of the plain version.
   L1 (SE2 linearization) on corridor-1728 in f32 at λ = 0 and on the
   fleet of 8 in f32 with a λ a row (LM_LAMBDA0 2^k): system_values on the
   kernel path against system_values_plain on the same inputs, vals bit
   for bit, b within L1_RHS_ULPS max_degree f32 units of each dof's sum of
   |parts| and bit-equal to the plain version's plan-order gather, χ²
   within L1_CHI2_RTOL, the same bits on a second call, one LAUNCHES count
   a call, two device operations a call (torch.profiler). The robust L1
   (se2_edge_terms_gnc) the same way on corridor-1728-gnc and on the fleet
   of 8 with its false closures, under gnc-gm at μ0, at μ halfway and at
   μ = 1 (device tensors, as the LM loops pass μ) and at a number μ with
   δ = GNC_NUMBER_DELTA. LC (se2_lm_cost, LM's accept test) against its
   plain version (se2_cost_plain) within LC_RTOL on corridor-1728 by least
   squares and on corridor-1728-gnc and its fleet under gnc-gm, at μ
   halfway and at the number μ: the same bits on a second call, equal sums
   for equal graphs, one LAUNCHES count and one device operation a call.
   Every parity call's counters are set to 0 just before it;
4. main paths, each with every launch counter set to 0 just before it and
   read just after:
   a. make_optimize(backend="banded-kernel") on corridor-1728 in f32,
      Gauss-Newton 10 iterations and Levenberg-Marquardt 6, held to the χ²
      trace of the f64 reference and to the plain banded-direct trace;
      K4's, K1's and K2's counters must move, L1's once an iteration;
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
      and one K1, one K2 and one L1 launch per fleet iteration, and no
      plain scatter;
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
   j. bootstrap: corridor-1728 with every pose zeroed, GN 10 on
      banded-kernel without initialization (printed), then
      chordal_init_se2 and GN 10; sphere-2500 with identity poses,
      chordal_init_se3 and LM 6; f32 on the card. The chordal graphs on
      the card, their |pose| column sums within CHORDAL_RTOL of the JAX f64
      run's, their χ² below CHORDAL_CHI2_MAX, GN errors[10] < 1e-2, the
      sphere's LM within BOOT_LM_FACTOR of its own LM run; the host seconds
      of each chordal call printed; K4's, K1's and K2's counters must move;
   k. posegraph: corridor-1728 and sphere-2500 written as g2o files; the
      native parser (no fallback) bit-equal to the Python one; PoseGraph(
      path).optimize(10, backend="banded-kernel") in f32 against optimize
      on the same graph (PARITY_TOL["solve"] on entries above 1),
      corridor-1728's iteration 10; K4, K1 and K2 launch;
   l. fixed-lag: the circle session of the fixed-lag tests, FL_STEPS steps
      through W=FL_WINDOW, C=FL_CAPACITY, a closure at each revisit, f32
      on the card against f64 on the CPU (FL_POSE_TOL at every step), RMSE
      against dead reckoning (FL_RMSE_FACTOR), every state tensor on the
      card; device launches per advance and the idle share printed (its
      steps/s is the bench phase's fixed_lag_w32 row);
   m. frontend: a synthetic SLAM-course log (FE_POSES poses along
      corridor-1728's path, FE_LANDMARKS landmarks) loaded, built into a
      graph by build_pose_graph_from_slam_course, LM FE_ITERS on
      banded-kernel in f32: a band plan; errors[-1] < errors[0] / 2, as
      the JAX package's test holds it, and the final graph's χ² within
      FE_FINAL_RTOL of banded-direct's; K4, K1 and K2 launch; landmark
      errors and LM it/s printed. K1's pivots on a band that does not move:
      banded-direct LM FE_ITERS in f64 on the CPU in one thread
      (frontend_gate_graph, in a third worker process from the start: the
      same bits every run), cast to f32, through system_values and K4
      on the card at λ = FE_BREAK_LAM, built twice with equal SHA-256;
      that band is indefinite as f32 rounds it, so the gate (pivot_gate)
      holds K1 and the plain chain to every pivot, and K1 within
      FE_K1_TOL of the plain chain, on the block rows before r64, the
      first row where the f64 chain on the same f32 band breaks down (r64
      >= 1 required; the rows from r64 on are printed); then the same on
      that graph's band at λ = LM_LAMBDA0, gated whole where the f64 chain
      keeps every pivot;
   the filters, on a UTIAS MRCLE-shaped dataset from write_utias (15
   landmarks and 5 robots keyed by barcode, a 15 m x 8 m arena,
   groundtruth at 100 Hz, odometry at ~67 Hz, measurement groups of 1-6
   sightings with other robots' barcodes among them, epoch stamps near
   1.25e9 s, more than 10,000 merged events); they run none of K1-K5,
   whose counters are printed around them. Their CPU f64 references
   (cpu_references) run in a worker process from the script's start:
   n. filters-sim: run_simulation ekf, ukf and pf (SIM_TIME s at dt 0.1,
      SIM_PARTICLES particles): f64 on the card against f64 on the CPU on
      the same numpy draws, and the entry point in f32 on the card held to
      the JAX tests' RMSE bounds; steps/s;
   o. landmarks: run_utias_localization, LM_EVENTS events: EKF f64 (event
      for event against the CPU f64 run) and f32, both ATEs below
      LM_ATE_MAX, UKF f64 and PF f64 (LM_PARTICLES); events/s, device
      launches per event and the idle share of a traced replay, and no
      host read in the EKF and PF replays (CUDA sync debug mode);
   p. fleet: run_utias_localization_fleet, bank FLEET_BANK, LM_EVENTS
      events, f32: every row finite, FLEET_ROWS rows against the unbanked
      EKF-KC (f64, CPU) from their initial states, and those rows through
      the banked path in f64 on the card; events/s, filter-updates/s,
      launches per event, idle share, no host read;
   q. banked: simple_problem_banked (B = BANKED_EKF_B) and
      simple_problem_banked_ukf (B = BANKED_UKF_B), BANKED_STEPS chained
      steps in f32 at the JAX package's benchmark settings, columns
      against the unbanked filters (f64, CPU); Mupdates/s; the banked
      UKF-KC fleet (UKF_FLEET_B, UKF_FLEET_EVENTS events) against UKF-KC
      rows;
   r. filters-extra: the parallel Kalman filter and RTS smoother against
      the sequential ones at T = SCAN_T (f64), the EIF-KC on EIF_EVENTS
      events against the CPU run and the EKF-KC, the histogram filter on
      a HIST_GRID grid over HIST_EVENTS events against the CPU run;
   the SLAM families, vision and control; they run none of K1-K5, whose
   counters are printed around them, and their CPU f64 references
   (slam_references) run in a second worker process from the start:
   s. scan-matching: the JAX loop-closure test's room (±6 m walls, two
      pillars) at its size, SCAN_TEST_STEPS scans of SCAN_TEST_BEAMS
      beams, f32, with its gates (odometry leaves the loop open > 1 m,
      scan_matching_slam_pgo closes it < 0.1 m, mean drift within 1.05x
      odometry's); then a 2D lidar's width, SCAN_BEAMS beams, SCAN_STEPS
      scans on SCAN_LAPS laps, a SCAN_GRID² grid at SCAN_RES m: ms an ICP
      alignment, icp_odometry scans/s, closures, the pipeline's seconds,
      occupancy scans/s, the map's free interior and occupied wall;
      icp_odometry in f64 on the first scans, card against CPU;
   t. ekf-slam: the JAX EKF-SLAM tests' gates on their simulation in f32
      (known and unknown correspondences; Schmidt in f64, its f32 reading
      printed); run_slam_course f64 and f32 on the front end's log and on
      one of SLAM_BIG_LANDMARKS landmarks (events/s, map error), f64 held
      to the CPU over the first SLAM_EKF_PARITY events; step_unknown
      (ids hidden) and schmidt_step (half the slots consider states);
      device launches per event, idle share, no host read in a replay;
   u. fastslam: run_slam_course_fastslam versions 1 and 2 at
      FS_PARTICLES particles, f32 (events/s, map error); both in f64 on
      FS_SEED's draws, card against CPU event for event up to the first
      resample whose rows differ; fastslam_step_unknown over
      FS_UNKNOWN_EVENTS events; the JAX FastSLAM 2.0 test's gate on its
      keys' draws (tests/data/fastslam2_gate_draws.npz), FS2_SEEDS other
      seeds printed; launches per event, idle share, no host read;
   v. vision: Zhang on VIS_VIEWS views of OpenCV's 9 x 6 chessboard with
      radial distortion, DLT on VIS_DLT_POINTS points, PnP RANSAC
      (VIS_PNP_HYPOTHESES hypotheses, VIS_PNP_POINTS points, 30%
      outliers), triangulation of VIS_TRI_POINTS points in VIS_TRI_VIEWS
      views, bundle adjustment at BAL Ladybug-49's shape (LM BA_ITERS):
      ms a call in f32 and f64, the JAX vision tests' gates on the f32
      run, f64 against the CPU, the BA's RMS trace;
   w. control: the pendulum's DARE against scipy, the LQR closed loop,
      simulate_inverted_pendulum's settling (f32, f64), an LQG rollout of
      LQG_STEPS steps in f64 against the CPU on the same draws;
   the distributed tier and the measurement layer (none of K1-K5 runs on
   them; the counters are printed around the parallel phase):
   x. parallel: an NCCL process group of world size 1 (one H100: NCCL
      takes a card a rank); distributed_optimize GN PAR_GN_ITERS and LM
      PAR_LM_ITERS on corridor-1728 in f64 (cg_tol 1e-10) held to GN_CHI2
      and to the single-device optimize(backend="cg") runs; both sharded
      PF steps on PF_PARTICLES particles, PF_STEPS steps: gather and
      bounded equal to a single-device systematic resampling on the same
      draws in f64 (in f32 within PF_F32_FLIP_SHARE of the rows), 0 ring
      rounds; s an iteration, PCG rounds a solve, steps/s and
      Mparticles/s (f32) printed;
   y. aux: utils.devtime.time_scalar_program against CUDA events on one
      program (AUX_TIMING_RTOL), utils.debug.checked catching a NaN made
      on the card, a checkpoint of card tensors restored on the card;
   z. blocks: the map-block optimizer (parallel.pgo_blocks) on an NCCL
      group of world size 1 (D = 1: no halo traffic): corridor-100k
      (BLK_POSES poses, >= 100k dof) GN BLK_GN with Jacobi and Schwarz in
      f64 (errors[-1] < errors[0] x BLK_DROP, finite) and in f32 at the
      CLI's cg_tol; corridor-1728 f64 GN (single and classic CG), LM and
      Schur held to optimize(backend="cg"); elastic (segments of
      BLK_SEGMENT, interrupted and resumed) held to the GN run; s a GN
      iteration, CG rounds a GN iteration, ms of the run a CG round,
      comm_budget; one GN iteration under the profiler (device launches
      a CG round, idle share); then cli: `python -m
      rustrobotics_tpu_torch.cli pgo --distributed 1` on corridor-1728
      with noisy measurements as a g2o file in a subprocess, its χ²
      against the same command in-process and both against
      optimize(backend="cg") on the same file, and `cli doctor`; K1-K5
      launch 0 times in both;
   the benchmark entry:
   bench. `python -m rustrobotics_tpu_torch.cli bench --suite-out` in a
      subprocess on a dataset root without intel.g2o: its last line
      parses (synthetic1728), banded-kernel ran in its race, the chosen
      backend's χ² trace falls, its MFU is in (0, 1.05], the suite file
      holds rows and no error, the repo's BENCH_SUITE.json is unchanged;
      then in-process on a dataset root of corridor-1728, sphere-2500 (g2o
      files) and a write_utias set, the counters set to 0 around each
      family: graph_slam (banded-kernel and banded-direct; K4, K1 and K2
      once a banded-kernel GN iteration, the kernel's χ² trace within
      PARITY_TOL["solve"] of banded-direct's), pgo_batch (the fleet of 8;
      K5 once a fleet iteration, K1 and K2 once an iteration), the fleet
      replay, and on an NCCL group of world size 1 the sharded PF, the
      block scaling, entry() and dryrun_multichip(1); every row printed
      beside the card's name and power limit;
   phases v and s also feed the repaired non-finite paths: one NaN pixel
   in the VIS_TRI_POINTS triangulation (its point NaN, the rest as the
   clean run's) and ICP with a NaN point (R, t, rmse NaN, no error);
5. times from CUDA events: each kernel, its plain version and a library
   yardstick, each beside its bound, as device time a call with the calls
   queued behind a sleep kernel (K1's and K2's back to back, L2 warm as
   in the solve; K3's, K4's and K5's with L2 flushed before each call, as
   their bounds count every byte through HBM; their L2-warm times are
   printed beside them); the stages of one GN iteration
   of each main path; GN iterations/s end to end for each (and the
   banded-kernel GN's MFU from roofline.pgo_iteration_flops), and the
   fleets' graph-iterations/s against one graph's; K1 on its fleet of 32;
   K1, K2, K4 and K5 again at sphere-2500's kb = 384; L1 on corridor-1728 and the fleet of 8 (calls
   queued back to back) beside system_values_plain and its bound, and the
   host's time a call of both; the robust L1 on the gnc fleet of 8 at μ
   halfway, and LC on corridor-1728-gnc and that fleet, the same way;
6. trace: one GN run of each main path under torch.profiler (cg-banded
   and sphere-2500 GN of TRACE_SHORT_ITERS iterations), device time by
   kernel and the device's idle share; K1's device launches per
   factorization and the panel kernel's µs per launch;
7. one JSON line describing the kernels (K1, K2, K4 and K5 with their
   kb = 384 readings under *_3d keys, K3 with its fleet-of-8 readings
   under *_b8 keys; K1 with its fleet of 32's readings under *_b32 keys;
   K1, K2 and K4 with the launches of phases j, k and m
   under bootstrap_launches, posegraph_launches and frontend_launches,
   and every kernel with filters_launches, slam_launches,
   parallel_launches, blocks_launches and cli_launches, 0: the filter,
   SLAM, vision, control, parallel, blocks and cli phases run none; and
   bench_launches, the in-process families of the bench phase; L1 with its
   fleet of 8's readings under *_b8 keys, its robust form's under
   max_abs_err_gnc and *_gnc_b8 keys, and the launches of every phase; LC
   with its readings on corridor-1728-gnc, its fleet's under *_b8 keys and
   the launches of every phase), then the contract line {"ok": true,
   "device": {...}} last.
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
# K1's fleet at the robust fleet cell's shape (kb 512, B 32), where K1
# takes strips of 64 rows: the same corridor-1728 and jittered copies.
K1_FLEET = 32

SOURCES = ("band_chol", "banded_matvec", "band_assemble", "se2_linearize")

# L1 (the SE2 linearization) against the plain CUDA path on the same f32
# inputs: vals bit for bit (the same f32 operations in the same order); each
# dof of b within L1_RHS_ULPS * max_degree f32 units of its sum of |parts|
# (the plain path's atomic index_add_ and L1's plan-order gather add the
# same at most max_degree parts in two orders, each within max_degree
# units of the exact sum); χ² within L1_CHI2_RTOL (a fixed tree against
# torch.sum's order: the H100 read 0 on corridor-1728 and 6.3e-8 on a
# landmark graph).
L1_RHS_ULPS, L1_CHI2_RTOL = 2, 1e-5
# The robust L1 (se2_edge_terms_gnc, robust="gnc-gm") is held to the same
# limits, b's units taken from each dof's sum of weighted |parts|: at GNC's
# μ0, at μ halfway and at μ = 1, device tensors as the LM loops pass μ, and
# at a number μ with δ = GNC_NUMBER_DELTA (pgo.optimize's form, whose
# weights form s = (μ δ) δ in double). LC (se2_lm_cost, LM's accept test)
# against its plain version: Σ e^T Ω e and Σ ρ_μ within LC_RTOL (a fixed
# order against torch.sum's, as L1's χ²).
GNC_NUMBER_DELTA, LC_RTOL = 1.5, 1e-5
# LC's operations an edge of a graph costed, counted from edge_cost in
# csrc/se2_linearize.cu, a sine or cosine as one: the residual, W e, e^T W e,
# ρ and the two running sums.
LC_FLOPS_PP, LC_FLOPS_PL = 52, 27

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
# The front-end cell's synthetic SLAM-course log (write_slam_course): a
# landmark is sighted from the poses within SLAM_SIGHT_RADIUS metres; noise
# σ on each odometry component and on range and bearing.
SLAM_SIGHT_RADIUS, SLAM_ODOM_NOISE, SLAM_MEAS_NOISE = 5.0, 0.01, 0.05
# write_utias: UTIAS MRCLE's shape. Robots 1-5 and landmarks 6-20 carry
# MRCLE's barcode numbers; a 15 m x 8 m arena; epoch stamps near 1.25e9 s.
UTIAS_ROBOT_BARCODES = (5, 14, 41, 32, 23)
UTIAS_LANDMARK_BARCODES = (72, 27, 54, 70, 36, 18, 25, 9, 81, 16, 90, 61,
                           45, 7, 63)
UTIAS_ARENA, UTIAS_MARGIN, UTIAS_T0 = (15.0, 8.0), 1.0, 1248272262.0
UTIAS_STEP, UTIAS_DURATION = 1e-3, 160.0  # path integration step, seconds
UTIAS_SIGHT, UTIAS_ODOM_NOISE, UTIAS_MEAS_NOISE = 6.0, 0.01, 0.03
BACKEND_RUNS = ("banded-cr", "banded-mixed high", "banded-mixed bf16",
                "schur", "native")

# bootstrap: corridor-1728 with every pose zeroed and sphere-2500 with every
# pose the identity, through chordal initialization. The measurements are
# exact, so the JAX package's f64 chordal graphs are the optimum up to
# rounding: χ² 4.2749913158065936e-19 (2D) and 5.301641884414783e-22 (3D),
# which no f32 graph can be held to relatively. The chordal result is held
# instead to the JAX f64 run's column sums of |poses| (and of |landmarks|),
# within CHORDAL_RTOL, and its f32 χ² to CHORDAL_CHI2_MAX (the corridor's
# errors[10] gate).
CHORDAL_CHI2_2D, CHORDAL_CHI2_3D = 4.2749913158065936e-19, 5.301641884414783e-22
CHORDAL_SUMS_2D = (742339.1795735484, 74458.27784810352, 175.6049604980097)
CHORDAL_LM_SUMS_2D = (13744.274877429358, 1335.4930475857905)
CHORDAL_SUMS_3D = (10120.446184907902, 10155.324641866046, 24999.999999993062,
                   1028.7054318460932, 996.8849158923207, 1028.7054318460928,
                   996.8849158923215)
CHORDAL_RTOL, CHORDAL_CHI2_MAX = 1e-4, 1e-2
# sphere-2500's LM 6 from its chordal graph ends within BOOT_LM_FACTOR x
# the χ² that LM 6 reaches from sphere-2500's own initial guess (both at
# f32's floor, ~1e-6 in the port on the CPU), or below BOOT_LM_FLOOR.
BOOT_LM_FACTOR, BOOT_LM_FLOOR = 10.0, 1e-5
# fixed-lag: the circle session (circle_data) of FL_STEPS steps through a
# window of FL_WINDOW poses and FL_CAPACITY closure slots, a closure at
# each revisit; f32 on the card against f64 on the CPU through the port
# (FL_POSE_TOL: ~25x the port's f32 reading on the CPU, 4.1e-4).
FL_STEPS, FL_WINDOW, FL_CAPACITY, FL_CIRCLE = 400, 32, 16, 12
FL_TRACED = 2 * FL_WINDOW  # steps of the profiled session
FL_POSE_TOL = 1e-2
# tests/test_fixed_lag.py holds the RMSE below dead reckoning's / 2.5 at
# W = 16, C = 8. At W = 32 the JAX package's smoother itself lands between
# dead reckoning and that factor over these 400 steps, and the port equals
# it pose for pose (tests/test_torch_fixed_lag.py::
# test_window32_session_matches_jax, f64 on the CPU), so the factor is held
# on a W = 16, C = 8 session of the same steps, and the W = 32 session
# must beat dead reckoning.
FL_RMSE_FACTOR, FL_TEST_WINDOW, FL_TEST_CAPACITY = 2.5, 16, 8
# front end: the synthetic SLAM-course log (slam_course_world, numpy
# default_rng(0)), LM FE_ITERS on banded-kernel in f32.
FE_POSES, FE_LANDMARKS, FE_ITERS = 1728, 32, 30
# The final graph's χ² against banded-direct's on the card (1034.1196 and
# 1034.1156 on the H100, PERF.md § 6).
FE_FINAL_RTOL = 1e-3
# K1 against the plain chain on the front end's band at the damping where
# an earlier K1 lost pivots (LM step 10: λ = 0.01 / 2^9): max|ldinv_kernel
# L_plain - I| over the block rows read 2.3e-3 to 6.5e-3 on the H100.
# That band is indefinite as f32 rounds it (the f64 chain on the f32 band
# breaks down from some block row r64), and past r64 no factorization
# exists for a chain to keep: pivot_gate holds the rows before it.
FE_BREAK_LAM, FE_K1_TOL = 0.01 / 2 ** 9, 5e-2
# The filters. filters-sim: run_simulation's episode (SIM_TIME s at dt
# 0.1), the PF with SIM_PARTICLES particles, numpy draws from SIM_SEED;
# the f32 runs held to tests/test_filters.py's RMSE bounds (the EKF also
# below dead reckoning's). landmarks: write_utias(seed 0), LM_EVENTS
# merged events, ATE below tests/test_data.py's 0.3 m. fleet: bank
# FLEET_BANK (the entry point's default), FLEET_ROWS rows held to the
# unbanked EKF-KC from their initial states. banked: the JAX package's
# benchmark settings (benchmarks.py: B = 65536 EKF, B = 32768 UKF, 100
# chained steps); the UKF-KC fleet of UKF_FLEET_B on UKF_FLEET_EVENTS.
# filters-extra: the Kalman scan at T = SCAN_T, the EIF-KC on EIF_EVENTS
# events, the histogram filter on a HIST_GRID grid over HIST_EVENTS events.
SIM_TIME, SIM_PARTICLES, SIM_SEED = 50.0, 300, 0
SIM_RMSE_MAX = {"ekf": 0.5, "ukf": 0.5, "pf": 0.7}
LM_EVENTS, LM_PARTICLES, LM_ATE_MAX = 10000, 300, 0.3
FLEET_BANK, FLEET_ROWS, FLEET_SPREAD = 1024, 8, 0.1
BANKED_EKF_B, BANKED_UKF_B, BANKED_STEPS = 65536, 32768, 100
UKF_FLEET_B, UKF_FLEET_EVENTS = 1024, 1000
SCAN_T, EIF_EVENTS, HIST_EVENTS, HIST_GRID = 4096, 2000, 100, (64, 64, 36)
FLEET_F64_EVENTS = 2000  # the fleet's rows in f64 on the card
SCAN_SYSTEM_SEED = 3  # numpy seed of the Kalman scan's observations
TRACE_EVENTS = 100  # events of a replay under torch.profiler
TRACE_SHORT_ITERS = 3  # GN iterations of the cg-banded and sphere traces
# Limits (max |difference|, headings wrapped), about 10x the first card
# readings (NVIDIA H100 80GB HBM3, 700.00 W), in brackets. The f32 fleet
# rows drift from f64 by the single filter's own f32 drift (centimetres:
# phase landmarks prints the EKF-KC's f32 run against its f64 run).
FILTER_TOL = {
    "sim_f64": 2e-11,       # card f64 against CPU f64, same draws [1.5e-12]
    "lm_f64": 1e-7,         # EKF-KC, card f64 against CPU f64 [8.0e-9]
    "fleet_rows": 2.0,      # fleet f32 rows against the f64 EKF-KC [0.18]
    "fleet_f64": 4e-8,      # the same rows in f64 on the card [3.4e-9]
    "banked_ekf": 1.5e-5,   # f32 columns, f64 unbanked EKF [1.2e-6]
    "banked_ukf": 1.5e-5,   # the same, UKF at alpha 1 [1.1e-6]
    "ukf_fleet_f64": 5e-8,  # UKF-KC fleet rows in f64 on the card [4.4e-9]
    "scan": 1e-14,          # parallel (card) against sequential (CPU) [1.1e-15]
    "eif_f64": 5e-9,        # EIF-KC card f64 against CPU f64 [5.3e-10]
    "eif_ekf": 1e-4,        # EIF-KC against EKF-KC, both f64 [8.6e-6]
    "hist": 1e-15,          # histogram belief, card against CPU [6.2e-17]
}

# The SLAM families, vision and control. scan-matching: the room of the JAX
# package's loop-closure test (±SCAN_HALF m walls, two pillars), the robot
# on a circle of radius SCAN_RADIUS facing along it; the test's own size
# (SCAN_TEST_STEPS scans of SCAN_TEST_BEAMS beams, one lap), then a 2D
# lidar's width (SCAN_BEAMS beams over 360 degrees, SCAN_STEPS scans on
# SCAN_LAPS laps) mapped into a SCAN_GRID x SCAN_GRID grid at SCAN_RES m.
SCAN_HALF, SCAN_RADIUS, SCAN_MAX_RANGE = 6.0, 2.0, 20.0
SCAN_PILLARS = ((3.0, -2.0, 0.8), (-2.5, 3.5, 0.5))
SCAN_TEST_STEPS, SCAN_TEST_BEAMS = 36, 240
SCAN_STEPS, SCAN_BEAMS, SCAN_LAPS = 144, 720, 2
SCAN_GRID, SCAN_RES, SCAN_PARITY_SCANS = 400, 0.05, 10
# ekf-slam / fastslam: the front end's SLAM-course log (FE_LANDMARKS
# landmarks) and one of SLAM_BIG_LANDMARKS landmarks along the same path;
# SLAM_SPARE_SLOTS more slots for unknown correspondences. FastSLAM at
# FS_PARTICLES (run_slam_course_fastslam's default), numpy draws from
# FS_SEED for the f64 parity; the JAX FastSLAM 2.0 test's simulation on
# its keys' draws and on FS2_SEEDS numpy seeds.
SLAM_BIG_LANDMARKS, SLAM_SPARE_SLOTS = 256, 8
# run_slam_course's covariance turns indefinite on the corridor log from
# about event 120, in the JAX package too (tests/test_torch_slam_replay.py
# pins it); from there f64 runs on two machines part. The card is held to
# the CPU over the first SLAM_EKF_PARITY events.
SLAM_EKF_PARITY = 100
FS_PARTICLES, FS_SEED, FS_UNKNOWN_EVENTS, FS2_SEEDS = 256, 0, 200, 2
FS_F64_EVENTS = 400  # events of the f64 card-against-CPU replay
# vision: the JAX vision tests' camera K; OpenCV's 9 x 6 chessboard in
# VIS_VIEWS views; DLT, PnP RANSAC and triangulation at the sizes below;
# bundle adjustment at BAL Ladybug-49's shape (49 cameras, 7,776 points,
# 31,843 observations), LM BA_ITERS. control: an LQG rollout of LQG_STEPS.
VIS_K = np.array([[800.0, 2.0, 320.0], [0.0, 780.0, 240.0], [0.0, 0.0, 1.0]])
VIS_SEED, VIS_VIEWS, VIS_SQUARE, VIS_PIXEL_NOISE = 0, 15, 0.025, 0.05
VIS_K1, VIS_K2 = -0.25, 0.08
VIS_DLT_POINTS, VIS_PNP_POINTS, VIS_PNP_OUTLIERS = 100, 1000, 0.3
VIS_PNP_HYPOTHESES, VIS_TRI_POINTS, VIS_TRI_VIEWS = 256, 10000, 5
BA_CAMERAS, BA_POINTS, BA_OBSERVATIONS, BA_ITERS = 49, 7776, 31843, 20
LQG_STEPS, LQG_SEED = 1000, 0
# Card f64 against CPU f64 on the same inputs and draws (max |diff|;
# vision: relative to max(1, |CPU result|)); about 10x the first card
# readings (NVIDIA H100 80GB HBM3, 700.00 W), in brackets.
SLAM_TOL = {
    "scan_f64": 1e-13,       # icp_odometry poses, first scans [5.1e-15]
    "ekf_f64": 4e-9,         # EKF-SLAM, first SLAM_EKF_PARITY events [4.0e-10]
    "fastslam_f64": 1e-11,   # FastSLAM poses and log-weights [7.4e-13]
    "vision_f64": 3e-10,     # every vision result [3.3e-11]
    "lqg_f64": 4e-14,        # LQG rollout: states, estimates [3.8e-15]
}


# [parallel]: the edge-sharded GN on an NCCL group of world size 1
# (corridor-1728, f64, JAX's cg_tol 1e-10) and the sharded PF at
# benchmarks.bench_pf_sharded's size. The GN's χ² is held to GN_CHI2 and
# to the single-device optimize(backend="cg") f64 trace within PAR_RTOL
# (both PCG to 1e-10: the traces part by the sums' order), the poses
# within PAR_POSE_TOL m; a χ² below PAR_CHI2_FLOOR x errors[0] is
# rounding and compared at that floor.
PAR_GN_ITERS = 6
PAR_LM_ITERS = 4
PAR_RTOL = 1e-6
PAR_CHI2_FLOOR = 1e-9
PAR_POSE_TOL = 1e-6
PF_PARTICLES = 1_048_576
PF_STEPS = 5
PF_SEED = 0
# f32 rows of the sharded PF off the single-device resampling: the card's
# cumsum is not bitwise reproducible, and two runs of one gather step
# differed in 16,081 and 25,456 of 1,048,576 rows (1.5% and 2.4%; NVIDIA
# H100 80GB HBM3, 700 W); a wrong grid or gather moves nearly every row.
# f64 is held exactly
PF_F32_FLIP_SHARE = 0.1

# [aux]: time_scalar_program against CUDA events on the same program
AUX_TIMING_RTOL = 0.2
AUX_ELEMS = 1 << 25  # 128 MB of f32 a pass
AUX_REPS = 100

# [blocks]: the map-block optimizer (parallel.pgo_blocks) on an NCCL group
# of world size 1 (D = 1, h = 0: no point-to-point traffic). corridor-100k
# is the JAX package's test_block_optimize_corridor_100k (34,000 poses,
# 102,000 dof): GN BLK_GN, cg_tol BLK_CG_TOL, cg_maxiter BLK_CG_MAXITER
# (inexact Newton), held to its criterion errors[-1] < errors[0] x
# BLK_DROP, with Jacobi and with Schwarz (at D = 1 the local cyclic
# reduction factors the whole band); in f32 at the CLI's cg_tol
# BLK_F32_CG_TOL. corridor-1728 in f64 (cg_tol 1e-10, as [parallel]):
# GN PAR_GN_ITERS (single and classic CG) and LM PAR_LM_ITERS held to
# optimize(backend="cg") within PAR_RTOL / PAR_POSE_TOL, Schur and elastic
# (segments of BLK_SEGMENT) to the GN run.
BLK_POSES, BLK_GN, BLK_CG_TOL, BLK_CG_MAXITER = 34000, 8, 1e-8, 150
BLK_DROP, BLK_F32_CG_TOL, BLK_SEGMENT = 1e-3, 1e-6, 2
# [cli]: `python -m rustrobotics_tpu_torch.cli pgo --distributed 1` on
# corridor-1728 with noisy measurements (noisy_corridor_spec, numpy seed
# CLI_SEED) as a g2o file, f64, at most CLI_ITERS iterations, in a
# subprocess against the same command run in-process, and both against
# optimize(backend="cg") within PAR_RTOL; CLI_TIMEOUT s for each
# subprocess
CLI_ITERS, CLI_SEED, CLI_TIMEOUT = 6, 0, 300
# the headline benchmark's subprocess (bench_headline), s
BENCH_TIMEOUT = 400

# the repair of non-finite input: the point given a NaN pixel in
# [vision]'s triangulation, the point given NaN in [scan-matching]'s ICP
VIS_NAN_POINT = 4321
SCAN_NAN_POINT = 7
# the other points against the clean run: equal but for the batched SVD's
# rounding, should the card's batch solver couple the problems' sweeps
VIS_NAN_TOL = 1e-5


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


def host_ms(fn, calls=100, repeats=5):
    """The host's ms a call of fn, in blocks of ``calls`` calls with a
    synchronize at each end (median of ``repeats``)."""
    import torch

    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / calls * 1e3)
    return statistics.median(walls)


def tf32(t):
    """t (f32) rounded to TF32's 10-bit mantissa, to nearest."""
    import torch

    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _counters():
    from rustrobotics_tpu_torch.ops import band_assemble_kernels as bak
    from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
    from rustrobotics_tpu_torch.ops import banded_kernels as bmk
    from rustrobotics_tpu_torch.ops import linearize_kernels as lk

    return (bk.LAUNCHES, bmk.LAUNCHES, bak.LAUNCHES, lk.LAUNCHES)


def reset_counts():
    for counts in _counters():
        for key in counts:
            counts[key] = 0


def read_counts():
    return {k: v for counts in _counters() for k, v in counts.items()}


def bound_ms(nbytes, flops):
    """(the least ms the card could take, "bytes" or "operations"),
    from the H100's peaks in the port's roofline."""
    from rustrobotics_tpu_torch.roofline import (
        PEAK_F32_FLOPS,
        PEAK_HBM_BYTES,
    )

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


def graph_spec(graph):
    """A port graph as a spec (numpy fields, total_dof, prior2, prior3),
    the form sphere_graph returns."""
    from rustrobotics_tpu_torch.mapping.g2o import FLOAT_FIELDS, INDEX_FIELDS

    fields = {n: getattr(graph, n).double().cpu().numpy()
              for n in FLOAT_FIELDS}
    fields.update({n: getattr(graph, n).cpu().numpy() for n in INDEX_FIELDS})
    return dict(fields=fields, total_dof=graph.total_dof,
                prior2=graph.prior2, prior3=graph.prior3)


def g2o_text(spec):
    """A spec as g2o text, every float written exactly (repr): SE2 poses
    get ids 0.., landmarks the ids after them, SE3 poses 0.. (the specs'
    dof layout: poses first, in order). Pose-pose edges keep their order,
    pose-landmark edges theirs, and the two are interleaved in the file."""
    f = spec["fields"]
    n2 = len(f["poses2"])
    fmt = " ".join
    lines = [f"VERTEX_SE2 {i} " + fmt(map(repr, map(float, p)))
             for i, p in enumerate(f["poses2"])]
    lines += [f"VERTEX_XY {n2 + i} " + fmt(map(repr, map(float, p)))
              for i, p in enumerate(f["landmarks2"])]
    for i, p in enumerate(f["poses3"]):
        vals = [*p[:3], p[4], p[5], p[6], p[3]]  # the file's x y z w
        lines.append(f"VERTEX_SE3:QUAT {i} " + fmt(map(repr, map(float,
                                                                  vals))))
    iu2, iu3, iu6 = np.triu_indices(2), np.triu_indices(3), np.triu_indices(6)
    pp = [(k / len(f["pp_z"]), 0,
           f"EDGE_SE2 {a} {b} " + fmt(map(repr, map(float, [*z, *om[iu3]]))))
          for k, (a, b, z, om) in enumerate(zip(
              f["pp_from"], f["pp_to"], f["pp_z"], f["pp_omega"]))]
    pl = [(k / len(f["pl_z"]), 1,
           f"EDGE_SE2_XY {a} {n2 + b} " + fmt(map(repr, map(float,
                                                             [*z, *om[iu2]]))))
          for k, (a, b, z, om) in enumerate(zip(
              f["pl_pose"], f["pl_lm"], f["pl_z"], f["pl_omega"]))]
    lines += [text for _, _, text in sorted(pp + pl)]
    for a, b, z, om in zip(f["qq_from"], f["qq_to"], f["qq_z"],
                           f["qq_omega"]):
        vals = [*z[:3], z[4], z[5], z[6], z[3], *om[iu6]]
        lines.append(f"EDGE_SE3:QUAT {a} {b} " + fmt(map(repr, map(float,
                                                                     vals))))
    return "\n".join(lines) + "\n"


def _wrap(a):
    return (a + np.pi) % (2.0 * np.pi) - np.pi


def _compose2(a, b):
    """SE2 a ∘ b for (3,) poses (numpy)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     _wrap(a[2] + b[2])])


def _relative2(a, b):
    """SE2 a⁻¹ ∘ b for (..., 3) poses (numpy)."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    return np.stack([c * dx + s * dy, -s * dx + c * dy,
                     _wrap(b[..., 2] - a[..., 2])], axis=-1)


def corridor_path(num_poses):
    """The ground-truth path of synthetic_corridor_graph_2d, relative to
    its first pose, and its landmark anchors: (num_poses, 3) poses."""
    s = np.arange(num_poses) * 0.5
    gt = np.stack([s, 2.0 * np.sin(s * 0.05), 0.1 * np.cos(s * 0.05)],
                  axis=-1)
    return _relative2(gt[0], gt)


def slam_course_world(num_poses, num_landmarks):
    """corridor_path(num_poses) and num_landmarks landmarks 1.5 m to its
    side at evenly spaced poses, as synthetic_corridor_graph_2d places
    them."""
    path = corridor_path(num_poses)
    anchor = np.linspace(0, num_poses - 1, num_landmarks).astype(int)
    return path, path[anchor, :2] + np.array([0.0, 1.5])


def write_slam_course(directory, path, landmarks, seed=0,
                      sight_radius=SLAM_SIGHT_RADIUS,
                      odom_noise=SLAM_ODOM_NOISE, meas_noise=SLAM_MEAS_NOISE):
    """A SLAM-course log of a robot driving ``path`` (T+1, 3) among
    ``landmarks`` (K, 2): sensor_data.dat with T ODOMETRY records [rot1,
    trans, rot2] (noise N(0, odom_noise²) on each), each followed by SENSOR
    lines [id, range, bearing] for the landmarks within sight_radius of
    the pose it reaches (noise N(0, meas_noise²) on range and bearing), and
    world.dat with the landmarks (ids 1..K). numpy default_rng(seed)."""
    import pathlib

    rng = np.random.default_rng(seed)
    out = []
    for p, q in zip(path[:-1], path[1:]):
        dx, dy = q[0] - p[0], q[1] - p[1]
        r1 = _wrap(np.arctan2(dy, dx) - p[2])
        u = np.array([r1, np.hypot(dx, dy), _wrap(q[2] - p[2] - r1)])
        u = u + rng.normal(0.0, odom_noise, 3)
        out.append("ODOMETRY " + " ".join(map(repr, map(float, u))))
        d = landmarks - q[:2]
        rng_ = np.hypot(d[:, 0], d[:, 1])
        for k in np.flatnonzero(rng_ <= sight_radius):
            z = np.array([rng_[k], _wrap(np.arctan2(d[k, 1], d[k, 0]) - q[2])])
            z = z + rng.normal(0.0, meas_noise, 2)
            out.append(f"SENSOR {k + 1} " + " ".join(map(repr, map(float, z))))
    directory = pathlib.Path(directory)
    (directory / "sensor_data.dat").write_text("\n".join(out) + "\n")
    (directory / "world.dat").write_text("".join(
        f"{k + 1} {float(x)!r} {float(y)!r}\n"
        for k, (x, y) in enumerate(landmarks)))


def _utias_path(rng, duration, step=UTIAS_STEP):
    """A unicycle path through the UTIAS arena at 1 kHz: speed
    0.2 ± 0.08 m/s, turn rate steering toward random waypoints at least
    UTIAS_MARGIN inside the walls, |ω| ≤ 0.6 rad/s. Returns (v, ω, poses)
    with poses (n + 1, 3) after each step."""
    half = np.array(UTIAS_ARENA) / 2 - UTIAS_MARGIN
    n = int(round(duration / step))
    v = 0.2 + 0.08 * np.sin(2 * np.pi * np.arange(n) * step / 23.0)
    w = np.empty(n)
    poses = np.empty((n + 1, 3))
    x, y, th, rate = -half[0] + 0.5, 0.0, 0.0, 0.0
    gx, gy = rng.uniform(-half, half)
    poses[0] = x, y, th
    for k, vk in enumerate(v.tolist()):
        if math.hypot(gx - x, gy - y) < 0.5:
            gx, gy = rng.uniform(-half, half)
        err = (math.atan2(gy - y, gx - x) - th + math.pi) % (2 * math.pi) \
            - math.pi
        want = min(max(1.5 * err, -0.6), 0.6)
        rate += (want - rate) * step / 0.5  # 0.5 s lag on the turn rate
        w[k] = rate
        x += step * vk * math.cos(th)
        y += step * vk * math.sin(th)
        th = (th + step * rate + math.pi) % (2 * math.pi) - math.pi
        poses[k + 1] = x, y, th
    return v, w, poses


def write_utias(directory, seed=0, duration=UTIAS_DURATION):
    """A UTIAS MRCLE-shaped dataset: the five CSVs load_utias reads
    (Barcodes, Landmark_Groundtruth, Groundtruth, Odometry, Measurement),
    one header row each. 5 robots (subjects 1-5) and 15 landmarks
    (subjects 6-20) keyed by MRCLE's barcode numbers; the landmarks on a
    jittered 5 x 3 grid in a UTIAS_ARENA (15 m x 8 m) arena; robot 1
    drives _utias_path for ``duration`` s. Groundtruth at 100 Hz,
    odometry (v, ω) at ~67 Hz with N(0, UTIAS_ODOM_NOISE²) on each,
    measurement groups at ~4.5 Hz of 1-6 sightings: landmarks within
    UTIAS_SIGHT of range and ±60° of bearing (N(0, UTIAS_MEAS_NOISE²) on
    range and bearing) and, at one group in three, another robot's
    barcode, which the landmark table lacks. Stamps are epoch seconds
    from UTIAS_T0 at 1 ms resolution; odometry and measurements start
    0.5 s before the groundtruth (the loader clips them). numpy
    default_rng(seed). Over UTIAS_DURATION the merged stream holds more
    than 10,000 events."""
    import pathlib

    rng = np.random.default_rng(seed)
    directory = pathlib.Path(directory)
    barcodes = UTIAS_ROBOT_BARCODES + UTIAS_LANDMARK_BARCODES
    gx, gy = np.meshgrid(np.linspace(-6.0, 6.0, 5), np.linspace(-3.0, 3.0, 3))
    lms = np.stack([gx.ravel(), gy.ravel()], -1) + rng.normal(0, 0.3, (15, 2))
    v, w, poses = _utias_path(rng, duration)
    step = UTIAS_STEP

    def at(times):
        """Index of the 1 kHz step at each time (s from the start)."""
        return np.clip(np.round(times / step).astype(int), 0, len(v) - 1)

    def csv(name, header, rows, fmt):
        body = "\n".join(",".join(f % x for f, x in zip(fmt, row))
                         for row in rows)
        (directory / name).write_text(header + "\n" + body + "\n")

    csv("Barcodes.csv", "# Subject #,Barcode #",
        [(k + 1, b) for k, b in enumerate(barcodes)], ("%d", "%d"))
    csv("Landmark_Groundtruth.csv",
        "# Subject #,x [m],y [m],x std-dev [m],y std-dev [m]",
        [(k + 6, x, y, 0.001, 0.001) for k, (x, y) in enumerate(lms)],
        ("%d", "%.6f", "%.6f", "%.6f", "%.6f"))
    t_gt = np.arange(0.0, duration, 0.01)
    gt = poses[at(t_gt)]
    csv("Groundtruth.csv", "# Time [s],x [m],y [m],orientation [rad]",
        [(UTIAS_T0 + t, *p) for t, p in zip(t_gt, gt)],
        ("%.3f", "%.6f", "%.6f", "%.6f"))
    t_od = np.cumsum(rng.uniform(0.014, 0.016, int(duration * 70))) - 0.5
    t_od = np.round(t_od[t_od < duration - 0.1], 3)
    k = at(np.maximum(t_od, 0.0))
    od = np.stack([v[k], w[k]], -1) + rng.normal(0, UTIAS_ODOM_NOISE,
                                                 (len(k), 2))
    csv("Odometry.csv", "# Time [s],Forward Velocity [m/s],Angular "
        "Velocity[rad/s]", [(UTIAS_T0 + t, *u) for t, u in zip(t_od, od)],
        ("%.3f", "%.6f", "%.6f"))
    rows = []
    t_me = np.cumsum(rng.uniform(0.15, 0.30, int(duration * 7))) - 0.5
    for t in np.round(t_me[t_me < duration - 0.1], 3):
        p = poses[at(np.array([max(t, 0.0)]))[0]]
        d = lms - p[:2]
        rng_ = np.hypot(d[:, 0], d[:, 1])
        bear = _wrap(np.arctan2(d[:, 1], d[:, 0]) - p[2])
        seen = np.flatnonzero((rng_ < UTIAS_SIGHT)
                              & (np.abs(bear) < np.pi / 3))[:5]
        group = [(UTIAS_LANDMARK_BARCODES[j], rng_[j], bear[j])
                 for j in rng.permutation(seen)]
        if rng.random() < 1 / 3 or not group:
            group.append((int(rng.choice(UTIAS_ROBOT_BARCODES[1:])),
                          rng.uniform(0.5, 6.0), rng.uniform(-1.0, 1.0)))
        for b, r, a in group:
            z = np.array([r, a]) + rng.normal(0, UTIAS_MEAS_NOISE, 2)
            rows.append((UTIAS_T0 + t, b, z[0], _wrap(z[1])))
    csv("Measurement.csv", "# Time [s],Subject #,range [m],bearing [rad]",
        rows, ("%.3f", "%d", "%.6f", "%.6f"))
    return directory


def circle_data(steps, n_circle=12, seed=0):
    """The circle session of the fixed-lag tests: a robot that steps 1 m
    and turns 2π/n_circle each step, noisy odometry (σ 0.05, 0.05, 0.02)
    from numpy default_rng(seed), closures of σ (0.02, 0.02, 0.01) drawn
    from the same generator as the session adds them. Returns (truth
    (steps+1, 3), odometry (steps, 3), sig_odo, sig_clo, rng)."""
    rng = np.random.default_rng(seed)
    step = np.array([1.0, 0.0, 2 * np.pi / n_circle])
    gt = [np.zeros(3)]
    for _ in range(steps):
        gt.append(_compose2(gt[-1], step))
    sig_odo = np.array([0.05, 0.05, 0.02])
    sig_clo = np.array([0.02, 0.02, 0.01])
    odom = step + rng.normal(0, sig_odo, (steps, 3))
    return np.asarray(gt), odom, sig_odo, sig_clo, rng


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
    require(launches["se2_linearize"] == it_gn + it_lm,
            f"se2_linearize launched once an iteration "
            f"({launches['se2_linearize']} == {it_gn + it_lm})")
    return gn, g32, launches


def k1_need(nb, kb):
    """(FLOP, bytes) of one graph's K1: what the function needs, not what
    the kernels do. Every block row takes chol(D̂_j) and its triangular
    inverse, kb³/3 FLOP each; rows j > 0 also take lp_j = Lcoup_j
    ldinv_{j-1}ᵀ against a triangle (kb³) and the symmetric lp_j lp_jᵀ
    (kb³). dsym and ldinv count by their lower triangles, lcoup and lp
    from row 1 (lcoup_0 is never read, lp_0 is 0)."""
    tri, sq = kb * (kb + 1) // 2, kb * kb
    return ((nb * 2.0 / 3.0 + (nb - 1) * 2.0) * kb ** 3,
            4 * (2 * nb * tri + 2 * (nb - 1) * sq))


def k1_fleet_times(kf):
    """Phase 5 for K1's fleet of K1_FLEET: the kernel and factorize_plain
    (device ms a call, queued back to back) and the bound of the fleet's
    need, under *_b32 keys."""
    from rustrobotics_tpu_torch.ops import band_chol_kernels as bk

    dsym, lcoup = kf["dsym"], kf["lcoup"]
    batch, nb, kb = dsym.shape[:3]
    flops, nbytes = k1_need(nb, kb)
    bound, by = bound_ms(batch * nbytes, batch * flops)
    out = dict(ms_b32=queued_ms(lambda: bk.factorize_kernel(dsym, lcoup),
                                calls=10),
               plain_ms_b32=queued_ms(lambda: bk.factorize_plain(dsym, lcoup),
                                      calls=3),
               bound_ms_b32=bound)
    print(f"[times] factorize (K1 fleet B={batch}, kb={kb}): kernel "
          f"{out['ms_b32']:.4f} ms, plain {out['plain_ms_b32']:.4f} ms, bound "
          f"{bound:.6f} ms ({by}), kernel/bound "
          f"{out['ms_b32'] / bound:.1f}", flush=True)
    return out


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
    from rustrobotics_tpu_torch.roofline import (
        PEAK_F32,
        mfu,
        pgo_iteration_flops,
    )

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

    tri, sq = kb * (kb + 1) // 2, kb * kb
    k1_flops, k1_bytes = k1_need(nb, kb)
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
    plan = p["layout"].linearize_plan.to(g32.device)
    vals32, b32, _ = system_values(g32, 0.0, plan=plan)
    bl = p["bl"]
    dx = bk.solve_band_kernel(bl, vals32, b32)
    stages = {
        "system_values (linearize + assemble)":
            lambda: system_values(g32, 0.0, plan=plan),
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
    flops = pgo_iteration_flops(g32, "banded-kernel", bl)
    print(f"[times] GN banded-kernel, {name} f32: roofline."
          f"pgo_iteration_flops {flops:.6g} FLOP an iteration, "
          f"{flops * it_s / 1e12:.6f} TFLOP/s, MFU "
          f"{mfu(flops * it_s, 'cuda'):.6g} of PEAK_F32['cuda'] "
          f"({PEAK_F32['cuda']:.4g} FLOP/s)", flush=True)
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
            lambda: system_values(g32, 0.0, plan=layout.linearize_plan),
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


def fleet_graphs(device, count=FLEET):
    """Phase 3's and 4c's fleet in f64: corridor-1728 and count - 1 copies
    with poses jittered by N(0, FLEET_JITTER²) (numpy, FLEET_SEED; the
    first FLEET of a larger count are the fleet's)."""
    import numpy as np
    import torch

    g = corridor(1728, device)
    rng = np.random.default_rng(FLEET_SEED)
    poses = g.poses2.cpu().numpy()
    return [g] + [g.replace(poses2=torch.as_tensor(
        poses + rng.normal(0.0, FLEET_JITTER, poses.shape), device=device))
        for _ in range(count - 1)]


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


def k1_fleet_parity(bl, device, tol=PARITY_TOL):
    """Phase 3 for K1 at the robust fleet cell's shape: corridor-1728 and
    K1_FLEET - 1 jittered copies at λ = 0.01 in one K1 call, which must
    take strips of 64 rows; held to factorize_plain (tol) and, graph by
    graph, to the unbatched K1 (32-row strips) bit for bit. Returns the
    fleet's K1 inputs and its error against plain."""
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

    batch = K1_FLEET
    vals, _, _ = system_values(stack_graphs(fleet_graphs(device, batch)),
                               LM_LAMBDA0)
    dsym, lcoup = split_blocks(_prepare_blocks(bl, vals.float(),
                                               band_assemble_kernel)[0])
    print(f"[parity] K1 fleet: B={batch}, corridor-1728 and {batch - 1} "
          f"jittered copies; kb={bl.kb} nb={bl.nb}; λ={LM_LAMBDA0}",
          flush=True)
    reset_counts()
    work, heights = dict(bk.K1_WORK), dict(bk.K1_STRIP_ROWS)
    ld_b, lp_b = bk.factorize_kernel(dsym, lcoup)
    added = {k: bk.K1_WORK[k] - work[k] for k in work}
    rows = {r: bk.K1_STRIP_ROWS[r] - heights[r] for r in heights}
    launches = read_counts()["factorize"]
    print(f"  K1_WORK of the call {added}, calls by strip rows {rows}, "
          f"launches {launches}", flush=True)
    require(rows == {32: 0, 64: 1}, "the fleet's K1 takes 64-row strips")
    require(added == bk.k1_work(bl.nb, bl.kb, batch, 64),
            "the fleet's K1_WORK is k1_work's at 64-row strips")
    require(launches == 1, "one K1 launch for the fleet")
    ld_p, lp_p = bk.factorize_plain(dsym, lcoup)
    k1 = max_eye_residual(ld_b, factor_of(ld_p))
    lp = float((lp_b - lp_p).abs().max())
    del ld_p, lp_p
    equal = True
    for i in range(batch):
        ld_1, lp_1 = bk.factorize_kernel(dsym[i].contiguous(),
                                         lcoup[i].contiguous())
        equal &= torch.equal(ld_b[i], ld_1) and torch.equal(lp_b[i], lp_1)
    rows = {r: bk.K1_STRIP_ROWS[r] - heights[r] for r in heights}
    print(f"  K1 fleet against factorize_plain: max|ldinv_b L_plain - I| "
          f"{k1:.6g}, max|lp_b - lp_plain| {lp:.6g}; every graph bit-equal "
          f"to the unbatched K1: {equal}", flush=True)
    require(bool(torch.isfinite(ld_b).all() and torch.isfinite(lp_b).all()),
            "the fleet's K1 outputs finite")
    require(k1 <= tol["k1"] and lp <= tol["lp"],
            f"the fleet's K1 against factorize_plain within {tol}")
    require(equal, "every graph of the fleet's K1 bit-equal to the "
                   "unbatched K1")
    require(rows == {32: batch, 64: 1},
            "the unbatched calls take 32-row strips")
    require(read_counts()["factorize"] == 1 + batch,
            f"K1 launched once a call ({1 + batch})")
    return dict(dsym=dsym, lcoup=lcoup, k1=k1)


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
    for key in ("assemble_batch", "factorize", "substitute",
                "se2_linearize"):
        require(launches[key] == steps,
                f"{key} launched once a fleet iteration ({launches[key]} == "
                f"{steps})")
    require(launches["assemble_b1"] == 0 and plain_calls[0] == 0,
            "no one-graph assembly and no plain scatter on the fleet path")
    return runners["gauss_newton"], fleet, launches


def rhs_scale(graph, robust=None):
    """Per dof of an SE2 graph (or fleet), the sum of |parts| that
    system_values' index_add_ adds into b, each part times its edge's
    weight under ``robust`` (system_values' robust keyword arguments)."""
    import torch

    from rustrobotics_tpu_torch.mapping import assemble, linearize

    *_, bi, bj, c2_pp = linearize.edge_terms_pp_soa(
        graph.poses2, graph.pp_from, graph.pp_to, graph.pp_z, graph.pp_omega)
    *_, li, lj, c2_pl = linearize.edge_terms_pl_soa(
        graph.poses2, graph.landmarks2, graph.pl_pose, graph.pl_lm,
        graph.pl_z, graph.pl_omega)
    if robust:
        rw = {"robust_delta": 1.0, "mu": None, "robust_edges": "closures",
              **robust}
        w_pp, w_pl = (assemble.robust_weight(rw["robust"], c2,
                                             rw["robust_delta"], mu=rw["mu"])
                      for c2 in (c2_pp, c2_pl))
        if rw["robust_edges"] == "closures":
            w_pp = torch.where(assemble.odometry(graph.pp_from, graph.pp_to),
                               torch.ones_like(w_pp), w_pp)
        bi, bj = bi * w_pp[..., None, :], bj * w_pp[..., None, :]
        li, lj = li * w_pl[..., None, :], lj * w_pl[..., None, :]
    scale = torch.zeros(graph.batch_shape + (graph.total_dof,),
                        dtype=graph.dtype, device=graph.device)
    for off, d, part in ((graph.pose2_offsets[graph.pp_from], 3, bi),
                         (graph.pose2_offsets[graph.pp_to], 3, bj),
                         (graph.pose2_offsets[graph.pl_pose], 3, li),
                         (graph.lm2_offsets[graph.pl_lm], 2, lj)):
        idx = off[None, :] + torch.arange(d, device=graph.device)[:, None]
        scale.index_add_(-1, idx.reshape(-1),
                         part.abs().reshape(graph.batch_shape + (-1,)))
    return scale


def l1_parity(name, graph, lam, **robust):
    """Phase 3 for L1 on an f32 SE2 graph or fleet on the card, by least
    squares or under ``robust`` (system_values' robust keyword arguments):
    system_values on the kernel path against system_values_plain (vals,
    b, χ² as L1_RHS_ULPS and L1_CHI2_RTOL say), b bit-equal to the plain
    version's plan-order gather, the same bits on a second call, one
    LAUNCHES count a call from counts reset just before, and two device
    operations (the two kernels, no fill or copy). Returns the graph, λ,
    the robust arguments, the device plan and the errors."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rustrobotics_tpu_torch.mapping.assemble import (
        PRIOR_WEIGHT,
        build_layout,
        system_values,
        system_values_plain,
    )
    from rustrobotics_tpu_torch.ops import linearize_kernels as lk

    plan = build_layout(graph).linearize_plan.to(graph.device)
    want = system_values_plain(graph, lam, **robust)
    reset_counts()
    got = system_values(graph, lam, plan=plan, **robust)
    again = system_values(graph, lam, plan=plan, **robust)
    torch.cuda.synchronize()
    launches = read_counts()["se2_linearize"]
    _, b_mirror, _ = lk.se2_linearize_plain(graph, lam, PRIOR_WEIGHT, plan,
                                            **robust)
    (vals_k, b_k, chi2_k), (vals_p, b_p, chi2_p) = got, want
    vals_bad = int((vals_k.view(torch.int32)
                    != vals_p.view(torch.int32)).sum())
    unit = 2.0 ** -24 * rhs_scale(graph, robust)
    diff = (b_k - b_p).abs()
    b_units = float((diff / unit.clamp(min=torch.finfo(unit.dtype).tiny))
                    .max())
    b_abs = float(diff.max())
    b_limit = L1_RHS_ULPS * plan.max_degree
    mirror_bad = int((b_k.view(torch.int32)
                      != b_mirror.view(torch.int32)).sum())
    chi2_rel = float(((chi2_k - chi2_p).abs() / chi2_p.abs()).max())
    same = all(torch.equal(x, y) for x, y in zip(again, got))
    calls = 4
    system_values(graph, lam, plan=plan, **robust)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            system_values(graph, lam, plan=plan, **robust)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"[parity] L1 {name}: batch {tuple(graph.batch_shape)}, "
          f"{graph.pp_from.shape[0]} pose-pose and {graph.pl_pose.shape[0]} "
          f"pose-landmark edges, n={graph.total_dof}, max_degree "
          f"{plan.max_degree}; vals entries differing from the plain path "
          f"{vals_bad} of {vals_p.numel()}; max|b_kernel - b_plain| "
          f"{b_abs:.6g} ({b_units:.4g} f32 units of the sum of |parts|, "
          f"limit {b_limit}); b entries differing from the plan-order "
          f"gather {mirror_bad}; χ² {chi2_k.double().cpu().tolist()} against "
          f"{chi2_p.double().cpu().tolist()} ({chi2_rel:.3g} relative); "
          f"device operations over {calls} calls: {len(ops)}", flush=True)
    require(vals_bad == 0, f"[parity] L1 {name}: vals bit-equal to the "
                           f"plain CUDA path")
    require(b_units <= b_limit, f"[parity] L1 {name}: b within "
                                f"{b_limit} f32 units of the plain path")
    require(mirror_bad == 0, f"[parity] L1 {name}: b bit-equal to the "
                             f"plain version's plan-order gather")
    require(chi2_rel <= L1_CHI2_RTOL, f"[parity] L1 {name}: χ² within "
                                      f"{L1_CHI2_RTOL} of the plain path")
    require(same, f"[parity] L1 {name}: the same bits on a second call")
    require(launches == 2, f"[parity] L1 {name}: LAUNCHES counts each call")
    # the profiler can miss the first kernel after it starts (seen on the
    # card in tests/test_torch_kernels_card.py), so 2 calls - 1 pass; a
    # third device operation a call would read 3 calls or more
    require(2 * calls - 1 <= len(ops) <= 2 * calls
            and all("se2_edge_terms" in n or "se2_rhs_gather" in n
                    for n in ops),
            f"[parity] L1 {name}: two device operations a call, the two "
            f"kernels")
    return dict(graph=graph, lam=lam, robust=robust, plan=plan, b_abs=b_abs,
                b_units=b_units, chi2_rel=chi2_rel)


def l1_times(l1):
    """Phase 5 for L1 (by least squares or under ``l1["robust"]``): the
    kernel's device time a call and its plain version's
    (system_values_plain), each queued behind a sleep kernel (L2
    warm, as in the GN loop), beside the bound: every input read once,
    vals, b and χ² written once, roofline.linearize_flops. No library
    routine does this step (library_ms None). The host's time a call of
    each, blocks of 100 calls, is the extra key host_ms / plain_host_ms."""
    import torch

    from rustrobotics_tpu_torch.mapping.assemble import (
        PRIOR_WEIGHT,
        system_values_plain,
    )
    from rustrobotics_tpu_torch.ops import linearize_kernels as lk
    from rustrobotics_tpu_torch.roofline import linearize_flops

    graph, lam, plan, robust = l1["graph"], l1["lam"], l1["plan"], l1[
        "robust"]
    graphs = math.prod(graph.batch_shape)
    inputs = sum(t.numel() * t.element_size() for t in (
        graph.poses2, graph.landmarks2, graph.pp_z, graph.pp_omega,
        graph.pl_z, graph.pl_omega, graph.pp_from, graph.pp_to,
        graph.pl_pose, graph.pl_lm))
    nbytes = inputs + 4 * graphs * (plan.nnz + graph.total_dof + 1)
    flops = graphs * linearize_flops(graph.pp_from.shape[0],
                                     graph.pl_pose.shape[0], 0)
    bound, by = bound_ms(nbytes, flops)

    def kernel():
        return lk.se2_linearize_kernel(graph, lam, PRIOR_WEIGHT, plan,
                                       **robust)

    def plain():
        return system_values_plain(graph, lam, **robust)

    out = dict(ms=queued_ms(kernel), plain_ms=queued_ms(plain, calls=5),
               library_ms=None, bound_ms=bound, bound_by=by,
               host_ms=host_ms(kernel), plain_host_ms=host_ms(plain))
    form = f" {robust['robust']}" if robust else ""
    print(f"[times] L1 se2_linearize{form} B={graphs}: kernel "
          f"{out['ms']:.6f} ms, "
          f"plain {out['plain_ms']:.6f} ms (device, queued), bound "
          f"{bound:.6f} ms ({by}; {nbytes:.4g} B, {flops:.4g} FLOP), "
          f"kernel/bound {out['ms'] / bound:.1f}; host a call (blocks of "
          f"100): kernel {out['host_ms']:.6f} ms, plain "
          f"{out['plain_host_ms']:.6f} ms", flush=True)
    return out


def gnc_fleet(device, graphs64):
    """corridor-1728-gnc in f32 and the fleet of FLEET with its false
    closures (the fleet's guesses, corrupt_closures' measurements)."""
    import torch

    from rustrobotics_tpu_torch.mapping.pgo import stack_graphs

    _, bad, _ = gnc_graphs(device)
    return bad, stack_graphs([g.to(dtype=torch.float32).replace(
        pp_z=bad.pp_z) for g in graphs64])


def gnc_mus(graph):
    """GNC's μ as the LM loops pass it (``pgo._gnc_mu``, a device tensor of
    the graph's batch shape) at μ0, halfway through the schedule of
    GNC_ITERS and at μ = 1, by label; and a number μ, the square root of
    the first row's μ0 at δ = GNC_NUMBER_DELTA, as pgo.optimize passes
    it."""
    import torch

    from rustrobotics_tpu_torch.mapping.pgo import (
        _gnc_mu,
        gnc_iterations,
        gnc_mu0,
    )

    k_gnc = gnc_iterations(GNC_ITERS)
    mu0 = gnc_mu0(graph, 1.0)
    mus = {at: _gnc_mu(mu0, torch.full(graph.batch_shape, it,
                                       device=graph.device), k_gnc)
           for at, it in (("μ0", 0), ("μ halfway", k_gnc // 2),
                          ("μ = 1", k_gnc))}
    number = float(gnc_mu0(graph, GNC_NUMBER_DELTA).reshape(-1)[0]) ** 0.5
    return mus, number


def gnc_l1_parity(bad, fleet, lams):
    """Phase 3 for the robust L1 (se2_edge_terms_gnc): l1_parity under
    gnc-gm on corridor-1728-gnc and on its fleet (``lams`` the fleet's λs)
    at each of gnc_mus' μ tensors (δ 1) and at its number μ (δ
    GNC_NUMBER_DELTA). Returns the fleet's parity at μ halfway (for its
    times) and the worst b error."""
    worst, mid = 0.0, None
    for label, graph, lam in (("corridor-1728-gnc", bad, 0.0),
                              (f"fleet of {FLEET} gnc", fleet, lams)):
        mus, number = gnc_mus(graph)
        for at, mu in mus.items():
            r = l1_parity(f"{label} gnc-gm at {at}", graph, lam,
                          robust="gnc-gm", robust_delta=1.0, mu=mu)
            worst = max(worst, r["b_abs"])
            if graph is fleet and at == "μ halfway":
                mid = r
        r = l1_parity(f"{label} gnc-gm at μ {number:.6g} (a number), δ "
                      f"{GNC_NUMBER_DELTA}", graph, lam, robust="gnc-gm",
                      robust_delta=GNC_NUMBER_DELTA, mu=number)
        worst = max(worst, r["b_abs"])
    return mid, worst


def lm_cost_parity(name, trial, current, **robust):
    """Phase 3 for LC (se2_lm_cost) on an f32 SE2 graph or fleet on the
    card: ``linearize_kernels.se2_cost_kernel`` against se2_cost_plain on
    the same inputs (the trial's Σ e^T Ω e and, with ``robust``, Σ ρ_μ at
    the trial and at ``current``, each within LC_RTOL), the same bits on a
    second call, equal sums where the current graph is the trial, one
    LAUNCHES count a call from counts reset just before, and one device
    operation a call. Returns the inputs and the error."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rustrobotics_tpu_torch.ops import linearize_kernels as lk

    kw = dict(robust=robust.get("robust"),
              robust_delta=robust.get("robust_delta", 1.0),
              mu=robust.get("mu"), current=current if robust else None)
    want = lk.se2_cost_plain(trial, **kw)
    reset_counts()
    got = lk.se2_cost_kernel(trial, **kw)
    again = lk.se2_cost_kernel(trial, **kw)
    torch.cuda.synchronize()
    launches = read_counts()["se2_lm_cost"]
    got_sums, want_sums = ([r.double().cpu().tolist() for r in sums
                            if r is not None] for sums in (got, want))
    rel = max(float(((g - w).abs() / w.abs()).max())
              for g, w in zip(got, want) if w is not None)
    same = all(torch.equal(x, y) for x, y in zip(again, got)
               if x is not None)
    equal = True
    if robust:
        _, rho, rho_cur = lk.se2_cost_kernel(trial, **dict(kw,
                                                           current=trial))
        equal = torch.equal(rho, rho_cur)
    calls = 4
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            lk.se2_cost_kernel(trial, **kw)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"[parity] LC {name}: batch {tuple(trial.batch_shape)}, "
          f"{trial.pp_from.shape[0] + trial.pl_pose.shape[0]} edges; "
          f"sums {got_sums} against {want_sums} ({rel:.3g} relative, "
          f"limit {LC_RTOL}); device operations over "
          f"{calls} calls: {len(ops)}", flush=True)
    require(rel <= LC_RTOL, f"[parity] LC {name}: the sums within {LC_RTOL} "
                            f"of the plain version")
    require(same, f"[parity] LC {name}: the same bits on a second call")
    require(equal, f"[parity] LC {name}: the current graph's sum equals the "
                   f"trial's where they are one graph")
    require(launches == 2, f"[parity] LC {name}: LAUNCHES counts each call")
    require(calls - 1 <= len(ops) <= calls
            and all("se2_lm_cost" in n for n in ops),
            f"[parity] LC {name}: one device operation a call, the kernel")
    return dict(trial=trial, kw=kw, rel=rel)


def lm_cost_parities(g32, bad, fleet):
    """LC on corridor-1728 by least squares (``global_error``'s form), and
    under gnc-gm on corridor-1728-gnc and its fleet at μ halfway and at a
    number μ (δ GNC_NUMBER_DELTA), each trial the graph's poses moved by
    1e-3. Returns the one graph's and the fleet's gnc-gm parity at μ
    halfway (for their times) and the worst error."""
    out = [lm_cost_parity("corridor-1728 least squares", g32.replace(
        poses2=g32.poses2 + 1e-3), g32)]
    timed = []
    for label, graph in (("corridor-1728-gnc", bad),
                         (f"fleet of {FLEET} gnc", fleet)):
        mus, number = gnc_mus(graph)
        trial = graph.replace(poses2=graph.poses2 + 1e-3)
        timed.append(lm_cost_parity(f"{label} gnc-gm at μ halfway", trial,
                                    graph, robust="gnc-gm",
                                    mu=mus["μ halfway"]))
        out += [timed[-1], lm_cost_parity(
            f"{label} gnc-gm at μ {number:.6g} (a number), δ "
            f"{GNC_NUMBER_DELTA}", trial, graph, robust="gnc-gm",
            robust_delta=GNC_NUMBER_DELTA, mu=number)]
    return timed[0], timed[1], max(r["rel"] for r in out)


def lm_cost_times(lc):
    """Phase 5 for LC: the kernel's device time a call (trial and current
    graph) and its plain version's (se2_cost_plain), each queued behind a
    sleep kernel (L2 warm, as in the LM loop), beside the bound: the
    edges' indices, measurements and information matrices and both
    graphs' nodes read once, three sums a graph written once, LC_FLOPS_*
    an edge of each graph. No library routine does this step (library_ms
    None). The host's ms a call of each, blocks of 100 calls, as
    host_ms / plain_host_ms."""
    from rustrobotics_tpu_torch.ops import linearize_kernels as lk

    trial, kw = lc["trial"], lc["kw"]
    graphs = math.prod(trial.batch_shape)
    costed = [g for g in (trial, kw["current"]) if g is not None]
    nodes = sum(t.numel() * t.element_size() for g in costed
                for t in (g.poses2, g.landmarks2))
    edges = sum(t.numel() * t.element_size() for t in (
        trial.pp_z, trial.pp_omega, trial.pl_z, trial.pl_omega,
        trial.pp_from, trial.pp_to, trial.pl_pose, trial.pl_lm))
    nbytes = nodes + edges + 4 * graphs * 3
    flops = len(costed) * graphs * (LC_FLOPS_PP * trial.pp_from.shape[0]
                                    + LC_FLOPS_PL * trial.pl_pose.shape[0])
    bound, by = bound_ms(nbytes, flops)

    def kernel():
        return lk.se2_cost_kernel(trial, **kw)

    def plain():
        return lk.se2_cost_plain(trial, **kw)

    out = dict(ms=queued_ms(kernel), plain_ms=queued_ms(plain, calls=5),
               library_ms=None, bound_ms=bound, bound_by=by,
               host_ms=host_ms(kernel), plain_host_ms=host_ms(plain))
    print(f"[times] LC se2_lm_cost {kw['robust']} B={graphs}: kernel "
          f"{out['ms']:.6f} ms, plain {out['plain_ms']:.6f} ms (device, "
          f"queued), bound {bound:.6f} ms ({by}; {nbytes:.4g} B, "
          f"{flops:.4g} FLOP), kernel/bound {out['ms'] / bound:.1f}; host a "
          f"call (blocks of 100): kernel {out['host_ms']:.6f} ms, plain "
          f"{out['plain_host_ms']:.6f} ms", flush=True)
    return out


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
        build_layout,
        system_values,
    )
    from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
    from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
        band_assemble_kernel,
    )
    from rustrobotics_tpu_torch.ops.band_chol import _prepare_blocks

    plan = build_layout(g32).linearize_plan.to(g32.device)
    vals, b, _ = system_values(fleet, 0.0, plan=plan)
    dx = bk.solve_band_kernel(bl, vals, b)
    stages = {
        "system_values (linearize + assemble)":
            lambda: system_values(fleet, 0.0, plan=plan),
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


def bootstrap_phase(device):
    """Phase 4j: corridor-1728 with every pose zeroed, GN 10 on
    banded-kernel without initialization (printed only), then
    chordal_init_se2 and GN 10; sphere-2500 with identity poses,
    chordal_init_se3 and LM 6; f32 on the card. Returns the path's
    counts."""
    import torch

    from rustrobotics_tpu_torch.mapping import (
        chordal_init_se2,
        chordal_init_se3,
        global_error,
    )
    from rustrobotics_tpu_torch.mapping.pgo import make_optimize

    g32 = corridor(1728, device).to(dtype=torch.float32)
    g0 = g32.replace(poses2=torch.zeros_like(g32.poses2))
    spec = sphere_graph()
    own = port_graph(spec, device).to(dtype=torch.float32)
    spec["fields"]["poses3"] = np.tile([0.0] * 3 + [1.0] + [0.0] * 3,
                                       (len(spec["fields"]["poses3"]), 1))
    s0 = port_graph(spec, device).to(dtype=torch.float32)
    kw = dict(tolerance=0.0, backend="banded-kernel", device=device)
    gn = make_optimize(g0, num_iterations=10, **kw)
    lm = make_optimize(s0, num_iterations=6, solver="lm", **kw)
    own_final = float(lm(own)[1][-1])
    with counted_plain_scatter() as plain_calls:
        reset_counts()
        _, stalled, _ = gn(g0)
        t0 = time.perf_counter()
        gc = chordal_init_se2(g0)
        t_se2 = time.perf_counter() - t0
        _, err2, it2 = gn(gc)
        t0 = time.perf_counter()
        gc3 = chordal_init_se3(s0)
        t_se3 = time.perf_counter() - t0
        _, err3, it3 = lm(gc3)
        torch.cuda.synchronize()
        launches = read_counts()
    chi2_2d, chi2_3d = float(global_error(gc)), float(global_error(gc3))
    err2, err3 = err2.double().cpu(), err3.double().cpu()

    def rel_sums(t, want):
        got = t.double().abs().sum(0).cpu().numpy()
        return float(np.max(np.abs(got / np.asarray(want) - 1.0)))

    sums2 = max(rel_sums(gc.poses2, CHORDAL_SUMS_2D),
                rel_sums(gc.landmarks2, CHORDAL_LM_SUMS_2D))
    sums3 = rel_sums(gc3.poses3, CHORDAL_SUMS_3D)
    print(f"[bootstrap] corridor-1728 zeroed, GN 10 without initialization: "
          f"{stalled.double().cpu().tolist()}", flush=True)
    print(f"[bootstrap] chordal_init_se2 {t_se2:.4f} s on the host; chordal "
          f"χ² {chi2_2d:.6g} (JAX f64 {CHORDAL_CHI2_2D:.6g}); |pose| sums "
          f"{sums2:.3g} from JAX f64; GN 10 {err2.tolist()}", flush=True)
    print(f"[bootstrap] sphere-2500 identity poses: chordal_init_se3 "
          f"{t_se3:.4f} s on the host; chordal χ² {chi2_3d:.6g} (JAX f64 "
          f"{CHORDAL_CHI2_3D:.6g}); |pose| sums {sums3:.3g} from JAX f64; "
          f"LM 6 {err3.tolist()}; LM 6 from sphere-2500's own guess ends at "
          f"{own_final:.6g}", flush=True)
    print(f"[bootstrap] launches {launches}; plain band scatters "
          f"{plain_calls[0]}", flush=True)
    require(gc.poses2.device.type == gc.landmarks2.device.type
            == gc3.poses3.device.type == "cuda"
            and gc.poses2.dtype == gc3.poses3.dtype == torch.float32,
            "chordal results on the card in f32")
    require(sums2 <= CHORDAL_RTOL and sums3 <= CHORDAL_RTOL,
            f"chordal poses' |column| sums within {CHORDAL_RTOL} of the JAX "
            f"f64 run's (2D {sums2:.3g}, 3D {sums3:.3g})")
    require(chi2_2d <= CHORDAL_CHI2_MAX and chi2_3d <= CHORDAL_CHI2_MAX,
            f"chordal χ² {chi2_2d:.3g} (2D), {chi2_3d:.3g} (3D) <= "
            f"{CHORDAL_CHI2_MAX}")
    require(it2 == 10 and it3 == 6 and bool(torch.isfinite(err2).all())
            and bool(torch.isfinite(err3).all()),
            "bootstrap GN 10 and LM 6 ran, χ² finite")
    require(err2[10] < 1e-2, f"GN errors[10] {err2[10]:.3g} < 1e-2 from "
                             f"the chordal corridor")
    limit = max(BOOT_LM_FACTOR * own_final, BOOT_LM_FLOOR)
    require(err3[6] <= limit, f"sphere-2500 LM errors[6] {err3[6]:.3g} from "
                              f"the chordal graph <= {limit:.3g}")
    for key in ("assemble_b1", "factorize", "substitute"):
        require(launches[key] > 0, f"{key} kernel launched on the bootstrap "
                                   f"path")
    require(plain_calls[0] == 0, "no plain band scatter on the bootstrap path")
    return launches


def posegraph_phase(device):
    """Phase 4k: corridor-1728 and sphere-2500 written as g2o files; the
    native parser against the Python one (bit for bit), then
    PoseGraph(path).optimize(10, backend="banded-kernel") in f32 against
    optimize on the same graph. Returns the PoseGraph runs' counts."""
    import tempfile

    import torch

    from rustrobotics_tpu_torch.mapping import g2o, g2o_native
    from rustrobotics_tpu_torch.mapping.pgo import PoseGraph, optimize

    require(g2o_native.native_available(), "native g2o parser built "
                                           "(no Python fallback)")
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, spec in (("corridor-1728",
                            graph_spec(corridor(1728, device))),
                           ("sphere-2500", sphere_graph())):
            path = f"{tmp}/{name}.g2o"
            with open(path, "w") as fh:
                fh.write(g2o_text(spec))
            t0 = time.perf_counter()
            native = g2o_native.parse_native(path)
            t_native = time.perf_counter() - t0
            t0 = time.perf_counter()
            python = g2o._parse_python(path)
            t_python = time.perf_counter() - t0
            same = native is not None and set(native) == set(python) and all(
                np.array_equal(native[k], python[k])
                and np.asarray(native[k]).dtype == np.asarray(python[k]).dtype
                for k in python)
            require(same, f"{name}: the native parse equals the Python one "
                          f"bit for bit ({t_native:.4f} s against "
                          f"{t_python:.4f} s)")
            graph = g2o.load_g2o(path, dtype=torch.float32, device=device)
            pg = PoseGraph(path, dtype=torch.float32, device=device)
            reset_counts()
            got = pg.optimize(10, backend="banded-kernel")
            torch.cuda.synchronize()
            launches = read_counts()
            want = optimize(graph, 10, backend="banded-kernel",
                            device=device).errors
            n = min(len(got), len(want))
            got_t, want_t = (torch.tensor(e[:n]) for e in (got, want))
            rel = max_rel(got_t, want_t, want_t > 1.0)
            print(f"[posegraph] {name}: PoseGraph.optimize {got}; optimize "
                  f"{want}; iteration {pg.iteration}; launches {launches}",
                  flush=True)
            require(np.isfinite(got).all() and pg.iteration == len(got) - 1,
                    f"{name} PoseGraph trace finite, iteration "
                    f"{pg.iteration}")
            if name == "corridor-1728":  # f32 ‖dx‖ stays above 1e-4 there
                require(pg.iteration == 10, "corridor-1728 PoseGraph "
                                            "iteration 10")
            require(rel <= PARITY_TOL["solve"],
                    f"{name} PoseGraph entries above 1 within "
                    f"{PARITY_TOL['solve']} of optimize's ({rel:.3g})")
            for key in ("assemble_b1", "factorize", "substitute"):
                require(launches[key] > 0, f"{key} kernel launched on the "
                                           f"{name} PoseGraph path")
            for key, count in launches.items():
                total[key] = total.get(key, 0) + count
    return total


def fixed_lag_session(device, dtype, data, window=FL_WINDOW,
                      capacity=FL_CAPACITY):
    """The circle session through FixedLagSmoother on ``device``: a
    closure at each revisit, from circle_data's draws (closure_plan).
    Returns the smoother, the final state and the current pose after every
    step."""
    import torch

    from rustrobotics_tpu_torch.mapping import FixedLagSmoother

    _, odom, sig_odo, sig_clo, closures = data
    fls = FixedLagSmoother.create(
        window=window, closure_capacity=capacity,
        chain_omega=torch.diag(torch.tensor(1.0 / sig_odo ** 2, dtype=dtype)),
        clos_omega=torch.diag(torch.tensor(1.0 / sig_clo ** 2, dtype=dtype)),
        device=device)
    odom = torch.tensor(odom, dtype=dtype, device=device)
    ij = torch.tensor([c[1:3] for c in closures], device=device)
    zs = torch.tensor(np.array([c[3] for c in closures]), dtype=dtype,
                      device=device)
    at = {c[0]: k for k, c in enumerate(closures)}
    state = fls.init_state(torch.zeros(3, dtype=dtype, device=device))
    poses = []
    for t in range(len(odom)):
        state = fls.advance(state, odom[t])
        if t in at:
            k = at[t]
            state = fls.add_closure(state, ij[k, 0], ij[k, 1], zs[k])
        poses.append(fls.current_pose(state))
    return fls, state, torch.stack(poses)


def closure_plan(window):
    """circle_data(FL_STEPS) and its closures (step, i, j, z): at each
    revisit, the newest window pose j to the one FL_CIRCLE steps back, z
    drawn from circle_data's generator in session order, as
    tests/test_fixed_lag.py draws them."""
    gt, odom, sig_odo, sig_clo, rng = circle_data(FL_STEPS, FL_CIRCLE)
    closures = []
    for t in range(FL_STEPS):
        j = min(t + 2, window) - 1
        if t + 1 >= FL_CIRCLE and j - FL_CIRCLE >= 0:
            closures.append((t, j - FL_CIRCLE, j, rng.normal(0, sig_clo, 3)))
    return gt, (gt, odom, sig_odo, sig_clo, closures)


def rmse_against_truth(poses, gt, odom):
    """Trajectory RMSE (xy) of the current poses and of dead reckoning."""
    est = np.concatenate([np.zeros((1, 3)), poses.double().cpu().numpy()])
    dr = [np.zeros(3)]
    for u in odom:
        dr.append(_compose2(dr[-1], u))
    dr = np.asarray(dr)
    return tuple(float(np.sqrt(np.mean(np.sum((a[:, :2] - gt[:, :2]) ** 2,
                                                  -1)))) for a in (est, dr))


def fixed_lag_phase(device):
    """Phase 4l: the fixed-lag smoother's circle session, f32 on the card
    against f64 on the CPU through the port; RMSE against dead reckoning,
    device launches per advance and the idle share (steps/s: the [bench]
    row of benchmarks.bench_fixed_lag)."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    gt, data = closure_plan(FL_WINDOW)
    odom, closures = data[1], data[4]
    # one session for the gates; the smoother's steps/s at W = 32 is the
    # [bench] row fixed_lag_w32_steps_per_sec (best of 5 sessions)
    _, state, poses = fixed_lag_session(device, torch.float32, data)
    _, _, ref = fixed_lag_session("cpu", torch.float64, data)
    fields = {f.name: getattr(state, f.name)
              for f in dataclasses.fields(state)}
    diff = float((poses.double().cpu() - ref).abs().max())
    e_fls, e_dr = rmse_against_truth(poses, gt, odom)
    gt16, data16 = closure_plan(FL_TEST_WINDOW)
    _, _, poses16 = fixed_lag_session(device, torch.float32, data16,
                                      FL_TEST_WINDOW, FL_TEST_CAPACITY)
    e16, _ = rmse_against_truth(poses16, gt16, odom)

    # launches of one advance with the window full, then one traced session
    fls, full, _ = fixed_lag_session(
        device, torch.float32, (gt, odom[:FL_WINDOW + 1], *data[2:4], []))
    u = torch.tensor(odom[0], dtype=torch.float32, device=device)
    ij = torch.tensor([0, FL_CIRCLE], device=device)
    fls.advance(full, u)
    torch.cuda.synchronize()
    # advance and add_closure read nothing back to the host: CUDA's sync
    # debug mode raises on any operation that would wait for the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        fls.add_closure(fls.advance(full, u), ij[0], ij[1], u)
        no_sync = True
    except RuntimeError as err:
        no_sync = False
        print(f"[fixed-lag] a step synchronized with the host: {err}",
              flush=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fls.advance(full, u)
        torch.cuda.synchronize()
    per_advance = len([e for e in prof.events() if e.device_type
                       == torch.autograd.DeviceType.CUDA]) / 10
    # the traced session is FL_TRACED steps (the window fills, then slides):
    # the profiler's event list of 400 steps takes minutes to build
    short = (gt, odom[:FL_TRACED], *data[2:4],
             [c for c in closures if c[0] < FL_TRACED])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fixed_lag_session(device, torch.float32, short)
        torch.cuda.synchronize()
    idle = idle_share(prof.events())
    print(f"[fixed-lag] {FL_STEPS} steps, W={FL_WINDOW}, C={FL_CAPACITY}, "
          f"{len(closures)} closures on the card (steps/s: the [bench] row "
          f"fixed_lag_w{FL_WINDOW}_steps_per_sec); "
          f"{per_advance:.1f} device launches per advance (torch.profiler, "
          f"the window full); device idle share of a traced session of "
          f"{FL_TRACED} steps "
          f"{'not measured' if idle is None else f'{idle:.4f}'}", flush=True)
    print(f"[fixed-lag] current pose, card f32 against CPU f64: max |diff| "
          f"{diff:.6g}; RMSE {e_fls:.6g} against dead reckoning's {e_dr:.6g}"
          f"; W={FL_TEST_WINDOW}, C={FL_TEST_CAPACITY}: RMSE {e16:.6g}",
          flush=True)
    require(all(t.device.type == "cuda" for t in fields.values()),
            "every fixed-lag state tensor on cuda")
    require(no_sync, "advance and add_closure make no host read (CUDA sync "
                     "debug mode)")
    require(bool(torch.isfinite(poses).all()) and diff <= FL_POSE_TOL,
            f"card current pose within {FL_POSE_TOL} of the CPU f64 run's at "
            f"every step ({diff:.3g})")
    require(e_fls < e_dr, f"W={FL_WINDOW} RMSE {e_fls:.4g} < dead "
                          f"reckoning's {e_dr:.4g}")
    require(e16 < e_dr / FL_RMSE_FACTOR,
            f"W={FL_TEST_WINDOW} RMSE {e16:.4g} < dead reckoning's "
            f"{e_dr:.4g} / {FL_RMSE_FACTOR}")
    return dict(launches_per_advance=per_advance, idle_share=idle)


def frontend_dataset():
    """The front end's SLAM-course log (slam_course_world at FE_POSES,
    FE_LANDMARKS; write_slam_course with seed 0), loaded."""
    import tempfile

    from rustrobotics_tpu_torch.data import load_slam_course

    path, landmarks = slam_course_world(FE_POSES, FE_LANDMARKS)
    with tempfile.TemporaryDirectory() as tmp:
        write_slam_course(tmp, path, landmarks, seed=0)
        return load_slam_course(tmp)


def frontend_phase(device, gate):
    """Phase 4m: a synthetic SLAM-course log (write_slam_course) loaded,
    built into a pose graph by the front end and run through LM FE_ITERS
    on banded-kernel in f32, against the same on banded-direct; K1's pivot
    gate on the band of ``gate`` (the pending frontend_gate_graph()).
    Returns the path's counts."""
    import torch

    from rustrobotics_tpu_torch.mapping import (
        build_pose_graph_from_slam_course,
        global_error,
    )
    from rustrobotics_tpu_torch.mapping.assemble import build_layout
    from rustrobotics_tpu_torch.mapping.pgo import make_optimize
    from rustrobotics_tpu_torch.ops.band_chol import build_band_chol

    ds = frontend_dataset()
    sightings = sum(len(s) for s in ds.sensors)
    g = build_pose_graph_from_slam_course(ds, device=device)
    bl = build_band_chol(build_layout(g))
    require(bl is not None, "front-end graph has a band plan")
    kw = dict(num_iterations=FE_ITERS, solver="lm", tolerance=0.0,
              device=device)
    lm = make_optimize(g, backend="banded-kernel", **kw)
    with counted_plain_scatter() as plain_calls:
        reset_counts()
        out, err, it = lm(g)
        torch.cuda.synchronize()
        launches = read_counts()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm(g)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    out_d, err_d, _ = make_optimize(g, backend="banded-direct", **kw)(g)
    err, err_d = err.double().cpu(), err_d.double().cpu()
    final, final_d = float(global_error(out)), float(global_error(out_d))
    lm_err = np.linalg.norm(out.landmarks2.double().cpu().numpy()
                            - ds.landmarks, axis=-1)
    lm_err0 = np.linalg.norm(g.landmarks2.double().cpu().numpy()
                             - ds.landmarks, axis=-1)
    nan_trials = int(torch.isnan(err).sum())
    print(f"[frontend] log: {len(ds.odometry)} odometry records, "
          f"{len(ds.landmarks)} landmarks, {sightings} sightings; graph "
          f"n={g.total_dof}, kb={bl.kb}, nb={bl.nb}", flush=True)
    print(f"[frontend] LM {FE_ITERS} banded-kernel {err.tolist()}",
          flush=True)
    print(f"[frontend] LM {FE_ITERS} banded-direct {err_d.tolist()}",
          flush=True)
    print(f"[frontend] final χ² banded-kernel {final:.8g}, banded-direct "
          f"{final_d:.8g}; {nan_trials} rejected trials with a NaN χ² on "
          f"banded-kernel, {int(torch.isnan(err_d).sum())} on banded-direct",
          flush=True)
    print(f"[frontend] landmark error against the truth: mean "
          f"{lm_err.mean():.4f} m, max {lm_err.max():.4f} m (first sighting "
          f"{lm_err0.mean():.4f}, {lm_err0.max():.4f}); {FE_ITERS / wall:.4f} "
          f"LM it/s (median of 3 runs of {FE_ITERS}); launches {launches}; "
          f"plain band scatters {plain_calls[0]}", flush=True)
    require(it == FE_ITERS, f"front-end LM ran {FE_ITERS} iterations")
    # NaN compares false: a NaN last trial fails here
    require(err[-1] < err[0] / 2, f"front-end errors[-1] {float(err[-1]):.6g}"
                                  f" < errors[0] / 2 ({float(err[0]):.6g})")
    require(abs(final / final_d - 1) <= FE_FINAL_RTOL,
            f"front-end final χ² within {FE_FINAL_RTOL} of banded-direct's")
    frontend_k1_gate(gate, bl, device)
    for key in ("assemble_b1", "factorize", "substitute"):
        require(launches[key] > 0, f"{key} kernel launched on the front-end "
                                   f"path")
    require(plain_calls[0] == 0, "no plain band scatter on the front-end path")
    return launches


def frontend_gate_graph():
    """The graph the front end's K1 gate reads its band from: the front
    end's graph of frontend_dataset() built in f64 on the CPU, through
    banded-direct LM FE_ITERS on the CPU in one thread (sequential
    index_add_ and one BLAS thread: the same bits every run). chip_smoke
    runs this in a worker process from its start, beside the card's
    phases. Returns (graph_spec of the final graph, seconds)."""
    import torch

    from rustrobotics_tpu_torch.mapping import (
        build_pose_graph_from_slam_course,
    )
    from rustrobotics_tpu_torch.mapping.pgo import make_optimize

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    g = build_pose_graph_from_slam_course(frontend_dataset(),
                                          dtype=torch.float64, device="cpu")
    out, _, _ = make_optimize(g, num_iterations=FE_ITERS, solver="lm",
                              tolerance=0.0, backend="banded-direct",
                              device="cpu")(g)
    return graph_spec(out), time.perf_counter() - t0


def gate_band(graph, bl, device, lam):
    """(dsym, lcoup) of K4's band of ``graph`` (f32) at λ on the card: the
    per-edge values of system_values, no atomics, summed by K4 in plan
    order."""
    from rustrobotics_tpu_torch.mapping.assemble import system_values
    from rustrobotics_tpu_torch.ops.band_assemble_kernels import (
        band_assemble_kernel,
    )
    from rustrobotics_tpu_torch.ops.band_chol import (
        _prepare_blocks,
        split_blocks,
    )

    vals, _, _ = system_values(graph.to(device=device), lam)
    return split_blocks(
        _prepare_blocks(bl.to(device), vals, band_assemble_kernel)[0])


def band_checksum(dsym, lcoup):
    """SHA-256 of a band's bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in (dsym, lcoup):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def pivot_gate(dsym, lcoup, factorize, plain, tol=FE_K1_TOL):
    """K1 (``factorize``) against the plain chain (``plain``) on one f32
    band, held where exact arithmetic has a factorization. r64 is the
    first block row where the f64 chain on the same band (``plain`` in
    f64) has a non-finite entry, nb where there is none; past it no
    factorization exists, and whether a rounded chain keeps a pivot
    there is luck. Returns a dict: r64, nb, the block rows with a
    non-finite entry of K1 (k1_bad), of the plain chain (plain_bad) and of
    the f64 chain (f64_bad), resid = max over the rows before r64 of
    |ldinv_K1 L_plain - I| (inf where K1 or the plain chain lost a pivot
    there), and ok: r64 >= 1, K1 and the plain chain keep every pivot
    before r64, and resid <= tol. Where r64 = nb this is the whole band."""
    import torch

    ld_k, _ = factorize(dsym, lcoup)
    ld_p, _ = plain(dsym, lcoup)
    ld_64, _ = plain(dsym.double(), lcoup.double())

    def bad(t):
        return torch.nonzero(
            ~torch.isfinite(t).flatten(1).all(1)).flatten().tolist()

    nb = dsym.shape[-3]
    k1_bad, plain_bad, f64_bad = bad(ld_k), bad(ld_p), bad(ld_64)
    r64 = f64_bad[0] if f64_bad else nb
    lost = [r for r in k1_bad + plain_bad if r < r64]
    if lost or r64 == 0:
        resid = math.inf
    else:
        resid = float(eye_residual_rows(ld_k[:r64],
                                        factor_of(ld_p[:r64])).max())
    return dict(r64=r64, nb=nb, k1_bad=k1_bad, plain_bad=plain_bad,
                f64_bad=f64_bad, resid=resid,
                ok=r64 >= 1 and not lost and resid <= tol)


def frontend_k1_gate(gate, bl, device):
    """The front end's K1 gate (phase m) on the band of frontend_gate_graph
    (``gate``: its pending result) at λ = FE_BREAK_LAM, then at λ =
    LM_LAMBDA0."""
    import torch

    from rustrobotics_tpu_torch.ops.band_chol_kernels import (
        factorize_kernel,
        factorize_plain,
    )

    t0 = time.perf_counter()
    spec, secs = gate.get()
    waited = time.perf_counter() - t0
    graph = port_graph(spec, device).to(dtype=torch.float32)
    sums = [band_checksum(*gate_band(graph, bl, device, FE_BREAK_LAM))
            for _ in range(2)]
    print(f"[frontend] the K1 gate's graph: banded-direct LM {FE_ITERS} in "
          f"f64 on the CPU, cast to f32 ({secs:.2f} s in a worker process, "
          f"{waited:.2f} s waited for here); SHA-256 of K4's band "
          f"at λ = {FE_BREAK_LAM:.4g}, two builds: {sums[0]}, {sums[1]}",
          flush=True)
    require(sums[0] == sums[1], "[frontend] the gate's band is "
                                "bit-reproducible (two builds' SHA-256 equal)")
    for lam in (FE_BREAK_LAM, LM_LAMBDA0):
        res = pivot_gate(*gate_band(graph, bl, device, lam),
                         factorize_kernel, factorize_plain)
        whole = res["r64"] == res["nb"]
        print(f"[frontend] K4's band at λ = {lam:.4g}: the f64 chain on the "
              f"f32 band keeps "
              + ("every pivot" if whole else
                 f"the pivots of block rows 0..{res['r64'] - 1} of "
                 f"{res['nb']} (r64 = {res['r64']})")
              + f"; block rows with a non-finite entry: K1 {res['k1_bad']}, "
                f"plain chain {res['plain_bad']}, f64 chain "
                f"{res['f64_bad']}; max|ldinv_kernel L_plain - I| over rows "
                f"0..{res['r64'] - 1}: {res['resid']:.4g}", flush=True)
        require(res["r64"] >= 1, f"[frontend] λ = {lam:.4g}: the f64 chain "
                                 f"keeps block row 0's pivots (r64 >= 1)")
        require(res["ok"],
                f"[frontend] λ = {lam:.4g}: K1 and the plain chain keep every "
                f"pivot of the {'whole band' if whole else 'rows before r64'}"
                f", K1 within {FE_K1_TOL} of the plain chain")


# ------------------------------------------------------------- filters


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device):
    """(fn(), wall seconds) with the card synchronized at both ends."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _maxdiff(a, b, heading=None):
    """max |a - b| over two tensors or arrays; with ``heading``, that
    component of the last axis is an angle, compared wrapped."""
    import torch

    d = torch.as_tensor(a).double().cpu() - torch.as_tensor(b).double().cpu()
    if heading is not None:
        d[..., heading] = torch.remainder(d[..., heading] + math.pi,
                                          2 * math.pi) - math.pi
    return float(d.abs().max())


def _on(device):
    """The device argument an entry point gets: None (its default, the
    card) on the card, the device itself elsewhere."""
    import torch

    return None if torch.device(device).type == "cuda" else device


def launch_trace(run, device):
    """(device launches, idle share) of one run() under torch.profiler;
    (None, None) when the profiler recorded no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        run()
        _sync(device)
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None, None
    return len(dev), idle_share(events)


def no_host_read(label, run, device):
    """Whether run() makes no synchronizing CUDA call (CUDA's sync debug
    mode raises on any); True off the card."""
    import torch

    if torch.device(device).type != "cuda":
        return True
    _sync(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
        return True
    except RuntimeError as err:
        print(f"[{label}] a step synchronized with the host: {err}",
              flush=True)
        return False
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _fmt(x):
    return "not measured" if x is None else f"{x:.4f}"


def utias_dataset():
    """write_utias(seed 0), loaded by the port."""
    import tempfile

    from rustrobotics_tpu_torch.data import load_utias

    with tempfile.TemporaryDirectory() as tmp:
        write_utias(tmp, seed=0)
        return load_utias(tmp)


def sim_run(algo, device):
    """_run_simulation(algo) in f64 on numpy draws from SIM_SEED."""
    import torch

    from rustrobotics_tpu_torch.localization import simulation as sim

    steps = int(SIM_TIME / 0.1)
    rng = np.random.default_rng(SIM_SEED)
    draws = {"gps": rng.standard_normal((steps, 2)),
             "input": rng.standard_normal((steps, 2))}
    if algo == "pf":
        draws["init"] = rng.standard_normal((SIM_PARTICLES, 4))
        draws["noise"] = rng.standard_normal((steps, SIM_PARTICLES, 4))
        draws["resample"] = rng.random((steps, SIM_PARTICLES))
    draws = {k: torch.tensor(v, device=device) for k, v in draws.items()}
    return sim._run_simulation(draws, algo, SIM_TIME, 0.1, SIM_PARTICLES,
                               torch.float64, device)


def fleet_noise(bank, seed):
    """(3, bank) N(0, 1) draws in f32 on the CPU, numpy default_rng(seed)."""
    import torch

    return torch.tensor(np.random.default_rng(seed).standard_normal(
        (3, bank)), dtype=torch.float32)


def fleet_x0(ds, noise):
    """The fleet's initial states as the fleet entry point forms them:
    groundtruth's first pose + FLEET_SPREAD * noise, f32 on the CPU."""
    import torch

    return (torch.tensor(ds.groundtruth[0, 1:4], dtype=torch.float32)[:, None]
            + FLEET_SPREAD * noise)


def _fleet_rows(bank):
    return np.linspace(0, bank - 1, FLEET_ROWS).astype(int)


def unbanked_rows(ds, algo, x0_rows, var, events, device="cpu"):
    """The unbanked EKF-KC / UKF-KC replay from x0_rows (R, 3) at once (a
    leading batch axis), f64: (T, R, 3)."""
    import torch

    from rustrobotics_tpu_torch.localization import landmark_replay as lr
    from rustrobotics_tpu_torch.utils.state import GaussianState

    filt = lr.build_filter(ds, algo, torch.float64, device)
    ev = ds.events(max_events=events, device=device)
    cov = torch.eye(3, dtype=torch.float64, device=device) * var
    state = GaussianState(x=x0_rows.to(device),
                          cov=cov.expand(len(x0_rows), 3, 3))
    return lr._replay_kalman(filt, state, ev, lr._first_dt(ev)).x


def scan_run(name, device):
    """kalman_scan.<name> on the 2-state system of the JAX package's tests
    with SCAN_T observations, f64."""
    import torch

    from rustrobotics_tpu_torch.localization import kalman_scan as ks

    system = (np.array([[1.0, 0.1], [0.0, 1.0]]),
              np.array([[0.01, 0.0], [0.0, 0.02]]), np.array([[1.0, 0.0]]),
              np.array([[0.5]]), np.array([0.0, 0.5]), np.eye(2),
              np.random.default_rng(SCAN_SYSTEM_SEED).normal(
                  size=(SCAN_T, 1)))
    return getattr(ks, name)(*(torch.tensor(a, device=device)
                               for a in system))


def eif_run(ds, device):
    """The EIF-KC (the EKF-KC's noise settings) over EIF_EVENTS events from
    groundtruth's first pose, cov 1e-10 I, f64: the estimates (T, 3)."""
    import torch

    from rustrobotics_tpu_torch.localization import landmark_replay as lr
    from rustrobotics_tpu_torch.localization.eif import (
        ExtendedInformationFilterKnownCorrespondences,
        InformationState,
    )
    from rustrobotics_tpu_torch.utils.state import GaussianState

    ekf = lr.build_filter(ds, "ekf", torch.float64, device)
    eif = ExtendedInformationFilterKnownCorrespondences(
        q=ekf.q, landmarks=ekf.landmarks, motion_model=ekf.motion_model,
        measurement_model=ekf.measurement_model)
    ev = ds.events(max_events=EIF_EVENTS, device=device)
    dt = lr._first_dt(ev)
    st = InformationState.from_moments(GaussianState(
        x=torch.tensor(ds.groundtruth[0, 1:4], device=device),
        cov=torch.eye(3, dtype=torch.float64, device=device) * 1e-10))
    xs = []
    for k in range(ev.num_events):
        st = eif.step(st, ev.control[k], ev.has_control[k], ev.meas_ids[k],
                      ev.meas_z[k], ev.meas_mask[k], dt[k])
        xs.append(st.x)
    return torch.stack(xs)


def hist_run(ds, device):
    """The histogram filter on a HIST_GRID grid over the arena, from
    groundtruth's first pose, over HIST_EVENTS events, f64: (the final
    belief, the last event's time)."""
    import torch

    from rustrobotics_tpu_torch.localization import landmark_replay as lr
    from rustrobotics_tpu_torch.localization.histogram import HistogramFilter

    table = lr._landmark_table(ds, torch.float64, device)
    hf = HistogramFilter.create(table.positions[:, :2], np.diag([0.1, 0.2]),
                                motion_sigma=(0.05, 0.05, 0.05))
    ev = ds.events(max_events=HIST_EVENTS, device=device)
    rows, known = table.lookup_np(ev.meas_ids_np)
    lm_idx = torch.tensor(rows, device=device)
    mask = torch.tensor(known & ev.meas_mask_np, device=device)
    dt = lr._first_dt(ev)
    w, h = UTIAS_ARENA
    g = hf.init_at(HIST_GRID, -w / 2, -h / 2, w / HIST_GRID[0],
                   h / HIST_GRID[1], ds.groundtruth[0, 1:4])
    for k in range(ev.num_events):
        g = hf.step(g, ev.control[k], ev.has_control[k], lm_idx[k],
                    ev.meas_z[k], mask[k], dt[k])
    return g, float(ev.times[-1])


def cpu_references():
    """Every CPU f64 run the filter phases compare the card with, as numpy
    arrays. chip_smoke runs this in a worker process from its start, so the
    CPU runs overlap the card's phases."""
    import torch

    from rustrobotics_tpu_torch.localization import landmark_replay as lr

    torch.set_num_threads(2)
    ds = utias_dataset()
    refs = {}
    for algo in ("ekf", "ukf", "pf"):
        hist = sim_run(algo, "cpu")
        refs[f"sim {algo}"] = {k: hist[k].numpy() for k in ("x_est",
                                                             "cov_est")}
    _, st = lr.run_utias_localization(ds, "ekf", max_events=LM_EVENTS,
                                      device="cpu")
    refs["lm ekf"] = {"x": st.x.numpy(), "cov": st.cov.numpy()}
    x0 = fleet_x0(ds, fleet_noise(FLEET_BANK, 0))[:, _fleet_rows(FLEET_BANK)]
    refs["fleet rows"] = unbanked_rows(ds, "ekf", x0.T.double(), 1e-10,
                                       LM_EVENTS).numpy()
    x0 = fleet_x0(ds, fleet_noise(UKF_FLEET_B, 2))[:, _fleet_rows(
        UKF_FLEET_B)]
    refs["ukf rows"] = unbanked_rows(ds, "ukf", x0.T.double(), 1e-6,
                                     UKF_FLEET_EVENTS).numpy()
    for name in ("sequential_linear_kalman_filter",
                 "sequential_rts_smoother"):
        st = scan_run(name, "cpu")
        refs[name] = {"x": st.x.numpy(), "cov": st.cov.numpy()}
    refs["eif"] = eif_run(ds, "cpu").numpy()
    refs["eif ekf"] = unbanked_rows(ds, "ekf", torch.tensor(
        ds.groundtruth[0:1, 1:4]), 1e-10, EIF_EVENTS)[:, 0].numpy()
    refs["hist"] = hist_run(ds, "cpu")[0].belief.numpy()
    return refs


def _rmse(a, b):
    return float(((a[:, :2].double() - b[:, :2].double()) ** 2).sum(-1)
                 .mean().sqrt())


def filters_sim_phase(device, refs):
    """Phase filters-sim: run_simulation ekf, ukf and pf. f64 on the card
    against f64 on the CPU on the same numpy draws (_run_simulation), and
    the entry point in f32 on the card (device not given) held to the JAX
    tests' RMSE bounds; steps/s."""
    import torch

    from rustrobotics_tpu_torch.localization import simulation as sim

    steps = int(SIM_TIME / 0.1)
    rates = {}
    for algo in ("ekf", "ukf", "pf"):
        card64 = sim_run(algo, device)

        def entry(algo=algo):
            gen = torch.Generator(device).manual_seed(SIM_SEED)
            return sim.run_simulation(gen, algo, SIM_TIME, 0.1,
                                      SIM_PARTICLES, torch.float32,
                                      device=_on(device))

        entry()  # warm-up
        hist, wall = _timed(entry, device)
        ref = refs.get()[f"sim {algo}"]
        diff = max(_maxdiff(card64[k], ref[k]) for k in ref)
        err = _rmse(hist["x_est"], hist["x_true"])
        dr = _rmse(hist["x_dr"], hist["x_true"])
        rates[algo] = steps / wall
        print(f"[filters-sim] {algo}: {steps / wall:.4f} steps/s (f32 on "
              f"the card, an episode of {steps} steps in {wall * 1e3:.4f} "
              f"ms{', ' + str(SIM_PARTICLES) + ' particles' if algo == 'pf' else ''}); "
              f"RMSE {err:.6g} against dead reckoning's {dr:.6g}; card f64 "
              f"against CPU f64 on the same draws: max |diff| {diff:.6g}",
              flush=True)
        require(all(v.device.type == torch.device(device).type
                    and bool(torch.isfinite(v).all()) for v in hist.values()),
                f"{algo} history finite, on the card")
        require(diff <= FILTER_TOL["sim_f64"],
                f"{algo} card f64 within {FILTER_TOL['sim_f64']} of CPU f64 "
                f"({diff:.3g})")
        require(err < SIM_RMSE_MAX[algo],
                f"{algo} f32 RMSE {err:.4g} < {SIM_RMSE_MAX[algo]}")
        if algo == "ekf":
            require(err < dr, f"ekf RMSE {err:.4g} < dead reckoning's "
                              f"{dr:.4g}")
    return rates


def landmarks_phase(device, ds, refs):
    """Phase landmarks: run_utias_localization on write_utias's data,
    LM_EVENTS events: EKF f64 (held event for event to the CPU f64 run)
    and f32, UKF f64, PF f64 with LM_PARTICLES; events/s, device launches
    per event and the idle share of a traced replay of TRACE_EVENTS
    events; no host read in a replay."""
    import torch

    from rustrobotics_tpu_torch.localization import landmark_replay as lr
    from rustrobotics_tpu_torch.utils.state import GaussianState

    def entry(algo, dtype=torch.float64, events=LM_EVENTS, **kw):
        return lr.run_utias_localization(ds, algo, max_events=events,
                                         num_particles=LM_PARTICLES,
                                         dtype=dtype, device=_on(device),
                                         **kw)

    for algo in ("ekf", "ukf", "pf"):
        entry(algo, events=TRACE_EVENTS)  # warm-up
    runs = {}
    for algo, dtype in (("ekf", torch.float64), ("ekf", torch.float32),
                        ("ukf", torch.float64), ("pf", torch.float64)):
        kw = {}
        if algo == "pf":
            kw["generator"] = torch.Generator(device).manual_seed(0)
        (times, st), wall = _timed(lambda: entry(algo, dtype, **kw), device)
        ate = lr.ate_vs_groundtruth(ds, times, st)
        runs[(algo, dtype)] = (st, ate, wall)
        print(f"[landmarks] {algo} {str(dtype)[6:]}: {LM_EVENTS / wall:.4f} "
              f"events/s ({wall:.4f} s for {LM_EVENTS} events"
              f"{', ' + str(LM_PARTICLES) + ' particles' if algo == 'pf' else ''}"
              f"); ATE {ate:.6g} m", flush=True)
        require(st.x.device.type == torch.device(device).type
                and bool(torch.isfinite(st.x).all()),
                f"{algo} {dtype} estimates finite, on the card")

    filt = lr.build_filter(ds, "ekf", torch.float32, device)
    ev = ds.events(max_events=TRACE_EVENTS, dtype=torch.float32,
                   device=device)
    dt = lr._first_dt(ev)
    x0 = torch.tensor(ds.groundtruth[0, 1:4], dtype=torch.float32,
                      device=device)
    state = GaussianState(x=x0, cov=torch.eye(3, dtype=torch.float32,
                                              device=device) * 1e-10)

    def replay():
        return lr._replay_kalman(filt, state, ev, dt)

    launches, idle = launch_trace(replay, device)
    pf = lr.build_filter(ds, "pf", torch.float32, device)
    draws = lr._pf_draws(torch.Generator(device).manual_seed(0),
                         TRACE_EVENTS, LM_PARTICLES, torch.float32, device)
    p0 = x0 + draws["init"] * 0.2

    def replay_pf():
        return lr._replay_pf(pf, p0, ev, dt, draws["motion"],
                             draws["resample"])

    pf_launches, pf_idle = launch_trace(replay_pf, device)
    no_sync = (no_host_read("landmarks", replay, device)
               and no_host_read("landmarks", replay_pf, device))
    per = (None if launches is None else launches / TRACE_EVENTS)
    pf_per = (None if pf_launches is None else pf_launches / TRACE_EVENTS)
    print(f"[landmarks] EKF f32 replay of {TRACE_EVENTS} events under "
          f"torch.profiler: device launches per event {_fmt(per)}, device "
          f"idle share {_fmt(idle)}; PF ({LM_PARTICLES} particles): "
          f"launches per event {_fmt(pf_per)}, idle share {_fmt(pf_idle)}",
          flush=True)
    st64 = runs[("ekf", torch.float64)][0]
    drift = _maxdiff(runs[("ekf", torch.float32)][0].x, st64.x, heading=2)
    print(f"[landmarks] EKF f32 against EKF f64 on the card: max |diff| "
          f"{drift:.6g} (heading wrapped)", flush=True)
    ref = refs.get()["lm ekf"]
    diff = max(_maxdiff(st64.x, ref["x"], heading=2),
               _maxdiff(st64.cov, ref["cov"]))
    print(f"[landmarks] EKF f64, card against CPU, event for event: max "
          f"|diff| {diff:.6g}", flush=True)
    require(diff <= FILTER_TOL["lm_f64"],
            f"EKF f64 card within {FILTER_TOL['lm_f64']} of CPU f64 at every "
            f"event ({diff:.3g})")
    for key in (("ekf", torch.float64), ("ekf", torch.float32)):
        ate = runs[key][1]
        require(ate < LM_ATE_MAX, f"EKF {key[1]} ATE {ate:.4g} < "
                                  f"{LM_ATE_MAX}")
    require(no_sync, "the EKF and PF replays make no host read (CUDA sync "
                     "debug mode)")
    return dict(events_per_s={f"{a} {str(d)[6:]}": LM_EVENTS / w
                              for (a, d), (_, _, w) in runs.items()},
                ate={f"{a} {str(d)[6:]}": t for (a, d), (_, t, _)
                     in runs.items()},
                launches_per_event=per, idle_share=idle)


def _row_ates(ds, times, xs):
    """ATE of each row of xs (T, R, 3)."""
    from rustrobotics_tpu_torch.localization import landmark_replay as lr
    from rustrobotics_tpu_torch.utils.state import GaussianState

    return [lr.ate_vs_groundtruth(ds, times, GaussianState(x=xs[:, r],
                                                           cov=None))
            for r in range(xs.shape[1])]


def fleet_phase(device, ds, refs):
    """Phase fleet: run_utias_localization_fleet, bank FLEET_BANK,
    LM_EVENTS events, f32: every row finite; FLEET_ROWS rows against the
    unbanked EKF-KC (f64, CPU) from their initial states, within
    FILTER_TOL and each row's ATE below LM_ATE_MAX; the same rows through
    the banked path in f64 on the card against that reference;
    events/s, filter-updates/s, launches per event, idle share, no host
    read."""
    import torch

    from rustrobotics_tpu_torch.localization import landmark_replay as lr

    _, xs_default = lr.run_utias_localization_fleet(
        ds, max_events=TRACE_EVENTS, device=_on(device))  # warm-up
    noise = fleet_noise(FLEET_BANK, 0)
    x0 = fleet_x0(ds, noise)
    noise = noise.to(device)
    (times, xs), wall = _timed(lambda: lr._run_utias_localization_fleet(
        ds, noise, LM_EVENTS, FLEET_SPREAD, torch.float32, device), device)
    rows = _fleet_rows(FLEET_BANK)
    ev64 = ds.events(max_events=FLEET_F64_EVENTS, device=device)
    cov64 = (torch.eye(3, dtype=torch.float64, device=device)
             * 1e-10)[:, :, None].expand(3, 3, FLEET_ROWS)
    xs64 = lr._replay_banked(lr.build_banked_filter(ds, torch.float64,
                                                    device),
                             x0[:, rows].double().to(device), cov64, ev64,
                             lr._first_dt(ev64))

    filt = lr.build_banked_filter(ds, torch.float32, device)
    ev = ds.events(max_events=TRACE_EVENTS, dtype=torch.float32,
                   device=device)
    cov0 = (torch.eye(3, dtype=torch.float32, device=device)
            * 1e-10)[:, :, None].expand(3, 3, FLEET_BANK)
    x0b = x0.to(device)

    def replay():
        return lr._replay_banked(filt, x0b, cov0, ev, lr._first_dt(ev))

    launches, idle = launch_trace(replay, device)
    no_sync = no_host_read("fleet", replay, device)
    per = None if launches is None else launches / TRACE_EVENTS
    ref = refs.get()["fleet rows"]
    mine = xs[:, :, rows].permute(0, 2, 1)
    diff = _maxdiff(mine, ref, heading=2)
    diff64 = _maxdiff(xs64.permute(0, 2, 1), ref[:FLEET_F64_EVENTS],
                      heading=2)
    ates = _row_ates(ds, times, mine.cpu())
    ref_ates = _row_ates(ds, times, torch.as_tensor(ref))
    print(f"[fleet] bank {FLEET_BANK}, {LM_EVENTS} events, f32: "
          f"{LM_EVENTS / wall:.4f} events/s, "
          f"{LM_EVENTS * FLEET_BANK / wall:.6g} filter-updates/s "
          f"({wall:.4f} s); device launches per event {_fmt(per)}, device "
          f"idle share {_fmt(idle)} (a traced replay of {TRACE_EVENTS} "
          f"events)", flush=True)
    print(f"[fleet] rows {rows.tolist()} against the unbanked EKF-KC (f64, "
          f"CPU) from their initial states: max |diff| {diff:.6g} "
          f"(heading wrapped); ATE f32 {max(ates):.6g} m at most, f64 "
          f"{max(ref_ates):.6g}; the rows in f64 on the card, "
          f"{FLEET_F64_EVENTS} events: max |diff| {diff64:.6g}", flush=True)
    require(tuple(xs_default.shape) == (TRACE_EVENTS, 3, FLEET_BANK)
            and xs_default.device.type == torch.device(device).type,
            f"the fleet entry point's default bank {FLEET_BANK}, on the card")
    require(bool(torch.isfinite(xs).all()), "every fleet row finite")
    require(diff <= FILTER_TOL["fleet_rows"],
            f"{FLEET_ROWS} fleet rows within {FILTER_TOL['fleet_rows']} of "
            f"the unbanked EKF-KC ({diff:.3g})")
    require(max(ates) < LM_ATE_MAX, f"every checked fleet row's ATE "
                                    f"{max(ates):.4g} < {LM_ATE_MAX}")
    require(diff64 <= FILTER_TOL["fleet_f64"],
            f"the rows in f64 within {FILTER_TOL['fleet_f64']} of the "
            f"unbanked EKF-KC ({diff64:.3g})")
    require(no_sync, "the fleet replay makes no host read (CUDA sync "
                     "debug mode)")
    return dict(events_per_s=LM_EVENTS / wall,
                updates_per_s=LM_EVENTS * FLEET_BANK / wall,
                launches_per_event=per, idle_share=idle)


def banked_phase(device, ds, refs):
    """Phase banked: simple_problem_banked (B = BANKED_EKF_B) and
    simple_problem_banked_ukf (B = BANKED_UKF_B), BANKED_STEPS chained
    steps in f32 at the JAX package's benchmark settings; FLEET_ROWS
    columns against the unbanked filter (f64, CPU); Mupdates/s. The UKF's
    alpha = 0.001 puts its sigma weights at -1e6, past f32: its columns'
    distance from f64 is printed, and the gate runs the same bank at
    alpha = 1. Then the banked UKF-KC fleet (UKF_FLEET_B) on
    UKF_FLEET_EVENTS UTIAS events in f32 (finite; its rows' distance from
    the unbanked UKF-KC, f64, printed) and its rows in f64 on the card
    against that reference."""
    import torch

    from rustrobotics_tpu_torch.localization import banked as bk
    from rustrobotics_tpu_torch.localization import landmark_replay as lr
    from rustrobotics_tpu_torch.localization.ekf import ExtendedKalmanFilter
    from rustrobotics_tpu_torch.localization.ukf import (
        UnscentedKalmanFilter,
    )
    from rustrobotics_tpu_torch.models import (
        SimpleProblemMeasurementModel,
        SimpleProblemMotionModel,
    )
    from rustrobotics_tpu_torch.utils.state import GaussianState

    q = np.diag([0.1, 0.1, np.deg2rad(1.0), 1.0]) ** 2
    r = np.diag([1.0, 1.0]) ** 2
    f32 = torch.float32
    q32, r32 = (torch.tensor(a, dtype=f32, device=device) for a in (q, r))
    out = {}

    def chain(filt, x0, dev, dtype):
        x = torch.tensor(x0, dtype=dtype, device=dev)
        b = x.shape[1]
        cov = torch.eye(4, dtype=dtype, device=dev)[:, :, None].expand(
            4, 4, b)
        u = torch.tensor([1.0, 0.1], dtype=dtype, device=dev)[:, None]
        z = torch.tensor([0.3, 0.2], dtype=dtype, device=dev)[:, None]
        for _ in range(BANKED_STEPS):
            x, cov = filt.step(x, cov, u.expand(2, b), z.expand(2, b), 0.1)
        return x, cov

    def unbanked(kind, x0, alpha):
        mot = SimpleProblemMotionModel.create()
        meas = SimpleProblemMeasurementModel.create()
        if kind == "ekf":
            filt = ExtendedKalmanFilter(r=torch.tensor(q),
                                        q=torch.tensor(r), motion_model=mot,
                                        measurement_model=meas)
        else:
            filt = UnscentedKalmanFilter.create(
                q=q, r=r, motion_model=mot, measurement_model=meas,
                alpha=alpha, beta=2.0, kappa=0.0, device="cpu")
        state = GaussianState(x=torch.tensor(x0.T),
                              cov=torch.eye(4, dtype=torch.float64).expand(
                                  x0.shape[1], 4, 4))
        u, z = torch.tensor([1.0, 0.1]), torch.tensor([0.3, 0.2])
        for _ in range(BANKED_STEPS):
            state = filt.step(state, u, z, 0.1)
        return state.x

    for kind, bank in (("ekf", BANKED_EKF_B), ("ukf", BANKED_UKF_B)):
        x0 = np.random.default_rng(1).standard_normal((4, bank)) * 0.5
        cols = _fleet_rows(bank)
        alphas = (None,) if kind == "ekf" else (0.001, 1.0)
        for alpha in alphas:
            if kind == "ekf":
                filt = bk.simple_problem_banked(q32, r32)
            else:
                filt = bk.simple_problem_banked_ukf(q32, r32, alpha=alpha)
            chain(filt, x0[:, :2], device, f32)  # warm-up
            (x, cov), wall = _timed(lambda: chain(filt, x0, device, f32),
                                    device)
            ref = unbanked(kind, x0[:, cols], alpha)
            diff = _maxdiff(x[:, cols].T, ref)
            rate = bank * BANKED_STEPS / wall / 1e6
            name = kind if alpha is None else f"{kind} alpha={alpha}"
            out[name] = rate
            print(f"[banked] {name}, B = {bank}, {BANKED_STEPS} chained "
                  f"steps, f32: {rate:.4f} Mupdates/s ({wall * 1e3:.4f} "
                  f"ms); columns {cols.tolist()} against the unbanked "
                  f"{kind.upper()} (f64, CPU): max |diff| {diff:.6g}",
                  flush=True)
            require(bool(torch.isfinite(x).all())
                    and bool(torch.isfinite(cov).all()),
                    f"banked {name} finite")
            if alpha != 0.001:
                tol = FILTER_TOL[f"banked_{kind}"]
                require(diff <= tol, f"banked {name} columns within {tol} "
                                     f"of the unbanked filter ({diff:.3g})")

    def ukf_fleet(dtype, x0, dev, events):
        alpha = torch.tensor(lr._ALPHA, dtype=dtype, device=dev)
        qm = torch.diag(torch.tensor(lr._Q, dtype=dtype, device=dev))
        filt = bk.velocity_banked_ukf_kc(
            alpha, qm, lr._landmark_table(ds, dtype, dev))
        ev = ds.events(max_events=events, dtype=dtype, device=dev)
        cov0 = (torch.eye(3, dtype=dtype, device=dev)
                * 1e-6)[:, :, None].expand(3, 3, x0.shape[1])
        return lr._replay_banked(filt, x0.to(dev, dtype), cov0, ev,
                                 lr._first_dt(ev))

    x0 = fleet_x0(ds, fleet_noise(UKF_FLEET_B, 2))
    rows = _fleet_rows(UKF_FLEET_B)
    ukf_fleet(f32, x0, device, TRACE_EVENTS)  # warm-up
    xs, wall = _timed(lambda: ukf_fleet(f32, x0, device, UKF_FLEET_EVENTS),
                      device)
    xs64 = ukf_fleet(torch.float64, x0[:, rows], device, UKF_FLEET_EVENTS)
    ref = refs.get()["ukf rows"]
    mine = xs[:, :, rows].permute(0, 2, 1)
    diff = _maxdiff(mine, ref, heading=2)
    diff64 = _maxdiff(xs64.permute(0, 2, 1), ref, heading=2)
    times = ds.events(max_events=UKF_FLEET_EVENTS,
                      device="cpu").times.numpy()
    ates = _row_ates(ds, times, mine.cpu())
    ref_ates = _row_ates(ds, times, torch.as_tensor(ref))
    rate = UKF_FLEET_EVENTS * UKF_FLEET_B / wall / 1e6
    out["ukf_kc_fleet"] = rate
    print(f"[banked] UKF-KC fleet, B = {UKF_FLEET_B}, {UKF_FLEET_EVENTS} "
          f"UTIAS events, f32: {rate:.4f} Mupdates/s "
          f"({UKF_FLEET_EVENTS / wall:.4f} events/s); rows {rows.tolist()} "
          f"against the unbanked UKF-KC (f64, CPU): max |diff| {diff:.6g} "
          f"(heading wrapped), ATE f32 {max(ates):.6g} m at most, f64 "
          f"{max(ref_ates):.6g}; the rows in f64 on the card: max |diff| "
          f"{diff64:.6g}", flush=True)
    require(bool(torch.isfinite(xs).all()), "UKF-KC fleet finite")
    require(diff64 <= FILTER_TOL["ukf_fleet_f64"],
            f"UKF-KC fleet rows in f64 within "
            f"{FILTER_TOL['ukf_fleet_f64']} of the unbanked UKF-KC "
            f"({diff64:.3g})")
    return out


def extra_phase(device, ds, refs):
    """Phase filters-extra, against the CPU f64 runs: the parallel Kalman
    filter and RTS smoother (card f64) against the sequential ones at T =
    SCAN_T; the EIF-KC (card f64) against itself on the CPU and against
    the EKF-KC on EIF_EVENTS UTIAS events; the histogram filter on a
    HIST_GRID grid over HIST_EVENTS events (card f64 against CPU f64)."""
    import torch

    diffs = {}
    for par, seq in (("parallel_linear_kalman_filter",
                      "sequential_linear_kalman_filter"),
                     ("parallel_rts_smoother", "sequential_rts_smoother")):
        scan_run(par, device)  # warm-up
        got, wall = _timed(lambda par=par: scan_run(par, device), device)
        want = refs.get()[seq]
        diffs[par] = max(_maxdiff(got.x, want["x"]),
                         _maxdiff(got.cov, want["cov"]))
        print(f"[filters-extra] {par}, T = {SCAN_T}, f64 on the card: "
              f"{wall * 1e3:.4f} ms; against {seq} (CPU): max |diff| "
              f"{diffs[par]:.6g}", flush=True)

    eif_card, wall = _timed(lambda: eif_run(ds, device), device)
    diffs["eif_f64"] = _maxdiff(eif_card, refs.get()["eif"], heading=2)
    diffs["eif_ekf"] = _maxdiff(eif_card, refs.get()["eif ekf"],
                                heading=2)
    print(f"[filters-extra] EIF-KC, {EIF_EVENTS} UTIAS events, f64 on the "
          f"card: {EIF_EVENTS / wall:.4f} events/s; against the CPU f64 run:"
          f" max |diff| {diffs['eif_f64']:.6g}; against the EKF-KC (f64): "
          f"max |diff| {diffs['eif_ekf']:.6g}", flush=True)

    hist_run(ds, device)  # warm-up
    (g_card, t_end), wall = _timed(lambda: hist_run(ds, device), device)
    diffs["hist"] = _maxdiff(g_card.belief, refs.get()["hist"])
    gt = ds.groundtruth
    t_abs = t_end + gt[0, 0]
    truth = np.array([np.interp(t_abs, gt[:, 0], gt[:, c]) for c in (1, 2)])
    est = g_card.estimate().cpu().numpy()
    print(f"[filters-extra] histogram filter, {HIST_GRID} grid, "
          f"{HIST_EVENTS} events, f64 on the card: "
          f"{HIST_EVENTS / wall:.4f} events/s; belief against the CPU f64 "
          f"run: max |diff| {diffs['hist']:.6g}; final estimate "
          f"{np.linalg.norm(est[:2] - truth):.6g} m from groundtruth",
          flush=True)
    for par in ("parallel_linear_kalman_filter", "parallel_rts_smoother"):
        require(diffs[par] <= FILTER_TOL["scan"],
                f"{par} within {FILTER_TOL['scan']} of the sequential one "
                f"({diffs[par]:.3g})")
    for key in ("eif_f64", "eif_ekf", "hist"):
        require(diffs[key] <= FILTER_TOL[key],
                f"{key} within {FILTER_TOL[key]} ({diffs[key]:.3g})")
    require(bool(torch.isfinite(g_card.belief).all()), "histogram belief "
                                                        "finite")
    return diffs


# ------------------------------------ SLAM families, vision and control


def room_ranges(poses, angles, pillars=SCAN_PILLARS, half=SCAN_HALF):
    """Ranges (T, B) from poses (T, 3) along beam angles (B,) to the
    walls of a ±half square room and circular pillars [cx, cy, radius]
    (numpy; the room of the JAX package's loop-closure test)."""
    th = poses[:, 2:3] + angles[None, :]
    dx, dy = np.cos(th), np.sin(th)
    px, py = poses[:, :1], poses[:, 1:2]
    with np.errstate(divide="ignore", invalid="ignore"):
        tx = np.where(dx > 0, (half - px) / dx,
                      np.where(dx < 0, (-half - px) / dx, np.inf))
        ty = np.where(dy > 0, (half - py) / dy,
                      np.where(dy < 0, (-half - py) / dy, np.inf))
    r = np.minimum(tx, ty)
    for cx, cy, rad in pillars:
        ox, oy = px - cx, py - cy
        b = ox * dx + oy * dy
        disc = b * b - (ox * ox + oy * oy - rad * rad)
        t_hit = -b - np.sqrt(np.clip(disc, 0.0, None))
        r = np.minimum(r, np.where((disc > 0) & (t_hit > 0), t_hit, np.inf))
    return r


def scan_data(steps, beams, laps, dtype, device):
    """A robot on laps of the circle of radius SCAN_RADIUS in the room,
    facing along it: (ground truth (T, 3) numpy, scans (T, B), angles
    (B,) on device)."""
    import torch

    ts = np.linspace(0, 2 * np.pi * laps, steps, endpoint=False)
    gt = np.stack([SCAN_RADIUS * np.cos(ts), SCAN_RADIUS * np.sin(ts),
                   _wrap(ts + np.pi / 2)], -1)
    angles = np.linspace(-np.pi, np.pi, beams, endpoint=False)
    return (gt, torch.tensor(room_ranges(gt, angles), dtype=dtype,
                             device=device),
            torch.tensor(angles, dtype=dtype, device=device))


def scan_parity_run(device):
    """icp_odometry in f64 on the first SCAN_PARITY_SCANS scans of the
    lidar cell: poses (S, 3)."""
    import torch

    from rustrobotics_tpu_torch.mapping.scan_matching import icp_odometry

    _, sc, an = scan_data(SCAN_STEPS, SCAN_BEAMS, SCAN_LAPS, torch.float64,
                          device)
    return icp_odometry(sc[:SCAN_PARITY_SCANS], an, SCAN_MAX_RANGE)[0]


def slam_course_dataset(num_landmarks):
    """write_slam_course (seed 0) of slam_course_world(FE_POSES,
    num_landmarks), loaded: the front end's log at num_landmarks =
    FE_LANDMARKS."""
    import tempfile

    from rustrobotics_tpu_torch.data import load_slam_course

    path, landmarks = slam_course_world(FE_POSES, num_landmarks)
    with tempfile.TemporaryDirectory() as tmp:
        write_slam_course(tmp, path, landmarks, seed=0)
        return load_slam_course(tmp)


def fastslam_record(ds, version, dtype, device):
    """run_slam_course_fastslam's replay (FS_PARTICLES particles) over the
    first FS_F64_EVENTS events on numpy draws from FS_SEED, event by event:
    (poses (T, N, 3), logw (T, N)) as numpy."""
    import torch

    from rustrobotics_tpu_torch.mapping import slam_replay as sr

    t_len, n = FS_F64_EVENTS, FS_PARTICLES
    rng = np.random.default_rng(FS_SEED)
    draws = {"init": rng.standard_normal((n, 3))}
    if version == 2:
        draws["eps"] = rng.standard_normal((t_len, n, 3))
    else:
        draws["motion"] = rng.standard_normal((t_len, 3))
    draws["resample"] = rng.random(t_len)
    draws = {k: torch.tensor(v, dtype=dtype, device=device)
             for k, v in draws.items()}
    odometry, z, valid = sr._slam_inputs(ds, dtype, device)
    slam = sr._fastslam(ds, (1e-4, 2e-5, 5e-5, 2e-5), (0.2, 0.1), dtype,
                        device)
    parts = slam._init_particles(torch.zeros(3, dtype=dtype, device=device),
                                 draws["init"])
    poses, logw = [], []
    for t in range(t_len):
        one = {k: v[t:t + 1] for k, v in draws.items() if k != "init"}
        parts = sr._fastslam_replay(slam, parts, odometry[t:t + 1],
                                    z[t:t + 1], valid[t:t + 1], one, version)
        poses.append(parts.poses)
        logw.append(parts.logw)
    return torch.stack(poses).cpu().numpy(), torch.stack(logw).cpu().numpy()


def chessboard_views(seed=VIS_SEED):
    """OpenCV's 9 x 6 chessboard (inner corners, VIS_SQUARE m squares)
    seen by K = VIS_K in VIS_VIEWS views, board tilted up to ±0.35 rad
    about x and y and ±0.2 about z, 0.35-0.6 m away: (object points
    (54, 2), ideal pixels (V, 54, 2) and the same through the radial model
    (VIS_K1, VIS_K2), each with N(0, VIS_PIXEL_NOISE²) noise, rs (V, 3,
    3), ts (V, 3)); numpy default_rng(seed)."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(9) * VIS_SQUARE, np.arange(6) * VIS_SQUARE)
    obj = np.stack([gx.ravel(), gy.ravel()], -1)
    obj3 = np.concatenate([obj, np.zeros((len(obj), 1))], 1)
    center = obj3.mean(0)
    kinv = np.linalg.inv(VIS_K)
    ideal, distorted, rs, ts = [], [], [], []
    for _ in range(VIS_VIEWS):
        r = _rot3(*rng.uniform([-0.35, -0.35, -0.2], [0.35, 0.35, 0.2]))
        t = -r @ center + rng.uniform([-0.03, -0.03, 0.35],
                                      [0.03, 0.03, 0.6])
        uv = _pixels(VIS_K, r, t, obj3)
        xn = np.concatenate([uv, np.ones((len(uv), 1))], 1) @ kinv.T
        r2 = np.sum(xn[:, :2] ** 2, -1, keepdims=True)
        uvd = uv + (uv - VIS_K[:2, 2]) * (VIS_K1 * r2 + VIS_K2 * r2 * r2)
        ideal.append(uv + rng.normal(size=uv.shape) * VIS_PIXEL_NOISE)
        distorted.append(uvd + rng.normal(size=uv.shape) * VIS_PIXEL_NOISE)
        rs.append(r)
        ts.append(t)
    return (obj, np.stack(ideal), np.stack(distorted), np.stack(rs),
            np.stack(ts))


def _rot3(rx, ry, rz):
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))


def _pixels(k, r, t, pts):
    uvw = (pts @ r.T + t) @ k.T
    return uvw[:, :2] / uvw[:, 2:3]


def _quat(r):
    """Rotation matrix (near the identity) -> quaternion [w, x, y, z]."""
    s = np.sqrt(np.trace(r) + 1.0) * 2
    return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                     (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])


def vision_scenes(seed=VIS_SEED):
    """Every synthetic vision input (numpy, default_rng(seed)): the DLT's
    VIS_DLT_POINTS points, the PnP problem (VIS_PNP_POINTS points, a
    VIS_PNP_OUTLIERS share of bearings replaced by random directions, the
    VIS_PNP_HYPOTHESES sample triples), VIS_TRI_POINTS points in
    VIS_TRI_VIEWS views, and the bundle-adjustment problem at BAL
    Ladybug-49's shape (BA_CAMERAS cameras 1 m apart along a street,
    BA_POINTS points 5-15 m ahead, each seen by a run of consecutive
    cameras, BA_OBSERVATIONS observations with N(0, 0.1²) px noise; the
    guess perturbed by N(0, 0.05²) on camera translations but the first,
    and on the points)."""
    rng = np.random.default_rng(seed)
    out = {}
    r, t = _rot3(0.2, 0.1, -0.3), np.array([0.3, 0.1, 3.0])
    pts = rng.uniform(-1, 1, (VIS_DLT_POINTS, 3))
    out["dlt"] = (pts, _pixels(VIS_K, r, t, pts)
                  + rng.normal(size=(VIS_DLT_POINTS, 2)) * 0.05, r, t)
    r, t = _rot3(0.15, -0.25, 0.3), np.array([0.1, 0.2, 1.2])
    world = rng.uniform(-1, 1, (VIS_PNP_POINTS, 3)) + np.array([0, 0, 3.0])
    cam = world @ r.T + t
    bear = cam / np.linalg.norm(cam, axis=1, keepdims=True)
    bad = rng.choice(VIS_PNP_POINTS, int(VIS_PNP_OUTLIERS * VIS_PNP_POINTS),
                     replace=False)
    nd = rng.normal(size=(len(bad), 3))
    bear[bad] = nd / np.linalg.norm(nd, axis=1, keepdims=True)
    idx = rng.integers(0, VIS_PNP_POINTS, (VIS_PNP_HYPOTHESES, 3))
    out["pnp"] = (world, bear, idx, bad, r, t)
    specs = [(0, 0, 0, 0, 0, 0), (0.05, -0.1, 0.02, 0.4, 0, 0.1),
             (-0.08, 0.12, 0.0, -0.35, 0.1, 0.05),
             (0.03, 0.08, -0.02, 0.2, -0.3, 0.0),
             (-0.04, -0.06, 0.03, -0.2, 0.25, 0.1)][:VIS_TRI_VIEWS]
    rts = [(_rot3(*s[:3]), np.array(s[3:])) for s in specs]
    ps = np.stack([VIS_K @ np.concatenate([r, t[:, None]], 1)
                   for r, t in rts])
    pts = rng.uniform(-1, 1, (VIS_TRI_POINTS, 3)) + np.array([0, 0, 4.0])
    obs = np.stack([_pixels(VIS_K, r, t, pts) for r, t in rts], 1)
    out["tri"] = (ps, obs + rng.normal(size=obs.shape) * 0.1, pts)
    out["ba"] = _ba_scene(rng)
    return out


def _ba_scene(rng):
    c, p = BA_CAMERAS, BA_POINTS
    lengths = rng.integers(2, 7, p)
    while lengths.sum() != BA_OBSERVATIONS:
        i = rng.integers(p)
        step = 1 if lengths.sum() < BA_OBSERVATIONS else -1
        if 2 <= lengths[i] + step <= 8:
            lengths[i] += step
    first = rng.integers(0, c - lengths + 1)
    centers = np.stack([np.arange(c) * 1.0, np.zeros(c), np.zeros(c)], -1)
    rots = [_rot3(*rng.normal(size=3) * 0.02) for _ in range(c)]
    cams = np.stack([np.concatenate([-r @ ctr, _quat(r)])
                     for r, ctr in zip(rots, centers)])
    mid = first + (lengths - 1) / 2.0
    pts = np.stack([mid + rng.uniform(-1.5, 1.5, p),
                    rng.uniform(-2.0, 2.0, p), rng.uniform(5.0, 15.0, p)], -1)
    obs_cam = np.concatenate([np.arange(f, f + n)
                              for f, n in zip(first, lengths)])
    obs_pt = np.repeat(np.arange(p), lengths)
    uv = np.concatenate([
        _pixels(VIS_K, rots[ci], cams[ci, :3], pts[pi][None])
        for ci, pi in zip(obs_cam, obs_pt)])
    uv = uv + rng.normal(size=uv.shape) * 0.1
    cams0 = cams.copy()
    cams0[1:, :3] += rng.normal(size=(c - 1, 3)) * 0.05
    pts0 = pts + rng.normal(size=pts.shape) * 0.05
    return cams, pts, cams0, pts0, obs_cam, obs_pt, uv


def vision_runs(device, dtype):
    """Every vision entry point on vision_scenes() and chessboard_views()
    in dtype on device: a dict of numpy results, and of each call's host
    seconds (the call's result synchronized)."""
    import torch

    from rustrobotics_tpu_torch import vision
    from rustrobotics_tpu_torch.vision.bundle import bundle_adjust
    from rustrobotics_tpu_torch.vision.p3p import _pnp_ransac

    def tt(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    scenes = vision_scenes()
    obj, ideal, distorted, rs, ts = chessboard_views()
    k = tt(VIS_K)
    out, secs = {}, {}

    def run(name, fn):
        res, secs[name] = _timed(fn, device)
        out[name] = [r.detach().cpu().numpy() if isinstance(r, torch.Tensor)
                     else np.asarray(r) for r in res]

    run("zhang", lambda: vision.zhang_calibrate(tt(obj), tt(ideal)))
    run("radial", lambda: (vision.estimate_radial_distortion(
        k, tt(rs), tt(ts), tt(obj), tt(distorted)),))
    kz, rz, tz = (tt(a) for a in out["zhang"][:3])
    out["radial zhang"] = [vision.estimate_radial_distortion(
        kz, rz, tz, tt(obj), tt(distorted)).cpu().numpy()]
    pts, uv = scenes["dlt"][:2]
    run("dlt", lambda: (lambda p, krt: (p, *krt))(
        *vision.dlt_camera(tt(pts), tt(uv))))
    world, bear, idx = scenes["pnp"][:3]
    run("pnp", lambda: _pnp_ransac(tt(world), tt(bear),
                                   torch.tensor(idx, device=device)))
    ps, obs = scenes["tri"][:2]
    run("tri", lambda: (vision.triangulate(tt(ps), tt(obs)),))
    _, _, cams0, pts0, obs_cam, obs_pt, uv = scenes["ba"]
    run("ba", lambda: (lambda c, p, e: (c, p, np.asarray(e)))(
        *bundle_adjust(k, tt(cams0), tt(pts0), obs_cam, obs_pt, tt(uv),
                       num_iterations=BA_ITERS, solver="lm")))
    return out, secs


def control_runs(device, dtype):
    """The control entry points in dtype on device, as numpy: the
    pendulum's DARE (max_iter 100000, epsilon 1e-10), its LQR gain,
    simulate_inverted_pendulum, and an LQG rollout of LQG_STEPS steps on
    numpy draws from LQG_SEED (the JAX LQG test's cart-pole)."""
    import torch

    from rustrobotics_tpu_torch.control import inverted_pendulum as ip
    from rustrobotics_tpu_torch.control import lqg
    from rustrobotics_tpu_torch.control.lqr import lqr, solve_dare

    def tt(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    lin = ip.InvertedPendulumModel.create(dtype=dtype,
                                          device=device).linearize(0.01)
    out = {"p": solve_dare(lin, max_iter=100000, epsilon=1e-10),
           "k": lqr(lin, max_iter=500, epsilon=0.01)}
    out["states"], out["commands"] = ip.simulate_inverted_pendulum(
        dtype=dtype, device=device)
    dt = 0.02
    g0, lp, mc, mp = 9.8, 0.5, 1.0, 0.1
    a = np.array([[1.0, dt, 0.0, 0.0], [0.0, 1.0, -dt * mp * g0 / mc, 0.0],
                  [0.0, 0.0, 1.0, dt],
                  [0.0, 0.0, dt * (mc + mp) * g0 / (lp * mc), 1.0]])
    b = np.array([[0.0], [dt / mc], [0.0], [-dt / (lp * mc)]])
    model = lqg.LinearTimeInvariantModel(
        a=tt(a), b=tt(b), q=tt(np.diag([1.0, 0.1, 10.0, 0.1])),
        r=tt(np.eye(1) * 0.1))
    ctrl = lqg.lqg(model, tt([[1.0, 0, 0, 0], [0, 0, 1.0, 0]]),
                   tt(np.eye(4) * 1e-5), tt(np.eye(2) * 1e-4))
    rng = np.random.default_rng(LQG_SEED)
    out["xs"], out["xhs"], out["us"] = lqg._rollout(
        ctrl, tt([0.3, 0.0, 0.15, 0.0]),
        tt(rng.standard_normal((LQG_STEPS, 4))),
        tt(rng.standard_normal((LQG_STEPS, 2))),
        tt(np.eye(4) * np.sqrt(1e-5)), tt(np.eye(2) * np.sqrt(1e-4)))
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def ekf_slam_prefix(ds, device):
    """run_slam_course's f64 state after the first SLAM_EKF_PARITY events
    of ds."""
    import torch

    from rustrobotics_tpu_torch.mapping import slam_replay as sr

    f64, n = torch.float64, SLAM_EKF_PARITY
    odometry, z, valid = sr._slam_inputs(ds, f64, device)
    slam = sr._ekf_slam(ds, (0.05, 0.01, 0.02, 0.01), (0.2, 0.1), f64, device)
    st0 = slam.init_state(torch.zeros(3, dtype=f64, device=device))
    return sr._replay(slam, st0, odometry[:n], z[:n], valid[:n])[0]


def slam_references():
    """The CPU f64 runs the SLAM, vision and control phases hold the card
    to, as numpy; run in a worker process beside cpu_references'."""
    import torch

    from rustrobotics_tpu_torch.mapping import slam_replay as sr

    torch.set_num_threads(2)
    refs = {"scan": scan_parity_run("cpu").numpy()}
    ds = slam_course_dataset(FE_LANDMARKS)
    traj, _ = sr.run_slam_course(ds, dtype=torch.float64, device="cpu")
    st = ekf_slam_prefix(ds, "cpu")
    refs["ekf slam"] = {"traj": traj, "x": st.x.numpy(), "cov": st.cov.numpy()}
    for version in (1, 2):
        refs[f"fastslam {version}"] = fastslam_record(ds, version,
                                                      torch.float64, "cpu")
    refs["vision"] = vision_runs("cpu", torch.float64)[0]
    refs["control"] = control_runs("cpu", torch.float64)
    return refs


def scan_phase(device, refs):
    """Phase scan-matching: (1) the JAX loop-closure test's room and size
    (SCAN_TEST_STEPS scans of SCAN_TEST_BEAMS beams on one lap), f32 on
    the card, with its gates: odometry alone leaves the loop open by more
    than 1 m, scan_matching_slam_pgo closes it below 0.1 m and keeps the
    mean drift within 1.05x odometry's; (2) a 2D lidar's width, SCAN_BEAMS
    beams over 360 degrees, SCAN_STEPS scans on SCAN_LAPS laps, a
    SCAN_GRID x SCAN_GRID grid at SCAN_RES m: ms per ICP alignment,
    icp_odometry scans/s, closures, the pipeline's seconds, occupancy
    scans/s, the map's free interior and occupied wall; (3) icp_odometry
    in f64 on the first SCAN_PARITY_SCANS scans, card against CPU."""
    import torch

    from rustrobotics_tpu_torch.geometry import se2
    from rustrobotics_tpu_torch.mapping import scan_matching as sm
    from rustrobotics_tpu_torch.mapping.icp import icp
    from rustrobotics_tpu_torch.mapping.occupancy import (
        OccupancyGrid,
        integrate_trajectory,
    )

    f32 = torch.float32
    gt, sc, an = scan_data(SCAN_TEST_STEPS, SCAN_TEST_BEAMS, 1, f32, device)
    poses_odo, _, _ = sm.icp_odometry(sc, an, SCAN_MAX_RANGE)
    (poses, _, graph), wall = _timed(lambda: sm.scan_matching_slam_pgo(
        sc, an, SCAN_MAX_RANGE, closure_gap=8, closure_radius=2.0,
        grid_size=120, resolution=0.2), device)
    truth = {"g": None}

    def gap(p):
        g, p = truth["g"], p.double().cpu()
        return float((se2.relative(p[0], p[-1])[:2]
                      - se2.relative(g[0], g[-1])[:2]).norm())

    def drift(p):
        g = truth["g"]
        return float((p[:, :2].double().cpu() - g[:, :2]).norm(dim=1).mean())

    truth["g"] = torch.tensor(gt)

    closures = graph.pp_from.shape[0] - (SCAN_TEST_STEPS - 1)
    print(f"[scan-matching] the JAX test's room, {SCAN_TEST_STEPS} scans x "
          f"{SCAN_TEST_BEAMS} beams, f32: loop gap odometry "
          f"{gap(poses_odo):.6g} m, after scan_matching_slam_pgo "
          f"{gap(poses):.6g} m ({closures} closures, {wall:.4f} s); mean "
          f"drift {drift(poses):.6g} m against odometry's "
          f"{drift(poses_odo):.6g}", flush=True)
    require(gap(poses_odo) > 1.0, "odometry alone leaves the loop open "
                                  "(> 1 m)")
    require(gap(poses) < 0.1, "scan_matching_slam_pgo closes the loop "
                              "(< 0.1 m)")
    require(drift(poses) <= 1.05 * drift(poses_odo),
            "mean drift within 1.05x odometry's")

    gt, sc, an = scan_data(SCAN_STEPS, SCAN_BEAMS, SCAN_LAPS, f32, device)
    truth["g"] = torch.tensor(gt)
    pts, _ = sm.scan_to_points(sc[:2], an, SCAN_MAX_RANGE)
    icp(pts[1], pts[0], 15, 0.9)  # warm-up
    # non-finite input: a NaN point makes the alignment NaN, not an error
    src = pts[1].clone()
    src[SCAN_NAN_POINT] = float("nan")
    nan_out = [icp(src, pts[0], 15, q) for q in (None, 0.9)]
    all_nan = all(bool(torch.isnan(o).all()) for out in nan_out for o in out)
    print(f"[scan-matching] ICP with a NaN point (with and without "
          f"reject_quantile 0.9): R, t and rmse all NaN {all_nan}",
          flush=True)
    require(all_nan, "[scan-matching] ICP with a NaN point returns NaN")
    _, wall = _timed(lambda: [icp(pts[1], pts[0], 15, 0.9)
                              for _ in range(10)], device)
    ms_icp = wall / 10 * 1e3
    icp_launches, icp_idle = launch_trace(lambda: icp(pts[1], pts[0], 15,
                                                      0.9), device)
    sm.icp_odometry(sc[:4], an, SCAN_MAX_RANGE)  # warm-up
    (poses_odo, _, _), wall_odo = _timed(
        lambda: sm.icp_odometry(sc, an, SCAN_MAX_RANGE), device)
    kw = dict(closure_gap=8, closure_radius=2.0, grid_size=SCAN_GRID,
              resolution=SCAN_RES)
    (poses, grid, graph), wall_pgo = _timed(lambda: sm.scan_matching_slam_pgo(
        sc, an, SCAN_MAX_RANGE, **kw), device)
    closures = graph.pp_from.shape[0] - (SCAN_STEPS - 1)
    empty = OccupancyGrid.create(SCAN_GRID, SCAN_GRID, SCAN_RES,
                                 origin=(-SCAN_GRID * SCAN_RES / 2,) * 2,
                                 dtype=f32, device=device)
    grid2, wall_occ = _timed(lambda: integrate_trajectory(
        empty, poses, sc, an, SCAN_MAX_RANGE, 96), device)
    prob = grid2.probability.cpu().numpy()

    def cells_at(xy):
        """p at world points xy (n, 2): the map is in the first pose's
        frame."""
        c0, s0 = np.cos(gt[0, 2]), np.sin(gt[0, 2])
        d = xy - gt[0, :2]
        rc = (np.stack([c0 * d[:, 0] + s0 * d[:, 1],
                        -s0 * d[:, 0] + c0 * d[:, 1]], -1)
              + SCAN_GRID * SCAN_RES / 2) / SCAN_RES
        return prob[np.floor(rc[:, 1]).astype(int),
                    np.floor(rc[:, 0]).astype(int)]

    g1 = np.linspace(-0.5, 0.5, 11)
    interior = cells_at(np.stack(np.meshgrid(g1, g1), -1).reshape(-1, 2))
    interior = interior.max()
    wx, wy = np.meshgrid(np.linspace(-1.0, 1.0, 21),
                         -SCAN_HALF + np.array([-1, 0, 1]) * SCAN_RES)
    wall_band = cells_at(np.stack([wx.ravel(), wy.ravel()], -1))
    print(f"[scan-matching] lidar width, {SCAN_STEPS} scans x {SCAN_BEAMS} "
          f"beams on {SCAN_LAPS} laps, f32: one ICP alignment (15 "
          f"iterations, {SCAN_BEAMS} x {SCAN_BEAMS}) {ms_icp:.4f} ms, "
          f"{_fmt(None if icp_launches is None else icp_launches / 15)} "
          f"device launches an iteration, idle share {_fmt(icp_idle)}; "
          f"icp_odometry {SCAN_STEPS / wall_odo:.4f} scans/s; "
          f"scan_matching_slam_pgo {wall_pgo:.4f} s ({closures} closures, "
          f"{SCAN_GRID} x {SCAN_GRID} grid at {SCAN_RES} m); occupancy "
          f"integration {SCAN_STEPS / wall_occ:.4f} scans/s; loop gap "
          f"odometry {gap(poses_odo):.6g} m, optimized {gap(poses):.6g} m; "
          f"mean drift {drift(poses):.6g} m against odometry's "
          f"{drift(poses_odo):.6g}", flush=True)
    print(f"[scan-matching] map: interior max p {interior:.4f}, wall band "
          f"max p {wall_band.max():.4f}; grid equal to the pipeline's: "
          f"{bool(torch.equal(grid2.log_odds, grid.log_odds))}", flush=True)
    card = scan_parity_run(device)
    diff = _maxdiff(card, refs.get()["scan"], heading=2)
    print(f"[scan-matching] icp_odometry f64, first {SCAN_PARITY_SCANS} "
          f"scans, card against CPU: max |diff| {diff:.6g}", flush=True)
    require(closures > 0 and gap(poses) < gap(poses_odo) / 5
            and drift(poses) <= 1.05 * drift(poses_odo),
            "lidar-width loop gap cut 5x by ICP closures, mean drift within "
            "1.05x odometry's")
    require(interior < 0.25 and wall_band.max() > 0.7,
            "map interior free (p < 0.25), wall occupied (p > 0.7)")
    require(diff <= SLAM_TOL["scan_f64"],
            f"icp_odometry f64 card within {SLAM_TOL['scan_f64']} of CPU "
            f"({diff:.3g})")
    return dict(ms_icp=ms_icp, odometry_scans_per_s=SCAN_STEPS / wall_odo,
                pgo_s=wall_pgo, closures=closures,
                occupancy_scans_per_s=SCAN_STEPS / wall_occ)


def ekf_sim(num_steps=400, num_landmarks=6, dt=0.1, seed=0):
    """tests/test_ekf_slam.py::_simulate (numpy): the true poses (T, 3),
    landmarks (L, 2), measurements (T, L, 2), masks (T, L), control, dt."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, num_landmarks, endpoint=False)
    lms = 6.0 * np.stack([np.cos(ang), np.sin(ang)], -1)
    x = np.array([3.0, 0.0, np.pi / 2])
    u = np.array([1.0, 1.0 / 3.0])
    poses, zs, masks = [], [], []
    for _ in range(num_steps):
        th = x[2]
        x = x + np.array([u[0] / u[1] * (-np.sin(th) + np.sin(th + u[1] * dt)),
                          u[0] / u[1] * (np.cos(th) - np.cos(th + u[1] * dt)),
                          u[1] * dt])
        x[2] = _wrap(x[2])
        poses.append(x.copy())
        d = lms - x[:2]
        r = np.hypot(d[:, 0], d[:, 1])
        z = np.zeros((num_landmarks, 2))
        for kk in np.flatnonzero(r < 5.0):
            z[kk] = [r[kk] + rng.normal(0, 0.03),
                     np.arctan2(d[kk, 1], d[kk, 0]) - x[2]
                     + rng.normal(0, 0.01)]
        zs.append(z)
        masks.append(r < 5.0)
    return (np.asarray(poses), lms, np.asarray(zs), np.asarray(masks), u, dt)


def ekf_sim_gates(device):
    """The JAX EKF-SLAM tests' gates on their simulation, f32 on the card:
    known correspondences (ATE < 0.15 m, all 6 seen, landmarks within
    0.2 m, covariance symmetric and PSD), unknown correspondences (ATE <
    0.2 m, 6 tracks, each within 0.25 m of its own landmark) and Schmidt
    (the last 40 errors below 0.2 m with half the map frozen, trace at
    least the full filter's). Returns the readings."""
    import torch

    from rustrobotics_tpu_torch.mapping.ekf_slam import (
        EkfSlamKnownCorrespondences,
        schmidt_step,
    )
    from rustrobotics_tpu_torch.models import VelocityMotionModel

    f32 = torch.float32
    poses, lms, zs, masks, u, dt = ekf_sim()

    def slam(extra=0, alphas=(0.005,) * 4 + (0.001,) * 2,
             q=(0.03 ** 2, 0.01 ** 2)):
        return EkfSlamKnownCorrespondences.create(
            q=torch.diag(torch.tensor(q, dtype=f32)).to(device),
            motion_model=VelocityMotionModel.create(alphas, device, f32),
            max_landmarks=len(lms) + extra)

    ut = torch.tensor(u, dtype=f32, device=device)
    z_t = torch.tensor(zs, dtype=f32, device=device)
    x0 = torch.tensor([3.0, 0.0, np.pi / 2], dtype=f32, device=device)
    out = {}
    s = slam()
    st, traj = s.init_state(x0), []
    for t in range(len(zs)):
        st = s.predict(st, ut, dt)
        for kk in np.flatnonzero(masks[t]):
            st = s._update(st, int(kk), z_t[t, kk])
        traj.append(st.x[:3])
    traj = torch.stack(traj).double().cpu().numpy()
    out["known_ate"] = float(np.sqrt(np.mean(np.sum(
        (traj[:, :2] - poses[:, :2]) ** 2, -1))))
    est = st.landmarks.double().cpu().numpy()
    out["known_lm"] = float(np.linalg.norm(est - lms, axis=-1).max())
    cov = st.cov.double().cpu().numpy()
    out["known_asym"] = float(np.abs(cov - cov.T).max())
    out["known_min_eig"] = float(np.linalg.eigvalsh(cov).min())
    seen_known = int(st.seen.sum())

    s = slam(extra=4)
    rng = np.random.default_rng(7)
    st, traj = s.init_state(x0), []
    for t in range(len(zs)):
        p = rng.permutation(zs.shape[1])
        st = s.predict(st, ut, dt)
        for m in np.flatnonzero(masks[t][p]):
            kk, _, usable = s.associate(st, z_t[t, p[m]])
            st = s.update_one(st, kk, z_t[t, p[m]], usable)
        traj.append(st.x[:3])
    traj = torch.stack(traj).double().cpu().numpy()
    out["unknown_ate"] = float(np.sqrt(np.mean(np.sum(
        (traj[:, :2] - poses[:, :2]) ** 2, -1))))
    seen = st.seen.cpu().numpy()
    est = st.landmarks.double().cpu().numpy()[seen]
    d = np.linalg.norm(est[:, None, :] - lms[None, :, :], axis=-1)
    out["unknown_tracks"] = int(seen.sum())
    out["unknown_lm"] = float(d.min(axis=1).max())
    unique = len(set(d.argmin(axis=1))) == len(lms)

    for dtype in (torch.float64, f32):
        out[f"schmidt {str(dtype)[6:]}"] = schmidt_sim(device, dtype)
    print(f"[ekf-slam] the JAX tests' simulation, f32 on the card: known "
          f"ATE {out['known_ate']:.6g} m, landmarks within "
          f"{out['known_lm']:.6g} m ({seen_known} seen), covariance "
          f"asymmetry {out['known_asym']:.3g}, min eigenvalue "
          f"{out['known_min_eig']:.3g}; unknown ATE {out['unknown_ate']:.6g}"
          f" m, {out['unknown_tracks']} tracks within {out['unknown_lm']:.6g}"
          f" m", flush=True)
    for key in ("schmidt float64", "schmidt float32"):
        err, eig, excess = out[key]
        print(f"[ekf-slam] the JAX Schmidt test, {key[8:]}: last-40 error "
              f"{err:.6g} m, min eigenvalue {eig:.3g}, trace over the full "
              f"filter's {excess:.6g}", flush=True)
    require(out["known_ate"] < 0.15 and seen_known == len(lms)
            and out["known_lm"] < 0.2,
            "EKF-SLAM f32: ATE < 0.15 m, every landmark seen within 0.2 m")
    require(out["known_asym"] <= 1e-6 and out["known_min_eig"] > -1e-6,
            "EKF-SLAM f32 covariance symmetric (1e-6) and PSD (-1e-6)")
    require(out["unknown_ate"] < 0.2 and out["unknown_tracks"] == len(lms)
            and out["unknown_lm"] < 0.25 and unique,
            "unknown correspondences f32: ATE < 0.2 m, one track per "
            "landmark within 0.25 m")
    err, eig, excess = out["schmidt float64"]
    require(err < 0.2 and eig > -1e-10 and excess >= -1e-9,
            "Schmidt f64: last-40 error < 0.2 m, PSD, trace >= the full "
            "filter's (its general-gain form loses PSD in f32, in the JAX "
            "package too: printed above)")
    return out


def schmidt_sim(device, dtype):
    """tests/test_ekf_slam.py::test_schmidt_ekf_consider_states in dtype
    on device: the full filter and the one with landmarks 3-5 frozen
    from step 60, one noise stream for both runs. Returns the consider
    run's last-40 mean error, its covariance's least eigenvalue and its
    trace less the full run's."""
    import torch

    from rustrobotics_tpu_torch.mapping.ekf_slam import (
        EkfSlamKnownCorrespondences,
        schmidt_step,
    )
    from rustrobotics_tpu_torch.models import VelocityMotionModel

    lms = np.array([[4.0, 0.0], [0.0, 4.0], [-4.0, 0.0], [0.0, -4.0],
                    [3.0, 3.0], [-3.0, 3.0]])
    slam = EkfSlamKnownCorrespondences.create(
        q=torch.diag(torch.tensor([0.1, 0.05], dtype=dtype) ** 2).to(device),
        motion_model=VelocityMotionModel.create((0.02, 0.005, 0.01, 0.005),
                                                device, dtype),
        max_landmarks=len(lms))
    u = torch.tensor([0.8, 0.25], dtype=dtype, device=device)
    ids = torch.arange(len(lms), device=device)
    ones = torch.ones(len(lms), dtype=torch.bool, device=device)
    rng = np.random.default_rng(0)
    states, errs = {}, {}
    for consider in (False, True):
        st = slam.init_state(torch.zeros(3, dtype=dtype, device=device))
        pose, est, truth = np.zeros(3), [], []
        for t in range(200):
            th = pose[2]
            pose = pose + np.array([0.8 * 0.1 * np.cos(th),
                                    0.8 * 0.1 * np.sin(th), 0.25 * 0.1])
            d = lms - pose[:2]
            z = np.stack([np.linalg.norm(d, axis=1)
                          + rng.normal(size=len(lms)) * 0.1,
                          np.arctan2(d[:, 1], d[:, 0]) - pose[2]
                          + rng.normal(size=len(lms)) * 0.05], -1)
            cl = torch.tensor([False] * 3 + [consider and t >= 60] * 3,
                              device=device)
            st = schmidt_step(slam, st, u, True, ids,
                              torch.tensor(z, dtype=dtype, device=device),
                              ones, 0.1, cl)
            est.append(st.x[:2])
            truth.append(pose[:2].copy())
        states[consider] = st.cov.double().cpu().numpy()
        errs[consider] = np.linalg.norm(torch.stack(est).double().cpu()
                                        .numpy() - np.asarray(truth), axis=-1)
    return (float(errs[True][-40:].mean()),
            float(np.linalg.eigvalsh(states[True]).min()),
            float(np.trace(states[True]) - np.trace(states[False])))


def ekf_slam_phase(device, refs):
    """Phase ekf-slam: run_slam_course on the front end's log (FE_LANDMARKS
    landmarks) in f64 (held event for event to the CPU f64 run) and f32,
    and on a SLAM_BIG_LANDMARKS-landmark log along the same path (a
    3 + 2 x SLAM_BIG_LANDMARKS state); step_unknown on the
    FE_LANDMARKS-landmark stream with its ids hidden; schmidt_step with
    the first half of the slots as consider states; events/s, device
    launches per event and idle share of a traced replay of TRACE_EVENTS
    events, no host read in a replay; the JAX tests' gates on their
    simulation (ekf_sim_gates)."""
    import torch

    from rustrobotics_tpu_torch.mapping import slam_replay as sr
    from rustrobotics_tpu_torch.mapping.ekf_slam import schmidt_step

    f32, f64 = torch.float32, torch.float64
    out = {"sim": ekf_sim_gates(device)}
    logs = {FE_LANDMARKS: slam_course_dataset(FE_LANDMARKS),
            SLAM_BIG_LANDMARKS: slam_course_dataset(SLAM_BIG_LANDMARKS)}
    runs = {}
    for lms_count, ds in logs.items():
        t_len = len(ds.odometry)
        for dtype in ((f64, f32) if lms_count == FE_LANDMARKS else (f32,)):
            (traj, st), wall = _timed(lambda: sr.run_slam_course(
                ds, dtype=dtype, device=_on(device)), device)
            mx, mean, seen = sr.landmark_map_error(ds, st)
            runs[(lms_count, dtype)] = (traj, st)
            out[f"{lms_count} {str(dtype)[6:]} events/s"] = t_len / wall
            print(f"[ekf-slam] run_slam_course, {lms_count} landmarks "
                  f"(state {3 + 2 * lms_count}), {t_len} events, "
                  f"{str(dtype)[6:]}: {t_len / wall:.4f} events/s; map "
                  f"error mean {mean:.6g} m, max {mx:.6g} m, {seen} seen",
                  flush=True)
            require(bool(torch.isfinite(st.cov).all()) and np.isfinite(
                traj).all(), f"{lms_count}-landmark {dtype} replay finite")
    drift = _maxdiff(runs[(FE_LANDMARKS, f32)][0],
                     runs[(FE_LANDMARKS, f64)][0], heading=2)
    print(f"[ekf-slam] {FE_LANDMARKS} landmarks: f32 trajectory against f64 "
          f"on the card: max |diff| {drift:.6g}", flush=True)
    ref = refs.get()["ekf slam"]
    traj, st = runs[(FE_LANDMARKS, f64)]
    n = SLAM_EKF_PARITY
    prefix = ekf_slam_prefix(logs[FE_LANDMARKS], device)
    diff = max(_maxdiff(traj[:n], ref["traj"][:n], heading=2),
               _maxdiff(prefix.x, ref["x"]), _maxdiff(prefix.cov, ref["cov"]))
    d = traj - ref["traj"]
    d[:, 2] = _wrap(d[:, 2])
    steps = np.abs(d).max(1)
    part = np.flatnonzero(steps > SLAM_TOL["ekf_f64"])
    eig = float(torch.linalg.eigvalsh(st.cov.cpu()).min())
    print(f"[ekf-slam] f64, card against CPU, the first {n} poses and the "
          f"state there: max |diff| {diff:.6g}; the trajectories part (> "
          f"{SLAM_TOL['ekf_f64']}) from event "
          f"{int(part[0]) if len(part) else 'none'}; least eigenvalue of "
          f"the final f64 covariance {eig:.6g}", flush=True)
    require(diff <= SLAM_TOL["ekf_f64"], f"EKF-SLAM f64 card within "
                                         f"{SLAM_TOL['ekf_f64']} of CPU "
                                         f"over {n} events ({diff:.3g})")

    ds = logs[FE_LANDMARKS]
    odometry, z, valid = sr._slam_inputs(ds, f32, device)
    slam = sr._ekf_slam(ds, (0.05, 0.01, 0.02, 0.01), (0.2, 0.1), f32,
                        device, extra_slots=SLAM_SPARE_SLOTS)
    state0 = slam.init_state(torch.zeros(3, dtype=f32, device=device))

    def unknown(events=len(ds.odometry)):
        st = state0
        for t in range(events):
            st = slam.predict(st, odometry[t], 0.0)
            for _, m in valid[t]:
                kk, _, usable = slam.associate(st, z[t, m])
                st = slam.update_one(st, kk, z[t, m], usable)
        return st

    unknown(TRACE_EVENTS)  # warm-up
    st_u, wall = _timed(unknown, device)
    seen = st_u.seen.cpu().numpy()
    est = st_u.landmarks.double().cpu().numpy()[seen]
    near = np.linalg.norm(est[:, None] - ds.landmarks[None], axis=-1).min(1)
    print(f"[ekf-slam] step_unknown (ids hidden, {FE_LANDMARKS} + "
          f"{SLAM_SPARE_SLOTS} slots), f32: {len(ds.odometry) / wall:.4f} "
          f"events/s; {int(seen.sum())} tracks, nearest true landmark mean "
          f"{near.mean():.6g} m, max {near.max():.6g} m", flush=True)
    require(seen.any() and np.isfinite(est).all(), "step_unknown tracks "
                                                   "finite")

    consider = torch.arange(FE_LANDMARKS + SLAM_SPARE_SLOTS,
                            device=device) < FE_LANDMARKS // 2

    def schmidt():
        st = state0
        for t in range(len(ds.odometry)):
            st = schmidt_step(slam, st, odometry[t], True,
                              [k for k, _ in valid[t]],
                              [z[t, m] for _, m in valid[t]],
                              [True] * len(valid[t]), 0.0, consider)
        return st

    st_s, wall = _timed(schmidt, device)
    lm = st_s.landmarks.double().cpu().numpy()[:FE_LANDMARKS]
    err = np.linalg.norm(lm - ds.landmarks, axis=-1)
    half = FE_LANDMARKS // 2
    print(f"[ekf-slam] schmidt_step (slots 0-{half - 1} consider states), "
          f"f32: {len(ds.odometry) / wall:.4f} events/s; map error consider "
          f"half mean {err[:half].mean():.6g} m, active half "
          f"{err[half:].mean():.6g} m", flush=True)
    require(np.isfinite(lm).all(), "Schmidt replay finite")

    ev = TRACE_EVENTS
    traced = {"odometry": odometry[:ev], "z": z[:ev], "valid": valid[:ev]}
    slam_k = sr._ekf_slam(ds, (0.05, 0.01, 0.02, 0.01), (0.2, 0.1), f32,
                          device)
    st0 = slam_k.init_state(torch.zeros(3, dtype=f32, device=device))

    def replay():
        return sr._replay(slam_k, st0, traced["odometry"], traced["z"],
                          traced["valid"])

    launches, idle = launch_trace(replay, device)
    per = None if launches is None else launches / ev
    no_sync = no_host_read("ekf-slam", replay, device)
    print(f"[ekf-slam] f32 replay of {ev} events under torch.profiler: "
          f"device launches per event {_fmt(per)}, idle share {_fmt(idle)}",
          flush=True)
    require(no_sync, "the EKF-SLAM replay makes no host read (CUDA sync "
                     "debug mode)")
    out.update(launches_per_event=per, idle_share=idle)
    return out


def fastslam_phase(device, refs):
    """Phase fastslam: run_slam_course_fastslam version 1 and 2 at
    FS_PARTICLES particles on the front end's log, f32 (events/s, map
    error); the same replays in f64 on FS_SEED's numpy draws, card against
    CPU event for event up to the first resample whose indices differ;
    fastslam_step_unknown over FS_UNKNOWN_EVENTS events of the stream with
    its ids hidden; the JAX FastSLAM 2.0 test's gate on its simulation and
    its own keys' draws (tests/data/fastslam2_gate_draws.npz), and
    FS2_SEEDS other seeds printed; launches per event, idle share, no host
    read."""
    import pathlib

    import torch

    from rustrobotics_tpu_torch.mapping import slam_replay as sr
    from rustrobotics_tpu_torch.mapping.fastslam import (
        FastSlam,
        _fastslam2_step,
        _fastslam_step_unknown,
    )
    from rustrobotics_tpu_torch.models import VelocityMotionModel

    f32, f64 = torch.float32, torch.float64
    ds = slam_course_dataset(FE_LANDMARKS)
    t_len = len(ds.odometry)
    out = {}
    for version in (1, 2):
        def entry(version=version):
            return sr.run_slam_course_fastslam(
                ds, num_particles=FS_PARTICLES, version=version, dtype=f32,
                device=_on(device))

        (parts, est, seen), wall = _timed(entry, device)
        err = np.linalg.norm(est[seen] - ds.landmarks[seen], axis=-1)
        out[f"v{version} events/s"] = t_len / wall
        print(f"[fastslam] run_slam_course_fastslam version {version}, "
              f"{FS_PARTICLES} particles, {t_len} events, f32: "
              f"{t_len / wall:.4f} events/s; map error mean {err.mean():.6g}"
              f" m, max {err.max():.6g} m, {int(seen.sum())} seen",
              flush=True)
        require(bool(torch.isfinite(parts.poses).all()) and seen.any(),
                f"FastSLAM {version} f32 cloud finite")
        poses, logw = fastslam_record(ds, version, f64, device)
        ref_poses, ref_logw = refs.get()[f"fastslam {version}"]
        n64 = FS_F64_EVENTS
        d = np.abs(poses - ref_poses).reshape(n64, -1).max(1)
        d = np.maximum(d, np.abs(logw - ref_logw).max(1))
        bad = np.flatnonzero(d > SLAM_TOL["fastslam_f64"])
        agree = int(bad[0]) if len(bad) else n64
        reset = (agree < n64 and ((logw[agree] == 0).all()
                                  or (ref_logw[agree] == 0).all()))
        print(f"[fastslam] version {version} f64 on FS_SEED's draws, card "
              f"against CPU: the first {agree} of {n64} events within "
              f"{SLAM_TOL['fastslam_f64']} (max |diff| "
              f"{d[:agree].max() if agree else math.nan:.6g})"
              + (f"; at event {agree} a resample's rows differ"
                 if agree < n64 else ""), flush=True)
        require(agree == n64 or (reset and agree > 0),
                f"FastSLAM {version} f64 card equals CPU up to a resample "
                f"({agree} events)")

    odometry, z, valid = sr._slam_inputs(ds, f32, device)
    slam_u = sr._fastslam(ds, (1e-4, 2e-5, 5e-5, 2e-5), (0.2, 0.1), f32,
                          device, extra_slots=SLAM_SPARE_SLOTS)
    gen = torch.Generator(device).manual_seed(FS_SEED)
    noise = torch.randn((FS_UNKNOWN_EVENTS, 3), generator=gen, dtype=f32,
                        device=device)
    uniforms = torch.rand((FS_UNKNOWN_EVENTS,), generator=gen, dtype=f32,
                          device=device)
    p0 = slam_u._init_particles(torch.zeros(3, dtype=f32, device=device),
                                torch.zeros((FS_PARTICLES, 3), device=device))

    def unknown(events=FS_UNKNOWN_EVENTS):
        p = p0
        for t in range(events):
            p = _fastslam_step_unknown(slam_u, p, odometry[t], True,
                                       [z[t, m] for _, m in valid[t]],
                                       [True] * len(valid[t]), 0.0, noise[t],
                                       uniforms[t])
        return p

    unknown(10)  # warm-up
    p_u, wall = _timed(unknown, device)
    tracks = p_u.seen.sum(1).float()
    print(f"[fastslam] fastslam_step_unknown, {FS_UNKNOWN_EVENTS} events, "
          f"{FS_PARTICLES} particles, f32: {FS_UNKNOWN_EVENTS / wall:.4f} "
          f"events/s; tracks per particle mean {float(tracks.mean()):.4f}",
          flush=True)
    require(bool(torch.isfinite(p_u.poses).all()), "unknown-correspondence "
                                                   "cloud finite")

    lms, events, dt = fastslam_sim(220)
    gate = dict(np.load(pathlib.Path(__file__).resolve().parent / "tests"
                        / "data" / "fastslam2_gate_draws.npz"))
    slam_g = FastSlam.create(
        q=torch.diag(torch.tensor([0.08, 0.04], dtype=f32) ** 2).to(device),
        motion_model=VelocityMotionModel.create(
            [0.04, 0.02, 0.015, 0.008, 0.008, 0.004], device, f32),
        max_landmarks=len(lms))
    inputs = [tuple(torch.tensor(a, dtype=f32 if a.dtype.kind == "f"
                                 else None, device=device)
                    for a in ev[:4]) for ev in events]
    truth = np.stack([ev[4] for ev in events])

    def gate_run(version, draws):
        p = slam_g._init_particles(torch.zeros(3, dtype=f32, device=device),
                                   draws["init"])
        est = []
        for i, (u, ids, zz, vis) in enumerate(inputs):
            args = (u, True, ids, zz, vis, dt)
            if version == 2:
                p = _fastslam2_step(slam_g, p, *args, draws["eps"][i],
                                    draws["resample"][i])
            else:
                p = slam_g._step(p, *args, draws["vel"][i],
                                 draws["resample"][i])
            est.append(slam_g.estimate(p)[0][:2])
        e = np.linalg.norm(torch.stack(est).double().cpu().numpy()
                           - truth[:, :2], axis=-1)
        return float(e[-40:].mean())

    def as_dev(d):
        return {k: torch.tensor(v, dtype=f32, device=device)
                for k, v in d.items()}

    err2 = gate_run(2, as_dev(gate))
    err1 = gate_run(1, as_dev(gate))
    seeds = []
    for seed in range(FS2_SEEDS):
        rng = np.random.default_rng(seed)
        d = {"init": rng.standard_normal((12, 3)),
             "vel": rng.standard_normal((220, 3, 12)),
             "eps": rng.standard_normal((220, 12, 3)),
             "resample": rng.random(220)}
        seeds.append((gate_run(2, as_dev(d)), gate_run(1, as_dev(d))))
    print(f"[fastslam] the JAX FastSLAM 2.0 test (12 particles, 220 events) "
          f"on its keys' draws, f32: last-40 error version 2 {err2:.6g} m, "
          f"version 1 {err1:.6g} m (the JAX test reads 0.18 / 0.42); on "
          f"numpy seeds 0-{FS2_SEEDS - 1}: "
          + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in seeds), flush=True)
    require(err2 < 0.35 and err2 <= 0.8 * err1,
            "FastSLAM 2.0 error < 0.35 m and <= 0.8x FastSLAM 1.0's on the "
            "JAX test's draws")

    slam_t = sr._fastslam(ds, (1e-4, 2e-5, 5e-5, 2e-5), (0.2, 0.1), f32,
                          device)
    ev = TRACE_EVENTS
    draws = {"motion": noise[:ev], "resample": uniforms[:ev]}
    pt0 = slam_t._init_particles(torch.zeros(3, dtype=f32, device=device),
                                 torch.zeros((FS_PARTICLES, 3), device=device))

    def replay():
        return sr._fastslam_replay(slam_t, pt0, odometry[:ev], z[:ev],
                                   valid[:ev], draws, 1)

    launches, idle = launch_trace(replay, device)
    per = None if launches is None else launches / ev
    no_sync = no_host_read("fastslam", replay, device)
    print(f"[fastslam] version 1 f32 replay of {ev} events under "
          f"torch.profiler: device launches per event {_fmt(per)}, idle "
          f"share {_fmt(idle)}", flush=True)
    require(no_sync, "the FastSLAM replay makes no host read (CUDA sync "
                     "debug mode)")
    out.update(gate=(err2, err1), seeds=seeds, launches_per_event=per,
               idle_share=idle)
    return out


def fastslam_sim(steps, num_landmarks=6, seed=0, unoise=(0.2, 0.12),
                 vis_r=9.0):
    """tests/test_new_components.py::_fastslam_sim (numpy): a list of
    (control, ids, measurements, visible, true pose) events, and the
    landmarks and dt."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, num_landmarks, endpoint=False)
    lms = 5.6 * np.stack([np.cos(ang), np.sin(ang)], -1) + np.array([0, 5.6])
    dt, pose, events = 0.1, np.zeros(3), []
    for _ in range(steps):
        u = np.array([1.0, 0.18])
        nu = u + rng.normal(size=2) * unoise
        pose = np.array([pose[0] + nu[0] * dt * np.cos(pose[2]),
                         pose[1] + nu[0] * dt * np.sin(pose[2]),
                         pose[2] + nu[1] * dt])
        d = lms - pose[:2]
        rngs = np.linalg.norm(d, axis=1)
        z = np.stack([rngs + rng.normal(size=len(lms)) * 0.08,
                      np.arctan2(d[:, 1], d[:, 0]) - pose[2]
                      + rng.normal(size=len(lms)) * 0.04], -1)
        events.append((u, np.arange(len(lms)), z, rngs < vis_r, pose.copy()))
    return lms, events, dt


def vision_triangulate(ps, obs, device):
    """triangulate in f32 on the card, as numpy."""
    import torch

    from rustrobotics_tpu_torch import vision

    def tt(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    return vision.triangulate(tt(ps), tt(obs)).cpu().numpy()


def vision_phase(device, refs):
    """Phase vision: vision_runs in f32 and f64 on the card (ms a call;
    the f64 results against the CPU's, SLAM_TOL["vision_f64"] relative to
    each result's scale) and the JAX vision tests' gates on the f32 run:
    Zhang's K within 8 px on 15 chessboard views and (k1, k2) within 0.02,
    the DLT's reprojection (< 0.5 px) and pose, RANSAC PnP's pose and
    inliers with 30% outliers, triangulation within 0.02 of the truth,
    bundle adjustment's χ² down by 1e-3, RMS < 0.2 px, camera 0 fixed.
    Prints the BA's reprojection RMS trace."""
    import torch

    scenes = vision_scenes()
    vision_runs(device, torch.float32)  # warm-up
    res32, secs = vision_runs(device, torch.float32)
    res64, secs64 = vision_runs(device, torch.float64)
    ref = refs.get()["vision"]
    worst = 0.0
    for name, got in res64.items():
        for a, b in zip(got, ref[name]):
            if a.dtype.kind == "f":
                scale = max(1.0, float(np.abs(b).max()))
                worst = max(worst, float(np.abs(a - b).max()) / scale)
            else:
                worst = max(worst, float((a != b).any()))
    print("[vision] ms a call, f32 (f64): "
          + ", ".join(f"{k} {secs[k] * 1e3:.4f} ({secs64[k] * 1e3:.4f})"
                      for k in secs), flush=True)
    print(f"[vision] f64, card against CPU: max |diff| / max(1, |CPU "
          f"result|) {worst:.6g}", flush=True)
    k_est = res32["zhang"][0]
    k_err = np.abs(k_est[[0, 1, 0, 1], [0, 1, 2, 2]]
                   - VIS_K[[0, 1, 0, 1], [0, 1, 2, 2]]).max()
    dist = res32["radial"][0]
    dist_z = res32["radial zhang"][0]
    p_est, k2, r2, t2 = res32["dlt"]
    pts, uv, r_true, t_true = scenes["dlt"]
    uvw = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ p_est.T
    reproj = np.abs(uvw[:, :2] / uvw[:, 2:3] - uv).max()
    dlt_ok = (reproj < 0.5 and np.allclose(k2 * VIS_K[2, 2], VIS_K,
                                           rtol=2e-3, atol=0.5)
              and np.abs(r2 - r_true).max() < 5e-3
              and np.abs(t2 - t_true).max() < 2e-2)
    r_p, t_p, inl = res32["pnp"]
    _, _, _, bad, r_pt, t_pt = scenes["pnp"]
    n_in = VIS_PNP_POINTS - len(bad)
    tri_err = np.abs(res32["tri"][0] - scenes["tri"][2]).max()
    cams, _, _, _, obs_cam, _, _ = scenes["ba"]
    c_ba, _, errors = res32["ba"]
    rms = np.sqrt(errors / (2 * BA_OBSERVATIONS))
    print(f"[vision] Zhang on {VIS_VIEWS} views of the 9 x 6 board: K "
          f"within {k_err:.6g} px, (k1, k2) = ({dist[0]:.6g}, "
          f"{dist[1]:.6g}) against ({VIS_K1}, {VIS_K2}) at the true "
          f"extrinsics, ({dist_z[0]:.6g}, {dist_z[1]:.6g}) at Zhang's "
          f"(f64: ({res64['radial zhang'][0][0]:.6g}, "
          f"{res64['radial zhang'][0][1]:.6g})); DLT on "
          f"{VIS_DLT_POINTS} points: reprojection {reproj:.6g} px; PnP "
          f"RANSAC ({VIS_PNP_HYPOTHESES} hypotheses, {VIS_PNP_POINTS} points,"
          f" {len(bad)} outliers): R within {np.abs(r_p - r_pt).max():.3g}, "
          f"t within {np.abs(t_p - t_pt).max():.3g}, {int(inl.sum())} of "
          f"{n_in} inliers, {int(inl[bad].sum())} outliers kept; "
          f"triangulation of {VIS_TRI_POINTS} points in {VIS_TRI_VIEWS} "
          f"views: max error {tri_err:.6g}", flush=True)
    print(f"[vision] bundle adjustment, {BA_CAMERAS} cameras, {BA_POINTS} "
          f"points, {BA_OBSERVATIONS} observations, LM {BA_ITERS}, f32: "
          f"reprojection RMS trace (px) "
          f"{[round(float(x), 6) for x in rms]}", flush=True)
    require(k_err < 8.0, "Zhang K within 8 px (f32)")
    require(np.abs(dist - [VIS_K1, VIS_K2]).max() < 0.02,
            "radial distortion within 0.02 at the true extrinsics (f32), "
            "as the JAX test holds it")
    require(dlt_ok, "DLT reprojection < 0.5 px, K, R and t recovered (f32)")
    require(np.abs(r_p - r_pt).max() < 5e-3 and np.abs(t_p - t_pt).max()
            < 2e-2 and inl.sum() >= 0.9 * n_in and not inl[bad].any(),
            "PnP RANSAC pose, >= 90% of the inliers, no outlier (f32)")
    require(tri_err < 0.02, "triangulation within 0.02 (f32)")
    require(errors[-1] < errors[0] * 1e-3 and rms[-1] < 0.2
            and np.abs(c_ba[0] - cams[0]).max() < 1e-4,
            "BA χ² down by 1e-3, RMS < 0.2 px, camera 0 fixed (f32)")
    require(worst <= SLAM_TOL["vision_f64"],
            f"vision f64 card within {SLAM_TOL['vision_f64']} of CPU")
    # non-finite input: one NaN pixel leaves the rest of the cloud as it was
    ps, obs = scenes["tri"][:2]
    bad = obs.copy()
    bad[VIS_NAN_POINT, 1, 0] = np.nan
    clean, nan = (vision_triangulate(ps, o, device) for o in (obs, bad))
    rest = np.delete(np.arange(len(obs)), VIS_NAN_POINT)
    rest_diff = float(np.abs(nan[rest] - clean[rest]).max())
    print(f"[vision] triangulation with one NaN pixel (point "
          f"{VIS_NAN_POINT}), f32: its row NaN "
          f"{bool(np.isnan(nan[VIS_NAN_POINT]).all())}, the other "
          f"{len(rest)} points against the clean run max |diff| "
          f"{rest_diff:.3g}", flush=True)
    require(np.isnan(nan[VIS_NAN_POINT]).all() and rest_diff <= VIS_NAN_TOL,
            "[vision] one NaN pixel: its point NaN, the others equal to the "
            "clean run")
    return dict(ms={k: v * 1e3 for k, v in secs.items()},
                ba_rms=rms.tolist())


def control_phase(device, refs):
    """Phase control: control_runs in f32 and f64 on the card. The DARE
    against scipy.linalg.solve_discrete_are (rtol 1e-6, f64), the LQR
    closed loop strictly stable, the pendulum settled (the JAX tests'
    gates: the final state within 1e-3 of 0, the last 100 angles within
    1e-2), the LQG rollout of LQG_STEPS steps in f64 against the CPU's
    on the same draws, and within the JAX LQG test's bands."""
    import scipy.linalg
    import torch

    from rustrobotics_tpu_torch.control import inverted_pendulum as ip

    (r64, wall64) = _timed(lambda: control_runs(device, torch.float64),
                           device)
    r32 = control_runs(device, torch.float32)
    lin = ip.InvertedPendulumModel.create(dtype=torch.float64,
                                          device="cpu").linearize(0.01)
    p_ref = scipy.linalg.solve_discrete_are(
        *(getattr(lin, f).numpy() for f in ("a", "b", "q", "r")))
    dare = float(np.abs(r64["p"] - p_ref).max() / np.abs(p_ref).max())
    eig = float(np.abs(np.linalg.eigvals(lin.a.numpy() - lin.b.numpy()
                                         @ r64["k"])).max())
    ref = refs.get()["control"]
    diff = max(_maxdiff(r64[k], ref[k]) for k in ("xs", "xhs", "us"))
    drift32 = _maxdiff(r32["xs"], r64["xs"])
    xs = r32["xs"]
    print(f"[control] DARE against scipy: max rel |diff| {dare:.3g}; LQR "
          f"closed-loop spectral radius {eig:.6g}; pendulum final |x| "
          f"{np.abs(r32['states'][-1]).max():.3g} (f32), "
          f"{np.abs(r64['states'][-1]).max():.3g} (f64); LQG rollout "
          f"{LQG_STEPS} steps: f64 card against CPU max |diff| {diff:.6g}, "
          f"f32 against f64 {drift32:.6g}; control_runs f64 "
          f"{wall64 * 1e3:.4f} ms", flush=True)
    require(dare < 1e-6, "DARE within 1e-6 of scipy (f64)")
    require(eig < 1.0, "LQR closed loop strictly stable")
    for r in (r32, r64):
        require(np.abs(r["states"][-1]).max() < 1e-3
                and np.abs(r["states"][-100:, 2]).max() < 1e-2,
                "pendulum settles (final 1e-3, last 100 angles 1e-2)")
    require(diff <= SLAM_TOL["lqg_f64"],
            f"LQG f64 rollout card within {SLAM_TOL['lqg_f64']} of CPU")
    require(np.abs(xs[-50:, 2]).max() < 0.1 and np.abs(xs[-50:, 0]).max()
            < 0.6 and np.abs(r32["xhs"][-50:] - xs[-50:]).max() < 0.1,
            "LQG f32 holds the JAX test's bands (angle 0.1, cart 0.6, "
            "estimate 0.1)")
    return dict(dare=dare, lqg_f64=diff)


K12_GROUPS = {"K4 band_assemble": "band_assemble",
              "K1 panel_chol_inv": "panel_chol_inv", "K1 gemm_nt": "gemm_nt",
              "K1 trail_offdiag": "trail_offdiag",
              "K2 band_substitute": "band_substitute", "other": ""}
FLEET_GROUPS = {("K5" + k[2:] if k.startswith("K4") else k): v
                for k, v in K12_GROUPS.items()}
K3_GROUPS = {"K3 banded_matvec": "banded_matvec", "other": ""}


def _trace_close(got, want, floor):
    """max over a χ² trace of |got - want| / max(|want|, floor)."""
    return max(abs(a - b) / max(abs(b), floor) for a, b in zip(got, want))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_phase(device):
    """Phase parallel: the distributed tier on an NCCL process group of
    world size 1 (one H100; NCCL takes one card a rank), destroyed at the
    end. distributed_optimize GN PAR_GN_ITERS and LM PAR_LM_ITERS on
    corridor-1728 in f64 at JAX's cg_tol 1e-10, held to GN_CHI2 and to the
    single-device optimize(backend="cg") runs (PAR_RTOL, PAR_POSE_TOL);
    both sharded PF steps on PF_PARTICLES particles of the SimpleProblem
    models, PF_STEPS steps, 0 ring rounds: in f64 gather and bounded equal
    a single-device systematic resampling of the same propagated cloud on
    the same draws, in f32 all but PF_F32_FLIP_SHARE of the rows (timed
    in f32).
    s per GN iteration, PCG rounds per solve, steps/s and Mparticles/s
    printed. Returns the K1-K5 counts of the phase (0 expected) and the
    optimize(backend="cg") results by solver."""
    import torch
    import torch.distributed as dist

    from rustrobotics_tpu_torch.localization.pf import ParticleFilter
    from rustrobotics_tpu_torch.mapping.pgo import optimize
    from rustrobotics_tpu_torch.models.measurement import (
        SimpleProblemMeasurementModel,
    )
    from rustrobotics_tpu_torch.models.motion import SimpleProblemMotionModel
    from rustrobotics_tpu_torch.parallel import (
        distributed_optimize,
        make_mesh,
    )
    from rustrobotics_tpu_torch.parallel.pf_sharded import (
        make_sharded_pf_step,
        make_sharded_pf_step_bounded,
    )

    t_phase = time.perf_counter()
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        g64 = corridor(1728, device)
        reset_counts()
        runs = {}
        for solver, iters in (("gauss_newton", PAR_GN_ITERS),
                              ("levenberg_marquardt", PAR_LM_ITERS)):
            with recorded_rounds() as rounds:
                (g, errors, _), wall = _timed(
                    lambda: distributed_optimize(
                        mesh, g64, num_iterations=iters, solver=solver,
                        tolerance=0.0), device)
            runs[solver] = (g, errors, wall, list(rounds))
        counts = read_counts()
        refs = {}
        for solver, iters in (("gauss_newton", PAR_GN_ITERS),
                              ("levenberg_marquardt", PAR_LM_ITERS)):
            res, wall = _timed(lambda: optimize(
                g64, num_iterations=iters, solver=solver, backend="cg",
                tolerance=0.0, device=device), device)
            refs[solver] = (res, wall)
        for solver, (g, errors, wall, rounds) in runs.items():
            res, wall_ref = refs[solver]
            floor = PAR_CHI2_FLOOR * errors[0]
            rel = _trace_close(errors, res.errors, floor)
            pose = _maxdiff(g.poses2, res.graph.poses2, heading=2)
            iters = len(errors) - 1
            print(f"[parallel] distributed_optimize {solver}, corridor-1728 "
                  f"f64, NCCL world size 1: {wall / iters:.4f} s an "
                  f"iteration (single-device optimize cg "
                  f"{wall_ref / iters:.4f}); PCG rounds a solve {rounds}; "
                  f"χ² {[round(e, 6) for e in errors]}; against the "
                  f"single-device cg trace {rel:.3g} relative, poses "
                  f"{pose:.3g}", flush=True)
            require(rel <= PAR_RTOL, f"[parallel] {solver} χ² trace within "
                                     f"{PAR_RTOL} of optimize(backend='cg')")
            require(pose <= PAR_POSE_TOL, f"[parallel] {solver} poses within "
                                          f"{PAR_POSE_TOL} of optimize(cg)")
        gn_errors = runs["gauss_newton"][1]
        for got, want in zip(gn_errors[:2], GN_CHI2):
            require(abs(got - want) <= PAR_RTOL * want,
                    f"[parallel] GN χ² {got} within {PAR_RTOL} of the JAX "
                    f"f64 anchor {want}")
        if PAR_GN_ITERS < 10:
            print(f"[parallel] GN runs {PAR_GN_ITERS} iterations (not 10): "
                  f"every solve is PCG to 1e-10 in f64, whose rounds "
                  f"(above) set the phase's time", flush=True)

        # the sharded PF at the JAX benchmark's size
        def pf_of(dtype):
            return ParticleFilter(
                r=torch.eye(4, dtype=dtype, device=device) * 0.01,
                q=torch.eye(2, dtype=dtype, device=device) * 0.1,
                motion_model=SimpleProblemMotionModel.create(),
                measurement_model=SimpleProblemMeasurementModel.create(),
                resampling="systematic")

        cloud0 = torch.tensor(
            np.random.default_rng(PF_SEED).normal(
                size=(PF_PARTICLES, 4)).astype(np.float32) * 0.5,
            device=device)
        noise_gen = torch.Generator(device).manual_seed(PF_SEED)
        u0_gen = torch.Generator(device).manual_seed(PF_SEED + 1)
        reset_counts()
        check = {}
        for dtype in (torch.float64, torch.float32):
            pf = pf_of(dtype)
            u = torch.tensor([1.0, 0.1], dtype=dtype, device=device)
            z = torch.tensor([0.12, 0.03], dtype=dtype, device=device)
            gather = make_sharded_pf_step(mesh, pf, PF_PARTICLES)
            bounded = make_sharded_pf_step_bounded(mesh, pf, PF_PARTICLES)
            cloud, worst, flips, self_flips, max_rounds = (
                cloud0.to(dtype), 0.0, 0, 0, 0)
            for _ in range(PF_STEPS):
                noise = torch.randn(cloud.shape, generator=noise_gen,
                                    dtype=dtype, device=device)
                u0 = torch.rand((), generator=u0_gen, dtype=dtype,
                                device=device)
                out_g = gather._step(noise, u0, cloud, u, z, 0.1)
                out_b, rounds = bounded._step(noise, u0, cloud, u, z, 0.1)
                # single-device systematic resampling of the same
                # propagated cloud on the same draws
                pred, logw = pf._propagate_weigh(cloud, u, z, 0.1, noise)
                w = torch.exp(logw - torch.max(logw))
                draws = (torch.arange(PF_PARTICLES, dtype=dtype,
                                      device=device)
                         + u0) / PF_PARTICLES * torch.sum(w)
                idx = torch.clamp(torch.searchsorted(torch.cumsum(w, 0),
                                                     draws),
                                  0, PF_PARTICLES - 1)
                ref = pred[idx]
                worst = max(worst, _maxdiff(out_g, ref),
                            _maxdiff(out_b, out_g))
                flips = max(flips, int((out_g != ref).any(-1).sum()),
                            int((out_b != ref).any(-1).sum()))
                again = gather._step(noise, u0, cloud, u, z, 0.1)
                self_flips = max(self_flips,
                                 int((again != out_g).any(-1).sum()))
                max_rounds = max(max_rounds, rounds)
                cloud = out_g
            check[dtype] = (worst, flips, self_flips, max_rounds)
        counts = {k: counts[k] + v for k, v in read_counts().items()}
        walls = {}
        pf = pf_of(torch.float32)
        u = torch.tensor([1.0, 0.1], dtype=torch.float32, device=device)
        z = torch.tensor([0.12, 0.03], dtype=torch.float32, device=device)
        for name, make in (("gather", make_sharded_pf_step),
                           ("bounded", make_sharded_pf_step_bounded)):
            step = make(mesh, pf, PF_PARTICLES)

            def run(step=step):
                c = cloud0
                for _ in range(PF_STEPS):
                    c = step(noise_gen, u0_gen, c, u, z, 0.1)
                    c = c[0] if isinstance(c, tuple) else c
                return c
            run()
            _, walls[name] = _timed(run, device)
        w64, w32 = check[torch.float64], check[torch.float32]
        print(f"[parallel] sharded PF, {PF_PARTICLES} particles, NCCL "
              f"world size 1, {PF_STEPS} steps, f32: "
              + ", ".join(f"{k} {PF_STEPS / v:.4f} steps/s "
                          f"({PF_STEPS * PF_PARTICLES / v / 1e6:.4f} "
                          f"Mparticles/s)" for k, v in walls.items())
              + f"; ring rounds {max(w64[3], w32[3])}. Against the "
                f"single-device searchsorted resampling on the same draws: "
                f"f64 gather and bounded differ by {w64[0]:.3g} ({w64[1]} "
                f"rows); f32 {w32[1]} of {PF_PARTICLES} rows differ at most "
                f"a step, as do {w32[2]} between two runs of the same gather "
                f"step (the card's cumsum is not bitwise reproducible, and "
                f"an f32 draw within its rounding of a cumulative weight "
                f"picks the neighbour)", flush=True)
        require(w64[0] == 0.0, "[parallel] sharded PF clouds (f64) equal "
                               "the single-device resampling on the same "
                               "draws")
        require(w32[1] <= PF_F32_FLIP_SHARE * PF_PARTICLES,
                f"[parallel] sharded PF (f32): at most {PF_F32_FLIP_SHARE} "
                f"of the rows off the single-device resampling")
        require(max(w64[3], w32[3]) == 0,
                "[parallel] bounded PF: 0 ring rounds at world size 1")
        print(f"[parallel] K1-K5 and L1 launches in this phase: {counts}; "
              f"{time.perf_counter() - t_phase:.2f} s", flush=True)
        return counts, {k: res for k, (res, _) in refs.items()}
    finally:
        dist.destroy_process_group()


def _block_report(label, errs, it, rounds, wall, note=""):
    """Print a block run's s a GN iteration, CG rounds a GN iteration and
    ms of the run a CG round (assembly, preconditioner and retraction
    counted in) beside its χ² trace."""
    require(it > 0 and rounds > 0,
            f"[blocks] {label}: GN iterations and CG rounds ran")
    print(f"[blocks] {label}: {wall / it:.4f} s a GN iteration{note}, "
          f"{rounds / it:.1f} CG rounds a GN iteration, "
          f"{wall / rounds * 1e3:.4f} ms of the run a CG round; χ² "
          f"{[float(f'{e:.6g}') for e in errs]}", flush=True)


def blocks_phase(device, refs):
    """Phase blocks: the map-block optimizer on an NCCL process group of
    world size 1, destroyed at the end (BLK_* above); ``refs`` the
    single-device optimize(backend="cg") runs on corridor-1728 that
    parallel_phase made, by solver. Returns the K1-K5 counts of the phase
    (0 expected)."""
    import pathlib
    import tempfile

    import torch
    import torch.distributed as dist

    from rustrobotics_tpu_torch.mapping.synthetic import (
        synthetic_corridor_graph_2d,
    )
    from rustrobotics_tpu_torch.parallel import (
        block_optimize,
        build_block_layout,
        comm_budget,
        make_block_optimize,
        make_mesh,
    )
    from rustrobotics_tpu_torch.parallel.pgo_blocks import (
        block_optimize_elastic,
        extract_graph,
        layout_device_arrays,
    )

    t_phase = time.perf_counter()
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, axis="blocks")
        reset_counts()
        # corridor-100k: one layout, the optimizer with Jacobi and with
        # Schwarz in f64, then Jacobi in f32
        g100 = synthetic_corridor_graph_2d(num_poses=BLK_POSES,
                                           num_landmarks=0,
                                           dtype=torch.float64, device=device)
        require(g100.total_dof >= 100_000,
                f"[blocks] corridor-100k has {g100.total_dof} >= 100,000 dof")
        t0 = time.perf_counter()
        layout = build_block_layout(g100, 1)
        print(f"[blocks] corridor-100k: n = {g100.total_dof}; D = 1: h = "
              f"{layout.h}, ELL width {layout.ell_width}, Schwarz band kb = "
              f"{layout.kb_loc}, nb = {layout.nb_loc}; build_block_layout "
              f"{time.perf_counter() - t0:.2f} s of host time", flush=True)
        kw = dict(num_iterations=BLK_GN, tolerance=0.0,
                  cg_maxiter=BLK_CG_MAXITER)
        runs = {}
        for name, dtype, precond, cg_tol in (
                ("f64, jacobi", torch.float64, "jacobi", BLK_CG_TOL),
                ("f64, schwarz", torch.float64, "schwarz", BLK_CG_TOL),
                ("f32 (cg_tol 1e-6), jacobi", torch.float32, "jacobi",
                 BLK_F32_CG_TOL)):
            arrays = layout_device_arrays(layout, dtype, device)
            run = make_block_optimize(mesh, layout, dtype=dtype,
                                      precond=precond, cg_tol=cg_tol, **kw)
            (st, e, it, rounds), wall = _timed(lambda: run(*arrays), device)
            errs = [v for v in e.tolist() if not math.isnan(v)]
            _block_report(f"corridor-100k {name}", errs, it, rounds, wall)
            print(f"[blocks] comm_budget: "
                  f"{json.dumps(comm_budget(layout, dtype, it, rounds))}",
                  flush=True)
            finite = all(math.isfinite(v) for v in errs)
            drop = BLK_DROP if dtype == torch.float64 else 1.0
            require(finite and errs[-1] < errs[0] * drop,
                    f"[blocks] corridor-100k {name}: finite, errors[-1] "
                    f"{errs[-1]:.6g} < errors[0] x {drop:g}")
            runs[name] = errs
        out = extract_graph(layout, g100, st)
        require(out.poses2.shape == g100.poses2.shape
                and bool(torch.isfinite(out.poses2).all()),
                "[blocks] extract_graph returns corridor-100k's poses, "
                "finite")
        del g100, layout, arrays, st, out
        # corridor-1728 f64 through block_optimize against the single-device
        # cg
        g64 = corridor(1728, device)
        blk = {}
        for label, solver, iters, extra in (
                ("GN single", "gauss_newton", PAR_GN_ITERS, {}),
                ("GN classic", "gauss_newton", PAR_GN_ITERS,
                 dict(cg_variant="classic")),
                ("LM", "levenberg_marquardt", PAR_LM_ITERS, {}),
                ("GN Schur", "gauss_newton", PAR_GN_ITERS, dict(schur=True))):
            (g, errs, it, stats), wall = _timed(
                lambda: block_optimize(mesh, g64, num_iterations=iters,
                                       solver=solver, tolerance=0.0,
                                       cg_tol=1e-10, return_stats=True,
                                       **extra), device)
            _block_report(f"corridor-1728 f64 {label}", errs, it,
                          stats["cg_rounds_total"], wall,
                          " (its layout build counted in)")
            blk[label] = (g, errs)
        for label, (g, errs) in blk.items():
            ref = refs["levenberg_marquardt" if label == "LM"
                       else "gauss_newton"]
            rel = _trace_close(errs, ref.errors, PAR_CHI2_FLOOR * errs[0])
            pose = _maxdiff(g.poses2, ref.graph.poses2, heading=2)
            print(f"[blocks] corridor-1728 {label} against optimize(cg): χ² "
                  f"trace {rel:.3g} relative, poses {pose:.3g}", flush=True)
            if label != "GN Schur":
                require(rel <= PAR_RTOL and pose <= PAR_POSE_TOL,
                        f"[blocks] corridor-1728 {label} within {PAR_RTOL} "
                        f"(χ²) and {PAR_POSE_TOL} (poses) of optimize(cg)")
        gn = blk["GN single"][1]
        # Schur eliminates the landmarks with Hll + 1e-10 I (the JAX
        # package's regularization): held to the non-Schur run's final χ²
        schur = blk["GN Schur"][1]
        rel = _trace_close(schur[-1:], gn[-1:], PAR_CHI2_FLOOR * gn[0])
        require(rel <= PAR_RTOL, f"[blocks] Schur's final χ² {schur[-1]:.6g} "
                                 f"within {PAR_RTOL} of the non-Schur run's "
                                 f"{gn[-1]:.6g} (floor {PAR_CHI2_FLOOR} x "
                                 f"errors[0])")
        # elastic: one segment, then resumed, against the GN run
        with tempfile.TemporaryDirectory() as ck:
            ekw = dict(segment=BLK_SEGMENT, tolerance=0.0, cg_tol=1e-10,
                       checkpoint_dir=ck)
            _, first, it_a = block_optimize_elastic(
                mesh, g64, num_iterations=BLK_SEGMENT, **ekw)
            (g_el, errs_el, it_b), wall_el = _timed(
                lambda: block_optimize_elastic(
                    mesh, g64, num_iterations=PAR_GN_ITERS, **ekw), device)
            snaps = sorted(p.name for p in pathlib.Path(ck).glob(
                "block_*.npz"))
        rel = _trace_close(errs_el, gn, PAR_CHI2_FLOOR * gn[0])
        print(f"[blocks] elastic corridor-1728 f64, segments of "
              f"{BLK_SEGMENT}: interrupted after {it_a}, resumed to {it_b} "
              f"({wall_el:.2f} s), snapshots {snaps}; against the "
              f"uninterrupted GN {rel:.3g} relative", flush=True)
        require(it_a == BLK_SEGMENT and it_b == PAR_GN_ITERS
                and rel <= PAR_RTOL,
                f"[blocks] elastic resume equals the uninterrupted run within "
                f"{PAR_RTOL}")
        counts = read_counts()
        # one GN iteration of corridor-1728 f64 (Jacobi) under the
        # profiler: device launches a CG round and the card's idle share
        layout = build_block_layout(g64, 1)
        arrays = layout_device_arrays(layout, torch.float64, device)
        one = make_block_optimize(mesh, layout, num_iterations=1,
                                  tolerance=0.0, cg_tol=1e-10,
                                  precond="jacobi", dtype=torch.float64)
        rounds = one(*arrays)[3]
        label = "map-block GN corridor-1728 f64 jacobi, 1 iteration"
        totals = trace(label, lambda: one(*arrays), {"all": ""})
        if totals:
            print(f"[trace] {label}: {rounds} CG rounds, "
                  f"{totals['all'][1] / rounds:.1f} device launches a CG "
                  f"round", flush=True)
        print(f"[blocks] K1-K5 and L1 launches in this phase: {counts}; "
              f"{time.perf_counter() - t_phase:.2f} s", flush=True)
        require(not any(counts.values()),
                "[blocks] K1-K5 and L1 launch 0 times")
        return counts
    finally:
        dist.destroy_process_group()


def noisy_corridor_spec():
    """corridor-1728's spec with its measurements drawn about the truth
    from the edges' own information (numpy default_rng(CLI_SEED)): N(0,
    0.1²) m and N(0, 0.05²) rad on the pose-pose edges, N(0, 1/50) m² on
    the pose-landmark edges, so its optimum's χ² is ~1e3, far above
    rounding."""
    spec = graph_spec(corridor(1728, "cpu"))
    f = spec["fields"]
    rng = np.random.default_rng(CLI_SEED)
    for z, om in ((f["pp_z"], f["pp_omega"]), (f["pl_z"], f["pl_omega"])):
        sd = 1.0 / np.sqrt(np.diagonal(om, axis1=-2, axis2=-1))
        z += rng.normal(size=z.shape) * sd
    f["pp_z"][:, 2] = _wrap(f["pp_z"][:, 2])
    return spec


def cli_phase(device):
    """Phase cli: ``python -m rustrobotics_tpu_torch.cli pgo --file
    <noisy corridor-1728.g2o> --distributed 1 --x64`` in a subprocess
    against the same command run in-process (the counters around it),
    both against the single-device optimize(backend="cg") on the same
    file, and ``doctor`` in a subprocess. Returns the K1-K5 counts of the
    in-process run."""
    import io
    import pathlib
    import re
    import tempfile

    import torch

    from rustrobotics_tpu_torch import cli
    from rustrobotics_tpu_torch.mapping import load_g2o
    from rustrobotics_tpu_torch.mapping.pgo import optimize

    t_phase = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "corridor-1728-noisy.g2o"
        path.write_text(g2o_text(noisy_corridor_spec()))
        argv = ["pgo", "--file", str(path), "--distributed", "1", "--x64",
                "--iterations", str(CLI_ITERS)]
        # both subprocesses run beside the in-process run
        procs = [subprocess.Popen(
            [sys.executable, "-m", "rustrobotics_tpu_torch.cli", *args],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for args in (argv, ["doctor"])]
        try:
            reset_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            counts = read_counts()
            graph = load_g2o(str(path), dtype=torch.float64, device=device)
            (out, err), (doc_out, _) = (p.communicate(timeout=CLI_TIMEOUT)
                                        for p in procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    rc, doc_rc = (p.returncode for p in procs)
    pattern = r"converged in (\d+) iterations; chi2 ([0-9.e+-]+) -> " \
              r"([0-9.e+-]+)"
    sub = re.search(pattern, out)
    here = re.search(pattern, buf.getvalue())
    print(f"[cli] subprocess (exit {rc}): "
          f"{out.strip().splitlines()[-1:]}; in-process: "
          f"{buf.getvalue().strip().splitlines()[-1:]}", flush=True)
    print("[cli] doctor (exit {}):\n{}".format(
        doc_rc, "\n".join("  " + ln for ln in doc_out.strip().splitlines())),
          flush=True)
    if rc != 0:
        fail(f"[cli] `cli pgo --distributed 1` exited {rc}: "
             f"{err.strip()[-2000:]}")
    require(sub is not None and here is not None,
            "[cli] `cli pgo --distributed 1` exits 0 and prints its χ², "
            "in a subprocess and in-process")
    it = int(here.group(1))
    ref = optimize(graph, num_iterations=it, solver="gauss_newton",
                   backend="cg", tolerance=0.0, device=device).errors
    # the CLI prints χ² with 1 decimal at the start and 5 at the end
    printed = [(float(here.group(2)), ref[0], 0.05),
               (float(here.group(3)), ref[it], 5e-6)]
    print(f"[cli] optimize(cg) GN {it} on the same file: χ² {ref[0]:.1f} -> "
          f"{ref[it]:.5f}", flush=True)
    require(ref[it] > 1.0 and all(abs(a - b) <= r + PAR_RTOL * abs(b)
                                  for a, b, r in printed),
            f"[cli] the in-process χ² within {PAR_RTOL} (and the print's "
            f"rounding) of optimize(cg)'s, the final one above 1")
    require(sub.group(1) == here.group(1)
            and all(abs(float(a) - float(b)) <= r + PAR_RTOL * abs(float(b))
                    for a, b, r in zip(sub.groups()[1:], here.groups()[1:],
                                       (0.1, 1e-5))),
            "[cli] the subprocess prints the in-process run's iterations "
            "and χ² (within PAR_RTOL and a unit of the print)")
    require(doc_rc == 0 and "accelerator: cuda" in doc_out
            and doc_out.count(": built (") == len(SOURCES),
            "[cli] `cli doctor` exits 0, sees the card and builds every "
            "CUDA source")
    print(f"[cli] K1-K5 and L1 launches of the in-process run: {counts}; "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    require(not any(counts.values()), "[cli] K1-K5 and L1 launch 0 times")
    return counts


def _chi2_falls(errs):
    """A χ² trace that is finite, whose entries above 1 fall at every
    step, and whose last entry is below its first."""
    big = [e for e in errs if e > 1.0]
    return (all(math.isfinite(e) for e in errs) and errs[-1] < errs[0]
            and all(b < a for a, b in zip(big, big[1:])))


def bench_dataset(directory):
    """A dataset root for the benchmark families: g2o/corridor-1728.g2o,
    g2o/sphere-2500.g2o (both synthetic: corridor() and sphere_graph())
    and utias0/ (write_utias)."""
    g2o = directory / "g2o"
    g2o.mkdir(parents=True)
    (g2o / "corridor-1728.g2o").write_text(
        g2o_text(graph_spec(corridor(1728, "cpu"))))
    (g2o / "sphere-2500.g2o").write_text(g2o_text(sphere_graph()))
    (directory / "utias0").mkdir()
    write_utias(directory / "utias0", seed=0)


def bench_headline(root, directory):
    """`python -m rustrobotics_tpu_torch.cli bench --suite-out` in a
    subprocess on a dataset root without intel.g2o (so synthetic1728 is
    timed), with its gates. Returns (headline line, suite rows)."""
    import os
    import re

    empty = directory / "headline-root"
    empty.mkdir()
    suite_path = directory / "suite.json"
    suite_json = root / "BENCH_SUITE.json"
    before = suite_json.read_bytes()
    proc = subprocess.run(
        [sys.executable, "-m", "rustrobotics_tpu_torch.cli", "bench",
         "--suite-out", str(suite_path)],
        cwd=root, env=dict(os.environ, RUSTROBOTICS_DATASET=str(empty)),
        capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    print("[bench] headline stderr: " + " | ".join(
        ln for ln in proc.stderr.splitlines() if ln.startswith("[bench]")),
          flush=True)
    if proc.returncode != 0:
        fail(f"[bench] `cli bench` exited {proc.returncode}: "
             f"{proc.stderr.strip()[-2000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    print(f"[bench] headline: {last}", flush=True)
    line = json.loads(last)
    extra = line["extra"]
    require(line["metric"] == "pgo_synthetic1728_gn_iters_per_sec"
            and line["value"] > 0 and line["vs_baseline"] > 0,
            "[bench] the headline's last line parses: synthetic1728 timed")
    require("banded-kernel" in extra["backend_ms_per_10it"],
            "[bench] banded-kernel ran in the headline's race")
    trace = re.search(r"chi2 trace (\[[^]]*\])", proc.stderr)
    errs = json.loads(trace.group(1)) if trace else [math.nan]
    require(_chi2_falls(errs),
            f"[bench] the chosen backend's ({extra['solver_backend']}) χ² "
            f"trace is finite and falls: {errs}")
    mfu = extra["mfu_vs_f32_peak"]
    require(mfu is not None and 0 < mfu <= 1.05,
            f"[bench] mfu_vs_f32_peak {mfu} in (0, 1.05]")
    rows = json.loads(suite_path.read_text())["suite"]
    require(len(rows) == extra["suite_rows"] > 0
            and not any("error" in r for r in rows),
            f"[bench] the suite file holds {len(rows)} rows, none an error")
    require(suite_json.read_bytes() == before,
            "[bench] the repo's BENCH_SUITE.json is byte-identical")
    return line, rows


def bench_phase(device):
    """Phase bench: the port's headline in a subprocess (bench_headline),
    then the dataset-bound suite families in-process on a
    bench_dataset root, each with the counters set to 0 before it and
    read after: graph_slam (corridor-1728 and sphere-2500, banded-kernel
    and banded-direct; K4, K1 and K2 once a banded-kernel GN iteration,
    each banded-kernel χ² trace within PARITY_TOL["solve"] of
    banded-direct's on its entries above 1), pgo_batch (the fleet of 8 on
    corridor-1728: K5 once a fleet iteration, K1 and K2 once an iteration
    of the fleet or of one graph), fleet_replay, and on an NCCL group of
    world size 1 (as in [blocks]) pf_sharded, block_scaling, entry() and
    dryrun_multichip(1). Prints every row, the phase's wall time and the
    card's name and power limit. Returns the K1-K5 counts of the
    in-process families."""
    import pathlib
    import tempfile

    import torch
    import torch.distributed as dist

    from rustrobotics_tpu_torch import benchmarks as bm
    from rustrobotics_tpu_torch.entry import dryrun_multichip, entry
    from rustrobotics_tpu_torch.mapping import load_g2o
    from rustrobotics_tpu_torch.mapping.pgo import global_error

    t_phase = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    total = {}
    rows = []

    def counted(label, call):
        reset_counts()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        counts = read_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        print(f"[bench] {label}: K1-K5 and L1 launches {counts} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        return counts

    with tempfile.TemporaryDirectory() as d:
        d = pathlib.Path(d)
        data = d / "dataset"
        bench_dataset(data)
        t0 = time.perf_counter()
        line, suite = bench_headline(root, d)
        t_headline = time.perf_counter() - t0
        graphs = ("corridor-1728", "sphere-2500")
        counts = counted("graph_slam", lambda: bm.bench_graph_slam(
            rows, dataset_root=str(data), graphs=graphs,
            backends=("banded-kernel", "banded-direct"), device=device))
        require(counts["factorize"] == counts["substitute"]
                == counts["assemble_b1"] > 0,
                "[bench] graph_slam: K4, K1 and K2 launch once a "
                "banded-kernel GN iteration")
        for name in graphs:
            g32 = load_g2o(str(data / "g2o" / f"{name}.g2o"),
                           dtype=torch.float32, device=device)
            kern, direct = (
                bm._graph_slam_run(g32, b, 10, device)(g32)[1].double().cpu()
                for b in ("banded-kernel", "banded-direct"))
            big = direct > 1.0
            rel = float(((kern[big] - direct[big]).abs()
                         / direct[big]).max())
            require(rel <= PARITY_TOL["solve"],
                    f"[bench] {name}: banded-kernel's χ² trace within "
                    f"{PARITY_TOL['solve']} of banded-direct's on the "
                    f"entries above 1 ({rel:.3g})")
        counts = counted("pgo_batch", lambda: bm.bench_pgo_batch(
            rows, dataset_root=str(data), graph="corridor-1728", batch=8,
            device=device))
        require(counts["assemble_batch"] > 0
                and counts["factorize"] == counts["substitute"]
                == counts["assemble_batch"] + counts["assemble_b1"],
                "[bench] pgo_batch: K5 once a fleet iteration, K1 and K2 "
                "once an iteration of the fleet (batched) or of one graph")
        counted("fleet_replay", lambda: bm.bench_fleet_replay(
            rows, dataset_root=str(data), device=device))
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        counted("pf_sharded", lambda: bm.bench_pf_sharded(rows,
                                                          device=device))
        counted("block_scaling", lambda: bm.bench_block_scaling(
            rows, device=device))
        fn, (graph,) = entry()
        chi2_0, chi2 = float(global_error(graph)), float(fn(graph)[2])
        counted("dryrun_multichip(1)", lambda: dryrun_multichip(1))
    finally:
        dist.destroy_process_group()
    require(math.isfinite(chi2) and chi2 < chi2_0,
            f"[bench] entry(): one GN step lowers χ² ({chi2_0:.6g} -> "
            f"{chi2:.6g})")
    require(not any("error" in r for r in rows)
            and {r["metric"] for r in rows} >= {
                "graph_slam_corridor-1728_banded-kernel",
                "graph_slam_sphere-2500_banded-kernel",
                "pgo_batch8_corridor-1728_graphs_per_sec",
                "utias_fleet_banked_ekf_kc_b1024",
                "pf_sharded_1m_bounded_exchange",
                "block_pgo_weak_scaling_d1"},
            "[bench] every in-process family gave its rows, none an error")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for r in suite + rows:
        print(f"[bench] row {json.dumps(r)}", flush=True)
    print(f"[bench] K1-K5 and L1 launches of the in-process families: "
          f"{total}; "
          f"headline {t_headline:.2f} s, phase "
          f"{time.perf_counter() - t_phase:.2f} s ({smi})", flush=True)
    return total


def aux_phase(device, g32):
    """Phase aux: the measurement layer on the card. time_scalar_program
    on a scalar program (AUX_REPS passes over AUX_ELEMS floats) within
    AUX_TIMING_RTOL of the CUDA-event time of the same program; checked
    catches a NaN made on the card; a checkpoint of a card graph restores
    on the card."""
    import tempfile

    import torch

    from rustrobotics_tpu_torch.utils import devtime
    from rustrobotics_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from rustrobotics_tpu_torch.utils.debug import checked

    x = torch.rand(AUX_ELEMS, device=device)

    def prog(v):
        for _ in range(AUX_REPS):
            v = v * 0.999 + 0.001
        return v.sum()

    rtt = devtime.scalar_fetch_rtt()
    per = devtime.time_scalar_program(prog, x, reps=AUX_REPS, rtt=rtt)
    event_ms = cuda_ms(lambda: prog(x), repeats=5, warmup=1) / AUX_REPS
    rel = abs(per * 1e3 - event_ms) / event_ms
    print(f"[aux] time_scalar_program {per * 1e3:.6f} ms a pass (scalar "
          f"fetch RTT {rtt * 1e6:.2f} µs) against CUDA events "
          f"{event_ms:.6f} ms: {rel:.3g} apart", flush=True)
    require(rel <= AUX_TIMING_RTOL, f"[aux] time_scalar_program within "
                                    f"{AUX_TIMING_RTOL} of CUDA events")
    try:
        checked(lambda v: torch.log(v - 2.0))(x)
        caught = None
    except FloatingPointError as err:
        caught = str(err)
    print(f"[aux] checked on the card: {caught}", flush=True)
    require(caught is not None and "nan" in caught,
            "[aux] checked catches a NaN made on the card")
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(f"{d}/snap.npz", g32, step=3)
        back, step = restore_checkpoint(path, g32)
    same = all(torch.equal(getattr(back, f), getattr(g32, f))
               for f in ("poses2", "landmarks2", "pp_z", "pp_from"))
    print(f"[aux] checkpoint of corridor-1728 from the card restores on "
          f"{back.poses2.device}: step {step}, equal {same}", flush=True)
    require(same and step == 3 and back.poses2.is_cuda,
            "[aux] a checkpoint of card tensors restores")


def busy_window(events, dev):
    """(window, busy) in µs: first to last profiler event, and the union
    of the device events' intervals."""
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    busy, end = 0.0, -math.inf
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return window, busy


def idle_share(events):
    """The device's idle share of a profiler window, or None when the
    profiler recorded no device event."""
    import torch

    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    window, busy = busy_window(events, dev)
    return 1 - busy / window


def trace(label, run, groups):
    """Phase 6: one run of run() under torch.profiler, after a warm-up
    run: device time by kernel group (the first group whose pattern is in
    the kernel's name) and the device's idle share of the traced window
    (first to last event). The profiler's own host cost lengthens the
    window, so the idle share is an upper bound. Returns {group: [device
    µs, launches]}, or None when the profiler saw no device event."""
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
    window, busy = busy_window(events, dev)
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
    return totals


def main() -> int:
    import multiprocessing

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the CPU f64 references and the front end's gate graph, computed in
    # three worker processes beside the card's phases; the pool's exit
    # terminates the workers
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        return smoke(pool.apply_async(cpu_references),
                     pool.apply_async(slam_references),
                     pool.apply_async(frontend_gate_graph))


def smoke(refs, slam_refs, gate) -> int:
    """The phases on the card; ``refs``, ``slam_refs`` and ``gate`` the
    pending cpu_references(), slam_references() and
    frontend_gate_graph()."""
    import torch

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
    kf = k1_fleet_parity(p1728["bl"], device)
    from rustrobotics_tpu_torch.mapping.pgo import stack_graphs

    l1 = l1_parity("corridor-1728", corridor(1728, device).to(
        dtype=torch.float32), 0.0)
    l1b = l1_parity(f"fleet of {FLEET}", stack_graphs(
        [g.to(dtype=torch.float32) for g in graphs64]),
        LM_LAMBDA0 * 2.0 ** torch.arange(FLEET, device=device))
    gnc_bad, gnc_fleet_b = gnc_fleet(device, graphs64)
    l1g, l1g_err = gnc_l1_parity(
        gnc_bad, gnc_fleet_b,
        LM_LAMBDA0 * 2.0 ** torch.arange(FLEET, device=device))
    lc1, lcb, lc_err = lm_cost_parities(
        corridor(1728, device).to(dtype=torch.float32), gnc_bad, gnc_fleet_b)
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
    boot_launches = bootstrap_phase(device)
    pg_launches = posegraph_phase(device)
    fixed_lag_phase(device)
    fe_launches = frontend_phase(device, gate)
    # the filters (this slice's paths), counters set to 0 around them: the
    # filter path runs none of K1-K5
    t_filters = time.perf_counter()
    reset_counts()
    utias = utias_dataset()
    filters_sim_phase(device, refs)
    landmarks_phase(device, utias, refs)
    fleet_phase(device, utias, refs)
    banked_phase(device, utias, refs)
    extra_phase(device, utias, refs)
    filter_launches = read_counts()
    print(f"[filters] K1-K5 and L1 launches on the filter paths: "
          f"{filter_launches}"
          f"; the filter phases took "
          f"{time.perf_counter() - t_filters:.2f} s", flush=True)
    # the SLAM families, vision and control, counters set to 0 around
    # them: these paths run none of K1-K5
    t_slam = time.perf_counter()
    slam_refs.wait()
    waited = time.perf_counter() - t_slam
    reset_counts()
    walls = {}
    for name, phase in (("scan-matching", scan_phase),
                        ("ekf-slam", ekf_slam_phase),
                        ("fastslam", fastslam_phase),
                        ("vision", vision_phase), ("control", control_phase)):
        t0 = time.perf_counter()
        phase(device, slam_refs)
        walls[name] = time.perf_counter() - t0
    slam_launches = read_counts()
    print(f"[slam] K1-K5 and L1 launches on the SLAM, vision and control "
          f"paths: "
          f"{slam_launches}; these phases took "
          f"{time.perf_counter() - t_slam:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
          + f"; {waited:.2f} s waiting for their CPU references)",
          flush=True)
    # the distributed tier and the measurement layer (this slice)
    par_launches, cg_refs = parallel_phase(device)
    aux_phase(device, g32)
    # the map blocks and the CLI (this slice), counters set to 0 around
    # each: they run none of K1-K5
    blk_launches = blocks_phase(device, cg_refs)
    cli_launches = cli_phase(device)
    # the benchmark entry (this slice): the headline, then the suite's
    # dataset-bound and distributed families, counters set to 0 around each
    bench_launches = bench_phase(device)
    timed = times(p1728, gn, g32)
    timed["banded_matvec"] = cg_times(k3, cg_gn, g32)
    timed["banded_matvec"].update(k3_fleet_times(k3b))
    timed["assemble_b1"] = assemble_times(p1728["bl"], p1728["vals"].float())
    timed["assemble_batch"] = assemble_times(p1728["bl"], fp["vals"])
    timed["factorize"].update(k1_fleet_times(kf))
    timed["linearize"] = l1_times(l1)
    timed["linearize_batch"] = l1_times(l1b)
    timed["linearize_gnc_batch"] = l1_times(l1g)
    timed["lm_cost"] = lm_cost_times(lc1)
    timed["lm_cost_batch"] = lm_cost_times(lcb)
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
    # the cg-banded and sphere-2500 runs trace TRACE_SHORT_ITERS GN
    # iterations: the profiler's event list of 10 takes ~45 s and ~20 s to
    # build, and their per-launch and idle readings do not need 10
    cg_short = make_optimize(g32, num_iterations=TRACE_SHORT_ITERS,
                             backend="cg-banded", tolerance=0.0,
                             cg_tol=CG_TOL, cg_maxiter=CG_MAXITER,
                             device=device)
    trace(f"GN cg-banded, {TRACE_SHORT_ITERS} iterations",
          lambda: cg_short(g32), K3_GROUPS)
    trace(f"GN banded-kernel fleet B={FLEET}, 10 iterations",
          lambda: fleet_gn(fleet), FLEET_GROUPS)
    gn3_short = make_optimize(g3, num_iterations=TRACE_SHORT_ITERS,
                              backend="banded-kernel", tolerance=0.0,
                              device=device)
    trace(f"GN banded-kernel sphere-2500, {TRACE_SHORT_ITERS} iterations",
          lambda: gn3_short(g3), K12_GROUPS)
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
             max_abs_err_b32=kf["k1"],
             err_measure="max|ldinv_kernel L_plain - I|, corridor-1728 at "
                         "the first LM step's damping; *_b32: its fleet of "
                         f"{K1_FLEET} (64-row strips)",
             ms_measure="device ms a call, 10 calls queued back to back "
                        f"(*_b32: the fleet of {K1_FLEET}; its plain_ms 3)",
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
    # this slice's paths: bootstrap, PoseGraph and the front end
    for k, key in ((kernels[0], "factorize"), (kernels[1], "substitute"),
                   (kernels[3], "assemble_b1")):
        k.update(bootstrap_launches=boot_launches[key],
                 posegraph_launches=pg_launches[key],
                 frontend_launches=fe_launches[key])
    for k, key in zip(kernels, ("factorize", "substitute", "banded_matvec",
                                "assemble_b1", "assemble_batch")):
        k["filters_launches"] = filter_launches[key]
        k["slam_launches"] = slam_launches[key]
        k["parallel_launches"] = par_launches[key]
        k["blocks_launches"] = blk_launches[key]
        k["cli_launches"] = cli_launches[key]
        k["bench_launches"] = bench_launches[key]
    kernels[0]["gnc_launches"] = gnc_launches["factorize"]
    kernels[1]["gnc_launches"] = gnc_launches["substitute"]
    kernels[3]["gnc_launches"] = gnc_launches["assemble_b1"]
    # the marginals (corridor-1728 and sphere-2500) factor through K4 + K1
    kernels[0]["marginal_launches"] = (marg["launches"]["factorize"]
                                       + marg3["launches"]["factorize"])
    kernels[3]["marginal_launches"] = (marg["launches"]["assemble_b1"]
                                       + marg3["launches"]["assemble_b1"])
    # L1, the SE2 linearization (SE3 graphs take the plain code, so it has
    # no kb = 384 reading; the fleet's under *_b8 keys)
    kernels.append(dict(
        name="se2_linearize_f32 (L1)", route="cuda",
        source="rustrobotics_tpu_torch/csrc/se2_linearize.cu",
        replaces="none: mapping/assemble.py::system_values' SE2 edges, "
                 "left to XLA's fusion in the JAX package",
        launches=launches["se2_linearize"], max_abs_err=l1["b_abs"],
        fleet_launches=fleet_launches["se2_linearize"],
        err_measure="max|b_kernel - b_plain|, corridor-1728 f32 at λ = 0 "
                    "(vals bit-equal); *_b8: the fleet of 8 at LM λs",
        ms_measure="device ms a call, calls queued back to back (L2 warm); "
                   "host_ms a call in blocks of 100; library_ms None: no "
                   "library routine does this step",
        **timed["linearize"],
        **{f"{key}_b8": timed["linearize_batch"][key] for key in
           ("ms", "plain_ms", "bound_ms", "library_ms", "host_ms",
            "plain_host_ms")},
        max_abs_err_b8=l1b["b_abs"],
        max_abs_err_gnc=l1g_err,
        **{f"{key}_gnc_b8": timed["linearize_gnc_batch"][key] for key in
           ("ms", "plain_ms", "bound_ms", "host_ms", "plain_host_ms")},
        bootstrap_launches=boot_launches["se2_linearize"],
        posegraph_launches=pg_launches["se2_linearize"],
        frontend_launches=fe_launches["se2_linearize"],
        filters_launches=filter_launches["se2_linearize"],
        slam_launches=slam_launches["se2_linearize"],
        parallel_launches=par_launches["se2_linearize"],
        blocks_launches=blk_launches["se2_linearize"],
        cli_launches=cli_launches["se2_linearize"],
        bench_launches=bench_launches["se2_linearize"],
        gnc_launches=gnc_launches["se2_linearize"],
        marginal_launches=(marg["launches"]["se2_linearize"]
                           + marg3["launches"]["se2_linearize"])))
    # LC, LM's accept test (the trial's χ² and both graphs' GNC costs in
    # one launch; global_error of any f32 SE2 graph on the card)
    kernels.append(dict(
        name="se2_lm_cost_f32 (LC)", route="cuda",
        source="rustrobotics_tpu_torch/csrc/se2_linearize.cu",
        replaces="none: mapping/pgo.py::global_error and "
                 "robust_global_cost, left to XLA's fusion in the JAX "
                 "package",
        launches=launches["se2_lm_cost"], max_abs_err=lc_err,
        fleet_launches=fleet_launches["se2_lm_cost"],
        err_measure="max relative error of the sums against "
                    "se2_cost_plain: corridor-1728 by least squares, "
                    "corridor-1728-gnc and its fleet of 8 under gnc-gm at μ "
                    "halfway and at a number μ (δ 1.5)",
        ms_measure="device ms a call (the trial and the current graph), "
                   "calls queued back to back (L2 warm), corridor-1728-gnc "
                   "at μ halfway; *_b8 its fleet of 8; host_ms a call in "
                   "blocks of 100; library_ms None: no library routine "
                   "does this step",
        **timed["lm_cost"],
        **{f"{key}_b8": timed["lm_cost_batch"][key] for key in
           ("ms", "plain_ms", "bound_ms", "library_ms", "host_ms",
            "plain_host_ms")},
        bootstrap_launches=boot_launches["se2_lm_cost"],
        posegraph_launches=pg_launches["se2_lm_cost"],
        frontend_launches=fe_launches["se2_lm_cost"],
        filters_launches=filter_launches["se2_lm_cost"],
        slam_launches=slam_launches["se2_lm_cost"],
        parallel_launches=par_launches["se2_lm_cost"],
        blocks_launches=blk_launches["se2_lm_cost"],
        cli_launches=cli_launches["se2_lm_cost"],
        bench_launches=bench_launches["se2_lm_cost"],
        gnc_launches=gnc_launches["se2_lm_cost"],
        marginal_launches=(marg["launches"]["se2_lm_cost"]
                           + marg3["launches"]["se2_lm_cost"])))
    for k in kernels:
        for key in ("ms", "plain_ms", "library_ms", "max_abs_err"):
            for name in (key, f"{key}_3d", f"{key}_b8", f"{key}_b32",
                         f"{key}_gnc_b8"):
                if k.get(name) is not None and not math.isfinite(k[name]):
                    fail(f"{k['name']} {name} is not finite")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
