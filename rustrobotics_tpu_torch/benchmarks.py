"""Criterion-equivalent benchmark suite (counterpart of
``rustrobotics_tpu/benchmarks.py``; the reference's benches/).

The reference measures one EKF/UKF ``update_estimate`` on the 4-state
SimpleProblem models (benches/kalman_filter.rs:11-60) and parse + 10 GN
iterations on intel.g2o (benches/graph_slam.rs:6-16). On the card one tiny
update costs its launches and one synchronize, so each filter is reported
two ways:

- ``*_update_roundtrip``: one update, synchronized: the criterion analog
  (the host's launches and the sync are the number; marked as such);
- ``*_update_throughput``: a batch of independent filters (a leading
  batch axis of the state) advanced by one chained call, synchronized
  once.

Every family appends rows (dicts with ``metric``, ``value``, ``unit`` and
the JAX package's extra keys, key for key) to ``results`` and runs on
``device`` (None: the card; ``"cpu"`` on request). A family that needs a
dataset file returns without a row when the file is absent. Unlike the JAX
suite, no family catches an exception: a kernel that fails to build or
launch must not turn into a missing row or a win for another backend.

Each timed program is made by a private function (``_filter_chain``,
``_banked_chain``, ``_fixed_lag_run``, ``_graph_slam_run``,
``_pgo_batch_runs``, ...) that the parity tests also call.

Run: ``python -m rustrobotics_tpu_torch.cli bench --suite`` (or
``python -c "from rustrobotics_tpu_torch.benchmarks import run_suite;
run_suite()"``).
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from rustrobotics_tpu_torch.data import dataset_root as _default_root
from rustrobotics_tpu_torch.device import resolve_device
from rustrobotics_tpu_torch.utils.devtime import fetch

BATCH = 4096
STEPS = 100  # chained filter steps of a throughput row
DT = 0.1
# the CUDA sources the banded-kernel paths launch
KERNEL_SOURCES = ("band_chol", "band_assemble")


def _bench(fn, *args, repeats=20):
    """Best wall time of one call of ``fn(*args)`` over ``repeats``, each
    ending in one synchronize (``utils.devtime.fetch``), after one warm
    call."""
    return _bench_out(fn, *args, repeats=repeats)[0]


def _bench_out(fn, *args, repeats=20):
    """_bench that also returns the last output (for callers that need a
    result the timed runs already computed: no extra run)."""
    out = fetch(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fetch(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def build_kernels(device):
    """Compile the CUDA sources of the banded-kernel paths before a timed
    call, so that no first call counts ``nvcc`` (no-op off the card)."""
    if device.type != "cuda":
        return
    from rustrobotics_tpu_torch.ops import cuda_lib

    for name in KERNEL_SOURCES:
        cuda_lib.build(name)


def _simple_problem_noise(dtype=torch.float32, device=None):
    """(q, r): the SimpleProblem's process and measurement noise."""
    device = resolve_device(device)
    q = torch.diag(torch.tensor([0.1, 0.1, math.radians(1.0), 1.0],
                                dtype=dtype, device=device)) ** 2
    r = torch.diag(torch.tensor([1.0, 1.0], dtype=dtype,
                                device=device)) ** 2
    return q, r


def _simple_problem_filters(dtype=torch.float32, device=None):
    from rustrobotics_tpu_torch.localization import (
        ExtendedKalmanFilter,
        UnscentedKalmanFilter,
    )
    from rustrobotics_tpu_torch.models import (
        SimpleProblemMeasurementModel,
        SimpleProblemMotionModel,
    )

    q, r = _simple_problem_noise(dtype, device)
    ekf = ExtendedKalmanFilter(
        r=q, q=r, motion_model=SimpleProblemMotionModel(),
        measurement_model=SimpleProblemMeasurementModel(),
    )
    ukf = UnscentedKalmanFilter.create(
        q=q, r=r, motion_model=SimpleProblemMotionModel(),
        measurement_model=SimpleProblemMeasurementModel(),
        alpha=0.001, beta=2.0, kappa=0.0,
    )
    return ekf, ukf


def _control_measurement(dtype, device):
    u = torch.tensor([1.0, 0.1], dtype=dtype, device=device)
    z = torch.tensor([0.3, 0.2], dtype=dtype, device=device)
    return u, z


def _filter_chain(filt, batch, steps=STEPS, dtype=torch.float32,
                  device=None):
    """The throughput rows' program: ``batch`` independent filters (the
    state's leading batch axis, which the SimpleProblem models and the
    filters take) advanced ``steps`` times on one control and one
    measurement. Returns (run, state0); run(state) -> state."""
    from rustrobotics_tpu_torch.utils.state import GaussianState

    device = resolve_device(device)
    u, z = _control_measurement(dtype, device)
    bu, bz = u.expand(batch, 2), z.expand(batch, 2)
    state0 = GaussianState(
        x=torch.zeros((batch, 4), dtype=dtype, device=device),
        cov=torch.eye(4, dtype=dtype, device=device).expand(batch, 4, 4),
    )

    def run(state):
        for _ in range(steps):
            state = filt.step(state, bu, bz, DT)
        return state

    return run, state0


def _banked_chain(filt, bank, steps=STEPS, dtype=torch.float32, device=None):
    """The banked rows' program: a bank of ``bank`` filters (bank axis
    last) advanced ``steps`` times. Returns (run, (x0, cov0));
    run(x, cov) -> (x, cov)."""
    device = resolve_device(device)
    u, z = _control_measurement(dtype, device)
    ub, zb = u[:, None].expand(2, bank), z[:, None].expand(2, bank)
    x0 = torch.zeros((4, bank), dtype=dtype, device=device)
    cov0 = torch.eye(4, dtype=dtype, device=device)[:, :, None].expand(
        4, 4, bank)

    def run(x, cov):
        for _ in range(steps):
            x, cov = filt.step(x, cov, ub, zb, DT)
        return x, cov

    return run, (x0, cov0)


def bench_filter_updates(results, device=None):
    from rustrobotics_tpu_torch.localization.banked import (
        simple_problem_banked,
        simple_problem_banked_ukf,
    )
    from rustrobotics_tpu_torch.utils.state import GaussianState

    device = resolve_device(device)
    dtype = torch.float32
    ekf, ukf = _simple_problem_filters(dtype, device)
    u, z = _control_measurement(dtype, device)

    for name, filt in [("ekf", ekf), ("ukf", ukf)]:
        state = GaussianState(x=torch.zeros(4, dtype=dtype, device=device),
                              cov=torch.eye(4, dtype=dtype, device=device))
        # "roundtrip", not "latency": one synchronized call measures the
        # host's launches and the sync; the device-side truth is the
        # throughput row
        lat = _bench(filt.step, state, u, z, DT)
        results.append({
            "metric": f"{name}_update_roundtrip", "value": round(lat * 1e6, 2),
            "unit": "us", "note": "incl host launches + sync",
        })
        chained, bstate = _filter_chain(filt, BATCH, STEPS, dtype, device)
        t = _bench(chained, bstate, repeats=8)
        results.append({
            "metric": f"{name}_update_throughput",
            "value": round(BATCH * STEPS / t / 1e6, 3), "unit": "Mupdates/s",
        })

    # banked (bank axis last): every operand of a step is contiguous in B
    q, r = _simple_problem_noise(dtype, device)
    bb = BATCH * 16
    banked = simple_problem_banked(q=q, r=r)
    chained, args = _banked_chain(banked, bb, STEPS, dtype, device)
    t = _bench(chained, *args, repeats=4)
    results.append({
        "metric": "ekf_banked_update_throughput",
        "value": round(bb * STEPS / t / 1e6, 3), "unit": "Mupdates/s",
        "bank": bb,
    })
    # banked UKF: the sigma axis folded into the bank; 9x fan-out, so half
    # the bank
    bukf = simple_problem_banked_ukf(q=q, r=r, alpha=0.001, beta=2.0,
                                     kappa=0.0)
    bu_ukf = bb // 2
    chained, args = _banked_chain(bukf, bu_ukf, STEPS, dtype, device)
    t = _bench(chained, *args, repeats=4)
    results.append({
        "metric": "ukf_banked_update_throughput",
        "value": round(bu_ukf * STEPS / t / 1e6, 3), "unit": "Mupdates/s",
        "bank": bu_ukf,
    })


def _fleet_replay(dataset, bank, events, dtype=torch.float32, device=None):
    """The fleet replay's program: ``bank`` banked EKF-KC filters from
    the origin consume the first ``events`` events (the entry point's
    replay loop). Returns (run, (x0, cov0), number of events);
    run(x, cov) -> the last estimates (3, bank)."""
    from rustrobotics_tpu_torch.localization.landmark_replay import (
        _first_dt,
        _replay_banked,
        build_banked_filter,
    )

    device = resolve_device(device)
    filt = build_banked_filter(dataset, dtype, device)
    ev = dataset.events(max_events=events, dtype=dtype, device=device)
    dt = _first_dt(ev)
    x0 = torch.zeros((3, bank), dtype=dtype, device=device)
    cov0 = (torch.eye(3, dtype=dtype, device=device)
            * 1e-10)[:, :, None].expand(3, 3, bank)

    def run(x, cov):
        return _replay_banked(filt, x, cov, ev, dt)[-1]

    return run, (x0, cov0), ev.num_events


def bench_fleet_replay(results, bank=1024, events=2000, dataset_root=None,
                       device=None):
    """Banked EKF-KC fleet replay on UTIAS (``<dataset_root>/utias0``;
    None: ``data.dataset_root()``): B velocity + range-bearing filters
    consume the same event stream in one replay (the lane-major product
    path the reference's one-filter-object architecture runs B times,
    extended_kalman_filter.rs:81-165). Reports filter-events/s."""
    from rustrobotics_tpu_torch.data.utias import load_utias

    base = os.path.join(dataset_root or _default_root(),
                        "utias0")
    if not os.path.exists(base):
        return
    run, args, n_events = _fleet_replay(load_utias(base), bank, events,
                                        torch.float32, device)
    t = _bench(run, *args, repeats=5)
    results.append({
        "metric": f"utias_fleet_banked_ekf_kc_b{bank}",
        "value": round(bank * n_events / t / 1e6, 3),
        "unit": "Mfilter-events/s",
        "events": n_events,
    })


def bench_pf_update(results, device=None):
    from rustrobotics_tpu_torch.localization.simulation import run_simulation

    device = resolve_device(device)
    # the whole 500-step PF simulation a call; reports steps/s
    t = _bench(lambda: run_simulation(
        torch.Generator(device).manual_seed(0), algo="pf", device=device))
    results.append({
        "metric": "pf_sim_500steps", "value": round(0.5 / t, 3),
        "unit": "ksteps/s",
    })


def _pf_chain(num_particles, steps, dtype=torch.float32, device=None):
    """The particle-throughput program: an SIR filter on the SimpleProblem
    models, ``steps`` propagate + weight + systematic-resample steps of
    ``num_particles`` particles, its draws from a generator seeded 1 at
    every call. Returns (run, particles0)."""
    from rustrobotics_tpu_torch.localization.pf import ParticleFilter
    from rustrobotics_tpu_torch.models import (
        SimpleProblemMeasurementModel,
        SimpleProblemMotionModel,
    )

    device = resolve_device(device)
    r = torch.diag(torch.tensor([0.2, 0.2, math.radians(3.0), 0.1],
                                dtype=dtype, device=device)) ** 2
    q = torch.diag(torch.tensor([0.4, 0.4], dtype=dtype, device=device)) ** 2
    pf = ParticleFilter(
        r=r, q=q, motion_model=SimpleProblemMotionModel(),
        measurement_model=SimpleProblemMeasurementModel(),
    )
    u, z = _control_measurement(dtype, device)
    particles0 = torch.randn(
        (num_particles, 4), generator=torch.Generator(device).manual_seed(0),
        dtype=dtype, device=device)

    def run(p):
        gen = torch.Generator(device).manual_seed(1)
        for _ in range(steps):
            p = pf.step(gen, p, u, z, DT)
        return p

    return run, particles0


def bench_pf_scale(results, num_particles=262144, steps=50, device=None):
    """Large-particle SIR filter: propagate + weight + systematic resample
    of 256k particles a step, chained in one call (the reference iterates
    particles serially, particle_filter.rs:90-106)."""
    run, particles0 = _pf_chain(num_particles, steps, torch.float32, device)
    t = _bench(run, particles0, repeats=6)
    results.append({
        "metric": "pf_particle_throughput",
        "value": round(num_particles * steps / t / 1e9, 3),
        "unit": "Gparticle-steps/s",
    })


def _group_note():
    return (f"{dist.get_backend()} group, world size "
            f"{dist.get_world_size()}")


def bench_pf_sharded(results, num_particles=1_048_576, steps=5, device=None):
    """A 1M-particle cloud sharded over the caller's process group (every
    rank, one device a rank: NCCL on cards, gloo on the CPU; nothing runs
    without an initialized group): propagate + weight + bounded-exchange
    systematic resample a step. Records the ring-hop count (comm volume =
    hops x local cloud bytes, against the full-gather variant's D - 1
    chunks). Each rank appends the row."""
    from rustrobotics_tpu_torch.localization.pf import ParticleFilter
    from rustrobotics_tpu_torch.models import (
        SimpleProblemMeasurementModel,
        SimpleProblemMotionModel,
    )
    from rustrobotics_tpu_torch.parallel import make_mesh
    from rustrobotics_tpu_torch.parallel.pf_sharded import (
        make_sharded_pf_step_bounded,
    )

    if not dist.is_initialized():
        return
    device = resolve_device(device)
    mesh = make_mesh(device_type=device.type)
    rank, size = mesh.get_local_rank(0), mesh.size(0)
    f32 = torch.float32
    pf = ParticleFilter(
        r=torch.eye(4, dtype=f32, device=device) * 0.01,
        q=torch.eye(2, dtype=f32, device=device) * 0.1,
        motion_model=SimpleProblemMotionModel.create(),
        measurement_model=SimpleProblemMeasurementModel.create(),
    )
    n_local = num_particles // size
    cloud = np.random.default_rng(0).normal(
        size=(num_particles, 4)).astype(np.float32) * 0.5
    particles = torch.as_tensor(cloud[rank * n_local:(rank + 1) * n_local],
                                device=device)
    u = torch.tensor([1.0, 0.1], dtype=f32, device=device)
    z = torch.tensor([0.12, 0.03], dtype=f32, device=device)
    step = make_sharded_pf_step_bounded(mesh, pf, num_particles)
    # the rank's own process noise, one grid offset shared by every rank
    noise_gen = torch.Generator(device).manual_seed(1 + rank)
    u0_gen = torch.Generator(device).manual_seed(0)

    out, rounds = step(noise_gen, u0_gen, particles, u, z, DT)
    fetch(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        out, rounds = step(noise_gen, u0_gen, out, u, z, DT)
    fetch(out)
    t = (time.perf_counter() - t0) / steps
    results.append({
        "metric": "pf_sharded_1m_bounded_exchange",
        "value": round(num_particles / t / 1e6, 2),
        "unit": "Mparticle-steps/s",
        "ring_hops": int(rounds),
        "note": _group_note(),
    })


def _fixed_lag_run(window, steps, dtype=torch.float32, device=None):
    """The fixed-lag program: a smoother of ``window`` poses and 16
    closure slots advanced ``steps`` times on a constant odometry. Returns
    (run, (state0, odos)); run(state, odos) -> state."""
    from rustrobotics_tpu_torch.mapping.fixed_lag import FixedLagSmoother

    device = resolve_device(device)
    sig = torch.tensor([0.05, 0.05, 0.02], dtype=dtype, device=device)
    fls = FixedLagSmoother.create(
        window=window, closure_capacity=16,
        chain_omega=torch.diag(1.0 / sig ** 2),
        clos_omega=torch.eye(3, dtype=dtype, device=device) * 100.0,
        device=device,
    )
    state0 = fls.init_state(torch.zeros(3, dtype=dtype, device=device))
    odos = torch.tensor([1.0, 0.0, 0.3], dtype=dtype,
                        device=device).expand(steps, 3)

    def run(state, odos_):
        for u in odos_:
            state = fls.advance(state, u)
        return state

    return run, (state0, odos)


def bench_fixed_lag(results, window=32, steps=200, device=None):
    """Online sliding-window smoothing rate (W poses, 3 GN inner
    iterations + Schur marginalization a step)."""
    run, (state, odos) = _fixed_lag_run(window, steps, torch.float32, device)
    t = _bench(lambda: run(state, odos).poses, repeats=5)
    results.append({
        "metric": f"fixed_lag_w{window}_steps_per_sec",
        "value": round(steps / t, 1), "unit": "steps/s",
    })


def _graph_slam_run(graph, backend, iters=10, device=None):
    """The graph_slam rows' program: ``iters`` GN iterations at tolerance
    0 on ``backend``; run(graph) -> (graph', errors, iterations)."""
    from rustrobotics_tpu_torch.mapping.pgo import make_optimize

    return make_optimize(graph, num_iterations=iters, backend=backend,
                         tolerance=0.0, device=device)


def bench_graph_slam(results, dataset_root=None,
                     graphs=("intel", "dlr", "sphere2500", "torus3D"),
                     backends=("banded-direct", "dense"), device=None):
    """10 GN iterations per graph/backend (f32) with roofline accounting:
    iters/s, achieved TFLOP/s, MFU against the f32 peak (None on the CPU)
    and compile_s, the first call's extra time (the CUDA sources are built
    before it). Graphs are ``<dataset_root>/g2o/<name>.g2o``; a missing
    file gives no row."""
    from rustrobotics_tpu_torch.mapping import load_g2o
    from rustrobotics_tpu_torch.mapping.assemble import build_layout
    from rustrobotics_tpu_torch.ops.band_chol import build_band_chol
    from rustrobotics_tpu_torch.roofline import mfu, pgo_iteration_flops

    device = resolve_device(device)
    root = dataset_root or _default_root()
    for name in graphs:
        path = os.path.join(root, "g2o", f"{name}.g2o")
        if not os.path.exists(path):
            continue
        graph = load_g2o(path, dtype=torch.float32, device=device)
        bl = build_band_chol(build_layout(graph))
        for backend in backends:
            iters = 10
            if backend == "banded-kernel":
                build_kernels(device)
            run = _graph_slam_run(graph, backend, iters, device)
            t0 = time.perf_counter()
            fetch(run(graph))
            first = time.perf_counter() - t0
            t = _bench(lambda: run(graph), repeats=6)
            eff_backend = backend
            if backend in ("banded-direct", "banded-cr", "banded-kernel",
                           "banded-mixed") and bl is None:
                eff_backend = "dense"  # the banded plan fell back
            flops = pgo_iteration_flops(graph, eff_backend, bl) * iters
            u = mfu(flops / t, device.type)
            results.append({
                "metric": f"graph_slam_{name}_{backend}",
                "value": round(iters / t, 2), "unit": "GN iters/s",
                "tflops": round(flops / t / 1e12, 3),
                "mfu": round(u, 4) if u is not None else None,
                "compile_s": round(max(first - t, 0.0), 2),
            })


def _pgo_batch_runs(graph, batch, iters, backend, device=None):
    """The fleet row's programs: ``graph`` and ``batch - 1`` copies with
    poses jittered by N(0, 0.01²) (generator i seeded i), stacked; the
    batched optimizer and the one-graph optimizer, GN ``iters`` at
    tolerance 0 on ``backend``. Returns (run_batch, fleet, run_one,
    graphs)."""
    from rustrobotics_tpu_torch.mapping.pgo import (
        make_optimize,
        make_optimize_batch,
        stack_graphs,
    )

    device = resolve_device(device)
    g = graph.to(device=device)
    graphs = [g]
    for i in range(1, batch):
        noise = torch.randn(g.poses2.shape,
                            generator=torch.Generator(device).manual_seed(i),
                            dtype=g.dtype, device=device)
        graphs.append(g.replace(poses2=g.poses2 + 0.01 * noise))
    kw = dict(num_iterations=iters, tolerance=0.0, backend=backend,
              device=device)
    return (make_optimize_batch(g, **kw), stack_graphs(graphs),
            make_optimize(g, **kw), graphs)


def bench_pgo_batch(results, dataset_root=None, graph="intel", batch=None,
                    iters=10, device=None):
    """Fleet throughput: B same-structure graphs optimized by one batched
    loop (``pgo.make_optimize_batch``) against B sequential runs: the
    batch axis the reference's one-graph-at-a-time UMFPACK architecture
    cannot express (pose_graph_optimization.rs:215-303). On the card the
    fleet runs ``banded-kernel`` (K5 and the batched K1/K2), on the CPU
    ``banded-direct``; B defaults to 8 on the card and 2 on the CPU.
    Reports graphs/s and the batching speedup."""
    from rustrobotics_tpu_torch.mapping import load_g2o

    device = resolve_device(device)
    on_card = device.type == "cuda"
    if batch is None:
        batch = 8 if on_card else 2
    path = os.path.join(dataset_root or _default_root(), "g2o",
                        f"{graph}.g2o")
    if not os.path.exists(path):
        return
    backend = "banded-kernel" if on_card else "banded-direct"
    build_kernels(device)
    g = load_g2o(path, dtype=torch.float32, device=device)
    run_b, batched, run_1, graphs = _pgo_batch_runs(g, batch, iters, backend,
                                                    device)
    t_b = _bench(lambda: run_b(batched), repeats=3)

    def seq():
        outs = [run_1(gi) for gi in graphs]
        return outs[-1]

    t_seq = _bench(seq, repeats=2)
    results.append({
        "metric": f"pgo_batch{batch}_{graph}_graphs_per_sec",
        "value": round(batch / t_b, 2), "unit": "graphs/s",
        "batch": batch,
        "speedup_vs_sequential": round(t_seq / t_b, 2),
        "batched_ms_per_graph_iter": round(1e3 * t_b / batch / iters, 3),
        "seq_ms_per_graph_iter": round(1e3 * t_seq / batch / iters, 3),
    })


def bench_block_scaling(results, devices=(1, 2, 4, 8), base_poses=1024,
                        iters=6, device=None):
    """Weak and strong scaling of the map-block distributed GN iteration
    over the caller's process group (one device a rank: NCCL on cards,
    gloo on the CPU; nothing runs without an initialized group). Only the
    sizes D of ``devices`` up to the group's size run, on its first D
    ranks: D = 1 on one card. Every rank takes part in the meshes; rank 0,
    which is in every one, appends the rows. Efficiency % against the
    ">=80% 1 -> N" target:

    - weak: corridor graph grows with D (``base_poses`` a rank);
      eff = t1 * serial / tD;
    - strong: a fixed max(D) * base_poses graph; eff = t1 * serial / (D tD);

    ``serial`` = D / min(D, cores) for gloo ranks sharing the host's
    cores, 1 for cards. Then the fixed-round Jacobi comm-stress row per D
    (and the classic two-reduction CG at the largest D > 1), and the
    Eisenstat-Walker forcing row on ``intel.g2o`` where 8 ranks and the
    file exist."""
    from rustrobotics_tpu_torch.mapping.synthetic import (
        synthetic_corridor_graph_2d,
    )
    from rustrobotics_tpu_torch.parallel import make_mesh
    from rustrobotics_tpu_torch.parallel.pgo_blocks import (
        build_block_layout,
        comm_budget,
        layout_device_arrays,
        make_block_optimize,
    )

    if not dist.is_initialized():
        return
    device = resolve_device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    avail = [d for d in devices if d <= world]
    if not avail:
        return
    f32 = torch.float32

    def block_run(graph, d, **kw):
        """(run, args, layout) of the block program on the first d ranks;
        run is None on a rank outside them."""
        mesh = make_mesh(d, axis="blocks", device_type=device.type)
        if mesh.get_coordinate() is None:
            return None, None, None
        layout = build_block_layout(graph, d)
        args = layout_device_arrays(layout, f32, device)
        return make_block_optimize(mesh, layout, dtype=f32, **kw), args, \
            layout

    def time_block(graph, d):
        # the preconditioner pinned across D (auto would take Jacobi at
        # D = 1 and Schwarz above: two algorithms in one ratio)
        run, args, layout = block_run(
            graph, d, num_iterations=iters, tolerance=0.0, cg_tol=1e-6,
            cg_maxiter=200, precond="schwarz")
        if run is None:
            return None, None
        t, out = _bench_out(run, *args, repeats=4)
        return t / iters, comm_budget(layout, f32, int(out[2]), int(out[3]))

    cores = os.cpu_count() or 1
    weak, weak_budget = {}, {}
    for d in avail:
        g = synthetic_corridor_graph_2d(num_poses=base_poses * d,
                                        closure_span=32, dtype=f32,
                                        device=device)
        weak[d], weak_budget[d] = time_block(g, d)
    strong, strong_budget = {}, {}
    g_fix = synthetic_corridor_graph_2d(num_poses=base_poses * max(avail),
                                        closure_span=32, dtype=f32,
                                        device=device)
    for d in avail:
        strong[d], strong_budget[d] = time_block(g_fix, d)

    # comm-stressed per-round instrument: Jacobi at a FIXED round count
    # (cg_tol 0, maxiter K) on the fixed graph, so the program is K x
    # (halo exchange + matvec + the fused all-reduce); at the largest D
    # the classic two-reduction CG is timed beside it
    rounds_k = 32
    round_rows = {}
    for d in avail:
        def time_variant(variant):
            run, args, layout = block_run(
                g_fix, d, num_iterations=1, tolerance=0.0, cg_tol=0.0,
                cg_maxiter=rounds_k, precond="jacobi", cg_variant=variant)
            if run is None:
                return None, None, None
            t, out = _bench_out(run, *args, repeats=4)
            return t, max(int(out[3]), 1), layout

        t, k, layout = time_variant("single")
        classic = (time_variant("classic")
                   if d == max(avail) and d > 1 else None)
        if t is not None:
            round_rows[d] = (t, k, comm_budget(layout, f32, 1, k), classic)

    # inexact-Newton forcing on a real graph: total CG rounds for fixed
    # against adaptive Eisenstat-Walker forcing on intel at D = 8
    forcing = None
    intel = os.path.join(_default_root(), "g2o", "intel.g2o")
    if world >= 8 and os.path.exists(intel):
        from rustrobotics_tpu_torch.mapping.g2o import load_g2o

        g_intel = load_g2o(intel, dtype=f32, device=device)
        forcing = {"metric": "block_pgo_cg_forcing_intel_d8",
                   "unit": "CG rounds / 6 GN iters"}
        for mode in ("fixed", "ew-fast"):
            run, args, _ = block_run(
                g_intel, 8, num_iterations=6, tolerance=0.0, cg_tol=1e-6,
                cg_maxiter=2000, precond="schwarz", cg_forcing=mode)
            if run is None:
                continue
            out = run(*args)
            key = mode.replace("-", "_")
            forcing[f"rounds_{key}"] = int(out[3])
            errs = out[1].double().cpu().numpy()
            fin = errs[~np.isnan(errs)]
            forcing[f"chi2_{key}"] = (round(float(fin[-1]), 2) if len(fin)
                                      else None)
        forcing["value"] = forcing.get("rounds_ew_fast")

    if rank != 0:
        return
    on_card = device.type == "cuda"
    note = (f"{_group_note()}, one card a rank" if on_card else
            f"{_group_note()}, {cores}-core host (serialization-normalized)")
    t1w, t1s = weak[avail[0]], strong[avail[0]]
    for d in avail:
        serial = 1.0 if on_card else d / min(d, cores)
        results.append({
            "metric": f"block_pgo_weak_scaling_d{d}",
            "value": round(1e3 * weak[d], 2), "unit": "ms/GN iter",
            "efficiency_pct": round(100.0 * t1w * serial / weak[d], 1),
            "cg_rounds_per_gn": weak_budget[d]["cg_rounds_per_gn"],
            "ppermute_kb_per_gn": round(
                weak_budget[d]["ppermute_bytes_per_gn"] / 1024, 1),
            "note": note,
        })
        results.append({
            "metric": f"block_pgo_strong_scaling_d{d}",
            "value": round(1e3 * strong[d], 2), "unit": "ms/GN iter",
            "efficiency_pct": round(
                100.0 * t1s * serial / (d * strong[d]), 1),
            "cg_rounds_per_gn": strong_budget[d]["cg_rounds_per_gn"],
            "ppermute_kb_per_gn": round(
                strong_budget[d]["ppermute_bytes_per_gn"] / 1024, 1),
            "note": note,
        })
    round_t1 = None
    for d in avail:
        t, k, budget, classic = round_rows[d]
        us_per_round = 1e6 * t / k
        if round_t1 is None:
            round_t1 = us_per_round
        row = {
            "metric": f"block_pgo_cg_round_d{d}",
            "value": round(us_per_round, 1), "unit": "us/CG round",
            "cg_rounds": k,
            "halo_dofs_h": budget["halo_dofs_h"],
            "ppermute_kb_per_round": round(
                2 * budget["halo_dofs_h"] * 4 / 1024, 2),
            "collective_overhead_us_vs_d1": round(
                us_per_round - round_t1, 1),
            "note": "fixed-round jacobi comm stress; " + note,
        }
        if classic is not None:
            tc, kc, _ = classic
            row["us_per_round_classic_2psum"] = round(1e6 * tc / kc, 1)
        results.append(row)
    if forcing is not None:
        results.append(forcing)


def run_suite(device=None):
    """Every family on ``device`` (None: the card), in the JAX suite's
    order; the sharded PF and the block scaling run on the caller's
    process group, if one is initialized. Prints one JSON row a line (rank
    0 only under a group), each with ``device`` "cuda" or "cpu"."""
    device = resolve_device(device)
    results = []
    bench_filter_updates(results, device=device)
    bench_fleet_replay(results, device=device)
    bench_pf_update(results, device=device)
    bench_pf_scale(results, device=device)
    bench_fixed_lag(results, device=device)
    bench_graph_slam(results, device=device)
    bench_pgo_batch(results, device=device)
    bench_block_scaling(results, device=device)
    bench_pf_sharded(results, device=device)
    show = not dist.is_initialized() or dist.get_rank() == 0
    for r in results:
        r.setdefault("device", device.type)
        if show:
            print(json.dumps(r))
    return results


if __name__ == "__main__":
    run_suite()
