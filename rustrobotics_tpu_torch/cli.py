"""Non-interactive CLI (counterpart of ``rustrobotics_tpu/cli.py``).

The same capabilities as argparse subcommands, on the CUDA card unless
``--cpu`` asks for the CPU. ``--x64`` computes in float64 where the JAX
CLI's x64 mode does (the pose graph of ``pgo``, the ``landmarks`` replay);
the simulation, the pendulum and the SLAM replays keep their float32
defaults, as there:

    python -m rustrobotics_tpu_torch.cli localization --algo ekf --plot out.png
    python -m rustrobotics_tpu_torch.cli landmarks --dataset <utias0> --algo pf
    python -m rustrobotics_tpu_torch.cli pgo --file intel.g2o --solver gn --plot d/
    python -m rustrobotics_tpu_torch.cli pgo --file g.g2o --distributed 1
    torchrun --nproc-per-node 4 -m rustrobotics_tpu_torch.cli pgo \\
        --file g.g2o --distributed 2 --replicas 2
    python -m rustrobotics_tpu_torch.cli pendulum --plot out.png
    python -m rustrobotics_tpu_torch.cli doctor
    python -m rustrobotics_tpu_torch.cli bench [--suite] [--suite-out PATH]

``pgo --distributed N`` runs the map-block optimizer on the process group
it finds: under ``torchrun`` (``WORLD_SIZE`` in the environment) the
launcher's ranks, NCCL with one card a rank (gloo with ``--cpu``); alone,
a group of one rank. N (times the replicas) larger than the group is cut
to it; ranks beyond the mesh sit the run out. ``bench --suite`` runs its
sharded families on such a group too.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _setup(args):
    """(device, dtype) of a subcommand's arguments: the dtype of the
    commands whose precision follows ``--x64``."""
    import torch

    from rustrobotics_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if getattr(args, "cpu", False) else None)
    dtype = torch.float64 if getattr(args, "x64", False) else torch.float32
    return device, dtype


def cmd_localization(args):
    import numpy as np
    import torch

    from rustrobotics_tpu_torch.localization.simulation import run_simulation

    device, _ = _setup(args)
    hist = run_simulation(
        torch.Generator(device).manual_seed(args.seed), algo=args.algo,
        sim_time=args.sim_time, num_particles=args.particles, device=device,
    )
    est, true, dr = (hist[k][:, :2].double().cpu().numpy()
                     for k in ("x_est", "x_true", "x_dr"))
    err = np.sqrt(np.mean(np.sum((est - true) ** 2, axis=-1)))
    drift = np.sqrt(np.mean(np.sum((dr - true) ** 2, axis=-1)))
    print(f"{args.algo}: est-RMSE {err:.3f} m, dead-reckoning {drift:.3f} m")
    if args.plot:
        from rustrobotics_tpu_torch.utils.plot import plot_filter_history

        print("saved", plot_filter_history(hist, args.plot, title=args.algo))
    if args.gif:
        from rustrobotics_tpu_torch.utils.plot import save_filter_gif

        print("saved", save_filter_gif(hist, args.gif, title=args.algo))


def cmd_landmarks(args):
    import numpy as np

    from rustrobotics_tpu_torch.data import dataset_root, load_utias
    from rustrobotics_tpu_torch.localization.landmark_replay import (
        ate_vs_groundtruth,
        run_utias_localization,
    )

    device, dtype = _setup(args)
    base = args.dataset or (dataset_root() + "/utias0")
    ds = load_utias(base)
    t0 = time.time()
    times, states = run_utias_localization(
        ds, algo=args.algo, max_events=args.events,
        num_particles=args.particles, seed=args.seed, dtype=dtype,
        device=device,
    )
    ate = ate_vs_groundtruth(ds, times, states)
    print(f"{args.algo}: {len(times)} events in {time.time()-t0:.2f}s, "
          f"ATE {ate:.3f} m")
    if args.fleet:
        # banked fleet replay: B EKF-KC filters from jittered initial
        # states (localization/banked.py)
        from rustrobotics_tpu_torch.localization.landmark_replay import (
            run_utias_localization_fleet,
        )

        t0 = time.time()
        times_f, xs = run_utias_localization_fleet(
            ds, bank=args.fleet, max_events=args.events, seed=args.seed,
            device=device)
        dt_f = time.time() - t0

        class _Est:
            x = xs.mean(-1).cpu().numpy()

        ate_f = ate_vs_groundtruth(ds, times_f, _Est())
        print(f"fleet[{args.fleet} banked ekf-kc]: {len(times_f)} events "
              f"x {args.fleet} filters in {dt_f:.2f}s, "
              f"fleet-mean ATE {ate_f:.3f} m")
    if args.plot:
        from rustrobotics_tpu_torch.utils.plot import (
            plot_landmark_localization,
        )

        gt = ds.groundtruth
        gx = np.interp(times, gt[:, 0], gt[:, 1])
        gy = np.interp(times, gt[:, 0], gt[:, 2])
        print("saved", plot_landmark_localization(
            states.x[:, :2].cpu().numpy(), ds.landmarks[:, :2],
            np.stack([gx, gy], -1), args.plot,
            title=f"{args.algo} landmarks",
        ))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _process_group(device):
    """Initialize ``torch.distributed`` unless it is: from the
    environment under torchrun, else a group of one rank on a free local
    port. NCCL on the card (one card a rank), gloo on the CPU. Returns
    whether this call made the group (the caller then destroys it)."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
            world_size=1)
    return True


def _distributed_pgo(args, data, solver, device):
    """``pgo --distributed N [--replicas R]`` on the process group; rank 0
    prints."""
    import torch
    import torch.distributed as dist

    from rustrobotics_tpu_torch.parallel import (
        block_optimize,
        block_optimize_multistart,
        make_mesh,
        make_mesh_2d,
    )

    made = _process_group(device)
    try:
        world = dist.get_world_size()
        say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
        # f32 cannot reach 1e-10 residuals: an unreachable tolerance makes
        # every CG run to its cap
        f64 = data.dtype == torch.float64
        replicas = args.replicas
        if replicas > 1:
            n_dev = min(args.distributed, max(1, world // replicas))
            mesh2 = make_mesh_2d(blocks=n_dev, replicas=replicas,
                                 device_type=device.type)
            if mesh2.get_coordinate() is None:
                return  # a rank beyond the mesh sits this run out
            say(f"2-D mesh multi-start: {replicas} replicas x "
                f"{n_dev} blocks on {device.type}")
            _, traces, best = block_optimize_multistart(
                mesh2, data, num_iterations=args.iterations,
                jitter=args.jitter, cg_tol=1e-10 if f64 else 1e-6,
            )
            finals = [t[-1] for t in traces]
            say(f"per-replica final chi2: "
                f"{[round(f, 3) for f in finals]}")
            say(f"best replica {best}: chi2 {finals[best]:.5f}")
            return
        n_dev = min(args.distributed, world)
        mesh = make_mesh(n_dev, axis="blocks", device_type=device.type)
        if mesh.get_coordinate() is None:
            return
        say(f"map-block distributed optimize over {n_dev} "
            f"{device.type} device(s)")
        _, errors, it = block_optimize(
            mesh, data, num_iterations=args.iterations,
            solver=solver, cg_tol=1e-10 if f64 else 1e-6,
            cg_maxiter=4000, schur=args.schur,
            cg_forcing=args.cg_forcing, cg_variant=args.cg_variant,
        )
        say(f"converged in {it} iterations; "
            f"chi2 {errors[0]:.1f} -> {errors[-1]:.5f}")
    finally:
        if made:
            dist.destroy_process_group()


def cmd_pgo(args):
    from rustrobotics_tpu_torch.data import dataset_root
    from rustrobotics_tpu_torch.mapping import PoseGraph

    device, dtype = _setup(args)
    path = args.file
    if not os.path.exists(path):
        path = dataset_root() + "/g2o/" + args.file
        if not path.endswith(".g2o"):
            path += ".g2o"
    solver = {"gn": "gauss_newton", "lm": "levenberg_marquardt"}.get(
        args.solver, args.solver
    )
    graph = PoseGraph(path, solver=solver, dtype=dtype, device=device)
    if args.init == "chordal":
        from rustrobotics_tpu_torch.mapping.initialization import (
            chordal_init_se2,
            chordal_init_se3,
        )

        init = chordal_init_se3 if graph.data.is_3d else chordal_init_se2
        graph.data = init(graph.data)
    if args.distributed:
        return _distributed_pgo(args, graph.data, solver, device)
    if args.plot:
        os.makedirs(args.plot, exist_ok=True)
    backend = {"banded-pallas": "banded-kernel"}.get(args.backend,
                                                     args.backend)
    errors = graph.optimize(
        num_iterations=args.iterations, log=True, backend=backend,
        plot=bool(args.plot), out_dir=args.plot or "img",
        robust=args.robust, robust_delta=args.robust_delta,
        robust_alpha=args.robust_alpha,
    )
    print(f"final error: {errors[-1]:.5f}")


def cmd_pendulum(args):
    import numpy as np

    from rustrobotics_tpu_torch.control import simulate_inverted_pendulum

    device, _ = _setup(args)
    states, commands = simulate_inverted_pendulum(
        sim_time=args.sim_time, dt=args.dt, device=device
    )
    states, commands = states.cpu().numpy(), commands.cpu().numpy()
    final = states[-1]
    print(f"final state: x={final[0]:.5f} x_dot={final[1]:.5f} "
          f"theta={final[2]:.5f} theta_dot={final[3]:.5f}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = np.arange(states.shape[0]) * args.dt
        fig, ax = plt.subplots(figsize=(9, 5))
        for i, lbl in enumerate(["x", "x dot", "theta", "theta dot"]):
            ax.plot(t, states[:, i], label=lbl)
        ax.plot(t, commands, "--", label="u")
        ax.legend()
        ax.set_xlabel("t [s]")
        fig.savefig(args.plot, dpi=110, bbox_inches="tight")
        print("saved", args.plot)


def cmd_slam(args):
    import numpy as np

    from rustrobotics_tpu_torch.data import dataset_root, load_slam_course
    from rustrobotics_tpu_torch.mapping.slam_replay import (
        landmark_map_error,
        run_slam_course,
    )

    device, _ = _setup(args)
    base = args.dataset or (dataset_root() + "/slam_course")
    ds = load_slam_course(base)
    if args.method == "pgo":
        from rustrobotics_tpu_torch.mapping.frontend import (
            build_pose_graph_from_slam_course,
        )
        from rustrobotics_tpu_torch.mapping.pgo import optimize

        g = build_pose_graph_from_slam_course(ds, device=device)
        res = optimize(g, num_iterations=30, solver="levenberg_marquardt",
                       backend="banded-direct", log=True, device=device)
        traj = res.graph.poses2.double().cpu().numpy()
        est_lms = res.graph.landmarks2.double().cpu().numpy()
        err = np.linalg.norm(est_lms - np.asarray(ds.landmarks), axis=-1)
        print(f"graph SLAM: chi2 {res.errors[0]:.1f} -> {res.errors[-1]:.1f}"
              f", map error mean {err.mean():.3f} m / max {err.max():.3f} m")
        lms = est_lms
    elif args.method in ("fastslam", "fastslam2"):
        from rustrobotics_tpu_torch.mapping.slam_replay import (
            run_slam_course_fastslam,
        )

        version = 2 if args.method == "fastslam2" else 1
        # 2.0's measurement-driven proposal needs far fewer particles
        parts, est_lm, seen = run_slam_course_fastslam(
            ds, version=version, seed=args.seed,
            num_particles=64 if version == 2 else 256, device=device)
        err = np.linalg.norm(est_lm - np.asarray(ds.landmarks), axis=-1)
        traj = parts.poses.cpu().numpy()[:0]  # final cloud, no trajectory
        print(f"FastSLAM {version}.0: {int(seen.sum())}/"
              f"{len(ds.landmark_ids)} landmarks"
              f", map error mean {err.mean():.3f} m / max {err.max():.3f} m")
        lms = est_lm
    else:
        traj, state = run_slam_course(ds, device=device)
        mx, mean, nseen = landmark_map_error(ds, state)
        print(f"EKF-SLAM over {traj.shape[0]} steps: {nseen}/"
              f"{len(ds.landmark_ids)} landmarks mapped, "
              f"map error mean {mean:.3f} m / max {mx:.3f} m")
        lms = state.landmarks.double().cpu().numpy()
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 6))
        ax.plot(traj[:, 0], traj[:, 1], "r-", lw=0.8, label="trajectory")
        ax.scatter(lms[:, 0], lms[:, 1], marker="x", c="r", label="estimated")
        ax.scatter(ds.landmarks[:, 0], ds.landmarks[:, 1], marker="*",
                   s=120, c="k", label="true landmarks")
        ax.set_aspect("equal")
        ax.legend()
        fig.savefig(args.plot, dpi=110, bbox_inches="tight")
        print("saved", args.plot)


def _smi():
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip() or out.stderr.strip()


def cmd_doctor(args):
    """Device-environment diagnosis: the card (torch.cuda and
    nvidia-smi's name and power limit), a timed matmul on it, whether the
    CUDA kernels build, and the native C++ libraries."""
    import torch

    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        a = torch.ones((512, 512), device="cuda")
        (a @ a).sum().item()
        t0 = time.perf_counter()
        (a @ a).sum().item()
        sync = (time.perf_counter() - t0) * 1e3
        print(f"accelerator: cuda {torch.cuda.get_device_name(0)} "
              f"sync_ms={sync:.1f} n={n} (torch {torch.__version__}, "
              f"CUDA {torch.version.cuda})")
        print(f"nvidia-smi: {_smi()}")
        from rustrobotics_tpu_torch.ops import cuda_lib

        for name in ("band_chol", "banded_matvec", "band_assemble"):
            try:
                t0 = time.perf_counter()
                path = cuda_lib.build(name)
                print(f"CUDA kernels {name}.cu: built "
                      f"({time.perf_counter() - t0:.1f}s, {path.name})")
            except RuntimeError as e:
                print(f"CUDA kernels {name}.cu: FAILED to build: "
                      f"{str(e).splitlines()[0]}")
    else:
        print(f"accelerator: none (torch.cuda.is_available() is False; "
              f"torch {torch.__version__})")
        print("workaround: every subcommand accepts --cpu to run on the "
              "host (the kernels' plain PyTorch versions)")
    from rustrobotics_tpu_torch.mapping.g2o_native import (
        native_available as g2o_native,
    )
    from rustrobotics_tpu_torch.ops.native_solver import native_available

    ldl = "built" if native_available() else "unavailable (scipy fallback)"
    parser = "built" if g2o_native() else "unavailable (python fallback)"
    print(f"native C++ LDL solver: {ldl}")
    print(f"native C++ g2o parser: {parser}")


def cmd_bench(args):
    """The headline (``bench.main``) or, with ``--suite``, every family
    of ``benchmarks.run_suite`` on the process group ``_process_group``
    finds or makes."""
    device, _ = _setup(args)
    if args.suite:
        import torch.distributed as dist

        from rustrobotics_tpu_torch.benchmarks import run_suite

        made = _process_group(device)
        try:
            run_suite(device)
        finally:
            if made:
                dist.destroy_process_group()
        return
    from rustrobotics_tpu_torch import bench

    bench.main(device, args.suite_out)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="rustrobotics_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--x64", action="store_true",
                        help="float64 for pgo's graph and the landmark "
                             "replay (float32 otherwise)")
        sp.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the card otherwise)")

    sp = sub.add_parser("localization", help="simulated unicycle EKF/UKF/PF")
    common(sp)
    sp.add_argument("--algo", choices=["ekf", "ukf", "pf"], default="ekf")
    sp.add_argument("--sim-time", type=float, default=50.0)
    sp.add_argument("--particles", type=int, default=300)
    sp.add_argument("--plot", default=None, help="output PNG path")
    sp.add_argument("--gif", default=None,
                    help="output GIF path (animated filter run)")
    sp.set_defaults(fn=cmd_localization)

    sp = sub.add_parser("landmarks", help="UTIAS landmark localization")
    common(sp)
    sp.add_argument("--dataset", default=None, help="utias directory")
    sp.add_argument("--algo", choices=["ekf", "ukf", "pf"], default="ekf")
    sp.add_argument("--events", type=int, default=10000)
    sp.add_argument("--particles", type=int, default=300)
    sp.add_argument("--fleet", type=int, default=0, metavar="B",
                    help="also replay B banked EKF-KC filters from "
                         "jittered initial states")
    sp.add_argument("--plot", default=None)
    sp.set_defaults(fn=cmd_landmarks)

    sp = sub.add_parser("pgo", help="pose-graph optimization on a g2o file")
    common(sp)
    sp.add_argument("--file", required=True,
                    help="g2o path or bundled name (e.g. intel)")
    sp.add_argument("--solver", choices=["gn", "lm"], default="gn")
    sp.add_argument(
        "--backend", default="host",
        choices=["auto", "auto-measure", "host", "native", "dense",
                 "schur", "cg", "banded-direct", "banded-cr",
                 "banded-kernel", "banded-pallas", "banded-mixed"],
        help="banded-pallas names the JAX package's kernel backend and "
             "runs banded-kernel, its CUDA counterpart",
    )
    sp.add_argument("--iterations", type=int, default=50)
    sp.add_argument("--init", choices=["none", "chordal"], default="none",
                    help="bootstrap initialization before optimizing")
    sp.add_argument("--robust",
                    choices=["huber", "cauchy", "barron", "gnc-gm"],
                    default=None,
                    help="M-estimator reweighting of outlier edges; "
                         "barron = Barron general loss (--robust-alpha), "
                         "gnc-gm = graduated non-convexity over "
                         "Geman-McClure (adaptive)")
    sp.add_argument("--robust-delta", type=float, default=1.0)
    sp.add_argument("--robust-alpha", type=float, default=-2.0,
                    help="Barron loss shape (2=L2, 0=Cauchy, -2=GM)")
    sp.add_argument("--plot", default=None, help="output directory for PNGs")
    sp.add_argument("--distributed", type=int, default=0, metavar="N",
                    help="map-block distributed optimize over N ranks "
                         "(parallel.block_optimize)")
    sp.add_argument("--schur", action="store_true",
                    help="with --distributed: eliminate 2D landmark "
                         "blocks per rank before the halo-CG")
    sp.add_argument("--replicas", type=int, default=1, metavar="R",
                    help="with --distributed: 2-D (replicas x blocks) "
                         "mesh multi-start -- R jittered initializations "
                         "optimized in data-parallel, best chi2 wins")
    sp.add_argument("--jitter", type=float, default=0.05,
                    help="with --replicas: pose-noise scale for the "
                         "non-first replicas' initializations")
    sp.add_argument("--cg-forcing", dest="cg_forcing",
                    choices=["fixed", "ew", "ew-fast"], default="fixed",
                    help="with --distributed: inexact-Newton CG forcing "
                         "(ew: Eisenstat-Walker, exact optimum; ew-fast: "
                         "fewer rounds, a looser optimum)")
    sp.add_argument("--cg-variant", dest="cg_variant",
                    choices=["auto", "single", "classic"], default="auto",
                    help="with --distributed: CG communication pattern "
                         "(single: Chronopoulos-Gear, one fused "
                         "all-reduce a round; classic: two)")
    sp.set_defaults(fn=cmd_pgo)

    sp = sub.add_parser("pendulum", help="LQR inverted pendulum")
    common(sp)
    sp.add_argument("--sim-time", type=float, default=5.0)
    sp.add_argument("--dt", type=float, default=0.01)
    sp.add_argument("--plot", default=None)
    sp.set_defaults(fn=cmd_pendulum)

    sp = sub.add_parser("slam", help="SLAM on the slam_course dataset")
    common(sp)
    sp.add_argument("--dataset", default=None, help="slam_course directory")
    sp.add_argument("--method",
                    choices=["ekf", "pgo", "fastslam", "fastslam2"],
                    default="ekf",
                    help="online EKF-SLAM, batch graph SLAM, or FastSLAM")
    sp.add_argument("--plot", default=None, help="output PNG path")
    sp.set_defaults(fn=cmd_slam)

    sp = sub.add_parser("doctor", help="diagnose the device environment")
    sp.set_defaults(fn=cmd_doctor)

    sp = sub.add_parser("bench", help="run the headline benchmark")
    sp.add_argument("--suite", action="store_true",
                    help="run the full criterion-equivalent suite")
    sp.add_argument("--suite-out", default=None, metavar="PATH",
                    help="write the headline's suite rows to PATH (JSON)")
    sp.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the card otherwise)")
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
