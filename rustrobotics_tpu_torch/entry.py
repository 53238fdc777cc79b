"""Entry points of the port (counterpart of the JAX package's
``__graft_entry__.py``).

- ``entry()``: one Gauss-Newton step of the pose-graph optimizer
  (linearize -> assemble a dense H -> Cholesky solve -> manifold
  retraction) on a synthetic 2D graph, as (fn, example arguments).
- ``dryrun_multichip(n)``: a distributed dry run on the caller's process
  group of n ranks (one device a rank: NCCL on cards, gloo on the CPU):
  the map-block optimizer (node and edge partitions, halo exchanges,
  all-reduced PCG) held to the single-device dense optimizer, the 2-D
  replica multi-start where n >= 4 is even, and one edge-sharded GN step.

    torchrun --nproc-per-node 4 -m rustrobotics_tpu_torch.entry
    python -m rustrobotics_tpu_torch.entry --cpu   # world size 1, gloo
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from rustrobotics_tpu_torch.device import resolve_device

DRYRUN_ITERATIONS = 3
DRYRUN_RTOL = 2e-3


def _check(cond, msg):
    """An assertion of the dry run that ``python -O`` keeps."""
    if not cond:
        raise AssertionError(msg)


def _gn_step_fn(graph_template):
    """fn(graph) -> (poses2', landmarks2', χ²'): one undamped GN step with
    a dense H summed from the triplets (``index_put_`` with accumulate)
    and a dense Cholesky solve, for graphs of the template's structure."""
    from rustrobotics_tpu_torch.mapping.assemble import (
        apply_update,
        build_layout,
        system_values,
    )
    from rustrobotics_tpu_torch.mapping.pgo import global_error

    layout = build_layout(graph_template)
    device = graph_template.device
    plan = layout.linearize_plan.to(device)
    rows = torch.as_tensor(np.asarray(layout.rows), dtype=torch.long,
                           device=device)
    cols = torch.as_tensor(np.asarray(layout.cols), dtype=torch.long,
                           device=device)

    def gn_step(graph):
        vals, b, _ = system_values(graph, 0.0, plan=plan)
        h = torch.zeros((layout.n, layout.n), dtype=vals.dtype,
                        device=vals.device)
        h.index_put_((rows, cols), vals, accumulate=True)
        dx = torch.cholesky_solve(b[:, None], torch.linalg.cholesky(h))[:, 0]
        new_graph = apply_update(graph, dx)
        return new_graph.poses2, new_graph.landmarks2, global_error(new_graph)

    return gn_step


def entry(device=None):
    """(fn, (graph,)): the GN step on ``synthetic_pose_graph_2d(96, 12)``
    in f32 on ``device`` (None: the card)."""
    from rustrobotics_tpu_torch.mapping.synthetic import (
        synthetic_pose_graph_2d,
    )

    graph = synthetic_pose_graph_2d(num_poses=96, num_landmarks=12,
                                    dtype=torch.float32, device=device)
    return _gn_step_fn(graph), (graph,)


def _golden_trace(graph):
    """The single-device reference of the dry run: the χ² trace (numpy,
    NaN tail dropped) of ``DRYRUN_ITERATIONS`` dense GN iterations at
    tolerance 0 on the graph's device."""
    from rustrobotics_tpu_torch.mapping.pgo import make_optimize

    run = make_optimize(graph, num_iterations=DRYRUN_ITERATIONS,
                        backend="dense", tolerance=0.0, device=graph.device)
    ref = run(graph)[1].double().cpu().numpy()
    return ref[~np.isnan(ref)]


def _check_golden(got, ref, what):
    got = np.asarray(got, dtype=np.float64)
    _check(len(got) == len(ref), f"{what}: {got} against {ref}")
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    _check(rel.max() < DRYRUN_RTOL,
           f"{what} diverged from the single-device golden trace: {got} "
           f"against {ref} (relative {rel})")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The distributed dry run on the initialized process group, which
    must have ``n_devices`` ranks (ValueError otherwise), on ``device``
    (None: the card, over NCCL; "cpu" over gloo). Raises AssertionError
    where a check fails."""
    from rustrobotics_tpu_torch.mapping.assemble import apply_update
    from rustrobotics_tpu_torch.mapping.synthetic import (
        synthetic_corridor_graph_2d,
        synthetic_pose_graph_2d,
    )
    from rustrobotics_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from rustrobotics_tpu_torch.parallel.pgo_blocks import (
        block_optimize,
        block_optimize_multistart,
    )
    from rustrobotics_tpu_torch.parallel.pgo_sharded import (
        make_distributed_step_fns,
        pad_edges_for_sharding,
    )

    if not dist.is_initialized():
        raise RuntimeError("dryrun_multichip runs on an initialized "
                           "process group: call init_process_group first")
    if dist.get_world_size() != n_devices:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, the dry run asks for {n_devices}")
    device = resolve_device(device)
    f32 = torch.float32
    mesh = make_mesh(n_devices, axis="blocks", device_type=device.type)

    # map-block path: the whole distributed optimization
    graph = synthetic_corridor_graph_2d(num_poses=16 * n_devices,
                                        num_landmarks=4, dtype=f32,
                                        device=device)
    _, errors, _ = block_optimize(mesh, graph,
                                  num_iterations=DRYRUN_ITERATIONS,
                                  tolerance=0.0, cg_tol=1e-8)
    _check(len(errors) >= 2 and all(np.isfinite(e) for e in errors),
           f"block optimize χ² trace not finite: {errors}")
    _check(errors[-1] <= errors[0],
           f"block optimize did not decrease χ²: {errors}")
    # golden parity: the distributed trace must match the single-device
    # optimizer on the same graph (a wrong halo reduction that still
    # descends fails here)
    _check_golden(errors, _golden_trace(graph), "distributed χ² trace")

    # 2-D (replica x blocks) mesh: the multistart path; replica 0 runs
    # unperturbed, so its trace must match the golden trace too
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = make_mesh_2d(blocks=n_devices // 2, replicas=2,
                             device_type=device.type)
        graph2 = synthetic_corridor_graph_2d(
            num_poses=16 * (n_devices // 2), num_landmarks=4, dtype=f32,
            device=device)
        _, traces, best = block_optimize_multistart(
            mesh2, graph2, num_iterations=DRYRUN_ITERATIONS, jitter=0.02,
            tolerance=0.0, cg_tol=1e-8)
        _check(len(traces) == 2, f"{len(traces)} replica traces, not 2")
        _check_golden(traces[0], _golden_trace(graph2),
                      "2-D multistart replica-0 trace")
        finals = [t[-1] for t in traces]
        _check(finals[best] == min(finals),
               f"best replica {best} of finals {finals}")

    # edge-sharded path: one all-reduced PCG GN step
    mesh_e = make_mesh(n_devices, axis="edges", device_type=device.type)
    graph = synthetic_pose_graph_2d(num_poses=32, num_landmarks=4,
                                    dtype=f32, device=device)
    graph = pad_edges_for_sharding(graph, n_devices)
    solve, error = make_distributed_step_fns(mesh_e, graph, cg_tol=1e-6)
    dx, chi2_before = solve(graph, 0.0)
    chi2_after = error(apply_update(graph, dx))
    _check(bool(torch.isfinite(chi2_after)), "non-finite χ² after the step")
    _check(float(chi2_after) <= float(chi2_before),
           f"GN step did not decrease χ²: {float(chi2_before)} -> "
           f"{float(chi2_after)}")


def _main(argv=None):
    """One GN step of ``entry()``, then ``dryrun_multichip`` over the
    group under torchrun, or a group of one rank."""
    p = argparse.ArgumentParser(prog="rustrobotics_tpu_torch.entry")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU over gloo (the card over NCCL "
                        "otherwise)")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    fn, example = entry(device)
    print("entry ok, chi2 =", float(fn(*example)[2]))
    from rustrobotics_tpu_torch.cli import _process_group

    made = _process_group(device)
    try:
        dryrun_multichip(dist.get_world_size(), device)
        if dist.get_rank() == 0:
            print(f"dryrun_multichip ok on {dist.get_world_size()} "
                  f"rank(s), {dist.get_backend()}")
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    _main()
