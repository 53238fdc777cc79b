"""One rank of the port's map-block tier (``parallel.pgo_blocks``) on a gloo
process group, for ``tests/test_torch_block_{step,optimize,replicas}.py``
and ``tests/test_torch_entry.py``.
It holds no tests and imports nothing of JAX: the parent runs JAX, writes
the inputs, starts every rank of a world as

    python tests/test_torch_blocks_worker.py SUITE RANK WORLD STORE IN OUT

(SUITE one of ``step``, ``optimize``, ``replicas``, ``dryrun``; STORE a
file for the group's ``file://`` store, IN the inputs' .npz, OUT a
directory) and compares what the ranks write there
(``out_{SUITE}_{WORLD}_{RANK}.npz``). ``dryrun`` runs
``entry.dryrun_multichip`` and the benchmarks' distributed rows
(``bench_rows``) for ``tests/test_torch_entry.py``.
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rustrobotics_tpu_torch import benchmarks  # noqa: E402
from rustrobotics_tpu_torch.entry import dryrun_multichip  # noqa: E402
from rustrobotics_tpu_torch.mapping.g2o import (  # noqa: E402
    FLOAT_FIELDS,
    INDEX_FIELDS,
    graph_from_numpy,
)
from rustrobotics_tpu_torch.parallel import (  # noqa: E402
    block_optimize,
    block_optimize_multistart,
    build_block_layout,
    make_block_optimize,
    make_block_step,
    make_mesh,
    make_mesh_2d,
)
from rustrobotics_tpu_torch.parallel.pgo_blocks import (  # noqa: E402
    block_optimize_elastic,
    dx_to_reference,
    layout_device_arrays,
)

# (name, graph, D, keyword arguments) of the one-step cases; the parent
# runs the same list through JAX
STEP_LAM = 0.01
STEP_CASES = (
    ("jacobi_single", "circle", 1, dict(precond="jacobi")),
    ("schwarz_classic", "circle", 1, dict(precond="schwarz",
                                          cg_variant="classic")),
    ("jacobi_single", "circle", 2, dict(precond="jacobi")),
    ("jacobi_classic", "circle", 2, dict(precond="jacobi",
                                         cg_variant="classic")),
    ("schwarz2", "circle", 2, dict(precond="schwarz2")),
    ("schur", "circle", 2, dict(schur=True)),
    ("overlap", "corridor", 2, dict(precond="jacobi")),
    ("se3", "sphere", 2, dict()),
    ("multihop_jacobi", "circle", 4, dict(precond="jacobi")),
    ("multihop_schwarz2", "circle", 4, dict(precond="schwarz2")),
    ("multihop_schur", "circle", 4, dict(schur=True, precond="jacobi")),
)
STEP_CG_TOL = 1e-13

# the optimizer cases: (name, D, keyword arguments), on the circle graph
OPT_ITERATIONS = 4
OPT_CG_TOL = 1e-10
OPT_CASES = (
    ("gn", 2, dict(solver="gauss_newton")),
    ("lm", 2, dict(solver="levenberg_marquardt")),
    ("gn", 4, dict(solver="gauss_newton")),
    ("lm", 4, dict(solver="levenberg_marquardt")),
    ("ew", 2, dict(cg_forcing="ew")),
    ("ew_fast", 2, dict(cg_forcing="ew-fast")),
    ("schur", 2, dict(schur=True)),
)
ELASTIC_SEGMENT, ELASTIC_ITERATIONS = 2, 6

# the replica cases on a 2 x 2 mesh
REP_ITERATIONS, REP_JITTER, REP_SEED = 4, 0.05, 0


def graph_of(inp, prefix):
    fields = {k: inp[f"{prefix}_{k}"] for k in FLOAT_FIELDS + INDEX_FIELDS}
    return graph_from_numpy(fields, int(inp[f"{prefix}_total_dof"]),
                            int(inp[f"{prefix}_prior2"]),
                            int(inp[f"{prefix}_prior3"]), device="cpu")


def _step_suite(world, inp, out_dir):
    mesh = make_mesh(device_type="cpu", axis="blocks")
    out = {}
    for name, gname, d, kw in STEP_CASES:
        if d != world:
            continue
        kw = dict(kw)
        schur = kw.pop("schur", False)
        graph = graph_of(inp, gname)
        layout = build_block_layout(graph, d, schur=schur)
        state, edges, maps = layout_device_arrays(layout, torch.float64,
                                                  "cpu")
        solve = make_block_step(mesh, layout, cg_tol=STEP_CG_TOL, **kw)
        dx, chi2 = solve(state, edges, maps, STEP_LAM)
        out[f"{name}_dx"] = dx_to_reference(layout, dx)
        out[f"{name}_chi2"] = float(chi2)
    return out


def _outputs(prefix, graph, errors, it, extra=None):
    out = {f"{prefix}_errors": np.asarray(errors),
           f"{prefix}_iterations": it}
    for field in ("poses2", "landmarks2", "poses3"):
        out[f"{prefix}_{field}"] = getattr(graph, field).numpy()
    out.update(extra or {})
    return out


def _optimize_suite(world, inp, out_dir):
    mesh = make_mesh(device_type="cpu", axis="blocks")
    graph = graph_of(inp, "circle")
    out = {}
    for name, d, kw in OPT_CASES:
        if d != world:
            continue
        g, errors, it, stats = block_optimize(
            mesh, graph, num_iterations=OPT_ITERATIONS, tolerance=0.0,
            cg_tol=OPT_CG_TOL, return_stats=True, slice_size=1, **kw)
        out.update(_outputs(name, g, errors, it,
                            {f"{name}_rounds": stats["cg_rounds_total"],
                             f"{name}_stats": repr(stats)}))
    if world == 2:
        # one checkpoint directory for the ranks, as on a shared disk
        ck = pathlib.Path(out_dir) / "elastic"
        ck_jax = pathlib.Path(out_dir) / "elastic_jax"
        if dist.get_rank() == 0:
            shutil.rmtree(ck, ignore_errors=True)
            shutil.rmtree(ck_jax, ignore_errors=True)
        dist.barrier()
        kw = dict(segment=ELASTIC_SEGMENT, tolerance=0.0, cg_tol=OPT_CG_TOL)
        _, errs_a, it_a = block_optimize_elastic(
            mesh, graph, num_iterations=ELASTIC_SEGMENT,
            checkpoint_dir=ck, **kw)
        g, errs_b, it_b = block_optimize_elastic(
            mesh, graph, num_iterations=ELASTIC_ITERATIONS,
            checkpoint_dir=ck, **kw)
        out.update(_outputs("elastic", g, errs_b, it_b,
                            {"elastic_first": np.asarray(errs_a),
                             "elastic_first_iterations": it_a,
                             "elastic_snapshots": ",".join(
                                 sorted(p.name for p in ck.glob("*.npz")))}))
        g, errs, it = block_optimize_elastic(
            mesh, graph, num_iterations=ELASTIC_ITERATIONS,
            checkpoint_dir=None, **kw)
        out.update(_outputs("elastic_whole", g, errs, it))
        # resume from the JAX package's snapshot after its first segment,
        # which the parent writes while the ranks run
        jax_dir = pathlib.Path(str(inp["elastic_jax_dir"]))
        deadline = time.monotonic() + 300
        while not (jax_dir / "ready").exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"no JAX snapshot in {jax_dir}")
            time.sleep(0.1)
        if dist.get_rank() == 0:
            shutil.copytree(jax_dir, ck_jax)
        dist.barrier()
        g, errs, it = block_optimize_elastic(
            mesh, graph, num_iterations=ELASTIC_ITERATIONS,
            checkpoint_dir=ck_jax, **kw)
        out.update(_outputs("elastic_from_jax", g, errs, it))
    return out


class _Recorder:
    """Wraps torch.distributed's collectives and point-to-point calls and
    records (name, ranks of the group, elements, reduce op) of each."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
             "broadcast", "batch_isend_irecv", "barrier")

    def __init__(self):
        self.calls = collections.Counter()
        self.saved = {}

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self.saved[name] = fn
            setattr(dist, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            if name == "batch_isend_irecv":
                for op in args[0]:
                    self.calls[(name, tuple(dist.get_process_group_ranks(
                        op.group)), op.tensor.numel(), "")] += 1
            else:
                group = kw.get("group")
                ranks = (tuple(dist.get_process_group_ranks(group))
                         if group is not None else ())
                t = args[0] if args else kw.get("tensor")
                numel = t.numel() if isinstance(t, torch.Tensor) else 0
                op = str(kw.get("op", ""))
                self.calls[(name, ranks, numel, op)] += 1
            return fn(*args, **kw)
        return wrapped


def _replicas_suite(world, inp, out_dir):
    mesh2 = make_mesh_2d(2, 2, device_type="cpu")
    graph = graph_of(inp, "circle")
    out = {}
    g, traces, best = block_optimize_multistart(
        mesh2, graph, num_iterations=REP_ITERATIONS, jitter=REP_JITTER,
        seed=REP_SEED, tolerance=0.0, cg_tol=OPT_CG_TOL)
    out["multistart_traces"] = np.asarray(traces)
    out["multistart_best"] = best
    out["multistart_poses2"] = g.poses2.numpy()
    # a replica row given the unjittered state against the 1-D run of the
    # same blocks (this rank's row of the mesh, as a 1-D mesh)
    layout = build_block_layout(graph, 2)
    state, edges, maps = layout_device_arrays(layout, torch.float64, "cpu")
    kw = dict(num_iterations=REP_ITERATIONS, tolerance=0.0,
              cg_tol=OPT_CG_TOL, dtype=torch.float64)
    st1, errs1, it1, cg1 = make_block_optimize(
        mesh2["blocks"], layout, **kw)(state, edges, maps)
    state_r = tuple(a.expand((2,) + tuple(a.shape)).clone() for a in state)
    run2 = make_block_optimize(mesh2, layout, **kw)
    with _Recorder() as rec:
        st2, errs2, it2, cg2 = run2(state_r, edges, maps)
    out.update({"row_errors": errs2.numpy(), "row_iterations": it2,
                "row_rounds": cg2, "oned_errors": errs1.numpy(),
                "oned_iterations": it1, "oned_rounds": cg1})
    for i, (a1, a2) in enumerate(zip(st1, st2)):
        out[f"row_state{i}"] = a2.numpy()
        out[f"oned_state{i}"] = a1.numpy()
    out["traffic"] = repr(sorted(rec.calls.items()))
    out["replica_group"] = repr(tuple(dist.get_process_group_ranks(
        mesh2.get_group(0))))
    out["blocks_group"] = repr(tuple(dist.get_process_group_ranks(
        mesh2.get_group(1))))
    return out


def spawn(suite, worlds, directory, inp_path):
    """Start every rank of each world of ``worlds`` on ``suite``."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for world in worlds:
        store = pathlib.Path(directory) / f"store_{suite}_{world}"
        procs += [subprocess.Popen(
            [sys.executable, __file__, suite, str(rank), str(world),
             str(store), str(inp_path), str(directory)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(world)]
    return procs


def collect(procs, suite, worlds, directory, timeout=300):
    """Wait for the ranks (killing them on a failure) and load what each
    wrote: {(world, rank): outputs}."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(logs))
    return {(w, r): dict(np.load(pathlib.Path(directory)
                                 / f"out_{suite}_{w}_{r}.npz"))
            for w in worlds for r in range(w)}


def bench_rows():
    """The port's block-scaling and sharded-PF benchmark rows at small
    sizes on the initialized gloo group (rank 0 has the scaling rows)."""
    rows = []
    benchmarks.bench_block_scaling(rows, devices=(1, 2, 4), base_poses=48,
                                   iters=2, device="cpu")
    benchmarks.bench_pf_sharded(rows, num_particles=1024, steps=2,
                                device="cpu")
    return rows


def _dryrun_suite(world, inp, out_dir):
    """``entry.dryrun_multichip`` on the group (it raises on a failed
    check), then the benchmark rows."""
    dryrun_multichip(world, device="cpu")
    return {"rows": json.dumps(bench_rows())}


SUITES = {"step": _step_suite, "optimize": _optimize_suite,
          "replicas": _replicas_suite, "dryrun": _dryrun_suite}


def main(suite, rank, world, store, inp_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        inp = dict(np.load(inp_path))
        out = SUITES[suite](world, inp, out_dir)
        np.savez(pathlib.Path(out_dir) / f"out_{suite}_{world}_{rank}.npz",
                 **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5], sys.argv[6])
