"""One rank of the port's distributed tier on a gloo process group, for
``tests/test_torch_parallel.py``. It holds no tests and imports nothing
of JAX: the parent runs JAX, writes the inputs, starts every rank of a
world as

    python tests/test_torch_parallel_worker.py RANK WORLD STORE IN OUT

(STORE a file for the group's ``file://`` store, IN the inputs' .npz,
OUT a directory) and compares what the ranks write there.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rustrobotics_tpu_torch.localization.pf import ParticleFilter  # noqa: E402
from rustrobotics_tpu_torch.mapping.g2o import (  # noqa: E402
    FLOAT_FIELDS,
    INDEX_FIELDS,
    graph_from_numpy,
)
from rustrobotics_tpu_torch.models.measurement import (  # noqa: E402
    SimpleProblemMeasurementModel,
)
from rustrobotics_tpu_torch.models.motion import (  # noqa: E402
    SimpleProblemMotionModel,
)
from rustrobotics_tpu_torch.parallel import (  # noqa: E402
    distributed_gn_step,
    distributed_global_error,
    distributed_optimize,
    make_mesh,
    make_mesh_2d,
)
from rustrobotics_tpu_torch.parallel.pf_sharded import (  # noqa: E402
    make_sharded_pf_step,
    make_sharded_pf_step_bounded,
)

PGO_ITERATIONS = 4


def _mesh_checks(world):
    """The mesh helpers' errors and the 2-D layout."""
    out = {}
    try:
        make_mesh(world + 1, device_type="cpu")
    except ValueError as e:
        out["too_many"] = str(e)
    try:
        make_mesh(device_type="cuda")
    except (RuntimeError, ValueError) as e:
        out["cuda"] = str(e)
    if world == 4:
        m2 = make_mesh_2d(2, 2, device_type="cpu")
        out["mesh_2d"] = m2.mesh.numpy()
        out["mesh_2d_names"] = ",".join(m2.mesh_dim_names)
    return out


def _pgo(mesh, inp, prefix="", solvers=("gauss_newton",
                                         "levenberg_marquardt")):
    """The sharded GN/LM traces of the graph stored under ``prefix``, and
    for the 2D graph a damped step and the global error."""
    fields = {k: inp[prefix + k] for k in FLOAT_FIELDS + INDEX_FIELDS}
    graph = graph_from_numpy(fields, int(inp[prefix + "total_dof"]),
                             int(inp[prefix + "prior2"]),
                             int(inp[prefix + "prior3"]), device="cpu")
    out = {}
    for solver in solvers:
        g, errors, norms = distributed_optimize(
            mesh, graph, num_iterations=PGO_ITERATIONS, solver=solver,
            tolerance=0.0)
        out[f"{prefix}{solver}_errors"] = np.asarray(errors)
        out[f"{prefix}{solver}_norms"] = np.asarray(norms)
        for field in ("poses2", "landmarks2", "poses3"):
            out[f"{prefix}{solver}_{field}"] = getattr(g, field).numpy()
    if not prefix:
        dx, chi2 = distributed_gn_step(mesh, graph, lam=0.01)
        out["step_dx"] = dx.numpy()
        out["step_chi2"] = float(chi2)
        out["error"] = float(distributed_global_error(mesh, graph))
    return out


def _pf(mesh, inp, rank, world):
    out = {}
    for case in ("balanced", "skewed"):
        pf = ParticleFilter(
            r=torch.as_tensor(inp[f"{case}_r"]),
            q=torch.as_tensor(inp[f"{case}_q"]),
            motion_model=SimpleProblemMotionModel.create(),
            measurement_model=SimpleProblemMeasurementModel.create(),
            resampling="systematic")
        n = inp[f"{case}_particles"].shape[0]
        n_local = n // world
        shard = torch.as_tensor(
            inp[f"{case}_particles"][rank * n_local:(rank + 1) * n_local])
        args = (torch.as_tensor(inp[f"{case}_noise"][rank]),
                torch.as_tensor(inp[f"{case}_u0"]), shard,
                torch.as_tensor(inp[f"{case}_u"]),
                torch.as_tensor(inp[f"{case}_z"]), float(inp[f"{case}_dt"]))
        out[f"{case}_gather"] = make_sharded_pf_step(mesh, pf, n)._step(
            *args).numpy()
        cloud, rounds = make_sharded_pf_step_bounded(mesh, pf, n)._step(*args)
        out[f"{case}_bounded"] = cloud.numpy()
        out[f"{case}_rounds"] = rounds
    return out


def main(rank, world, store, inp_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(device_type="cpu")
        inp = dict(np.load(inp_path))
        out = _mesh_checks(world)
        out.update(_pgo(mesh, inp))
        out.update(_pgo(mesh, inp, "se3_", ("gauss_newton",)))
        if "balanced_noise" in inp and inp["balanced_noise"].shape[0] == world:
            out.update(_pf(mesh, inp, rank, world))
        np.savez(pathlib.Path(out_dir) / f"out_{world}_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
