"""The port's distributed tier (``rustrobotics_tpu_torch.parallel``) against
the JAX package's on the same inputs, f64.

JAX runs on a 4-device mesh of the virtual CPU devices (``conftest``). The
port runs as separate processes, one a rank, on gloo process groups over
a ``file://`` store in the test's directory (so parallel test workers do
not share ports), at world sizes 1, 2 and 4 for the sharded GN and at 4
for the sharded PF, whose draws are JAX's per-shard keys' draws replayed.
The ranks run ``tests/test_torch_parallel_worker.py``, which imports no
JAX; they start once for the module and run while JAX computes.

Tolerances: the χ² traces and norms within 1e-8 relative, dx and the
poses within 1e-8 of their largest entry (the
sums are the same up to their order across shards; the last iterations'
χ² sits at ~1e-2 of the first, well above rounding), the PF clouds
within 1e-12 and the ring rounds equal.
"""

import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustrobotics_tpu.localization.pf import ParticleFilter
from rustrobotics_tpu.mapping import g2o as jg2o
from rustrobotics_tpu.mapping.synthetic import synthetic_pose_graph_2d
from rustrobotics_tpu.models.measurement import SimpleProblemMeasurementModel
from rustrobotics_tpu.models.motion import SimpleProblemMotionModel
from rustrobotics_tpu.parallel.mesh import make_mesh
from rustrobotics_tpu.parallel.pf_sharded import (
    make_sharded_pf_step,
    make_sharded_pf_step_bounded,
)
from rustrobotics_tpu.parallel.pgo_sharded import (
    distributed_gn_step,
    distributed_global_error,
    distributed_optimize,
)
from rustrobotics_tpu_torch.mapping.g2o import FLOAT_FIELDS, INDEX_FIELDS

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).with_name("test_torch_parallel_worker.py")
WORLDS = (1, 2, 4)
JAX_DEVICES = 4
PGO_ITERATIONS = 4  # the worker's
RTOL = 1e-8
PF_TOL = 1e-12
SOLVERS = ("gauss_newton", "levenberg_marquardt")


def _graph():
    """A 24-pose circle with 3 landmarks whose measurements carry noise,
    so the converged χ² stays well above f64's rounding."""
    g = synthetic_pose_graph_2d(num_poses=24, num_landmarks=3, noise=0.1,
                                seed=0)
    rng = np.random.default_rng(5)
    pp_z = np.asarray(g.pp_z) + rng.normal(scale=0.05, size=g.pp_z.shape)
    pl_z = np.asarray(g.pl_z) + rng.normal(scale=0.05, size=g.pl_z.shape)
    return g.replace(pp_z=jnp.asarray(pp_z), pl_z=jnp.asarray(pl_z))


def _graph3(directory):
    """A 5 x 5 sphere of SE3 poses (chip_smoke.sphere_graph, as a g2o
    file), its measured translations given noise so that its χ² too stays
    well above rounding. Its 44 edges need no padding on a mesh of 1, 2
    or 4: a padded SE3 edge's zero quaternion makes JAX's sharded χ² NaN
    (a 4 x 6 sphere's 41 edges on 4 devices)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    path = directory / "sphere-25.g2o"
    path.write_text(cs.g2o_text(cs.sphere_graph(rings=5, per_ring=5,
                                                seed=2)))
    g = jg2o.load_g2o(str(path))
    qq_z = np.asarray(g.qq_z).copy()
    qq_z[:, :3] += np.random.default_rng(6).normal(scale=0.05,
                                                   size=(len(qq_z), 3))
    return g.replace(qq_z=jnp.asarray(qq_z))


def _pf_case(case):
    """Inputs of the two PF cases: test_sharded's balanced cloud and its
    skewed one (all the mass on the last shard)."""
    n = 1024
    if case == "balanced":
        particles = jax.random.normal(jax.random.key(0), (n, 4)) * 0.5
        return dict(r=np.eye(4) * 0.01, q=np.eye(2) * 0.1,
                    particles=np.asarray(particles), u=np.array([1.0, 0.1]),
                    z=np.array([0.12, 0.03]), dt=0.1, key=1)
    particles = np.concatenate([
        np.broadcast_to([50.0, 50.0, 0.0, 0.0], (n - n // 8, 4)),
        np.broadcast_to([0.1, 0.0, 0.0, 0.0], (n // 8, 4)),
    ])
    return dict(r=np.eye(4) * 1e-6, q=np.eye(2) * 0.01,
                particles=particles, u=np.zeros(2), z=np.array([0.1, 0.0]),
                dt=1e-3, key=3)


def _shard_draws(key, n_local):
    """JAX's draws inside the sharded step: each shard's standard normals
    from fold_in(key, shard), the shared u0 from key."""
    noise = []
    for shard in range(JAX_DEVICES):
        k_noise, _ = jax.random.split(jax.random.fold_in(key, shard))
        noise.append(np.asarray(jax.random.normal(k_noise, (n_local, 4),
                                                  dtype=jnp.float64)))
    return np.stack(noise), np.asarray(jax.random.uniform(
        key, (), dtype=jnp.float64))


def _jax_pf(mesh, case):
    c = _pf_case(case)
    pf = ParticleFilter(
        r=jnp.asarray(c["r"]), q=jnp.asarray(c["q"]),
        motion_model=SimpleProblemMotionModel.create(),
        measurement_model=SimpleProblemMeasurementModel.create(),
        resampling="systematic")
    n = c["particles"].shape[0]
    key = jax.random.key(c["key"])
    args = (key, jnp.asarray(c["particles"]), jnp.asarray(c["u"]),
            jnp.asarray(c["z"]), c["dt"])
    gather = np.asarray(make_sharded_pf_step(mesh, pf, n)(*args))
    bounded, rounds = make_sharded_pf_step_bounded(mesh, pf, n)(*args)
    noise, u0 = _shard_draws(key, n // JAX_DEVICES)
    inputs = {f"{case}_{k}": np.asarray(v) for k, v in c.items()
              if k != "key"}
    inputs.update({f"{case}_noise": noise, f"{case}_u0": u0})
    return inputs, dict(gather=gather, bounded=np.asarray(bounded),
                        rounds=int(rounds))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    graph = _graph()
    mesh = make_mesh(JAX_DEVICES)
    graph3 = _graph3(d)
    inputs = {}
    for prefix, g in (("", graph), ("se3_", graph3)):
        inputs.update({prefix + k: np.asarray(getattr(g, k))
                       for k in FLOAT_FIELDS + INDEX_FIELDS})
        inputs.update({prefix + "total_dof": g.total_dof,
                       prefix + "prior2": g.prior2,
                       prefix + "prior3": g.prior3})
    pf_ref = {}
    for case in ("balanced", "skewed"):
        case_inputs, pf_ref[case] = _jax_pf(mesh, case)
        inputs.update(case_inputs)
    np.savez(d / "in.npz", **inputs)

    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for world in WORLDS:
        store = d / f"store_{world}"
        procs += [subprocess.Popen(
            [sys.executable, str(WORKER), str(rank), str(world), str(store),
             str(d / "in.npz"), str(d)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(world)]
    try:
        ref = {}
        for solver in SOLVERS:
            g, errors, norms = distributed_optimize(
                mesh, graph, num_iterations=PGO_ITERATIONS, solver=solver,
                tolerance=0.0)
            ref[solver] = dict(errors=np.asarray(errors),
                               norms=np.asarray(norms),
                               poses2=np.asarray(g.poses2),
                               landmarks2=np.asarray(g.landmarks2))
        g, errors, norms = distributed_optimize(
            mesh, graph3, num_iterations=PGO_ITERATIONS, tolerance=0.0)
        ref["se3"] = dict(errors=np.asarray(errors), norms=np.asarray(norms),
                          poses3=np.asarray(g.poses3))
        dx, chi2 = distributed_gn_step(mesh, graph, lam=0.01)
        ref["step"] = dict(dx=np.asarray(dx), chi2=float(chi2))
        ref["error"] = float(distributed_global_error(mesh, graph))
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    port = {(w, r): dict(np.load(d / f"out_{w}_{r}.npz"))
            for w in WORLDS for r in range(w)}
    return ref, pf_ref, port


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _close_scaled(got, want):
    """Within RTOL of the largest entry: a coordinate near 0 (the prior
    pose's y, ~6e-15) keeps only rounding."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.max(np.abs(want)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_distributed_optimize_matches_jax(runs, solver, world):
    ref, _, port = runs
    want = ref[solver]
    assert want["errors"][-1] > 1e-2 * want["errors"][0]  # above rounding
    for rank in range(world):  # every rank holds the replicated result
        got = port[(world, rank)]
        _close(got[f"{solver}_errors"], want["errors"])
        _close(got[f"{solver}_norms"], want["norms"])
        _close_scaled(got[f"{solver}_poses2"], want["poses2"])
        _close_scaled(got[f"{solver}_landmarks2"], want["landmarks2"])


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_gn_se3_matches_jax(runs, world):
    ref, _, port = runs
    want = ref["se3"]
    assert want["errors"][-1] > 1e-2 * want["errors"][0]  # above rounding
    got = port[(world, 0)]
    _close(got["se3_gauss_newton_errors"], want["errors"])
    _close(got["se3_gauss_newton_norms"], want["norms"])
    _close_scaled(got["se3_gauss_newton_poses3"], want["poses3"])


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_gn_step_and_error_match_jax(runs, world):
    ref, _, port = runs
    got = port[(world, 0)]
    _close_scaled(got["step_dx"], ref["step"]["dx"])
    _close(got["step_chi2"], ref["step"]["chi2"])
    _close(got["error"], ref["error"])


@pytest.mark.parametrize("variant", ["gather", "bounded"])
@pytest.mark.parametrize("case", ["balanced", "skewed"])
def test_sharded_pf_matches_jax(runs, case, variant):
    _, pf_ref, port = runs
    world = 4
    got = np.concatenate([port[(world, r)][f"{case}_{variant}"]
                          for r in range(world)])
    np.testing.assert_allclose(got, pf_ref[case][variant], rtol=0,
                               atol=PF_TOL)
    if variant == "bounded":
        rounds = {int(port[(world, r)][f"{case}_rounds"])
                  for r in range(world)}
        assert rounds == {pf_ref[case]["rounds"]}
    if case == "skewed":  # every particle from the heavy region
        assert np.all(np.abs(got[:, 0] - 0.1) < 1.0)


def test_mesh_checks(runs):
    _, _, port = runs
    for world in WORLDS:
        got = port[(world, 0)]
        assert str(got["too_many"]) == (
            f"requested {world + 1} devices, have {world}")
        assert "CUDA" in str(got["cuda"]) or "nccl" in str(got["cuda"])
    got = port[(4, 0)]
    np.testing.assert_array_equal(got["mesh_2d"], [[0, 1], [2, 3]])
    assert str(got["mesh_2d_names"]) == "replica,blocks"


def test_worker_imports_no_jax():
    tree = ast.parse(WORKER.read_text())
    mods = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
            for a in node.names]
    mods += [node.module for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.module]
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                       "rustrobotics_tpu")]


def test_padded_se3_edges_nan_as_in_jax(tmp_path):
    """A reference behaviour kept: padding an SE3 edge family gives its
    zero-Ω edges a zero quaternion, which makes the χ² NaN (a 4 x 6
    sphere's 41 edges padded to 44) in both packages."""
    from rustrobotics_tpu_torch.mapping.triplets import graph_edge_triplets
    from rustrobotics_tpu_torch.parallel.pgo_sharded import (
        pad_edges_for_sharding,
    )

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    path = tmp_path / "sphere-24.g2o"
    path.write_text(cs.g2o_text(cs.sphere_graph(rings=4, per_ring=6,
                                                seed=2)))
    ref = jg2o.load_g2o(str(path))
    assert ref.qq_from.shape[0] % JAX_DEVICES
    assert np.isnan(float(distributed_global_error(make_mesh(JAX_DEVICES),
                                                   ref)))
    port = cs.port_graph(cs.sphere_graph(rings=4, per_ring=6, seed=2), "cpu")
    assert np.isfinite(float(graph_edge_triplets(port)[4]))
    padded = pad_edges_for_sharding(port, JAX_DEVICES)
    assert np.isnan(float(graph_edge_triplets(padded)[4]))
