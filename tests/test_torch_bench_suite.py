"""The port's benchmark suite (``rustrobotics_tpu_torch.benchmarks``)
against the JAX package's (``rustrobotics_tpu.benchmarks``) on the CPU.

Schema: every family runs in both packages at small arguments (``BATCH``
8 in both modules, the fixed-lag window 8 for 10 steps, the particle
filter 1024 particles for 3 steps, graph_slam and pgo_batch on a
96-pose corridor written as a g2o file under ``tmp_path``, batch 2,
graph_slam's backends banded-direct and dense, the fleet replay on a
short ``chip_smoke.write_utias`` dataset, bank 8, 50 events), each
``_bench`` cut to one timed call; the rows of the two packages have the
same metric names, units and key sets, in order. The port's sharded PF
and block-scaling rows run on a gloo group of one rank in this process
and are held to the keys the JAX rows have (JAX's functions are not run
here: their distributed compiles cost 5-19 s each; the four-rank rows
are in ``test_torch_entry.py``).

Workloads: each deterministic family's timed program, built by the
port's private function, is held to the JAX computation that JAX's
function times, in f64: the batched EKF/UKF chains (8 filters, 100
steps), the banked EKF/UKF (banks 128 and 64, 100 steps), the fixed-lag
smoother's poses (W 8, 10 steps), graph_slam's χ² traces (banded-direct
and dense, GN 10) and pgo_batch's unperturbed row 0 (its jittered row
draws its noise from a ``torch.Generator``, JAX's from a key, so only row
0 is the same computation). Tolerance 1e-9 relative to the largest entry.
The particle-filter rows are stochastic (torch generators against JAX
keys) and are checked for their schema and finite values only.
"""

import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_blocks_worker as W
from rustrobotics_tpu import benchmarks as jb
from rustrobotics_tpu_torch import benchmarks as pb

ROOT = pathlib.Path(__file__).resolve().parent.parent
GRAPH = "corridor96"
SMALL_BATCH = 8
RTOL = 1e-9
F64 = torch.float64


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A dataset root: g2o/corridor96.g2o and a short utias0/."""
    from rustrobotics_tpu_torch.mapping.synthetic import (
        synthetic_corridor_graph_2d,
    )

    d = tmp_path_factory.mktemp("bench_suite")
    cs = _chip_smoke()
    (d / "g2o").mkdir()
    graph = synthetic_corridor_graph_2d(96, num_landmarks=4,
                                        closure_span=32, device="cpu")
    (d / "g2o" / f"{GRAPH}.g2o").write_text(cs.g2o_text(cs.graph_spec(graph)))
    (d / "utias0").mkdir()
    cs.write_utias(d / "utias0", seed=0, duration=20.0)
    return d


def _families(root):
    """family -> call(module, rows, **device keyword)."""
    r = str(root)
    return {
        "filters": lambda m, rows, **kw: m.bench_filter_updates(rows, **kw),
        "fleet_replay": lambda m, rows, **kw: m.bench_fleet_replay(
            rows, bank=8, events=50, dataset_root=r, **kw),
        "pf_update": lambda m, rows, **kw: m.bench_pf_update(rows, **kw),
        "pf_scale": lambda m, rows, **kw: m.bench_pf_scale(rows, 1024, 3,
                                                           **kw),
        "fixed_lag": lambda m, rows, **kw: m.bench_fixed_lag(rows, 8, 10,
                                                             **kw),
        "graph_slam": lambda m, rows, **kw: m.bench_graph_slam(
            rows, dataset_root=r, graphs=(GRAPH,),
            backends=("banded-direct", "dense"), **kw),
        "pgo_batch": lambda m, rows, **kw: m.bench_pgo_batch(
            rows, dataset_root=r, graph=GRAPH, batch=2, **kw),
    }


def _one_call(module):
    """module._bench cut to one timed call (after its warm call)."""
    bench_out = module._bench_out
    return lambda fn, *args, repeats=20: bench_out(fn, *args, repeats=1)[0]


@pytest.fixture(scope="module")
def rows(root):
    """family -> (JAX rows, port rows)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for module in (jb, pb):
            mp.setattr(module, "BATCH", SMALL_BATCH)
            mp.setattr(module, "_bench", _one_call(module))
        for name, call in _families(root).items():
            jax_rows, port_rows = [], []
            call(jb, jax_rows)
            call(pb, port_rows, device="cpu")
            out[name] = (jax_rows, port_rows)
    return out


def _schema(rows):
    return [(r["metric"], r.get("unit"), sorted(r)) for r in rows]


def _finite(rows):
    for r in rows:
        for k, v in r.items():
            if isinstance(v, float):
                assert math.isfinite(v), (r["metric"], k, v)


@pytest.mark.parametrize("family", ["filters", "fleet_replay", "pf_update",
                                    "pf_scale", "fixed_lag", "graph_slam",
                                    "pgo_batch"])
def test_rows_match_jax_schema(rows, family):
    jax_rows, port_rows = rows[family]
    assert port_rows, family
    assert _schema(port_rows) == _schema(jax_rows)
    _finite(port_rows)
    # the rows round as JAX's do (3 decimals of Mupdates/s or
    # Gparticle-steps/s), which these tiny sizes can take to 0
    assert all(r["value"] >= 0 for r in port_rows)


def test_families_without_their_data_give_no_rows(tmp_path):
    rows = []
    pb.bench_fleet_replay(rows, dataset_root=str(tmp_path), device="cpu")
    pb.bench_graph_slam(rows, dataset_root=str(tmp_path), device="cpu")
    pb.bench_pgo_batch(rows, dataset_root=str(tmp_path), device="cpu")
    # without a process group the distributed families run nothing
    pb.bench_pf_sharded(rows, device="cpu")
    pb.bench_block_scaling(rows, device="cpu")
    assert rows == []


# the keys of the JAX package's rows (rustrobotics_tpu/benchmarks.py)
SHARDED_KEYS = ["metric", "note", "ring_hops", "unit", "value"]
SCALING_KEYS = ["cg_rounds_per_gn", "efficiency_pct", "metric", "note",
                "ppermute_kb_per_gn", "unit", "value"]
ROUND_KEYS = ["cg_rounds", "collective_overhead_us_vs_d1", "halo_dofs_h",
              "metric", "note", "ppermute_kb_per_round", "unit", "value"]


def distributed_schema(world):
    """The metric names, units and key sets the JAX package gives these
    rows at ``world`` devices (the sizes 1, 2, 4 up to ``world``)."""
    sizes = [d for d in (1, 2, 4) if d <= world]
    want = []
    for d in sizes:
        want.append((f"block_pgo_weak_scaling_d{d}", "ms/GN iter",
                     SCALING_KEYS))
        want.append((f"block_pgo_strong_scaling_d{d}", "ms/GN iter",
                     SCALING_KEYS))
    for d in sizes:
        keys = ROUND_KEYS + (["us_per_round_classic_2psum"]
                             if d == max(sizes) and d > 1 else [])
        want.append((f"block_pgo_cg_round_d{d}", "us/CG round",
                     sorted(keys)))
    want.append(("pf_sharded_1m_bounded_exchange", "Mparticle-steps/s",
                 SHARDED_KEYS))
    return want


def test_distributed_rows_match_jax_schema(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        rows = W.bench_rows()
    finally:
        dist.destroy_process_group()
    assert _schema(rows) == distributed_schema(1)
    _finite(rows)
    assert rows[-1]["ring_hops"] == 0
    assert "gloo group, world size 1" in rows[-1]["note"]


# --- the timed programs against the JAX computations, f64 ---------------

def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("kind", ["ekf", "ukf"])
def test_filter_chain_matches_jax(kind):
    from rustrobotics_tpu.utils.state import GaussianState

    jf = dict(zip(("ekf", "ukf"), jb._simple_problem_filters()))[kind]
    u, z = jnp.array([1.0, 0.1]), jnp.array([0.3, 0.2])
    b = SMALL_BATCH
    vstep = jax.vmap(jf.step, in_axes=(0, 0, 0, None))

    @jax.jit
    def chained(s):
        return jax.lax.scan(
            lambda c, _: (vstep(c, jnp.broadcast_to(u, (b, 2)),
                                jnp.broadcast_to(z, (b, 2)), pb.DT), None),
            s, None, length=pb.STEPS)[0]

    want = chained(GaussianState(x=jnp.zeros((b, 4)),
                                 cov=jnp.broadcast_to(jnp.eye(4), (b, 4, 4))))
    pf = dict(zip(("ekf", "ukf"),
                  pb._simple_problem_filters(F64, "cpu")))[kind]
    run, state0 = pb._filter_chain(pf, b, pb.STEPS, F64, "cpu")
    got = run(state0)
    _close(_np(got.x), want.x)
    _close(_np(got.cov), want.cov)


@pytest.mark.parametrize("kind", ["ekf", "ukf"])
def test_banked_chain_matches_jax(kind):
    from rustrobotics_tpu.localization import banked as jbanked
    from rustrobotics_tpu_torch.localization import banked as pbanked

    q = jnp.diag(jnp.array([0.1, 0.1, jnp.deg2rad(1.0), 1.0])) ** 2
    r = jnp.diag(jnp.array([1.0, 1.0])) ** 2
    bank = SMALL_BATCH * 16 if kind == "ekf" else SMALL_BATCH * 8
    if kind == "ekf":
        jf = jbanked.simple_problem_banked(q=q, r=r)
    else:
        jf = jbanked.simple_problem_banked_ukf(q=q, r=r, alpha=0.001,
                                               beta=2.0, kappa=0.0)
    ub = jnp.broadcast_to(jnp.array([1.0, 0.1])[:, None], (2, bank))
    zb = jnp.broadcast_to(jnp.array([0.3, 0.2])[:, None], (2, bank))

    @jax.jit
    def chained(x, cov):
        return jax.lax.scan(
            lambda c, _: (jf.step(c[0], c[1], ub, zb, pb.DT), None),
            (x, cov), None, length=pb.STEPS)[0]

    want = chained(jnp.zeros((4, bank)),
                   jnp.broadcast_to(jnp.eye(4)[:, :, None], (4, 4, bank)))
    qp, rp = pb._simple_problem_noise(F64, "cpu")
    if kind == "ekf":
        pf = pbanked.simple_problem_banked(q=qp, r=rp)
    else:
        pf = pbanked.simple_problem_banked_ukf(q=qp, r=rp, alpha=0.001,
                                               beta=2.0, kappa=0.0)
    run, args = pb._banked_chain(pf, bank, pb.STEPS, F64, "cpu")
    x, cov = run(*args)
    _close(_np(x), want[0])
    _close(_np(cov), want[1])


def test_fixed_lag_run_matches_jax():
    from rustrobotics_tpu.mapping.fixed_lag import FixedLagSmoother

    window, steps = 8, 10
    sig = np.array([0.05, 0.05, 0.02])
    fls = FixedLagSmoother.create(
        window=window, closure_capacity=16,
        chain_omega=jnp.diag(1.0 / jnp.asarray(sig ** 2)),
        clos_omega=jnp.eye(3) * 100.0,
    )
    odos = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.3]), (steps, 3))
    want = jax.jit(lambda s, o: jax.lax.scan(
        lambda c, u: (fls.advance(c, u), None), s, o)[0])(
        fls.init_state(jnp.zeros(3)), odos)
    run, (state0, podos) = pb._fixed_lag_run(window, steps, F64, "cpu")
    _close(_np(run(state0, podos).poses), want.poses)


def _graphs(root):
    from rustrobotics_tpu.mapping import load_g2o as jax_load
    from rustrobotics_tpu_torch.mapping import load_g2o

    path = str(root / "g2o" / f"{GRAPH}.g2o")
    return jax_load(path), load_g2o(path, dtype=F64, device="cpu")


@pytest.mark.parametrize("backend", ["banded-direct", "dense"])
def test_graph_slam_trace_matches_jax(root, backend):
    from rustrobotics_tpu.mapping.pgo import make_optimize_jit

    jg, pg = _graphs(root)
    want = make_optimize_jit(jg, num_iterations=10, backend=backend,
                             tolerance=0.0)(jg)[1]
    got = pb._graph_slam_run(pg, backend, 10, "cpu")(pg)[1]
    _close(_np(got), want)


def test_pgo_batch_row0_matches_jax(root):
    import dataclasses

    from rustrobotics_tpu.mapping.pgo import make_optimize_batch, stack_graphs

    jg, pg = _graphs(root)
    noise = 0.01 * jax.random.normal(jax.random.key(1), jg.poses2.shape,
                                     jg.poses2.dtype)
    fleet = stack_graphs([jg, dataclasses.replace(jg,
                                                  poses2=jg.poses2 + noise)])
    want = make_optimize_batch(jg, num_iterations=10, tolerance=0.0,
                               backend="banded-direct")(fleet)[1]
    run_b, batched, _, _ = pb._pgo_batch_runs(pg, 2, 10, "banded-direct",
                                              "cpu")
    got = run_b(batched)[1]
    _close(_np(got[0]), want[0])
