"""The port's mixed-precision banded solve (``solvers.make_banded_mixed``)
against the JAX package and the host solve, f64 on the CPU: both
low-precision modes (``high``: the factorization at full precision, with
the smaller lift; ``bf16``: the band truncated to bfloat16), their CG
round counts, the fleet's batch axis, and the
``banded-mixed`` backend on every driver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import assemble as jasm
from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping import solvers as jsol
from rustrobotics_tpu.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu_torch.mapping import assemble as tasm
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping import solvers as tsol
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    batch_from_numpy,
    graph_from_numpy,
)
from rustrobotics_tpu_torch.ops import band_chol as tbc

ITERS = 3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small-matrix tests: the suite runs
    several workers on one machine, and more threads oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_port(ref):
    fields = {n: np.asarray(getattr(ref, n)) for n in FLOAT_FIELDS + INDEX_FIELDS}
    return graph_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                            device="cpu")


def system(num_poses, closure_span=16):
    ref = synthetic_corridor_graph_2d(num_poses=num_poses,
                                      closure_span=closure_span)
    port = to_port(ref)
    jl, tl = jasm.build_layout(ref), tasm.build_layout(port)
    jv, jb, _ = jax.jit(jasm.system_values)(ref, jnp.float64(0.0))
    tv, tb, _ = tasm.system_values(port, 0.0)
    return jl, tl, jv, jb, tv, tb


@pytest.mark.parametrize("lp", ["high", "bf16"])
@pytest.mark.parametrize("num_poses", [96, 523])
def test_mixed_matches_host_and_jax(num_poses, lp):
    """dx within 1e-7 of max|x| from the host solve (the JAX test's
    bound), and CG rounds equal to JAX's within ±1."""
    jl, tl, jv, jb, tv, tb = system(num_poses)
    x, rounds = tsol.make_banded_mixed(tl, lp=lp, return_rounds=True,
                                       device="cpu")(tv, tb)
    assert isinstance(rounds, int) and 0 < rounds < 256
    ref = tsol.solve_host(tl, tv, tb).numpy()
    assert np.abs(x.numpy() - ref).max() / np.abs(ref).max() < 1e-7
    x_j, rounds_j = jax.jit(jsol.make_banded_mixed(
        jl, lp=lp, return_rounds=True))(jv, jb)
    assert abs(rounds - int(rounds_j)) <= 1, (rounds, int(rounds_j))
    x_j = np.asarray(x_j)
    assert np.abs(x.numpy() - x_j).max() / np.abs(x_j).max() < 1e-7


def test_mixed_fleet_rows():
    """A fleet of two (a corridor and a jittered copy): each row's rounds
    and x equal the one-graph solve on that row (x within 1e-9 of
    max|x|)."""
    port = to_port(synthetic_corridor_graph_2d(num_poses=96, closure_span=16))
    poses = port.poses2.numpy()
    fleet = tpgo.stack_graphs([port, port.replace(poses2=torch.as_tensor(
        poses + np.random.default_rng(0).normal(0.0, 0.1, poses.shape)))])
    vals, b, _ = tasm.system_values(fleet, 0.0)
    solve = tsol.make_banded_mixed(tasm.build_layout(port),
                                   return_rounds=True, device="cpu")
    x, rounds = solve(vals, b)
    assert x.shape == b.shape and rounds.shape == (2,)
    for i in range(2):
        x_i, rounds_i = solve(vals[i], b[i])
        assert rounds_i == int(rounds[i])
        assert (x[i] - x_i).abs().max() / x_i.abs().max() < 1e-9


def test_factor_runs_without_tf32(monkeypatch):
    """Both modes factor with TF32 off: on the card TF32 broke the lifted
    factor of lp="high" (NaN), so "high" factors at full f32, as the JAX
    package's HIGH precision does off the TPU. An unknown mode raises."""
    _, tl, _, _, tv, tb = system(96)
    seen = []
    factorize = tbc.cr_factorize

    def recording(r):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return factorize(r)

    monkeypatch.setattr(tbc, "cr_factorize", recording)
    for lp in ("high", "bf16"):
        tsol.make_banded_mixed(tl, lp=lp, device="cpu")(tv, tb)
    assert seen == [False, False]
    with pytest.raises(ValueError, match="lp"):
        tsol.make_banded_mixed(tl, lp="fp8", device="cpu")


@pytest.fixture(scope="module")
def graphs():
    ref = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=32)
    return ref, to_port(ref)


def assert_trace_close(got, want, rtol=1e-9, floor=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    sel = ~np.isnan(want) & (want > floor)
    assert sel.sum() >= 2
    np.testing.assert_allclose(got[sel], want[sel], rtol=rtol)


@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_make_optimize_banded_mixed_matches_jit(graphs, solver):
    ref, port = graphs
    g_ref, want, it_ref = jpgo.make_optimize_jit(
        ref, num_iterations=ITERS, solver=solver, backend="banded-mixed",
        tolerance=0.0)(ref)
    run = tpgo.make_optimize(port, num_iterations=ITERS, solver=solver,
                             backend="banded-mixed", tolerance=0.0,
                             device="cpu")
    g, errors, it = run(port)
    assert it == int(it_ref) == ITERS
    assert_trace_close(errors.numpy(), want)
    np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_ref.poses2),
                               atol=1e-8)


def test_host_optimize_banded_mixed_matches(graphs):
    ref, port = graphs
    want = jpgo.optimize(ref, num_iterations=ITERS, backend="banded-mixed",
                         tolerance=0.0)
    got = tpgo.optimize(port, num_iterations=ITERS, backend="banded-mixed",
                        tolerance=0.0, device="cpu")
    assert got.iterations == want.iterations == ITERS
    assert_trace_close(got.errors, want.errors)


def test_make_optimize_batch_banded_mixed_matches(graphs):
    """The fleet (the graph and a jittered copy) against JAX's
    make_optimize_batch, GN."""
    ref, _ = graphs
    poses = np.asarray(ref.poses2)
    refs = [ref, ref.replace(poses2=jnp.asarray(
        poses + np.random.default_rng(0).normal(0.0, 0.05, poses.shape)))]
    stacked = jpgo.stack_graphs(refs)
    fields = {n: np.asarray(getattr(stacked, n))
              for n in FLOAT_FIELDS + INDEX_FIELDS}
    fleet = batch_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                             device="cpu")
    kw = dict(num_iterations=ITERS, backend="banded-mixed", tolerance=0.0)
    g_j, want, it_j = jpgo.make_optimize_batch(refs[0], **kw)(stacked)
    g, errors, it = tpgo.make_optimize_batch(fleet, device="cpu", **kw)(fleet)
    assert it.tolist() == np.asarray(it_j).tolist() == [ITERS] * 2
    for i in range(2):
        assert_trace_close(errors[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_j.poses2),
                               atol=1e-8)
