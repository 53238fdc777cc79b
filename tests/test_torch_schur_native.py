"""The port's Schur and native solvers against the JAX package, f64 on the
CPU: the layout's Schur maps, ``solvers.solve_schur`` (with a fleet's
batch axis and without landmarks), the port's own loader of the native
LDL^T solver (``ops/native_solver.py``, built into the package's
``_build/``) and ``solvers.solve_native``, ``solvers.SOLVERS`` and
``pgo.linearize_and_solve``, and the ``schur`` and ``native`` backends on
the drivers that take them.

The graph is a corridor with landmarks (n = 776: 768 pose dofs and 4
landmarks)."""

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
from rustrobotics_tpu_torch.ops import native_solver as tnat

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


@pytest.fixture(scope="module")
def case():
    ref = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=32)
    port = to_port(ref)
    return dict(ref=ref, port=port, jl=jasm.build_layout(ref),
                tl=tasm.build_layout(port))


def values(case, lam):
    jv, jb, _ = jax.jit(jasm.system_values)(case["ref"], jnp.float64(lam))
    tv, tb, _ = tasm.system_values(case["port"], lam)
    return jv, jb, tv, tb


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def test_schur_maps_identical(case):
    for name in ("dof_is_lm", "pose_dofs", "lm_dofs", "dof_compact"):
        np.testing.assert_array_equal(getattr(case["tl"], name),
                                      getattr(case["jl"], name), err_msg=name)
    assert case["tl"].lm_dofs.size == 8


@pytest.mark.parametrize("lam", [0.0, 0.01])
def test_solve_schur_matches(case, lam):
    """Against JAX's solve_schur and the host solve: 1e-9 of max|x|."""
    jv, jb, tv, tb = values(case, lam)
    x = tsol.solve_schur(case["tl"], tv, tb)
    assert x.shape == tb.shape and x.dtype == torch.float64
    want = jax.jit(lambda v, b: jsol.solve_schur(case["jl"], v, b))(jv, jb)
    assert rel_err(x.numpy(), want) < 1e-9
    assert rel_err(x.numpy(), tsol.solve_host(case["tl"], tv, tb).numpy()) \
        < 1e-9


def test_solve_schur_fleet_rows(case):
    port = case["port"]
    poses = port.poses2.numpy()
    fleet = tpgo.stack_graphs([port, port.replace(poses2=torch.as_tensor(
        poses + np.random.default_rng(0).normal(0.0, 0.05, poses.shape)))])
    vals, b, _ = tasm.system_values(fleet, 0.01)
    x = tsol.solve_schur(case["tl"], vals, b)
    assert x.shape == b.shape
    for i in range(2):
        assert rel_err(x[i].numpy(),
                       tsol.solve_schur(case["tl"], vals[i], b[i]).numpy()) \
            < 1e-12


def test_solve_schur_without_landmarks():
    """A landmark-free graph takes the dense solve, as in JAX."""
    port = to_port(synthetic_corridor_graph_2d(64, closure_span=8))
    layout = tasm.build_layout(port)
    assert layout.lm_dofs.size == 0
    vals, b, _ = tasm.system_values(port, 0.0)
    torch.testing.assert_close(tsol.solve_schur(layout, vals, b),
                               tsol.solve_dense(layout, vals, b), rtol=0,
                               atol=0)


# ------------------------------------------------------------- native


def test_native_builds_into_the_package():
    assert tnat.native_available()
    lib = tnat._build()
    assert lib.parent == tnat.BUILD_DIR
    assert lib.parent.parent.name == "rustrobotics_tpu_torch"
    assert tnat.SOURCE.name == "ldl_solver.cpp"


def test_native_random_spd_and_duplicates():
    """The JAX package's native tests: a random sparse SPD system, and
    duplicate triplets summed."""
    rng = np.random.default_rng(0)
    n = 200
    m = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.05)
    a = m.T @ m + n * np.eye(n)
    rows, cols = np.nonzero(a)
    b = rng.normal(size=n)
    x = tnat.solve_coo_native(n, rows, cols, a[rows, cols], b)
    np.testing.assert_allclose(a @ x, b, atol=1e-8)
    x = tnat.solve_coo_native(2, [0, 0, 1, 0, 1], [0, 0, 1, 1, 0],
                              [1.0, 1.0, 3.0, 0.5, 0.5], [1.0, 2.0])
    np.testing.assert_allclose(np.array([[2.0, 0.5], [0.5, 3.0]]) @ x,
                               [1.0, 2.0], atol=1e-12)


def test_native_rejects_bad_input():
    with pytest.raises(RuntimeError):
        tnat.solve_coo_native(2, [0], [0], [1.0], np.zeros(2))  # singular
    with pytest.raises(ValueError, match="indices"):
        tnat.solve_coo_native(2, [0, 2], [0, 2], [1.0, 1.0], np.zeros(2))
    with pytest.raises(ValueError, match="length"):
        tnat.solve_coo_native(2, [0, 1], [0], [1.0, 1.0], np.zeros(2))


@pytest.mark.parametrize("lam", [0.0, 0.01])
def test_solve_native_matches(case, lam):
    """Against JAX's solve_native (its own build of the same source) and
    the host solve: 1e-9 of max|x|; the result keeps vals' dtype."""
    jv, jb, tv, tb = values(case, lam)
    x = tsol.solve_native(case["tl"], tv, tb)
    assert x.dtype == torch.float64
    assert rel_err(x.numpy(), jsol.solve_native(case["jl"], jv, jb)) < 1e-9
    assert rel_err(x.numpy(), tsol.solve_host(case["tl"], tv, tb).numpy()) \
        < 1e-9
    x32 = tsol.solve_native(case["tl"], tv.float(), tb.float())
    assert x32.dtype == torch.float32


def test_no_native_takes_superlu(case, monkeypatch):
    """RUSTROBOTICS_NO_NATIVE: no library, and solve_native is the host
    solve."""
    _, _, tv, tb = values(case, 0.0)
    monkeypatch.setenv("RUSTROBOTICS_NO_NATIVE", "1")
    assert not tnat.native_available()
    calls = []
    host = tsol.solve_host
    monkeypatch.setattr(tsol, "solve_host",
                        lambda *a: (calls.append(1), host(*a))[1])
    x = tsol.solve_native(case["tl"], tv, tb)
    assert calls == [1]
    torch.testing.assert_close(x, host(case["tl"], tv, tb), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="unavailable"):
        tnat.solve_coo_native(1, [0], [0], [1.0], [1.0])


@pytest.mark.parametrize("backend", ["host", "native", "dense", "cg", "schur"])
def test_linearize_and_solve_matches(case, backend):
    """Every SOLVERS entry, one GN step's dx against JAX's (1e-8 of
    max|dx|: cg stops at its 1e-10 tolerance)."""
    assert sorted(tsol.SOLVERS) == sorted(jsol.SOLVERS)
    got = tpgo.linearize_and_solve(case["port"], backend=backend, device="cpu")
    want = jpgo.linearize_and_solve(case["ref"], backend=backend)
    assert rel_err(got.numpy(), want) < 1e-8


def assert_trace_close(got, want, rtol=1e-9, floor=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    sel = ~np.isnan(want) & (want > floor)
    assert sel.sum() >= 2
    np.testing.assert_allclose(got[sel], want[sel], rtol=rtol)


@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_make_optimize_schur_matches_jit(case, solver):
    ref, port = case["ref"], case["port"]
    g_ref, want, it_ref = jpgo.make_optimize_jit(
        ref, num_iterations=ITERS, solver=solver, backend="schur",
        tolerance=0.0)(ref)
    run = tpgo.make_optimize(port, num_iterations=ITERS, solver=solver,
                             backend="schur", tolerance=0.0, device="cpu")
    g, errors, it = run(port)
    assert it == int(it_ref) == ITERS
    assert_trace_close(errors.numpy(), want)
    np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_ref.poses2),
                               atol=1e-8)


@pytest.mark.parametrize("backend", ["native", "schur"])
def test_host_optimize_matches(case, backend):
    want = jpgo.optimize(case["ref"], num_iterations=ITERS, solver="lm",
                         backend=backend, tolerance=0.0)
    got = tpgo.optimize(case["port"], num_iterations=ITERS, solver="lm",
                        backend=backend, tolerance=0.0, device="cpu")
    assert got.backend == backend
    assert got.iterations == want.iterations == ITERS
    assert_trace_close(got.errors, want.errors)


def test_make_optimize_batch_schur_matches(case):
    ref = case["ref"]
    poses = np.asarray(ref.poses2)
    refs = [ref, ref.replace(poses2=jnp.asarray(
        poses + np.random.default_rng(0).normal(0.0, 0.05, poses.shape)))]
    stacked = jpgo.stack_graphs(refs)
    fields = {n: np.asarray(getattr(stacked, n))
              for n in FLOAT_FIELDS + INDEX_FIELDS}
    fleet = batch_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                             device="cpu")
    kw = dict(num_iterations=ITERS, backend="schur", tolerance=0.0)
    g_j, want, _ = jpgo.make_optimize_batch(refs[0], **kw)(stacked)
    g, errors, it = tpgo.make_optimize_batch(fleet, device="cpu", **kw)(fleet)
    assert it.tolist() == [ITERS] * 2
    for i in range(2):
        assert_trace_close(errors[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_j.poses2),
                               atol=1e-8)


def test_native_is_not_a_device_backend(case):
    """As make_optimize_jit: the device loops take no host solver."""
    for driver in (tpgo.make_optimize, tpgo.make_optimize_batch):
        with pytest.raises(ValueError, match="device backend, got 'native'"):
            driver(case["port"], backend="native", device="cpu")
