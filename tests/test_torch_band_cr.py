"""The port's block cyclic reduction against the JAX package, f64 on the
CPU: ``cr_factorize``, ``cr_substitute``, ``cr_invert`` and
``cr_substitute_inv`` on random SPD block-tridiagonal chains of every
small length (``tests/test_band_cr.py``'s chain), their batch axis,
``solve_band_cr`` on corridor graphs, and the ``banded-cr`` backend on
every driver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import assemble as jasm
from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu.ops import band_chol as jbc
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

ITERS = 4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small-matrix tests: the suite runs
    several workers on one machine, and more threads oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_chain(nb, kb=8, seed=None):
    """An SPD block-tridiagonal matrix as packed block rows (nb, kb, 2kb)
    ([subdiagonal | lower triangle of the diagonal block]), its dense
    form, and a right-hand side."""
    rng = np.random.default_rng(nb if seed is None else seed)
    n = nb * kb
    m = rng.standard_normal((n, n))
    a = m @ m.T + n * np.eye(n)
    for i in range(nb):
        for j in range(nb):
            if abs(i - j) > 1:
                a[i * kb:(i + 1) * kb, j * kb:(j + 1) * kb] = 0.0
    r = np.zeros((nb, kb, 2 * kb))
    for j in range(nb):
        if j > 0:
            r[j, :, :kb] = a[j * kb:(j + 1) * kb, (j - 1) * kb:j * kb]
        r[j, :, kb:] = np.tril(a[j * kb:(j + 1) * kb, j * kb:(j + 1) * kb])
    return r, a, rng.standard_normal(n)


@pytest.mark.parametrize("nb", [1, 2, 3, 5, 4, 6, 7, 9, 11, 13, 16])
def test_cr_every_chain_length(nb):
    """Native-length CR, odd and even m at every level: the factor's
    levels, the root factor, both substitutions and the inverse factors
    against JAX's (1e-12 of their scale), and the solves against numpy
    (rtol 1e-8, atol 1e-10, the JAX test's)."""
    r, a, b = random_chain(nb)
    kb = r.shape[1]
    x_ref = np.linalg.solve(a, b)
    levels, f_root = tbc.cr_factorize(torch.as_tensor(r))
    j_levels, j_root = jbc.cr_factorize(jnp.asarray(r))
    assert len(levels) == len(j_levels) == int(np.ceil(np.log2(nb)))
    for got, want in zip(levels, j_levels):
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-12 * np.abs(w).max())
    np.testing.assert_allclose(f_root.numpy(), np.asarray(j_root), rtol=0,
                               atol=1e-12 * float(np.abs(j_root).max()))
    bp = torch.as_tensor(b.reshape(nb, kb))
    x = tbc.cr_substitute(levels, f_root, bp).reshape(-1).numpy()
    np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-10)
    j_x = np.asarray(jbc.cr_substitute(j_levels, j_root, jnp.asarray(
        b.reshape(nb, kb)))).reshape(-1)
    np.testing.assert_allclose(x, j_x, rtol=1e-12, atol=1e-14)
    inv_levels, root_inv = tbc.cr_invert(levels, f_root)
    j_inv, j_rinv = jbc.cr_invert(j_levels, j_root)
    for got, want in zip(inv_levels, j_inv):
        w = np.asarray(want[0])
        np.testing.assert_allclose(got[0].numpy(), w, rtol=0,
                                   atol=1e-12 * np.abs(w).max())
    np.testing.assert_allclose(root_inv.numpy(), np.asarray(j_rinv), rtol=0,
                               atol=1e-12 * float(np.abs(j_rinv).max()))
    x2 = tbc.cr_substitute_inv(inv_levels, root_inv, bp).reshape(-1).numpy()
    np.testing.assert_allclose(x2, x_ref, rtol=1e-8, atol=1e-10)
    j_x2 = np.asarray(jbc.cr_substitute_inv(j_inv, j_rinv, jnp.asarray(
        b.reshape(nb, kb)))).reshape(-1)
    np.testing.assert_allclose(x2, j_x2, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("nb", [5, 6])
def test_cr_batch_axis(nb):
    """A (B, nb, kb, 2kb) stack factors and solves each chain as alone."""
    chains = [random_chain(nb, seed=s) for s in range(3)]
    r = torch.as_tensor(np.stack([c[0] for c in chains]))
    bp = torch.as_tensor(np.stack([c[2] for c in chains]).reshape(3, nb, 8))
    levels, f_root = tbc.cr_factorize(r)
    x = tbc.cr_substitute(levels, f_root, bp)
    inv_levels, root_inv = tbc.cr_invert(levels, f_root)
    x2 = tbc.cr_substitute_inv(inv_levels, root_inv, bp)
    assert x.shape == x2.shape == (3, nb, 8)
    for i, (_, a, b) in enumerate(chains):
        x_ref = np.linalg.solve(a, b)
        np.testing.assert_allclose(x[i].reshape(-1).numpy(), x_ref, rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(x2[i].reshape(-1).numpy(), x_ref,
                                   rtol=1e-8, atol=1e-10)


def to_port(ref):
    fields = {n: np.asarray(getattr(ref, n)) for n in FLOAT_FIELDS + INDEX_FIELDS}
    return graph_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                            device="cpu")


@pytest.mark.parametrize("num_poses", [7, 64, 523])
def test_solve_band_cr_matches(num_poses):
    """solve_band_cr on corridors of 1 to many block rows against JAX's
    and the port's chain and host solves (1e-9 of max|x|)."""
    ref = synthetic_corridor_graph_2d(num_poses=num_poses, closure_span=16)
    port = to_port(ref)
    jl, tl = jasm.build_layout(ref), tasm.build_layout(port)
    jbl = jbc.build_band_chol(jl)
    jv, jb, _ = jax.jit(jasm.system_values)(ref, jnp.float64(0.0))
    tv, tb, _ = tasm.system_values(port, 0.0)
    bl = tbc.build_band_chol(tl)
    x = tbc.solve_band_cr(bl, tv, tb).numpy()
    scale = np.abs(x).max()
    for want in (np.asarray(jax.jit(lambda v, b: jbc.solve_band_cr(
                     jbl, v, b))(jv, jb)),
                 tbc.solve_band_chol(bl, tv, tb).numpy(),
                 tsol.solve_host(tl, tv, tb).numpy()):
        assert np.abs(x - want).max() / scale < 1e-9
    solve = tsol.make_banded_cr(tl, device="cpu")
    np.testing.assert_array_equal(solve(tv, tb).numpy(), x)


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
def test_make_optimize_banded_cr_matches_jit(graphs, solver):
    ref, port = graphs
    g_ref, want, it_ref = jpgo.make_optimize_jit(
        ref, num_iterations=ITERS, solver=solver, backend="banded-cr",
        tolerance=0.0)(ref)
    run = tpgo.make_optimize(port, num_iterations=ITERS, solver=solver,
                             backend="banded-cr", tolerance=0.0, device="cpu")
    assert run.backend == "banded-cr"
    g, errors, it = run(port)
    assert it == int(it_ref) == ITERS
    assert_trace_close(errors.numpy(), want)
    np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_ref.poses2),
                               atol=1e-8)


def test_host_optimize_banded_cr_matches(graphs):
    ref, port = graphs
    want = jpgo.optimize(ref, num_iterations=ITERS, backend="banded-cr",
                         tolerance=0.0)
    got = tpgo.optimize(port, num_iterations=ITERS, backend="banded-cr",
                        tolerance=0.0, device="cpu")
    assert got.backend == "banded-cr"
    assert got.iterations == want.iterations == ITERS
    assert_trace_close(got.errors, want.errors)


def test_make_optimize_batch_banded_cr_matches(graphs):
    """The fleet (the graph and two jittered copies) against JAX's
    make_optimize_batch, LM with rows stopping at different iterations."""
    ref, _ = graphs
    rng = np.random.default_rng(0)
    poses = np.asarray(ref.poses2)
    refs = [ref] + [ref.replace(poses2=jnp.asarray(
        poses + rng.normal(0.0, s, poses.shape))) for s in (0.05, 0.2)]
    stacked = jpgo.stack_graphs(refs)
    fields = {n: np.asarray(getattr(stacked, n))
              for n in FLOAT_FIELDS + INDEX_FIELDS}
    fleet = batch_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                             device="cpu")
    kw = dict(num_iterations=ITERS, solver="lm", backend="banded-cr",
              tolerance=1.0)
    g_j, want, it_j = jpgo.make_optimize_batch(refs[0], **kw)(stacked)
    g, errors, it = tpgo.make_optimize_batch(fleet, device="cpu", **kw)(fleet)
    assert it.tolist() == np.asarray(it_j).tolist()
    assert len(set(it.tolist())) > 1, "rows should stop apart"
    for i in range(3):
        assert_trace_close(errors[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_j.poses2),
                               atol=1e-8)


def test_make_banded_cr_too_wide_returns_none(monkeypatch):
    """No band plan, no banded-cr solve; the drivers then go dense, as
    the JAX package's do."""
    monkeypatch.setattr(tbc, "build_band_chol", lambda *a, **k: None)
    ref = synthetic_corridor_graph_2d(32, closure_span=8)
    port = to_port(ref)
    assert tsol.make_banded_cr(tasm.build_layout(port), device="cpu") is None
    _, errors, _ = tpgo.make_optimize(port, num_iterations=2,
                                      backend="banded-cr", tolerance=0.0,
                                      device="cpu")(port)
    _, want, _ = tpgo.make_optimize(port, num_iterations=2, backend="dense",
                                    tolerance=0.0, device="cpu")(port)
    torch.testing.assert_close(errors, want, rtol=0, atol=0)
