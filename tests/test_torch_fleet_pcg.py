"""The fleet's batched PCG against the JAX package, f64 on the CPU: the
batch axis of the block-banded operator (the plain version of the CUDA
kernel K3), the ELL operator and the block-Jacobi preconditioner;
``solvers.pcg`` over a fleet (the JAX package's batched ``while_loop``: a
stop test and a round count a row); and ``make_optimize_batch`` with
``cg``, ``cg-banded`` and ``cg-banded-jnp`` against JAX's
``make_optimize_batch`` (``jax.vmap`` over ``make_optimize_jit``).

The fleet is a corridor whose band has half = 2 (n = 776, nb = 7 block
rows, kb = 5 block diagonals) and two copies with poses jittered by
N(0, 0.05²) and N(0, 0.2²) (numpy seed 0). Its rows stop their PCG at
different rounds, and at the tolerances below their GN/LM loops stop at
different iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import assemble as jasm
from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping import solvers as jsol
from rustrobotics_tpu.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu.ops import banded as jband
from rustrobotics_tpu_torch.mapping import assemble as tasm
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping import solvers as tsol
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    batch_from_numpy,
)
from rustrobotics_tpu_torch.ops import banded as tband
from rustrobotics_tpu_torch.ops import banded_kernels as tbk

ITERS = 4
TOLERANCE = {"gauss_newton": 3.0, "lm": 1.0}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small-matrix tests: the suite runs
    several workers on one machine, and more threads oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    ref = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=96)
    rng = np.random.default_rng(0)
    poses = np.asarray(ref.poses2)
    refs = [ref] + [ref.replace(poses2=jnp.asarray(
        poses + rng.normal(0.0, s, poses.shape))) for s in (0.05, 0.2)]
    stacked = jpgo.stack_graphs(refs)
    fields = {n: np.asarray(getattr(stacked, n))
              for n in FLOAT_FIELDS + INDEX_FIELDS}
    fleet = batch_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                             device="cpu")
    jl, tl = jasm.build_layout(ref), tasm.build_layout(fleet)
    jv, jb, _ = jax.jit(jax.vmap(jasm.system_values, in_axes=(0, None)))(
        stacked, jnp.asarray(0.0))
    tv, tb, _ = tasm.system_values(fleet, 0.0)
    return dict(refs=refs, stacked=stacked, fleet=fleet, jl=jl, tl=tl,
                jband=jband.build_banded(jl), tband=tband.build_banded(tl),
                jv=jv, jb=jb, tv=tv, tb=tb)


def rel_close(got, want, rtol):
    """|got - want| <= rtol * max|want|, elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_banded_matvec_plain_batched_matches_rows(case):
    """The fleet's band (B, nb, kb, 128, 128) and its SpMV against each
    graph's own; the K3 wrapper takes the plain version for CPU tensors,
    a fleet included, and counts no launch."""
    tb, tl = case["tband"], case["tl"]
    hb = tband.band_values(tb, tl, case["tv"])
    assert hb.shape == (3, tb.nb, tb.kb, 128, 128)
    xp = torch.as_tensor(np.random.default_rng(1).normal(
        size=(3, tb.nb + tb.kb - 1, 128)))
    y = tband.banded_matvec_plain(hb, xp)
    assert y.shape == (3, tb.nb * 128)
    for i in range(3):
        hb_i = tband.band_values(tb, tl, case["tv"][i])
        assert torch.equal(hb[i], hb_i)
        rel_close(y[i].numpy(), tband.banded_matvec_plain(hb_i, xp[i]).numpy(),
                  1e-13)
        want = jband.banded_matvec_jnp(case["jband"], jnp.asarray(hb_i.numpy()),
                                       jnp.asarray(xp[i].numpy()))
        rel_close(y[i].numpy(), np.asarray(want), 1e-12)
    before = tbk.LAUNCHES["banded_matvec"]
    assert torch.equal(tbk.banded_matvec_kernel(hb, xp), y)
    assert tbk.LAUNCHES["banded_matvec"] == before


@pytest.mark.parametrize("kind", ["banded", "ell", "block_jacobi"])
def test_batched_operators_match_jax(case, kind):
    """The dof-space operators and the preconditioner over the fleet,
    row by row against JAX's (rtol 1e-12; 1e-10 for the inverted 6x6
    blocks, whose gauge-prior block has condition ~1e7)."""
    x = np.random.default_rng(2).normal(size=(3, case["tl"].n))
    make = {"banded": lambda lay, bl, v: tband.make_banded_matvec(bl, lay, v),
            "ell": lambda lay, bl, v: tsol.make_ell_matvec(lay, v),
            "block_jacobi": lambda lay, bl, v: tsol.make_block_jacobi(lay, v)}
    jmake = {"banded": lambda lay, bl, v: jband.make_banded_matvec(
                 bl, lay, v, use_pallas=False),
             "ell": lambda lay, bl, v: jsol.make_ell_matvec(lay, v),
             "block_jacobi": lambda lay, bl, v: jsol.make_block_jacobi(lay, v)}
    got = make[kind](case["tl"], case["tband"], case["tv"])(torch.as_tensor(x))
    assert got.shape == x.shape
    for i in range(3):
        want = jmake[kind](case["jl"], case["jband"], case["jv"][i])(
            jnp.asarray(x[i]))
        rel_close(got[i].numpy(), np.asarray(want),
                  1e-10 if kind == "block_jacobi" else 1e-12)


def _fleet_ops(case):
    tl, tv = case["tl"], case["tv"]
    return (tband.make_banded_matvec(case["tband"], tl, tv),
            tsol.make_block_jacobi(tl, tv))


def test_pcg_rows_match_jax_vmap(case):
    """Each row's round count equals JAX's vmapped ``_pcg_counted`` and
    the port's one-graph pcg on that row; the rows stop at different
    rounds; x within 1e-10 of max|x|."""
    tol, maxiter = 1e-10, 2000
    matvec, precond = _fleet_ops(case)
    x, rounds = tsol.pcg(matvec, precond, case["tb"], tol, maxiter)
    assert rounds.shape == (3,) and rounds.dtype == torch.long
    assert len(set(rounds.tolist())) > 1, "rows should stop apart"

    def one(v, b):
        mv = jband.make_banded_matvec(case["jband"], case["jl"], v,
                                      use_pallas=False)
        return jsol._pcg_counted(mv, jsol.make_block_jacobi(case["jl"], v), b,
                                 tol, maxiter)

    x_j, rounds_j = jax.vmap(one)(case["jv"], case["jb"])
    assert rounds.tolist() == np.asarray(rounds_j).tolist()
    for i in range(3):
        rel_close(x[i].numpy(), np.asarray(x_j[i]), 1e-10)
        mv_i = tband.make_banded_matvec(case["tband"], case["tl"],
                                        case["tv"][i])
        pc_i = tsol.make_block_jacobi(case["tl"], case["tv"][i])
        x_i, rounds_i = tsol.pcg(mv_i, pc_i, case["tb"][i], tol, maxiter)
        assert isinstance(rounds_i, int) and rounds_i == int(rounds[i])
        rel_close(x[i].numpy(), x_i.numpy(), 1e-10)


def test_pcg_maxiter_and_a_stopped_row(case):
    """maxiter caps every row; a row whose right-hand side is 0 never runs
    (its test fails at once), stays 0, and its pᵀAp = 0 (a NaN step) never
    reaches the live rows."""
    matvec, precond = _fleet_ops(case)
    b = case["tb"].clone()
    b[1] = 0.0
    x, rounds = tsol.pcg(matvec, precond, b, 1e-10, 37)
    assert rounds.tolist() == [37, 0, 37]
    assert torch.isfinite(x).all() and torch.equal(x[1], torch.zeros_like(x[1]))
    x_live, _ = tsol.pcg(matvec, precond, case["tb"], 1e-10, 37)
    for i in (0, 2):
        rel_close(x[i].numpy(), x_live[i].numpy(), 1e-12)


_JAX_RUNS = {}


def jax_batch(case, backend, solver):
    key = (backend, solver)
    if key not in _JAX_RUNS:
        run = jpgo.make_optimize_batch(case["refs"][0], num_iterations=ITERS,
                                       solver=solver, backend=backend,
                                       tolerance=TOLERANCE[solver])
        g, errors, it = run(case["stacked"])
        _JAX_RUNS[key] = (np.asarray(g.poses2), np.asarray(errors),
                          np.asarray(it))
    return _JAX_RUNS[key]


@pytest.mark.parametrize("backend,jax_backend", [
    ("cg", "cg"), ("cg-banded", "cg-banded-jnp"),
    ("cg-banded-jnp", "cg-banded-jnp")])
@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_make_optimize_batch_cg_matches_jax(case, monkeypatch, backend,
                                            jax_backend, solver):
    """cg_tol 1e-10 and cg_maxiter None (JAX's defaults). Same iteration
    count a row, rows stopping at different iterations and their PCGs at
    different rounds; χ² entries above 1e-6 within 1e-9, poses within
    1e-8."""
    pcg, rounds = tsol.pcg, []

    def recording(*args, **kwargs):
        x, k = pcg(*args, **kwargs)
        rounds.append(k.tolist())
        return x, k

    monkeypatch.setattr(tsol, "pcg", recording)
    run = tpgo.make_optimize_batch(case["fleet"], num_iterations=ITERS,
                                   solver=solver, backend=backend,
                                   tolerance=TOLERANCE[solver], device="cpu")
    assert run.backend == backend
    g, errors, it = run(case["fleet"])
    poses_j, errors_j, it_j = jax_batch(case, jax_backend, solver)
    assert it.tolist() == it_j.tolist()
    assert len(set(it.tolist())) > 1, "rows should stop apart"
    assert any(len(set(r)) > 1 for r in rounds), "PCG rows should stop apart"
    got = errors.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(errors_j))
    sel = ~np.isnan(errors_j) & (errors_j > 1e-6)
    np.testing.assert_allclose(got[sel], errors_j[sel], rtol=1e-9)
    np.testing.assert_allclose(g.poses2.numpy(), poses_j, atol=1e-8, rtol=0)
