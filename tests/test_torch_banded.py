"""The port's CG backends against the JAX package, f64 on the CPU: the
block-banded layout and SpMV (the plain version of the CUDA kernel K3),
the ELL operator, the block-Jacobi preconditioner, the PCG and both
drivers with ``cg`` and ``cg-banded``.

The graph is a corridor whose band has half = 2 (n = 776, nb = 7 block
rows of 128, kb = 5 block diagonals), so every block row sees more than
its neighbours and the Pallas kernel in interpret mode stays small."""

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
    graph_from_numpy,
)
from rustrobotics_tpu_torch.ops import banded as tband
from rustrobotics_tpu_torch.ops import banded_kernels as tbk

ITERS = 4


@pytest.fixture(scope="module")
def case():
    ref = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=96)
    fields = {n: np.asarray(getattr(ref, n)) for n in FLOAT_FIELDS + INDEX_FIELDS}
    port = graph_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                            device="cpu")
    jl, tl = jasm.build_layout(ref), tasm.build_layout(port)
    return dict(ref=ref, port=port, jl=jl, tl=tl,
                jb=jband.build_banded(jl), tb=tband.build_banded(tl))


def values(case, lam):
    jv, jb, _ = jasm.system_values(case["ref"], jnp.asarray(lam))
    tv, tb, _ = tasm.system_values(case["port"], lam)
    return jv, jb, tv, tb


def rel_close(got, want, rtol):
    """|got - want| <= rtol * max|want|, elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_build_banded_identical(case):
    jb, tb = case["jb"], case["tb"]
    assert (tb.n, tb.nb, tb.half, tb.kb) == (jb.n, jb.nb, jb.half, jb.kb)
    assert tb.half == 2
    for name in ("perm", "inv_perm", "ell_to_block"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      err_msg=name)
    moved = tb.to("cpu")
    assert moved.perm.dtype == torch.int64
    np.testing.assert_array_equal(moved.ell_to_block.numpy(), jb.ell_to_block)


@pytest.mark.parametrize("lam", [0.0, 0.37])
def test_band_values_match(case, lam):
    """Equal up to the order of the duplicate sums: 1e-14 of max|H| (the
    1e7 gauge prior)."""
    jv, _, tv, _ = values(case, lam)
    want = np.asarray(jband.band_values(case["jb"], case["jl"], jv))
    got = tband.band_values(case["tb"], case["tl"], tv)
    assert got.shape == want.shape
    rel_close(got.numpy(), want, 1e-14)


def test_pad_x_blocks_matches(case):
    x = np.random.default_rng(0).normal(size=case["tb"].n)
    want = np.asarray(jband._pad_x_blocks(case["jb"], jnp.asarray(x)))
    got = tband._pad_x_blocks(case["tb"], torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def band_system(case):
    jv, _, tv, _ = values(case, 0.0)
    hb = np.array(jband.band_values(case["jb"], case["jl"], jv))
    xp = np.random.default_rng(1).normal(
        size=(case["jb"].nb + 2 * case["jb"].half, jband.LANE))
    return hb, xp


def test_banded_matvec_plain_matches_jnp(case, band_system):
    """Only the summation order differs: rtol 1e-12 of max|y|."""
    hb, xp = band_system
    want = np.asarray(jband.banded_matvec_jnp(case["jb"], jnp.asarray(hb),
                                              jnp.asarray(xp)))
    got = tband.banded_matvec_plain(torch.as_tensor(hb), torch.as_tensor(xp))
    rel_close(got.numpy(), want, 1e-12)


def test_banded_matvec_plain_matches_pallas_interpret(case, band_system):
    """The TPU kernel's program in interpret mode (nb = 7 <= 8: one grid
    step), rtol 1e-12 of max|y|."""
    hb, xp = band_system
    want = np.asarray(jband.banded_matvec_pallas(
        case["jb"], jnp.asarray(hb), jnp.asarray(xp), interpret=True))
    got = tband.banded_matvec_plain(torch.as_tensor(hb), torch.as_tensor(xp))
    rel_close(got.numpy(), want, 1e-12)


def test_kernel_wrapper_takes_plain_on_cpu(band_system):
    hb, xp = (torch.as_tensor(a) for a in band_system)
    before = tbk.LAUNCHES["banded_matvec"]
    got = tbk.banded_matvec_kernel(hb, xp)
    assert torch.equal(got, tband.banded_matvec_plain(hb, xp))
    assert tbk.LAUNCHES["banded_matvec"] == before


@pytest.mark.parametrize("kind", ["banded", "ell"])
def test_matvec_matches(case, kind):
    """The dof-space operators, rtol 1e-12 of max|y|."""
    jv, _, tv, _ = values(case, 0.0)
    x = np.random.default_rng(2).normal(size=case["tl"].n)
    if kind == "banded":
        want = jband.make_banded_matvec(case["jb"], case["jl"], jv,
                                        use_pallas=False)(jnp.asarray(x))
        got = tband.make_banded_matvec(case["tb"], case["tl"], tv)(
            torch.as_tensor(x))
    else:
        want = jsol.make_ell_matvec(case["jl"], jv)(jnp.asarray(x))
        got = tsol.make_ell_matvec(case["tl"], tv)(torch.as_tensor(x))
    rel_close(got.numpy(), np.asarray(want), 1e-12)


def test_ell_values_match(case):
    jv, _, tv, _ = values(case, 0.37)
    want = np.asarray(jsol.ell_values(case["jl"], jv))
    rel_close(tsol.ell_values(case["tl"], tv).numpy(), want, 1e-14)


@pytest.mark.parametrize("lam", [0.0, 0.01])
def test_block_jacobi_matches(case, lam):
    """The inverted 6x6 blocks applied to a vector, rtol 1e-10: the gauge
    prior's block has condition ~1e7, so inversion alone amplifies the
    last-bit differences of the two frameworks' inverses."""
    jv, _, tv, _ = values(case, lam)
    r = np.random.default_rng(3).normal(size=case["tl"].n)
    want = np.asarray(jsol.make_block_jacobi(case["jl"], jv)(jnp.asarray(r)))
    got = tsol.make_block_jacobi(case["tl"], tv)(torch.as_tensor(r))
    rel_close(got.numpy(), want, 1e-10)


def _operators(case, lam):
    jv, jbv, tv, tbv = values(case, lam)
    j_ops = (jband.make_banded_matvec(case["jb"], case["jl"], jv,
                                      use_pallas=False),
             jsol.make_block_jacobi(case["jl"], jv), jbv)
    t_ops = (tband.make_banded_matvec(case["tb"], case["tl"], tv),
             tsol.make_block_jacobi(case["tl"], tv), tbv)
    return j_ops, t_ops


@pytest.mark.parametrize("lam,tol,maxiter", [
    (0.0, 1e-10, 2000), (0.01, 1e-10, 2000), (0.01, 1e-12, 37)])
def test_pcg_matches_pcg_counted(case, lam, tol, maxiter):
    """Same round count, whether the loop ends on the tolerance or on
    maxiter; x within 1e-10 of max|x| (each round's dot products sum in
    another order)."""
    (jmv, jpc, jbv), (tmv, tpc, tbv) = _operators(case, lam)
    x_ref, rounds_ref = jsol._pcg_counted(jmv, jpc, jbv, tol, maxiter)
    x, rounds = tsol.pcg(tmv, tpc, tbv, tol, maxiter)
    assert rounds == int(rounds_ref)
    if maxiter == 37:
        assert rounds == 37
    else:
        assert 100 < rounds < maxiter
    rel_close(x.numpy(), np.asarray(x_ref), 1e-10)


def test_solve_cg_matches(case):
    """The ELL backend at its defaults (tol 1e-10, 4·n rounds): x within
    1e-9 of max|x|."""
    jv, jbv, tv, tbv = values(case, 0.0)
    want = np.asarray(jsol.solve_cg(case["jl"], jv, jbv))
    rel_close(tsol.solve_cg(case["tl"], tv, tbv).numpy(), want, 1e-9)


def test_solve_cg_banded_matches(case):
    """At its defaults (tol 1e-6, 400 rounds): x within 1e-9 of max|x|."""
    jv, jbv, tv, tbv = values(case, 0.01)
    want = np.asarray(jsol.solve_cg_banded(case["jl"], case["jb"], jv, jbv,
                                           use_pallas=False))
    got = tsol.solve_cg_banded(case["tl"], case["tb"], tv, tbv)
    rel_close(got.numpy(), want, 1e-9)


_JAX_RUNS = {}


def jax_trace(ref, solver, backend, cg_maxiter=None):
    key = (solver, backend, cg_maxiter)
    if key not in _JAX_RUNS:
        run = jpgo.make_optimize_jit(ref, num_iterations=ITERS, solver=solver,
                                     backend=backend, tolerance=0.0,
                                     cg_maxiter=cg_maxiter)
        g, errors, it = run(ref)
        _JAX_RUNS[key] = (g, np.asarray(errors), int(it))
    return _JAX_RUNS[key]


@pytest.mark.parametrize("backend,jax_backend", [
    ("cg", "cg"), ("cg-banded", "cg-banded-jnp"),
    ("cg-banded-jnp", "cg-banded-jnp")])
@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
@pytest.mark.parametrize("cg_maxiter", [None, 3])
def test_make_optimize_cg_matches_jit(case, solver, backend, jax_backend,
                                      cg_maxiter):
    """cg_tol 1e-10 (JAX's default). cg_maxiter None: 4·n rounds for cg,
    10·n for the banded PCG; 3: the banded PCG stops at 3 rounds and cg,
    which takes no cg_maxiter in either package, still runs to 4·n. χ²
    entries above 1e-6 within 1e-6, poses within 1e-8."""
    g_ref, want, it_ref = jax_trace(case["ref"], solver, jax_backend,
                                    cg_maxiter)
    run = tpgo.make_optimize(case["port"], num_iterations=ITERS,
                             solver=solver, backend=backend, tolerance=0.0,
                             cg_maxiter=cg_maxiter, device="cpu")
    g, errors, it = run(case["port"])
    assert it == it_ref == ITERS
    got = errors.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    sel = want > 1e-6
    assert sel.sum() >= 2
    np.testing.assert_allclose(got[sel], want[sel], rtol=1e-6)
    np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_ref.poses2),
                               atol=1e-8)


def test_host_optimize_cg_matches(case):
    want = jpgo.optimize(case["ref"], num_iterations=ITERS, backend="cg",
                         tolerance=0.0)
    got = tpgo.optimize(case["port"], num_iterations=ITERS, backend="cg",
                        tolerance=0.0, device="cpu")
    assert got.iterations == want.iterations == ITERS
    errs, errs_ref = np.asarray(got.errors), np.asarray(want.errors)
    sel = errs_ref > 1e-6
    np.testing.assert_allclose(errs[sel], errs_ref[sel], rtol=1e-6)
    np.testing.assert_allclose(got.norms, want.norms, rtol=1e-6, atol=1e-9)


def test_host_optimize_rejects_cg_banded(case):
    """As the JAX ``optimize``: the banded PCG runs in ``make_optimize``."""
    with pytest.raises(ValueError, match="backend"):
        tpgo.optimize(case["port"], backend="cg-banded", device="cpu")
