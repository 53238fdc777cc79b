"""The port's GN/LM drivers against the JAX package's on a small corridor
graph (n=776, kb=256, nb=4): the device loop ``make_optimize`` against
``make_optimize_jit`` and the host loop ``optimize`` against ``optimize``."""

import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    graph_from_numpy,
)

ITERS = 6


@pytest.fixture(scope="module")
def graphs():
    ref = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=32)
    fields = {n: np.asarray(getattr(ref, n)) for n in FLOAT_FIELDS + INDEX_FIELDS}
    port = graph_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                            device="cpu")
    return ref, port


_JAX_RUNS = {}


def jax_trace(ref, solver, tolerance=0.0):
    """JAX make_optimize_jit(banded-direct) f64 trace, cached per case."""
    key = (solver, tolerance)
    if key not in _JAX_RUNS:
        run = jpgo.make_optimize_jit(ref, num_iterations=ITERS, solver=solver,
                                     backend="banded-direct",
                                     tolerance=tolerance)
        g, errors, it = run(ref)
        _JAX_RUNS[key] = (g, np.asarray(errors), int(it))
    return _JAX_RUNS[key]


def assert_trace_close(got, want, rtol, floor):
    """Same NaN tail; entries above ``floor`` equal to rtol."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    sel = ~np.isnan(want) & (want > floor)
    assert sel.sum() >= 2
    np.testing.assert_allclose(got[sel], want[sel], rtol=rtol)


@pytest.mark.parametrize("backend", ["banded-direct", "dense", "banded-kernel"])
@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_make_optimize_matches_jit(graphs, solver, backend):
    ref, port = graphs
    g_ref, want, it_ref = jax_trace(ref, solver)
    run = tpgo.make_optimize(port, num_iterations=ITERS, solver=solver,
                             backend=backend, tolerance=0.0, device="cpu")
    g, errors, it = run(port)
    got = errors.numpy()
    assert it == it_ref == ITERS
    if backend == "banded-kernel":
        # f32 inside the solve: the χ² entries above 1 keep to 1e-3
        assert_trace_close(got, want, rtol=1e-3, floor=1.0)
    else:
        assert_trace_close(got, want, rtol=1e-6, floor=1e-6)
        np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_ref.poses2),
                                   atol=1e-8)


def test_make_optimize_converges_like_jit(graphs):
    """tolerance > 0: the loop stops at the same iteration and leaves the
    same NaN tail."""
    ref, port = graphs
    _, want, it_ref = jax_trace(ref, "gauss_newton", tolerance=1e-4)
    run = tpgo.make_optimize(port, num_iterations=ITERS,
                             backend="banded-direct", tolerance=1e-4,
                             device="cpu")
    _, errors, it = run(port)
    assert it == it_ref < ITERS
    assert_trace_close(errors.numpy(), want, rtol=1e-6, floor=1e-6)


@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_host_optimize_matches(graphs, solver):
    ref, port = graphs
    want = jpgo.optimize(ref, num_iterations=8, solver=solver, backend="host")
    got = tpgo.optimize(port, num_iterations=8, solver=solver, backend="host",
                        device="cpu")
    assert got.iterations == want.iterations
    assert_trace_close(np.asarray(got.errors), np.asarray(want.errors),
                       rtol=1e-6, floor=1e-6)
    np.testing.assert_allclose(got.norms, want.norms, rtol=1e-6, atol=1e-9)


def test_default_device_is_cuda(graphs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    _, port = graphs
    with pytest.raises(RuntimeError, match="CUDA"):
        tpgo.make_optimize(port)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpgo.optimize(port)


def test_unknown_backend_raises(graphs):
    _, port = graphs
    with pytest.raises(ValueError, match="backend"):
        tpgo.make_optimize(port, backend="schur", device="cpu")
    with pytest.raises(ValueError, match="robust"):
        tpgo.make_optimize(port, robust="tukey", device="cpu")(port)
    assert float(tpgo.global_error(port)) == pytest.approx(
        float(jpgo.global_error(graphs[0])), rel=1e-12)


def test_make_optimize_host_raises(graphs):
    """As make_optimize_jit: the device loop takes no host backend, while
    the host loop keeps it."""
    _, port = graphs
    with pytest.raises(ValueError, match="device backend, got 'host'"):
        tpgo.make_optimize(port, backend="host", device="cpu")
    assert tpgo.optimize(port, num_iterations=1, backend="host",
                         device="cpu").iterations == 1
