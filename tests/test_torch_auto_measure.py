"""The port's ``auto-measure`` backend (``pgo._measure_backend``) on the
CPU, f64: it times the banded candidates on the template's system and
runs the fastest, on ``optimize``, ``make_optimize`` and
``make_optimize_batch``; it disqualifies a candidate that returns None or
a non-finite x, goes dense when none qualifies, and (unlike the JAX
package, which skips it) lets a candidate's exception propagate. The run
it picks is held to the JAX driver with the same backend."""

import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping import solvers as tsol
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    graph_from_numpy,
)

CANDIDATES = {"banded-direct", "banded-cr", "banded-mixed"}
ITERS = 3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small-matrix tests: the suite runs
    several workers on one machine, and more threads oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def graphs():
    ref = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=32)
    fields = {n: np.asarray(getattr(ref, n)) for n in FLOAT_FIELDS + INDEX_FIELDS}
    return ref, graph_from_numpy(fields, ref.total_dof, ref.prior2,
                                 ref.prior3, device="cpu")


def test_make_optimize_picks_a_candidate(graphs):
    """On the CPU the candidates are the three plain banded backends (no
    kernel); the pick is the fastest measured, and its run equals the JAX
    driver's with that backend (χ² entries above 1e-6 within 1e-9)."""
    ref, port = graphs
    run = tpgo.make_optimize(port, num_iterations=ITERS, backend="auto-measure",
                             tolerance=0.0, device="cpu")
    assert set(run.backend_times) == CANDIDATES
    assert all(t > 0 for t in run.backend_times.values())
    assert run.backend == min(run.backend_times, key=run.backend_times.get)
    _, errors, it = run(port)
    _, want, it_j = jpgo.make_optimize_jit(ref, num_iterations=ITERS,
                                           backend=run.backend,
                                           tolerance=0.0)(ref)
    assert it == int(it_j) == ITERS
    want = np.asarray(want)
    sel = want > 1e-6
    np.testing.assert_allclose(errors.numpy()[sel], want[sel], rtol=1e-9)


def test_optimize_and_batch_pick_a_candidate(graphs):
    _, port = graphs
    res = tpgo.optimize(port, num_iterations=2, backend="auto-measure",
                        tolerance=0.0, device="cpu")
    assert res.backend in CANDIDATES and res.iterations == 2
    fleet = tpgo.stack_graphs([port, port])
    run = tpgo.make_optimize_batch(fleet, num_iterations=2,
                                   backend="auto-measure", tolerance=0.0,
                                   device="cpu")
    assert run.backend in CANDIDATES and set(run.backend_times) == CANDIDATES
    _, errors, it = run(fleet)
    assert it.tolist() == [2, 2]
    torch.testing.assert_close(errors[0], errors[1], rtol=0, atol=0)


def test_disqualified_candidates(graphs, monkeypatch):
    """None (bandwidth too large) and a non-finite x are skipped; with no
    candidate left the driver goes dense, as the JAX package's does."""
    _, port = graphs
    monkeypatch.setattr(tsol, "make_banded_cr", lambda *a, **k: None)

    def make_nan(*args, **kwargs):
        return lambda vals, b: torch.full_like(b, float("nan"))

    monkeypatch.setattr(tsol, "make_banded_mixed", make_nan)
    run = tpgo.make_optimize(port, num_iterations=1, backend="auto-measure",
                             device="cpu")
    assert run.backend == "banded-direct"
    assert set(run.backend_times) == {"banded-direct"}
    monkeypatch.setattr(tsol, "make_banded_direct", lambda *a, **k: None)
    run = tpgo.make_optimize(port, num_iterations=2, backend="auto-measure",
                             tolerance=0.0, device="cpu")
    assert run.backend == "dense" and run.backend_times == {}
    dense = tpgo.make_optimize(port, num_iterations=2, backend="dense",
                               tolerance=0.0, device="cpu")
    torch.testing.assert_close(run(port)[1], dense(port)[1], rtol=0, atol=0)


@pytest.mark.parametrize("driver", ["optimize", "make_optimize",
                                    "make_optimize_batch"])
def test_a_raising_candidate_propagates(graphs, monkeypatch, driver):
    """A candidate that fails (a kernel that did not build, say) is not
    skipped: its exception reaches the caller."""
    _, port = graphs

    def broken(*args, **kwargs):
        raise RuntimeError("candidate failed to build")

    monkeypatch.setattr(tsol, "make_banded_cr", broken)
    with pytest.raises(RuntimeError, match="failed to build"):
        getattr(tpgo, driver)(port, backend="auto-measure", device="cpu")
