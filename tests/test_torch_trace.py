"""The optimizer's spans (``utils.metrics.span``) on the CPU: off, a span
is one shared null context and records nothing; under a profiler, each
entry point's request holds one ``rrt.linearize``, ``rrt.band.assemble``,
``rrt.band.factorize`` and ``rrt.band.substitute`` an iteration and at
least one ``rrt.update``, nested as the layers nest; and the results are
bit for bit those of a run without a profiler. No JAX: the spans are the
port's own."""

import collections
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rustrobotics_tpu_torch.mapping import pgo
from rustrobotics_tpu_torch.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu_torch.utils import metrics

ITERS = 3
BAND = ("rrt.band.assemble", "rrt.band.factorize", "rrt.band.substitute")


def test_span_off_is_the_shared_null_context(monkeypatch):
    def no_range(*args, **kwargs):
        raise AssertionError("a range was created with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not torch.autograd.profiler._is_profiler_enabled
    got = metrics.span("linearize")
    assert got is metrics.span("update")
    assert isinstance(got, contextlib.nullcontext)
    with got, metrics.span("request"):
        pass


@pytest.mark.parametrize("session", ["torch.profiler", "autograd"])
def test_span_records_under_a_profiler(session):
    if session == "autograd":
        ctx = torch.autograd.profiler.profile()
    else:
        ctx = profile(activities=[ProfilerActivity.CPU])
    with ctx as prof:
        with metrics.span("band.factorize"):
            torch.ones(4).sum()
    events = (prof.function_events if session == "autograd"
              else prof.events())
    names = [e.name for e in events]
    assert names.count(metrics.SPAN_PREFIX + "band.factorize") == 1
    assert metrics.span("x") is metrics.span("y")  # off again


def _graph(seed=0):
    return synthetic_corridor_graph_2d(64, closure_span=8, seed=seed,
                                       device="cpu")


def _request_of(kind):
    """A function of no arguments running one request of ``kind``, GN
    ``ITERS`` on banded-direct, returning its poses and χ² trace."""
    g = _graph()
    if kind == "make_optimize":
        run = pgo.make_optimize(g, ITERS, backend="banded-direct",
                                tolerance=0.0, device="cpu")

        def request():
            out, errors, _ = run(g)
            return out.poses2, errors
    elif kind == "make_optimize_batch":
        fleet = pgo.stack_graphs([g, _graph(seed=1)])
        run = pgo.make_optimize_batch(fleet, ITERS, backend="banded-direct",
                                      tolerance=0.0, device="cpu")

        def request():
            out, errors, _ = run(fleet)
            return out.poses2, errors
    else:
        def request():
            res = pgo.optimize(g, ITERS, backend="banded-direct",
                               tolerance=0.0, device="cpu")
            assert res.iterations == ITERS
            return res.graph.poses2, torch.tensor(res.errors)
    return request


ENTRIES = ["make_optimize", "make_optimize_batch", "optimize"]


@pytest.mark.parametrize("kind", ENTRIES)
def test_spans_of_one_request_nest(kind):
    request = _request_of(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        request()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("rrt.")]
    count = collections.Counter(n for n, _, _ in spans)
    assert count["rrt.request"] == 1
    for name in ("rrt.linearize",) + BAND:
        assert count[name] == ITERS, (name, count)
    assert count["rrt.update"] >= ITERS
    assert set(count) == {"rrt.request", "rrt.linearize", "rrt.update",
                          *BAND}
    (_, r0, r1), = [s for s in spans if s[0] == "rrt.request"]
    for _, s, e in spans:
        assert r0 <= s <= e <= r1
    linearize = [(s, e) for n, s, e in spans if n == "rrt.linearize"]
    for n, s, e in spans:
        if n in BAND or n == "rrt.update":
            assert not any(a <= s and e <= b for a, b in linearize), n


@pytest.mark.parametrize("kind", ENTRIES)
def test_results_equal_with_and_without_profiler(kind):
    request = _request_of(kind)
    poses, errors = request()
    with profile(activities=[ProfilerActivity.CPU]):
        traced_poses, traced_errors = request()
    assert torch.equal(poses, traced_poses)
    assert torch.equal(errors.isnan(), traced_errors.isnan())
    assert torch.equal(errors.nan_to_num(), traced_errors.nan_to_num())
    assert np.isfinite(errors.numpy()).any()


def test_xla_trace_writes_the_spans(tmp_path):
    request = _request_of("make_optimize")
    with metrics.xla_trace(str(tmp_path)):
        request()
    (path,) = tmp_path.glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"rrt.request", "rrt.linearize", "rrt.update", *BAND} <= names


@pytest.mark.parametrize("kind", ["make_optimize", "make_optimize_batch"])
@pytest.mark.parametrize("robust", [None, "gnc-gm"])
def test_lm_accept_spans_each_accept_test(kind, robust):
    """An LM request holds one ``rrt.lm.accept`` an iteration, inside the
    request and apart from the linearization and the band's spans; on the
    CPU the trial's costs (``rrt.update``) nest in it."""
    g = _graph()
    graph = g if kind == "make_optimize" else pgo.stack_graphs(
        [g, _graph(seed=1)])
    run = getattr(pgo, kind)(graph, ITERS, solver="lm",
                             backend="banded-direct", tolerance=0.0,
                             robust=robust, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(graph)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("rrt.")]
    accept = [(s, e) for n, s, e in spans if n == "rrt.lm.accept"]
    assert len(accept) == ITERS
    (_, r0, r1), = [s for s in spans if s[0] == "rrt.request"]
    for a, b in accept:
        assert r0 <= a <= b <= r1
        inner = [n for n, s, e in spans if a <= s and e <= b]
        assert inner.count("rrt.lm.accept") == 1
        assert "rrt.update" in inner
        assert not set(inner) & {"rrt.linearize", *BAND}
