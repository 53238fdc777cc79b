"""The slice put down to the program's spans (``perfbench/spans.py``): the
arithmetic on synthetic events, the links read from a profiler's events,
a traced slice of a small cell on the CPU, and on a card the identities
against the slice's own readings.

    python -m pytest perfbench/tests/test_perfbench_spans.py
    python -m pytest -m cuda perfbench/tests/test_perfbench_spans.py
"""

import json
import subprocess
import sys
import types

import pytest
import torch

from perfbench import harness, spans, trace

# one request; a K1 kernel runs past its span's end, a CUDA graph replays
# in update, a fill launched before the slice runs into it, and one kernel
# has no launch call on the trace
HOST = [(trace.SLICE, 0.0, 100.0),
        ("cudaLaunchKernel", -8.0, -7.0),
        ("cudaLaunchKernel", 2.0, 3.0),
        ("rrt.request", 5.0, 95.0),
        ("rrt.linearize", 10.0, 30.0),
        ("aten::mul", 11.0, 14.0),
        ("cudaLaunchKernel", 12.0, 13.0),
        ("rrt.band.assemble", 40.0, 50.0),
        ("rrt.band.factorize", 50.0, 70.0),
        ("cudaLaunchKernelExC", 55.0, 56.0),
        ("cudaMemcpyAsync", 60.0, 61.0),
        ("rrt.update", 80.0, 90.0),
        (spans.GRAPH_LAUNCH, 82.0, 83.0),
        ("cudaLaunchKernel", 96.0, 97.0),
        ("cudaLaunchKernel", 110.0, 111.0)]
DEVICE = [("fill", -5.0, 4.0), ("elementwise", 14.0, 20.0),
          ("panel_chol_inv", 57.0, 75.0), ("Memcpy HtoD", 62.0, 64.0),
          ("gemm_nt", 84.0, 99.0), ("mystery", 90.0, 92.0),
          ("late", 120.0, 130.0)]
LINKS = {DEVICE[0]: HOST[1], DEVICE[1]: HOST[6], DEVICE[2]: HOST[9],
         DEVICE[3]: HOST[10], DEVICE[4]: HOST[12], DEVICE[6]: HOST[14]}


def _us(d):
    return {k: round(v * 1e6, 9) for k, v in d.items()}


def test_device_time_goes_to_the_span_of_its_launch():
    sp = spans.by_span(DEVICE, HOST, LINKS)
    assert _us(sp.device_s) == {"request": 0, "linearize": 6,
                                "assemble": 0, "factorize": 20,
                                "substitute": 0, "update": 15, "outside": 4}
    assert sp.unlinked_s == pytest.approx(2e-6)
    s = trace.reduce(DEVICE, HOST)
    assert sum(sp.device_s.values()) + sp.unlinked_s == pytest.approx(
        sum(s.device_s.values()))


def test_launches_by_span_count_a_graph_launch():
    sp = spans.by_span(DEVICE, HOST, LINKS)
    assert sp.launches == {"request": 0, "linearize": 1, "assemble": 0,
                           "factorize": 1, "substitute": 0, "update": 1,
                           "outside": 2}
    s = trace.reduce(DEVICE, HOST)
    assert sum(sp.launches.values()) == s.launches + 1


def test_idle_gaps_split_by_overlap():
    sp = spans.by_span(DEVICE, HOST, LINKS)
    # gaps (4, 14), (20, 57), (75, 84), (99, 100): the second straddles
    # linearize, request, assemble and factorize
    assert _us(sp.idle_s) == {"request": 20, "linearize": 14,
                              "assemble": 10, "factorize": 7,
                              "substitute": 0, "update": 4, "outside": 2}
    s = trace.reduce(DEVICE, HOST)
    assert sum(sp.idle_s.values()) == pytest.approx(s.window_s - s.busy_s)
    assert sp.requests == 1


def test_timeline_innermost_wins_at_shared_edges():
    host = [("rrt.request", 0.0, 10.0), ("rrt.linearize", 0.0, 4.0),
            ("rrt.update", 4.0, 6.0), ("perfbench.layer.solve", 6.0, 9.0),
            ("rrt.band.factorize", 6.0, 9.0)]
    starts, layers = spans._timeline(host)
    assert list(zip(starts, layers)) == [
        (float("-inf"), "outside"), (0.0, "linearize"), (4.0, "update"),
        (6.0, "factorize"), (9.0, "request"), (10.0, "outside")]


def test_readings():
    sp = spans.by_span(DEVICE, HOST, LINKS)
    assert len(spans.METRICS) == 18
    got = {m: spans.reading(sp, m, 5) for m in spans.METRICS}
    assert got["device_ms.factorize"] == pytest.approx(1e3 * 20e-6 / 5)
    assert got["launches.update"] == pytest.approx(0.2)
    assert got["idle_ms.assemble"] == pytest.approx(1e3 * 10e-6 / 5)
    for m in ("device_ms.substitute", "launches.substitute",
              "idle_ms.substitute", "device_ms.request"):
        assert got[m] == 0.0
    assert spans.reading(sp, "launches.outside", 5) == pytest.approx(0.4)
    assert all(spans.reading(sp, m, 0) is None for m in spans.METRICS)
    lost = [r for r in HOST if r[0] != "rrt.request"]
    gone = spans.by_span(DEVICE, lost, LINKS)
    assert gone.requests == 0
    assert all(spans.reading(gone, m, 5) is None for m in spans.METRICS)


def _event(name, eid, start, end, cuda=False, annotation=False):
    dt = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, id=eid, thread=1, is_user_annotation=annotation,
        device_type=dt.CUDA if cuda else dt.CPU,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_links_join_by_correlation_id():
    events = [_event(trace.SLICE, 1, 0.0, 50.0),
              _event("rrt.band.factorize", 2, 1.0, 40.0),
              _event("aten::mm", 7, 2.0, 9.0),          # an op's own id
              _event("cudaLaunchKernel", 7, 3.0, 4.0),  # CUPTI's id 7
              _event("cudaMemsetAsync", 8, 5.0, 6.0),
              _event("cudaStreamSynchronize", 9, 20.0, 30.0),
              _event("gemm_nt", 7, 10.0, 12.0, cuda=True),
              _event("Memset (Device)", 8, 12.0, 13.0, cuda=True),
              _event("orphan", 11, 14.0, 15.0, cuda=True),
              _event("rrt.band.factorize", 2, 10.0, 13.0, cuda=True,
                     annotation=True)]
    prof = types.SimpleNamespace(events=lambda: events)
    links = spans.launch_links(prof)
    assert links == {("gemm_nt", 10.0, 12.0): ("cudaLaunchKernel", 3.0, 4.0),
                     ("Memset (Device)", 12.0, 13.0):
                         ("cudaMemsetAsync", 5.0, 6.0)}
    device, host = trace.from_profiler(prof)
    assert set(links) <= set(device)
    assert set(links.values()) <= set(host)
    sp = spans.by_span(device, host, links)
    assert _us(sp.device_s)["factorize"] == 3
    assert sp.unlinked_s == pytest.approx(1e-6)


def test_cpu_slice_has_the_programs_spans(small_plan):
    p = small_plan("intel-solve")
    s, sp = spans.measure(p, 2**31 + 17, 0.2, torch.device("cpu"))
    assert sp.requests == p["traffic"]["trace_requests"]
    assert s.iterations == 10 * sp.requests
    assert sum(sp.idle_s.values()) == pytest.approx(s.window_s)
    for layer in spans.LAYERS:
        assert sp.idle_s[layer] > 0, layer
    out = spans.summary(s, sp, p)
    assert set(out["metrics"]) == set(spans.METRICS)
    assert out["launches_sum"] == out["launches_slice"] == 0
    assert out["span_device_events"] == []
    json.dumps(out)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_spec()["workloads"]])
def test_spans_on_card_add_up(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "perfbench.spans",
                          "--workload", cell, "--seed", str(2**31 + 29),
                          "--seconds", "3"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(v is not None for v in r["metrics"].values()), r["metrics"]
    assert all(v is not None for v in r["existing"].values())
    assert r["span_device_events"] == []
    # no CUDA graph in the step: both count the same launch calls
    assert r["launches_sum"] == r["launches_slice"] > 0
    assert r["unlinked_share"] <= 0.01
    assert r["device_ms_sum"] == pytest.approx(r["device_ms_slice"],
                                               rel=1e-3)
    assert r["idle_ms_sum"] == pytest.approx(r["idle_ms_slice"], rel=1e-6)
    assert r["metrics"]["device_ms.factorize"] == pytest.approx(
        r["k1_by_name_ms"], rel=0.05)
