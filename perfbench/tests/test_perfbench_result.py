"""A whole run on the CPU at a small size, the card's look skipped: the
last line's schema, a sound run judged correct, and each fault a cell can
have, planted in the timed path, judged not correct. A fleet cell's
request is B graphs: its iterations are graph-iterations, every row of a
sampled request is compared, and a request fails when any row does."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness


def _run(plan, seed=2**31 + 3):
    return harness.run_cell(plan, seed, 0.3, False, "cpu",
                            log=lambda s: None)


def test_result_schema(small_plan):
    r = _run(small_plan("intel-solve"))
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"graph_iters_per_s", "solve_ms_p95",
                                 "setup_s"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert set(r["checks"]) == {"failed_requests",
                                *harness.plan("intel-solve")["workload"][
                                    "limits"]}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


@pytest.mark.parametrize("cell", ["intel-solve", "sphere2500-solve",
                                  "intel-fleet8"])
def test_sound_run_is_correct(small_plan, cell):
    r = _run(small_plan(cell))
    assert r["correct"], r["checks"]


def test_fleet_request_counts_graph_iterations(small_plan, monkeypatch):
    """The tiny fleet cell (fleet 4, pool 8) is correct, and each request
    of its window is 4 graphs of 10 iterations."""
    p = small_plan("intel-fleet8")
    seen = []
    harness_request = harness._request

    def request(*a):
        r = harness_request(*a)
        seen.append((r.iterations, tuple(r.poses.shape)))
        return r

    monkeypatch.setattr(harness, "_request", request)
    r = _run(p)
    assert r["correct"], r["checks"]
    assert len(seen) == r["attempted"] >= 1
    assert set(seen) == {(4 * 10, (4, 48, 3))}


def _identity_step(graph, dx):
    return graph


def _altered_answer(apply_update):
    """One pose of one graph moved: of a fleet, its last row's."""
    def fault(graph, dx):
        g = apply_update(graph, dx)
        field = "poses3" if g.is_3d else "poses2"
        poses = getattr(g, field).clone()
        poses.view(-1, *poses.shape[-2:])[-1, 5, 0] += 0.1
        return g.replace(**{field: poses})
    return fault


def _half_edges(system_values):
    def fault(graph, *a, **kw):
        pre = "qq" if graph.is_3d else "pp"
        omega = getattr(graph, f"{pre}_omega").clone()
        omega[..., ::2, :, :] = 0.0
        omega[..., 1::2, :, :] *= 2.0
        return system_values(graph.replace(**{f"{pre}_omega": omega}),
                             *a, **kw)
    return fault


@pytest.mark.parametrize("cell", ["intel-solve", "sphere2500-solve",
                                  "intel-fleet8"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_edges",
                                   "answer_altered"])
def test_fault_is_not_correct(small_plan, monkeypatch, cell, fault):
    from rustrobotics_tpu_torch.mapping import pgo

    if fault == "state_unchanged":
        monkeypatch.setattr(pgo, "apply_update", _identity_step)
    elif fault == "half_edges":
        monkeypatch.setattr(pgo, "system_values",
                            _half_edges(pgo.system_values))
    else:
        monkeypatch.setattr(pgo, "apply_update",
                            _altered_answer(pgo.apply_update))
    r = _run(small_plan(cell))
    assert r["correct"] is False, r["checks"]


def test_fleet_rows_left_out_is_not_correct(small_plan, monkeypatch):
    """Half of a fleet's rows left out of the step: they keep their
    guesses."""
    from rustrobotics_tpu_torch.mapping import pgo

    apply_update = pgo.apply_update

    def fault(graph, dx):
        g = apply_update(graph, dx)
        half = graph.poses2.shape[0] // 2
        return g.replace(poses2=torch.cat([g.poses2[:half],
                                           graph.poses2[half:]]))

    monkeypatch.setattr(pgo, "apply_update", fault)
    r = _run(small_plan("intel-fleet8"))
    assert r["correct"] is False, r["checks"]


def test_nonfinite_row_is_one_failed_request(small_plan):
    """A request fails when any row's trace is not finite, and counts
    once however many of its rows do; every row of a sampled request is
    an answer under its own pool index."""
    p = small_plan("intel-fleet8")   # fleet 4, pool 8

    def request():
        return harness.Request(0.0, 1.0, 40, torch.zeros(4, 48, 3),
                               torch.ones(4, 11))

    requests = [request() for _ in range(3)]
    requests[1].trace[2, 5] = float("nan")
    pool = torch.zeros(8, 48, 3)
    failed, answers, guesses = harness.sample_answers(p, requests, pool, 7)
    assert failed == 1
    assert [j for j, _, _ in answers] == [0, 1, 2, 3, 4, 5, 6, 7,
                                          0, 1, 2, 3]
    assert sorted(guesses) == list(range(8))
    for r in requests:
        r.trace[:] = float("nan")
    assert harness.sample_answers(p, requests, pool, 7)[0] == len(requests)


@pytest.mark.parametrize("cell,maker", [("intel-solve", "make_optimize"),
                                        ("intel-fleet8",
                                         "make_optimize_batch")])
def test_options_reach_the_optimizer(small_plan, monkeypatch, cell, maker):
    """The traffic's ``options`` reach the optimizer its loop builds as
    keyword arguments, unchanged; without them none is passed."""
    from rustrobotics_tpu_torch.mapping import pgo

    calls = []
    for name in ("make_optimize", "make_optimize_batch"):
        monkeypatch.setattr(pgo, name, lambda template, _name=name, **kw:
                            calls.append((_name, template, kw)))
    p = small_plan(cell)
    options = dict(robust="huber", robust_delta=0.5, robust_alpha=-1.0,
                   cg_tol=1e-6, cg_maxiter=400)
    base = dict(num_iterations=10, solver="gauss_newton",
                backend="banded-kernel", tolerance=0.0, device="cpu")
    harness._optimizer(p, "template", "cpu")
    p["traffic"] = {**p["traffic"], "options": options}
    harness._optimizer(p, "template", "cpu")
    assert calls == [(maker, "template", base),
                     (maker, "template", {**base, **options})]


def test_cli_without_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "-m", "perfbench.run",
                          "--workload", "intel-solve", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
