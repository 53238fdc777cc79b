"""A whole run on the CPU at a small size, the card's look skipped: the
last line's schema, a sound run judged correct, and each fault a cell can
have, planted in the timed path, judged not correct."""

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


@pytest.mark.parametrize("cell", ["intel-solve", "sphere2500-solve"])
def test_sound_run_is_correct(small_plan, cell):
    r = _run(small_plan(cell))
    assert r["correct"], r["checks"]


def _identity_step(graph, dx):
    return graph


def _altered_answer(apply_update):
    def fault(graph, dx):
        g = apply_update(graph, dx)
        field = "poses3" if g.is_3d else "poses2"
        poses = getattr(g, field).clone()
        poses[5, 0] += 0.1
        return g.replace(**{field: poses})
    return fault


def _half_edges(system_values):
    def fault(graph, *a, **kw):
        pre = "qq" if graph.is_3d else "pp"
        omega = getattr(graph, f"{pre}_omega").clone()
        omega[::2] = 0.0
        omega[1::2] *= 2.0
        return system_values(graph.replace(**{f"{pre}_omega": omega}),
                             *a, **kw)
    return fault


@pytest.mark.parametrize("cell", ["intel-solve", "sphere2500-solve"])
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


def test_cli_without_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "-m", "perfbench.run",
                          "--workload", "intel-solve", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
