"""On a CUDA card: a short traced run of each cell of BENCHMARK.json
ends correct, with every per-layer metric. Skips without a card.

    python -m pytest -m cuda perfbench/tests/test_perfbench_card.py
"""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_spec()["workloads"]])
def test_traced_run_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "perfbench.run",
                          "--workload", cell, "--seed", str(2**31 + 21),
                          "--seconds", "3", "--trace", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {m["name"] for m in
                                 harness.plan(cell)["per_layer"]}
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
