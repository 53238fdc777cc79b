"""The port's headline benchmark (``rustrobotics_tpu_torch.bench`` and
``cli bench``) against the JAX package's root ``bench.py`` on the CPU.

``import bench`` runs no probe (it probes only as ``__main__``). On a
96-pose corridor written as a g2o file, JAX's ``_time_device_path`` races
banded-direct and banded-cr on the CPU; the port's, given the same two
backends, picks a valid one (finite trace, ending below its start) whose
f32 χ² trace matches JAX's chosen trace: entries above 1 within 1e-4
relative, every entry within 1e-6 of errors[0] (both are exact f32
solves; the tail sits at f32's rounding of the optimum, ~1e-9). Then
``cli bench --cpu --suite-out PATH`` with ``_load_graph`` giving that
graph, an empty dataset root and the suite's families cut to small sizes:
the last stdout line has JAX's top-level keys and extra keys from JAX's
set (the TPU-only ones absent), the suite's rows go to PATH and nowhere
else (no JSON file appears at the repo's root), and the repo's
``BENCH_SUITE.json`` is unchanged.
"""

import functools
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest
import torch

import bench as jax_bench
from rustrobotics_tpu.mapping import load_g2o as jax_load_g2o
from rustrobotics_tpu_torch import benchmarks as pb
from rustrobotics_tpu_torch import bench, cli
from rustrobotics_tpu_torch.mapping import load_g2o

ROOT = pathlib.Path(__file__).resolve().parent.parent
RACE = ["banded-direct", "banded-cr"]  # JAX's race off a TPU

# every key of the JAX headline line (bench.py _emit / main)
TOP_KEYS = ["extra", "metric", "unit", "value", "vs_baseline"]
CORE_EXTRA = {"tflops", "mfu_vs_f32_peak", "solver_backend",
              "backend_ms_per_10it", "dispatch_rtt_ms", "suite_file",
              "suite_rows", "budget_spent_s"}
JAX_EXTRA = CORE_EXTRA | {
    "iters_per_sec_device_est", "platform_fallback", "suite_skipped",
    "ekf_banked_Mups", "ukf_banked_Mups", "weak_scaling_eff_pct_8dev_cpu_proxy",
    "strong_scaling_eff_pct_8dev_cpu_proxy", "scaling_error",
    "pallas_ms_per_10it", "pallas_preflight", "pallas_error",
} | {f"fleet{b}_{k}" for b in (2, 8, 32)
     for k in ("speedup", "graphs_per_sec")}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    from rustrobotics_tpu_torch.mapping.synthetic import (
        synthetic_corridor_graph_2d,
    )

    cs = _chip_smoke()
    path = tmp_path_factory.mktemp("headline") / "corridor96.g2o"
    graph = synthetic_corridor_graph_2d(96, num_landmarks=4,
                                        closure_span=32, device="cpu")
    path.write_text(cs.g2o_text(cs.graph_spec(graph)))
    return path


def test_import_runs_no_probe():
    assert jax_bench._TPU_OK is False
    assert bench._race_backends(torch.device("cpu")) == [
        "banded-direct", "banded-cr", "banded-mixed"]


def test_without_a_card_the_entries_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError):
        cli.main(["bench"])
    with pytest.raises(RuntimeError):
        cli.main(["bench", "--suite"])
    with pytest.raises(RuntimeError):
        pb.run_suite()


@pytest.fixture
def fresh_budget(monkeypatch):
    """Both headlines count their wall budget from their module's import;
    the suite imports them at collection, so restart both clocks."""
    now = time.monotonic()
    monkeypatch.setattr(jax_bench, "T0", now)
    monkeypatch.setattr(bench, "T0", now)


def test_device_path_matches_jax(graph_file, monkeypatch, fresh_budget):
    _, want, jax_backend, jax_timed = jax_bench._time_device_path(
        jax_load_g2o(str(graph_file)))
    assert sorted(jax_timed) == sorted(RACE)
    monkeypatch.setattr(bench, "_race_backends", lambda device: list(RACE))
    seconds, got, backend, timed = bench._time_device_path(
        load_g2o(str(graph_file), device="cpu"))
    assert sorted(timed) == sorted(RACE) and backend in RACE
    assert seconds == timed[backend] > 0
    assert np.all(np.isfinite(got)) and got[-1] <= got[0]
    want = np.asarray(want, np.float64)
    big = want > 1.0
    np.testing.assert_allclose(got[big], want[big], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * want[0])


def test_cli_bench_line_and_suite_file(graph_file, tmp_path, monkeypatch,
                                       capsys, fresh_budget):
    data = tmp_path / "dataset"
    data.mkdir()
    monkeypatch.setenv("RUSTROBOTICS_DATASET", str(data))
    monkeypatch.setattr(bench, "_load_graph", lambda device: (
        load_g2o(str(graph_file), dtype=torch.float32, device=device),
        "corridor96"))
    monkeypatch.setattr(pb, "BATCH", 8)
    monkeypatch.setattr(pb, "bench_fixed_lag",
                        functools.partial(pb.bench_fixed_lag, window=8,
                                          steps=10))
    monkeypatch.setattr(pb, "bench_pf_scale",
                        functools.partial(pb.bench_pf_scale,
                                          num_particles=1024, steps=3))
    suite_json = ROOT / "BENCH_SUITE.json"
    before = suite_json.read_bytes()
    listing = sorted(p.name for p in ROOT.glob("*.json"))
    out = tmp_path / "out"
    out.mkdir()
    cli.main(["bench", "--cpu", "--suite-out", str(out / "suite.json")])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 2  # the safety-net line, then the enriched one
    line = json.loads(lines[-1])
    assert sorted(line) == TOP_KEYS
    assert line["metric"] == "pgo_corridor96_gn_iters_per_sec"
    assert line["unit"] == "iters/s" and line["value"] > 0
    assert line["vs_baseline"] > 0
    extra = line["extra"]
    assert CORE_EXTRA <= set(extra) <= JAX_EXTRA, set(extra) ^ JAX_EXTRA
    assert extra["mfu_vs_f32_peak"] is None  # no peak for the CPU
    assert extra["solver_backend"] in ("banded-direct", "banded-cr",
                                       "banded-mixed")
    assert sorted(extra["backend_ms_per_10it"]) == sorted(
        bench._race_backends(torch.device("cpu")))
    assert extra["suite_file"] == str(out / "suite.json")
    suite = json.loads((out / "suite.json").read_text())
    assert suite["device"] == "cpu"
    assert len(suite["suite"]) == extra["suite_rows"] > 0
    assert not any("error" in r for r in suite["suite"])
    assert {r["metric"] for r in suite["suite"]} >= {
        "ekf_banked_update_throughput", "fixed_lag_w8_steps_per_sec",
        "pf_particle_throughput"}
    assert len(lines[-1]) <= 1400
    # the rows went to PATH only
    assert sorted(p.name for p in out.iterdir()) == ["suite.json"]
    assert sorted(p.name for p in ROOT.glob("*.json")) == listing
    assert suite_json.read_bytes() == before
