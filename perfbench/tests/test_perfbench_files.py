"""Every file BENCHMARK.json names loads, the harness resolves a cell by
name, and a configuration, cell or metric dropped into its folder is found
without an edit to the harness."""

import json
import shutil
import subprocess
import sys

from perfbench import harness, work

ROOT = harness.ROOT


def test_spec_files_load():
    spec = harness.load_spec()
    for c in spec["configs"]:
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        harness.generator(cfg)
        harness.reference(cfg)
    for w in spec["workloads"]:
        p = harness.plan(w["name"], spec)
        assert p["workload"]["config"] == w["config"]
        assert p["workload"]["traffic"] == w["traffic"]
        assert p["workload"]["why"] == w["why"]
        assert set(p["workload"]["limits"]) <= set(harness.check.NAMES)
        assert {m["source"] for m in p["end_to_end"]} == {"host_clock"}
        assert "setup_s" in {m["name"] for m in p["end_to_end"]}
        assert p["per_layer"]
    for kind, entries in (("e2e", spec["end_to_end"]),
                          ("metrics", spec["per_layer"])):
        for m in entries:
            assert callable(harness.reader(kind, m["name"]).read)


def test_every_cell_file_resolves():
    for path in (harness.PKG / "workloads").glob("*.json"):
        p = harness.plan(path.stem)
        assert p["workload"]["name"] == path.stem
        assert set(p["workload"]["limits"]) <= set(harness.check.NAMES)
        harness.generator(p["config"])
        harness.reference(p["config"])


def test_every_metric_file_is_named():
    spec = harness.load_spec()
    for kind, entries in (("e2e", spec["end_to_end"]),
                          ("metrics", spec["per_layer"])):
        files = {p.stem for p in (harness.PKG / kind).glob("*.py")}
        assert files == {m["name"] for m in entries}


def test_config_work_counts_follow_layout():
    for path in (harness.PKG / "configs").glob("*.json"):
        cfg = harness.load_json(path)
        lay = cfg["layout"]
        assert cfg["work"] == work.counts(lay["nb"], lay["kb"], lay["kept"],
                                          lay["n_pp"], lay["n_pl"],
                                          lay["n_qq"])
        s = harness.generator(cfg).structure(cfg)
        f = s["fields"]
        assert (len(f["pp_from"]), len(f["pl_pose"]), len(f["qq_from"])) == (
            lay["n_pp"], lay["n_pl"], lay["n_qq"])
        assert s["total_dof"] == lay["n"]
        assert lay["n_pp"] + lay["n_qq"] == cfg["published"]["edges"]


NEW_METRIC = '''
def read(window):
    times = sorted(1e3 * (r.end - r.start) for r in window.requests)
    return times[len(times) // 2]
'''

NEW_LAYER = '''
def read(s, config):
    return s.busy_s or None
'''

PROBE = '''
import json
from perfbench import harness, kernels, trace
p = harness.plan("intel-tiny")
r = harness.run_cell(p, 3, 0.2, False, "cpu", log=lambda s: None)
fleet = harness.plan("intel-tiny-fleet")
rf = harness.run_cell(fleet, 5, 0.2, False, "cpu", log=lambda s: None)
names = kernels.FACTOR + kernels.SUBST + kernels.ASSEMBLY + ("elementwise",)
device = [(n, 10.0 * k, 10.0 * k + 5.0) for k, n in enumerate(names)]
host = [(trace.SLICE, 0.0, 100.0), ("cudaLaunchKernel", 1.0, 2.0)]
s = trace.reduce(device, host)
s.iterations = 2
layer = {m["name"]: harness.reader("metrics", m["name"]).read(s, p["config"])
         for m in p["per_layer"]}
print(json.dumps({"e2e": sorted(r["metrics"]), "layer": layer,
                  "poses": p["config"]["poses"], "correct": r["correct"],
                  "fleet_e2e": sorted(rf["metrics"]),
                  "fleet_traffic": fleet["traffic"],
                  "fleet_checks": rf["checks"],
                  "fleet_correct": rf["correct"]}))
'''


def test_new_files_found_without_code_edit(tmp_path):
    """A new configuration, cell and two metric readers are files; the
    cell's entry in BENCHMARK.json and its name in the lists of the
    per-layer metrics it reports are data. The new cell then reports the
    existing per-layer metrics, a new one that lists it, and a new one
    without a list (by the end-to-end metric it moves), whose name holds
    a dot. A fleet traffic file, with optimizer options, and a cell that
    runs it are files too, and the fleet cell runs correct; no file
    already in perfbench/ changes."""
    shutil.copytree(harness.PKG, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    pkg = tmp_path / "perfbench"
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    cfg = harness.load_config("intel-1728")
    cfg.update(name="intel-tiny-cfg", poses=48, closures=60, max_span=16)
    (pkg / "configs" / "intel-tiny-cfg.json").write_text(json.dumps(cfg))
    cell = harness.load_json(pkg / "workloads" / "intel-solve.json")
    cell.update(name="intel-tiny", config="intel-tiny-cfg")
    (pkg / "workloads" / "intel-tiny.json").write_text(json.dumps(cell))
    fleet_traffic = harness.load_json(pkg / "traffic" / "closed-gn10.json")
    fleet_traffic.update(fleet=2, pool=4, options={"cg_tol": 1e-6})
    (pkg / "traffic" / "closed-fleet2-tiny.json").write_text(
        json.dumps(fleet_traffic))
    cell.update(name="intel-tiny-fleet", traffic="closed-fleet2-tiny")
    (pkg / "workloads" / "intel-tiny-fleet.json").write_text(
        json.dumps(cell))
    (pkg / "e2e" / "solve_ms_p50.py").write_text(NEW_METRIC)
    (pkg / "metrics" / "busy_s.tiny.py").write_text(NEW_LAYER)
    (pkg / "metrics" / "busy_seconds.py").write_text(NEW_LAYER)
    spec = harness.load_spec()
    existing = [m["name"] for m in spec["per_layer"]]
    for m in spec["per_layer"]:
        m["workloads"].append("intel-tiny")
    spec["configs"].append({"name": "intel-tiny-cfg", "source": "test",
                            "file": "perfbench/configs/intel-tiny-cfg.json",
                            "reduced": ["poses"], "why": "test"})
    spec["workloads"].append({"name": "intel-tiny", "config":
                              "intel-tiny-cfg", "traffic": "closed-gn10",
                              "chips": 1, "why": "test"})
    spec["workloads"].append({"name": "intel-tiny-fleet", "config":
                              "intel-tiny-cfg", "traffic":
                              "closed-fleet2-tiny", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "solve_ms_p50", "unit": "ms",
                               "better": "lower", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["intel-tiny"]})
    spec["per_layer"].append({"name": "busy_seconds", "unit": "s",
                              "better": "lower", "source": "device_trace",
                              "layer": "device", "moves": "graph_iters_per_s",
                              "workloads": ["intel-tiny"]})
    spec["per_layer"].append({"name": "busy_s.tiny", "unit": "s",
                              "better": "lower", "source": "device_trace",
                              "layer": "device", "moves": "solve_ms_p50"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    env_path = f"{tmp_path}:{ROOT}"
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(got["layer"]) == existing + ["busy_seconds", "busy_s.tiny"]
    assert all(v is not None and v > 0 for v in got["layer"].values())
    assert got["e2e"] == ["graph_iters_per_s", "setup_s", "solve_ms_p50"]
    assert got["poses"] == 48 and got["correct"]
    assert got["fleet_e2e"] == ["graph_iters_per_s", "setup_s"]
    assert got["fleet_traffic"] == fleet_traffic
    assert got["fleet_correct"], got["fleet_checks"]
    assert all(p.read_bytes() == b for p, b in before.items())
