"""The port's CLI (``python -m rustrobotics_tpu_torch.cli``) and examples
(``rustrobotics_tpu_torch/examples/``) against the JAX package's on the
CPU, on the same inputs written to ``tmp_path``: the block tests' noisy
circle graph as a g2o file, a SLAM-course log and a UTIAS dataset from
``chip_smoke``'s writers.

Both CLIs run with ``--x64 --cpu`` (float64 for pgo's graph and the
landmark replay, float32 elsewhere, as the JAX CLI's x64 mode gives it)
and print their results rounded; the printed results of the
deterministic commands are equal: ``pgo``
(banded-direct, ``--distributed 1``, ``--distributed 2 --replicas 2``,
the port's as 4 gloo ranks launched as torchrun launches them),
``pendulum``, ``slam`` (EKF-SLAM) and ``landmarks`` (EKF). The
simulation of ``localization`` draws its noise from a ``torch.Generator``
where JAX draws from its keys: fed the JAX key tree's draws, the port's
prints the JAX CLI's line; on its own draws both are held to the same
bounds (the filter beats dead reckoning by 2x). The JAX CLI runs
in-process on the test's virtual CPU devices.
"""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from rustrobotics_tpu import cli as jax_cli
from rustrobotics_tpu_torch import cli
from test_torch_block_step import graph_inputs, jax_graphs
from test_torch_blocks_worker import graph_of

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "rustrobotics_tpu_torch" / "examples"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cs = _chip_smoke()
    graph = graph_of(graph_inputs({"circle": jax_graphs(d)["circle"]}),
                     "circle")
    (d / "circle.g2o").write_text(cs.g2o_text(cs.graph_spec(graph)))
    (d / "slam").mkdir()
    path, landmarks = cs.slam_course_world(60, 6)
    cs.write_slam_course(d / "slam", path, landmarks, seed=0)
    (d / "utias").mkdir()
    cs.write_utias(d / "utias", seed=0, duration=20.0)
    return d


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def _line(out, prefix):
    lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    assert lines, out
    return lines[-1]


@pytest.mark.parametrize("argv,prefix", [
    (["--backend", "banded-direct"], "final error:"),
    (["--distributed", "1"], "converged in"),
    (["--distributed", "1", "--solver", "lm"], "converged in"),
    (["--distributed", "1", "--schur", "--cg-variant", "classic"],
     "converged in"),
])
def test_pgo_prints_jax_results(data, capsys, argv, prefix):
    args = ["pgo", "--file", str(data / "circle.g2o"), "--iterations", "5",
            "--x64", "--cpu", *argv]
    want = _line(_run(jax_cli.main, args, capsys), prefix)
    got = _line(_run(cli.main, args, capsys), prefix)
    assert got == want
    assert float(want.split()[-1]) > 1.0  # a χ² above rounding


def test_pgo_replicas_under_a_launcher_prints_jax_results(data, capsys):
    """``--distributed 2 --replicas 2`` on 4 ranks started as torchrun
    starts them (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): rank 0 prints
    the replicas' final χ² and the best one, as the JAX CLI does on a 2 x 2
    mesh of its devices."""
    args = ["pgo", "--file", str(data / "circle.g2o"), "--iterations", "4",
            "--x64", "--cpu", "--distributed", "2", "--replicas", "2"]
    port = cli._free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rustrobotics_tpu_torch.cli", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="4",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 OMP_NUM_THREADS="1"))
        for r in range(4)]
    try:
        out = _run(jax_cli.main, args, capsys)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for prefix in ("per-replica final chi2:", "best replica"):
        assert _line(logs[0], prefix) == _line(out, prefix)
        for log in logs[1:]:
            assert prefix not in log  # only rank 0 prints
    assert "2 replicas x 2 blocks on cpu" in logs[0]


def test_pendulum_prints_jax_results(capsys):
    args = ["pendulum", "--x64", "--cpu"]
    want = _line(_run(jax_cli.main, args, capsys), "final state:")
    assert _line(_run(cli.main, args, capsys), "final state:") == want


def test_slam_ekf_prints_jax_results(data, capsys):
    args = ["slam", "--dataset", str(data / "slam"), "--x64", "--cpu"]
    want = _line(_run(jax_cli.main, args, capsys), "EKF-SLAM over")
    assert _line(_run(cli.main, args, capsys), "EKF-SLAM over") == want


def test_landmarks_ekf_prints_jax_results(data, capsys):
    args = ["landmarks", "--dataset", str(data / "utias"), "--events", "400",
            "--x64", "--cpu"]
    want = _line(_run(jax_cli.main, args, capsys), "ekf:")
    got = _line(_run(cli.main, args, capsys), "ekf:")
    # "ekf: N events in S s, ATE A m": the time differs
    assert re.sub(r"in [0-9.]+s", "", got) == re.sub(r"in [0-9.]+s", "",
                                                     want)


def _jax_simulation_draws(seed, steps):
    """The EKF's draws of the JAX package's run_simulation(key(seed)) in
    float32, by its own key tree: each step's key splits into the
    observation's and the filter's, the observation's into the GPS's and
    the input's."""
    import jax
    import jax.numpy as jnp
    import torch

    def per_step(k):
        k_gps, k_u = jax.random.split(jax.random.split(k)[0])
        return (jax.random.normal(k_gps, (2,), dtype=jnp.float32),
                jax.random.normal(k_u, (2,), dtype=jnp.float32))

    gps, inp = jax.vmap(per_step)(jax.random.split(jax.random.key(seed),
                                                   steps))
    return {"gps": torch.tensor(np.asarray(gps)),
            "input": torch.tensor(np.asarray(inp))}


def test_localization_prints_jax_results(capsys, monkeypatch):
    """The port's CLI with its simulation fed the JAX key tree's draws for
    the same seed (``_run_simulation``, the draws form of
    ``run_simulation``) prints the JAX CLI's ``ekf:`` line: both RMSEs
    within one unit of the print's last digit (float32 filters)."""
    from rustrobotics_tpu_torch.localization import simulation as tsim

    def replay(generator, algo, sim_time, num_particles, device):
        draws = _jax_simulation_draws(generator.initial_seed(),
                                      int(sim_time / 0.1))
        return tsim._run_simulation(draws, algo, sim_time,
                                    num_particles=num_particles,
                                    device=device)

    monkeypatch.setattr(tsim, "run_simulation", replay)
    args = ["localization", "--sim-time", "10", "--seed", "3", "--x64",
            "--cpu"]
    want = _line(_run(jax_cli.main, args, capsys), "ekf:")
    got = _line(_run(cli.main, args, capsys), "ekf:")
    nums = [[float(v) for v in re.findall(r"([0-9.]+) m", ln)]
            for ln in (got, want)]
    assert len(nums[0]) == len(nums[1]) == 2, (got, want)
    assert np.allclose(nums[0], nums[1], rtol=0, atol=1e-3), (got, want)
    assert nums[1][0] < nums[1][1] / 2  # the filter beats dead reckoning


def test_localization_meets_the_jax_bounds(capsys):
    args = ["localization", "--sim-time", "10", "--x64", "--cpu"]
    rmse = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        line = _line(_run(main, args, capsys), "ekf:")
        est, dr = (float(v) for v in re.findall(r"([0-9.]+) m", line))
        rmse[name] = (est, dr)
        assert est < dr / 2, (name, line)
    # the same noise scales: dead reckoning drifts alike
    assert 0.2 < rmse["port"][1] / rmse["jax"][1] < 5.0, rmse


def test_doctor_reports_the_host(capsys):
    out = _run(cli.main, ["doctor"], capsys)
    assert "accelerator: none" in out  # no card in this container
    assert "native C++ LDL solver:" in out
    assert "native C++ g2o parser:" in out


WRAPPERS = {
    "distributed_pgo": ("pgo", ["--file", "intel", "--distributed", "1"]),
    "inverted_pendulum": ("pendulum", []),
    "localization": ("localization", []),
    "localization_landmarks": ("landmarks", []),
    "pose_graph_optimization": ("pgo", ["--file", "intel"]),
    "slam": ("slam", []),
}


def _example(name):
    spec = importlib.util.spec_from_file_location(f"ex_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_nine_examples_mirror_the_jax_package():
    names = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert len(names) == 9
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")
                  if p.stem != "__init__") == names


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cli_wrappers_pass_their_argv(name, monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv))
    mod = _example(name)
    cmd, default = WRAPPERS[name]
    mod.main([])
    mod.main(["--cpu", "--x64"])
    assert seen == [[cmd, *default], [cmd, "--cpu", "--x64"]]


def test_pendulum_example_runs_the_cli(capsys):
    got = _line(_run(_example("inverted_pendulum").main, ["--x64", "--cpu"],
                     capsys), "final state:")
    want = _line(_run(jax_cli.main, ["pendulum", "--x64", "--cpu"], capsys),
                 "final state:")
    assert got == want


def test_camera_calibration_example_prints_jax_results(capsys):
    _example("camera_calibration").main(["--cpu"])
    got = capsys.readouterr().out
    spec = importlib.util.spec_from_file_location(
        "jax_camera_calibration", ROOT / "examples" / "camera_calibration.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    assert got == capsys.readouterr().out


def test_online_slam_and_fleet_examples_run(data, capsys):
    _example("online_slam").main(["--cpu", "--steps", "40", "--window", "8"])
    out = capsys.readouterr().out
    assert "40 odometry steps through a W=8 fixed-lag smoother on cpu" in out
    head = re.search(r"window head pose: \[([^\]]+)\]", out).group(1)
    assert np.all(np.isfinite([float(v) for v in head.split(",")]))
    _example("fleet_pgo").main(["--cpu", "--file", str(data / "circle.g2o"),
                                "--batch", "2", "--iterations", "3"])
    out = capsys.readouterr().out
    finals = re.search(r"final chi2 per robot: \[([^\]]+)\]", out).group(1)
    assert len(finals.split(",")) == 2
