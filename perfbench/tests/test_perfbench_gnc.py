"""The robust cell ``intel-gnc10-fleet16``: its generator's false
closures, its reference (``reference/gnc_lm.py``) against the port's
LM-GNC on the CPU, the agreement of its files, a whole run of the cell at
a small size, and on the card its controls."""

import numpy as np
import pytest
import torch

from perfbench import calibrate, check, harness, work

CELL = "intel-gnc10-fleet16"
# a 60-pose corridor with 10% garbage closures, and a fleet of 3 over a
# pool of 6 for a whole run on the CPU
SMALL = dict(poses=60, closures=100, max_span=20)
SMALL_TRAFFIC = dict(fleet=3, pool=6)


def _plan(small=True):
    p = harness.plan(CELL)
    if small:
        p["config"] = {**p["config"], **SMALL}
        p["traffic"] = {**p["traffic"], **SMALL_TRAFFIC}
    return p


def _struct(cfg):
    return harness.generator(cfg).structure(cfg)


def test_false_closures_keep_the_counts_and_the_band():
    """1728 poses, 4830 edges, 310 of the 3103 closures false, no
    odometry edge touched, the edges and so the band (kb 512, nb 11) of
    intel-1728; the same structure every call."""
    cfg = _plan(small=False)["config"]
    s, again = _struct(cfg), _struct(cfg)
    clean = _struct(harness.load_config("intel-1728"))
    f, fc = s["fields"], clean["fields"]
    fr, to = f["pp_from"], f["pp_to"]
    assert len(s["truth"]) == 1728 and len(fr) == 4830
    odo = np.abs(to - fr) == 1
    assert odo.sum() == 1727 and (~odo).sum() == 3103
    assert s["outlier"].sum() == 310 and not (s["outlier"] & odo).any()
    assert np.array_equal(fr, fc["pp_from"]) and np.array_equal(
        to, fc["pp_to"])
    assert np.array_equal(f["pp_z"][~s["outlier"]],
                          fc["pp_z"][~s["outlier"]])
    assert not np.isclose(f["pp_z"][s["outlier"]],
                          fc["pp_z"][s["outlier"]]).all(-1).any()
    assert (np.abs(f["pp_z"][s["outlier"], :2]) <= 15.0).all()
    for k, v in s["fields"].items():
        assert np.array_equal(v, again["fields"][k]), k
    assert np.array_equal(s["outlier"], again["outlier"])
    lay = work._layout_of(cfg)
    assert (lay["kb"], lay["nb"]) == (512, 11)
    assert lay == cfg["layout"] == harness.load_config("intel-1728")["layout"]


def test_reference_chi2_is_the_inliers():
    """The reference's chi^2 is 0 at the ground truth (the inliers'
    measurements are exact) and its plain trace starts at every edge's."""
    cfg = _plan()["config"]
    s = _struct(cfg)
    ref = harness.reference(cfg).Problem(s, "cpu", "f64")
    truth = torch.as_tensor(s["truth"])
    assert ref.chi2(truth) < 1e-18
    _, trace = ref.solve(truth, 1)
    assert trace[0] > 1e3


def test_config_options_match_the_traffic():
    """The configuration's robust settings, which the reference reads, are
    the options the traffic hands the program."""
    p = _plan(small=False)
    opts = p["traffic"]["options"]
    assert opts == {"robust": p["config"]["robust"],
                    "robust_delta": p["config"]["robust_delta"]}
    assert p["traffic"]["solver"] == "lm"


def _port_graph(struct, guesses):
    from rustrobotics_tpu_torch.mapping.g2o import graph_from_numpy
    from rustrobotics_tpu_torch.mapping.pgo import stack_graphs

    graphs = [graph_from_numpy({**struct["fields"], "poses2": g.numpy()},
                               struct["total_dof"], struct["prior2"],
                               struct["prior3"], device="cpu",
                               dtype=torch.float64) for g in guesses]
    return graphs[0], (graphs[0] if len(graphs) == 1
                       else stack_graphs(graphs))


@pytest.mark.parametrize("fleet", [1, 3])
def test_reference_matches_port_lm_gnc(fleet):
    """f64 on the CPU, a 60-pose corridor with 10% garbage closures: the
    reference and the port's make_optimize (one graph) or
    make_optimize_batch (a fleet of 3), LM 20 with gnc-gm, give the same
    chi^2 trace (1e-6 relative: the port takes mu's exponent in f32) and
    final poses, which reject the outliers (inlier chi^2 near 0)."""
    from rustrobotics_tpu_torch.mapping import pgo

    p = _plan()
    cfg, t = p["config"], p["traffic"]
    s = _struct(cfg)
    pool = harness.generator(cfg).guesses(cfg, s, 2**31 + 41, fleet,
                                          "cpu").double()
    template, graph = _port_graph(s, pool)
    make = pgo.make_optimize if fleet == 1 else pgo.make_optimize_batch
    out, errors, _ = make(template, num_iterations=t["num_iterations"],
                          solver="lm", tolerance=0.0, backend="dense",
                          device="cpu", **t["options"])(graph)
    ref = harness.reference(cfg).Problem(s, "cpu", "f64")
    poses = out.poses2.reshape(fleet, -1, 3)
    errors = errors.reshape(fleet, -1)
    for i in range(fleet):
        rp, rt = ref.solve(pool[i], t["num_iterations"])
        np.testing.assert_allclose(errors[i].numpy(), rt, rtol=1e-6)
        assert float((poses[i] - rp).abs().max()) < 1e-6
        assert ref.chi2(poses[i]) < 1e-6 and ref.chi2(rp) < 1e-6


def test_small_run_is_correct():
    """A whole run of the cell at the small size on the CPU (the program
    in f32 against the f64 reference) is judged correct, every row of a
    fleet of 3 compared."""
    r = harness.run_cell(_plan(), 2**31 + 5, 0.3, False, "cpu",
                         log=lambda s: None)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"graph_iters_per_s", "setup_s"}


@pytest.mark.cuda
def test_controls_fail_on_card():
    """At the cell's own size, on three seeds: the program's answers pass
    the limits and each TF32 control's fail them, every row of the
    requests a run compares."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _plan(small=False)
    limits = p["workload"]["limits"]
    seeds = [2**31 + 311, 2**31 + 312, 2**31 + 313]
    device = torch.device("cuda", 0)
    for numbers in calibrate.readings(p, seeds, device).values():
        assert check.judge(numbers, limits)[0], numbers
    for control in ("tf32", "tf32-cholesky"):
        for numbers in calibrate.readings(p, seeds, device, control).values():
            assert not check.judge(numbers, limits)[0], (control, numbers)
