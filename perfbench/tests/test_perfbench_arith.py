"""The idle-share, percentile, rate and work arithmetic on synthetic
events and shapes."""

import math

import pytest

from perfbench import harness, trace, work


def _window(times, gaps=None, iters=10):
    reqs, t = [], 0.0
    for i, d in enumerate(times):
        t += (gaps or {}).get(i, 0.0)
        reqs.append(harness.Request(t, t + d, iters, None, None))
        t += d
    return harness.Window(reqs, 0.0, t, 1.5)


def _e2e(name, win):
    return harness.reader("e2e", name).read(win)


def test_rate_and_p95_see_a_stall():
    steady = _window([0.05] * 200)
    assert _e2e("graph_iters_per_s", steady) == pytest.approx(200.0)
    assert _e2e("solve_ms_p95", steady) == pytest.approx(50.0)
    stalled = _window([0.05] * 189 + [0.5] * 11)
    assert _e2e("graph_iters_per_s", stalled) < 200.0
    assert _e2e("solve_ms_p95", stalled) == pytest.approx(500.0)
    # a stall between requests counts against the rate too
    idle = _window([0.05] * 200, gaps={100: 1.0})
    assert _e2e("graph_iters_per_s", idle) == pytest.approx(2000 / 11.0)
    assert _e2e("setup_s", steady) == 1.5


def test_nearest_rank():
    vals = list(range(1, 101))
    assert harness.nearest_rank(vals, 0.95) == 95
    assert harness.nearest_rank(vals, 0.5) == 50
    assert harness.nearest_rank([7.0], 0.95) == 7.0


def test_idle_share_and_launches():
    device = [("gemm_nt<64>", 10.0, 20.0), ("band_substitute", 15.0, 30.0),
              ("elementwise", 50.0, 60.0), ("outside", 120.0, 130.0),
              ("band_assemble_tiles", 95.0, 105.0)]
    host = [(trace.SLICE, 0.0, 100.0),
            (trace.LAYER_PREFIX + "system_values", 30.0, 50.0),
            ("aten::mul", 32.0, 48.0), ("cudaLaunchKernel", 44.0, 45.0),
            ("cudaLaunchKernelExC", 5.0, 6.0), ("cudaLaunchKernel", 110.0,
                                                 111.0)]
    s = trace.reduce(device, host)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(35e-6)
    assert s.launches == 2
    assert s.device_s["band_assemble_tiles"] == pytest.approx(5e-6)
    t, hit = s.kernel_s(("gemm_nt",))
    assert hit and t == pytest.approx(10e-6)
    assert s.kernel_s(("gemm",)) == (0, False)
    assert s.idle_by_host["system_values / aten::mul"] == pytest.approx(
        20e-6)
    assert sum(s.idle_by_host.values()) == pytest.approx(65e-6)
    s.iterations = 5
    cfg = harness.load_config("intel-1728")
    idle = harness.reader("metrics", "device_idle_share").read(s, cfg)
    assert idle == pytest.approx(0.65)
    assert harness.reader("metrics", "launches_per_iter").read(s, cfg) == 0.4
    ops = harness.reader("metrics", "torch_ops_ms_per_iter").read(s, cfg)
    assert ops == pytest.approx(1e3 * 10e-6 / 5)
    fac = harness.reader("metrics", "factor_roofline").read(s, cfg)
    w = cfg["work"]
    assert fac == pytest.approx(
        100 * work.bound_s(w["factor_flops"], w["factor_bytes"]) * 5 / 10e-6)
    mfu = harness.reader("metrics", "step_mfu").read(s, cfg)
    assert mfu == pytest.approx(
        100 * work.step_flops(w) * 5 / 100e-6 / 67e12)


def test_reader_finds_nothing_returns_none():
    s = trace.reduce([("elementwise", 1.0, 2.0)], [(trace.SLICE, 0.0, 4.0)])
    s.iterations = 3
    cfg = harness.load_config("intel-1728")
    for name in ("factor_roofline", "subst_roofline", "assembly_roofline"):
        assert harness.reader("metrics", name).read(s, cfg) is None
    empty = trace.reduce([], [(trace.SLICE, 0.0, 4.0)])
    empty.iterations = 3
    assert harness.reader("metrics", "device_idle_share").read(
        empty, cfg) is None


def test_work_counts_against_hand_sums():
    nb, kb, kept = 3, 128, 1000
    chol, trsm, syrk = kb**3 / 3, kb**3, kb**3
    assert work.factor_flops(nb, kb) == pytest.approx(
        sum(chol for _ in range(nb)) + sum(trsm + syrk for _ in range(nb - 1)))
    tri, coup = kb * kb, 2 * kb * kb
    assert work.subst_flops(nb, kb) == pytest.approx(
        2 * (nb * tri + (nb - 1) * coup))
    band = 4 * nb * kb * 2 * kb
    assert work.factor_bytes(nb, kb) == 2 * band
    assert work.subst_bytes(nb, kb) == band + 2 * 4 * nb * kb
    assert work.assembly_bytes(nb, kb, kept) == 4 * kept + band
    assert work.linearize_flops(10, 2, 1) == 600 * 10 + 400 * 2 + 6000
    assert work.bound_s(67e12, 1.0) == pytest.approx(1.0)
    assert work.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    assert math.isclose(work.step_flops(work.counts(nb, kb, kept, 10, 0, 0)),
                        work.factor_flops(nb, kb) + work.subst_flops(nb, kb)
                        + 6000)
