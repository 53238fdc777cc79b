"""The port's measurement layer against the JAX package's: configuration,
phase timers and optimizer metrics, checkpoints (the same file format,
restored across the two packages), the sanitizers, the FLOP models and
MFU, card timing on its CPU contract, and the package exports. f64 on the
CPU; the FLOP models are equal, checkpoints restore bit for bit."""

import importlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustrobotics_tpu_torch
from rustrobotics_tpu import roofline as jroof
from rustrobotics_tpu.config import FilterConfig as JFilterConfig
from rustrobotics_tpu.config import PGOConfig as JPGOConfig
from rustrobotics_tpu.mapping import assemble as jasm
from rustrobotics_tpu.mapping.synthetic import (
    synthetic_corridor_graph_2d,
    synthetic_pose_graph_2d,
)
from rustrobotics_tpu.ops import band_chol as jband
from rustrobotics_tpu.utils import checkpoint as jck
from rustrobotics_tpu_torch import roofline as troof
from rustrobotics_tpu_torch.config import FilterConfig, PGOConfig, from_dict
from rustrobotics_tpu_torch.mapping import assemble as tasm
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    graph_from_numpy,
)
from rustrobotics_tpu_torch.mapping.pgo import global_error, optimize
from rustrobotics_tpu_torch.ops import band_chol as tband
from rustrobotics_tpu_torch.utils import devtime
from rustrobotics_tpu_torch.utils.checkpoint import (
    CheckpointingOptimizer,
    restore_checkpoint,
    save_checkpoint,
)
from rustrobotics_tpu_torch.utils.debug import (
    assert_finite,
    check_covariance,
    checked,
)
from rustrobotics_tpu_torch.utils.metrics import (
    OptimizerMetrics,
    PhaseTimer,
    xla_trace,
)


def to_port(ref):
    fields = {n: np.asarray(getattr(ref, n))
              for n in FLOAT_FIELDS + INDEX_FIELDS}
    return graph_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                            device="cpu")


def assert_graph_equal(port, ref):
    for name in FLOAT_FIELDS + INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(port, name).cpu().numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("total_dof", "prior2", "prior3"):
        assert getattr(port, name) == getattr(ref, name)


def test_config_layer():
    cfg = PGOConfig()
    assert cfg.tolerance == 1e-4 and cfg.lambda0 == 0.01  # reference values
    cfg2 = cfg.replace(backend="dense")
    assert cfg2.backend == "dense" and cfg.backend == "host"
    assert hash(cfg) != hash(cfg2)  # hashable
    fc = from_dict(FilterConfig, {"algo": "pf", "num_particles": 64})
    assert fc.num_particles == 64
    with pytest.raises(ValueError, match="unknown PGOConfig keys"):
        from_dict(PGOConfig, {"bogus": 1})
    # the same fields and defaults as the JAX package's
    for port, ref in ((PGOConfig, JPGOConfig), (FilterConfig, JFilterConfig)):
        assert port().__dict__ == ref().__dict__


def test_phase_timer():
    t = PhaseTimer()
    x = torch.zeros(1000)
    with t.phase("op", block_on=x):
        y = x + 1
    with t.phase("op", block_on={"y": (y, [y])}):
        time.sleep(0.01)
    s = t.summary()
    assert s["op"]["count"] == 2
    assert s["op"]["total_s"] >= 0.01
    assert s["op"]["mean_ms"] == pytest.approx(1e3 * s["op"]["total_s"] / 2)


def test_optimizer_metrics_callback():
    g = to_port(synthetic_pose_graph_2d(num_poses=24, num_landmarks=2,
                                        noise=0.1))
    m = OptimizerMetrics()
    optimize(g, num_iterations=5, backend="dense", callback=m.callback,
             device="cpu")
    d = m.as_dict()
    assert len(d["chi2"]) >= 2 and len(d["lam"]) == len(d["chi2"])
    assert d["chi2"][-1] < d["chi2"][0]


def test_xla_trace_writes_a_trace(tmp_path):
    with xla_trace(tmp_path / "trace") as prof:
        torch.ones(64).cumsum(0)
    assert list((tmp_path / "trace").glob("*.json"))
    assert any("cumsum" in e.key for e in prof.key_averages())


def test_checkpoint_roundtrip(tmp_path):
    g = to_port(synthetic_pose_graph_2d(num_poses=16, num_landmarks=2))
    p = save_checkpoint(tmp_path / "snap.npz", g, step=7)
    g2, step = restore_checkpoint(p, g)
    assert step == 7
    np.testing.assert_array_equal(g.poses2.numpy(), g2.poses2.numpy())
    np.testing.assert_array_equal(g.pp_z.numpy(), g2.pp_z.numpy())
    assert g2.total_dof == g.total_dof
    # nested containers keep their structure, dtypes and numbers
    tree = {"b": (torch.arange(3), [np.ones(2, np.float32), 2.5]),
            "a": torch.eye(2, dtype=torch.float64), "c": None}
    out, step = restore_checkpoint(save_checkpoint(tmp_path / "t.npz", tree),
                                   tree)
    assert step is None and out["c"] is None
    assert torch.equal(out["a"], tree["a"]) and out["b"][0].dtype == torch.long
    assert out["b"][1][0].dtype == np.float32 and out["b"][1][1] == 2.5
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path / "t.npz", {"a": torch.zeros(1)})


def test_checkpoint_crosses_packages(tmp_path):
    ref = synthetic_pose_graph_2d(num_poses=16, num_landmarks=2)
    port = to_port(ref)
    # written by JAX, restored by the port
    p = jck.save_checkpoint(tmp_path / "jax.npz", ref, step=3)
    got, step = restore_checkpoint(p, port)
    assert step == 3 and got.pp_from.dtype == torch.long
    assert_graph_equal(got, ref)
    # written by the port, restored by JAX
    moved = port.replace(poses2=port.poses2 + 0.5)
    p = save_checkpoint(tmp_path / "port.npz", moved, step=4)
    back, step = jck.restore_checkpoint(p, ref)
    assert step == 4 and back.pp_from.dtype == ref.pp_from.dtype
    assert_graph_equal(moved, back)


def test_checkpointing_optimizer_resumes(tmp_path):
    g = to_port(synthetic_pose_graph_2d(num_poses=48, num_landmarks=4,
                                        noise=0.1))
    opt = CheckpointingOptimizer(tmp_path, every=2)
    res1 = opt.optimize(g, num_iterations=3, backend="host", tolerance=0.0,
                        device="cpu")
    assert opt.latest() is not None
    assert opt.latest().name == "pgo_000003.npz"
    assert (tmp_path / "pgo_000002.npz").exists()
    # resume continues from the snapshot, not from scratch
    res2 = opt.optimize(g, num_iterations=6, backend="host", tolerance=0.0,
                        device="cpu")
    assert res2.iterations <= 3
    assert float(global_error(res2.graph)) <= res1.errors[-1] + 1e-9
    assert res2.errors[0] == pytest.approx(res1.errors[-1], rel=1e-12)


def test_debug_sanitizers():
    # a NaN made anywhere inside the function raises
    def bad(x):
        return torch.sqrt(x)  # NaN for negative input

    f = checked(bad)
    f(torch.tensor(4.0))  # fine
    with pytest.raises(FloatingPointError, match="nan"):
        f(torch.tensor(-1.0))
    with pytest.raises(FloatingPointError, match="aten.log"):
        checked(lambda x: torch.log(x).sum() * 0.0)(torch.tensor([0.0, 1.0]))

    # covariance invariant
    def with_cov(c):
        check_covariance(c)
        return c.sum()

    g = checked(with_cov)
    g(torch.eye(3))
    with pytest.raises(Exception, match="symmetric"):
        g(torch.tensor([[1.0, 2.0], [0.0, 1.0]]))
    with pytest.raises(ValueError, match="diagonal negative"):
        check_covariance(torch.tensor([[-1.0, 0.0], [0.0, 1.0]]))

    # host-side nested check
    assert_finite({"a": torch.ones(3)})
    with pytest.raises(FloatingPointError, match=r"\['a'\]"):
        assert_finite({"a": torch.tensor([1.0, float("nan")])})


def corridor(num_poses, num_landmarks, span):
    return synthetic_corridor_graph_2d(num_poses, num_landmarks=num_landmarks,
                                       closure_span=span, seed=1)


@pytest.fixture(scope="module")
def layouts():
    out = []
    for args in ((96, 3, 16), (200, 4, 32), (400, 0, 64)):
        ref = corridor(*args)
        port = to_port(ref)
        jbl = jband.build_band_chol(jasm.build_layout(ref))
        tbl = tband.build_band_chol(tasm.build_layout(port))
        out.append((ref, port, jbl, tbl))
    return out


def test_flop_models_match_jax(layouts):
    for ref, port, jbl, tbl in layouts:
        assert (tbl.kb, tbl.nb) == (jbl.kb, jbl.nb)
        n, kb, nb = ref.total_dof, tbl.kb, tbl.nb
        for name in ("banded_solve_flops", "banded_cr_flops",
                     "banded_pallas_flops", "banded_mixed_flops"):
            assert getattr(troof, name)(n, kb, nb) == \
                getattr(jroof, name)(n, kb, nb), name
        assert troof.banded_mixed_flops(n, kb, nb, rounds=27) == \
            jroof.banded_mixed_flops(n, kb, nb, rounds=27)
        assert troof.dense_solve_flops(n) == jroof.dense_solve_flops(n)
        assert troof.schur_solve_flops(n - 8, 4) == \
            jroof.schur_solve_flops(n - 8, 4)
        assert troof.linearize_flops(10, 3, 2) == \
            jroof.linearize_flops(10, 3, 2)


@pytest.mark.parametrize("backend", ["banded-direct", "banded-cr",
                                     "banded-pallas", "banded-mixed",
                                     "schur", "dense", "host", "cg"])
def test_pgo_iteration_flops_match_jax(layouts, backend):
    for ref, port, jbl, tbl in layouts:
        for jl, tl in ((jbl, tbl), (None, None)):
            assert troof.pgo_iteration_flops(port, backend, tl) == \
                jroof.pgo_iteration_flops(ref, backend, jl)


def test_banded_kernel_counts_the_fused_chain(layouts):
    for ref, port, jbl, tbl in layouts:
        assert troof.pgo_iteration_flops(port, "banded-kernel", tbl) == \
            troof.pgo_iteration_flops(port, "banded-pallas", tbl) == \
            jroof.linearize_flops(ref.pp_from.shape[0], ref.pl_pose.shape[0],
                                  0) + jroof.banded_pallas_flops(
                ref.total_dof, jbl.kb, jbl.nb)


def test_mfu_and_peaks():
    assert troof.mfu(1e12, "cpu") is None
    assert troof.mfu(6.7e12, "cuda") == pytest.approx(0.1)
    assert troof.PEAK_F32["cuda"] == troof.PEAK_F32_FLOPS == 67e12
    assert troof.PEAK_HBM_BYTES == 3.35e12
    assert troof.mfu(1e12, "tpu") is None


def test_devtime_cpu_contract():
    x = torch.arange(4.0)
    assert devtime.fetch(x) is x
    tree = {"a": [x, (x,)]}
    assert devtime.fetch(tree) is tree and devtime.fetch({}) == {}
    rtt = devtime.scalar_fetch_rtt(samples=3, device="cpu")
    assert 0 < rtt < 1.0

    def prog(v, reps=50):
        for _ in range(reps):
            v = torch.sin(v)
        return v.sum()

    per = devtime.time_scalar_program(prog, x, reps=50, calls=2, rtt=rtt)
    assert 0 < per < 0.05
    # a program that sleeps: per-body time at least the sleep
    slow = devtime.time_scalar_program(
        lambda v: (time.sleep(0.02), v.sum())[1], x, reps=2, calls=1,
        rtt=0.0)
    assert slow >= 0.01


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        devtime.scalar_fetch_rtt()


def test_package_exports():
    from rustrobotics_tpu_torch import geometry, ops
    from rustrobotics_tpu_torch.utils.state import GaussianState

    assert rustrobotics_tpu_torch.__version__ == "0.1.0"
    assert rustrobotics_tpu_torch.GaussianState is GaussianState
    assert geometry.se2 is importlib.import_module(
        "rustrobotics_tpu_torch.geometry.se2")
    assert geometry.se3 is importlib.import_module(
        "rustrobotics_tpu_torch.geometry.se3")
    from rustrobotics_tpu_torch.ops import native_solver

    assert ops.native_available is native_solver.native_available
    assert ops.solve_coo_native is native_solver.solve_coo_native
    import rustrobotics_tpu_torch.parallel as par

    for name in ("make_mesh", "make_mesh_2d", "distributed_gn_step",
                 "distributed_global_error", "distributed_optimize",
                 "pad_edges_for_sharding", "sharded_pf_step"):
        assert callable(getattr(par, name))
    assert jnp is not None  # the JAX side is importable beside the port
