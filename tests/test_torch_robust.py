"""The port's robust kernels and graduated non-convexity against the JAX
package, f64 on the CPU: the IRLS weights and losses, the robust
assembly, and every driver's robust accept test and GNC schedule.

The outlier graphs: the 96-pose corridor with ``inject_pp_outliers``'
far-apart garbage closures (copied from tests/test_robust_adaptive.py; the
dense backend), a 256-pose corridor whose own closures carry garbage
(``chip_smoke.corrupt_closures``; the band stays local, so the banded
backend runs), and the 3D sphere of tests/test_torch_se3.py."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import assemble as jasm
from rustrobotics_tpu.mapping import g2o as jg2o
from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu_torch.mapping import assemble as tasm
from rustrobotics_tpu_torch.mapping import g2o as tg2o
from rustrobotics_tpu_torch.mapping import pgo as tpgo

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = tg2o.FLOAT_FIELDS + tg2o.INDEX_FIELDS


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()


def inject_pp_outliers(graph, num, seed=0, scale=15.0):
    """Append ``num`` gross outlier SE2-SE2 edges: random far-apart pose
    pairs with garbage relative measurements at typical edge information.
    Returns (corrupted graph, inlier edge count E0)."""
    rng = np.random.default_rng(seed)
    n2 = graph.poses2.shape[0]
    e0 = graph.pp_from.shape[0]
    i = rng.integers(0, n2, num)
    j = (i + rng.integers(n2 // 4, n2 // 2, num)) % n2
    z = np.stack(
        [rng.uniform(-scale, scale, num), rng.uniform(-scale, scale, num),
         rng.uniform(-np.pi, np.pi, num)], axis=1)
    omega_med = np.median(np.asarray(graph.pp_omega), axis=0)
    omega = np.broadcast_to(omega_med, (num, 3, 3))
    dtype = graph.pp_z.dtype
    return graph.replace(
        pp_from=jnp.concatenate(
            [graph.pp_from, jnp.asarray(i, graph.pp_from.dtype)]),
        pp_to=jnp.concatenate(
            [graph.pp_to, jnp.asarray(j, graph.pp_to.dtype)]),
        pp_z=jnp.concatenate([graph.pp_z, jnp.asarray(z, dtype)]),
        pp_omega=jnp.concatenate(
            [graph.pp_omega, jnp.asarray(omega, dtype)]),
    ), e0


def to_port(ref):
    fields = {n: np.asarray(getattr(ref, n)) for n in FIELDS}
    return tg2o.graph_from_numpy(fields, ref.total_dof, ref.prior2,
                                 ref.prior3, device="cpu")


@pytest.fixture(scope="module")
def far():
    clean = synthetic_corridor_graph_2d(num_poses=96, closure_span=16)
    ref, _ = inject_pp_outliers(clean, num=16, seed=3)
    return clean, ref, to_port(ref)


def local_outliers(num_poses=256, closure_span=32, seed=5, share=0.2):
    """A corridor whose loop closures carry a share of garbage
    measurements."""
    clean = synthetic_corridor_graph_2d(num_poses, num_landmarks=4,
                                        closure_span=closure_span)
    z, mask = cs.corrupt_closures(np.asarray(clean.pp_from),
                                  np.asarray(clean.pp_to),
                                  np.asarray(clean.pp_z), seed=seed,
                                  share=share)
    assert mask.sum() >= 2
    ref = clean.replace(pp_z=jnp.asarray(z))
    return clean, ref, to_port(ref)


@pytest.fixture(scope="module")
def local():
    return local_outliers()


def assert_trace_close(got, want, rtol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    sel = ~np.isnan(want) & (want > 1e-12 * want[0])
    assert sel.sum() >= 3
    np.testing.assert_allclose(got[sel], want[sel], rtol=rtol)


# ------------------------------------------------------ weights and losses

KERNELS = {
    "huber": {},
    "cauchy": {},
    "barron-4": {"alpha": -4.0},
    "barron0": {"alpha": 0.0},
    "barron1": {"alpha": 1.0},
    "barron2": {"alpha": 2.0},
    "gnc-gm": {"mu": 5.0},
    "gnc-gm-mu1": {},
}


@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("fn", ["robust_weight", "robust_rho"])
def test_weight_and_rho_match_jax(kind, fn):
    robust = kind.rstrip("-0124").replace("-mu", "")
    c2 = np.concatenate([[0.0], np.geomspace(1e-8, 1e8, 49)])
    kw = KERNELS[kind]
    delta = 1.7
    want = getattr(jasm, fn)(robust, jnp.asarray(c2), delta, **kw)
    got = getattr(tasm, fn)(robust, torch.as_tensor(c2), delta, **kw)
    # Barron's loss at small c2 is a difference of two O(delta²) terms
    # ((c2/(δ²b) + 1)^(α/2) - 1), so its last-ulp error is absolute, on
    # the scale of delta²
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12 * delta * delta)


def test_robust_weight_families():
    c2 = torch.tensor([0.0, 1.0, 100.0, 1e6], dtype=torch.float64)
    w = tasm.robust_weight
    # barron alpha=0 ~ Cauchy shape; alpha=-2 = Geman-McClure
    np.testing.assert_allclose(w("barron", c2, 1.0, alpha=0.0),
                               1.0 / (1.0 + c2 / 2.0), rtol=1e-6)
    np.testing.assert_allclose(w("barron", c2, 1.0, alpha=-2.0),
                               (1.0 + c2 / 4.0) ** -2, rtol=1e-6)
    # alpha=2 is exactly L2
    np.testing.assert_allclose(w("barron", c2, 1.0, alpha=2.0), 1.0)
    # gnc-gm at huge mu -> L2; at mu=1 -> Geman-McClure-style weight
    np.testing.assert_allclose(w("gnc-gm", c2, 1.0, mu=1e12), 1.0, atol=1e-4)
    np.testing.assert_allclose(w("gnc-gm", c2, 1.0, mu=1.0),
                               (1.0 / (c2 + 1.0)) ** 2, rtol=1e-6)
    # weights monotonically non-increasing in c2 for every robust family
    for name, kw in [("huber", {}), ("cauchy", {}),
                     ("barron", {"alpha": -2.0}), ("gnc-gm", {"mu": 5.0})]:
        assert np.all(np.diff(w(name, c2, 1.0, **kw).numpy()) <= 1e-12), name
    # a fleet's mu: one per row
    mu = torch.tensor([1.0, 5.0], dtype=torch.float64)
    rows = w("gnc-gm", c2.expand(2, 4), 1.0, mu=mu)
    for i in range(2):
        torch.testing.assert_close(rows[i], w("gnc-gm", c2, 1.0, mu=mu[i]))
    with pytest.raises(ValueError, match="robust"):
        w("tukey", c2, 1.0)


@pytest.mark.parametrize("robust,edges", [("cauchy", "closures"),
                                          ("gnc-gm", "closures"),
                                          ("huber", "all")])
def test_system_values_robust_match(far, robust, edges):
    _, ref, port = far
    kw = dict(robust=robust, robust_delta=1.3, robust_edges=edges)
    v_ref, b_ref, c_ref = jasm.system_values(ref, jnp.asarray(0.1),
                                             mu=jnp.asarray(7.0), **kw)
    v, b, c = tasm.system_values(port, 0.1, mu=torch.tensor(7.0,
                                                            dtype=torch.float64),
                                 **kw)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-10,
                               atol=1e-10 * float(np.abs(v_ref).max()))
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-10,
                               atol=1e-10 * float(np.abs(b_ref).max()))
    # the returned χ² stays the raw one
    np.testing.assert_allclose(float(c), float(tpgo.global_error(port)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(c), float(c_ref), rtol=1e-10)
    for mu in (None, 7.0):
        np.testing.assert_allclose(
            float(tpgo.robust_global_cost(port, robust, 1.3, mu=mu,
                                          robust_edges=edges)),
            float(jpgo.robust_global_cost(ref, robust, 1.3, mu=mu,
                                          robust_edges=edges)), rtol=1e-10)


# ---------------------------------------------------------------- drivers

ROBUST_RUNS = {
    "huber": {},
    "cauchy": {},
    "barron": {"robust_alpha": -4.0},
    "gnc-gm": {},
}


@pytest.mark.parametrize("robust", sorted(ROBUST_RUNS))
def test_make_optimize_robust_matches_jit(far, robust):
    """LM 10 on the far-outlier corridor, dense, against make_optimize_jit:
    the raw χ² trace within 1e-9 and the poses within 1e-8."""
    _, ref, port = far
    kw = dict(num_iterations=10, solver="lm", backend="dense", tolerance=0.0,
              robust=robust, **ROBUST_RUNS[robust])
    g_ref, want, it_ref = jpgo.make_optimize_jit(ref, **kw)(ref)
    g, errors, it = tpgo.make_optimize(port, device="cpu", **kw)(port)
    assert it == int(it_ref) == 10
    assert_trace_close(errors.numpy(), want)
    np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_ref.poses2),
                               atol=1e-8, rtol=0)


@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_make_optimize_gnc_banded_matches_jit(local, solver):
    """gnc-gm through banded-direct on the local-outlier corridor, with a
    tolerance: the loop must not stop on ‖dx‖ while μ > 1, and GNC
    recovers the clean edges."""
    clean, ref, port = local
    kw = dict(num_iterations=12, solver=solver, backend="banded-direct",
              tolerance=1e-3, robust="gnc-gm")
    g_ref, want, it_ref = jpgo.make_optimize_jit(ref, **kw)(ref)
    g, errors, it = tpgo.make_optimize(port, device="cpu", **kw)(port)
    assert it == int(it_ref) >= tpgo.gnc_iterations(12)
    assert_trace_close(errors.numpy(), want)
    np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_ref.poses2),
                               atol=1e-8, rtol=0)
    inlier = to_port(clean).replace(poses2=g.poses2, landmarks2=g.landmarks2)
    assert float(tpgo.global_error(inlier)) < 1e-3


@pytest.mark.parametrize("robust", ["gnc-gm", "cauchy"])
def test_host_optimize_robust_matches(local, robust):
    """The host loop's robust accept test (cur_cost carried for a fixed
    kernel, re-evaluated under GNC) and GNC schedule against JAX's."""
    _, ref, port = local
    kw = dict(num_iterations=12, solver="lm", backend="banded-direct",
              tolerance=1e-3, robust=robust)
    want = jpgo.optimize(ref, **kw)
    got = tpgo.optimize(port, device="cpu", **kw)
    assert got.iterations == want.iterations
    assert_trace_close(got.errors, want.errors)
    np.testing.assert_allclose(got.norms, want.norms, rtol=1e-9)
    np.testing.assert_allclose(got.graph.poses2.numpy(),
                               np.asarray(want.graph.poses2), atol=1e-8)


@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_make_optimize_batch_gnc_matches(solver):
    """A fleet of 3 under gnc-gm, each row with its own μ0, μ(it) and
    accept test, against JAX's vmapped loop and the unbatched loop."""
    _, ref, _ = local_outliers(num_poses=96, closure_span=16, seed=6,
                               share=0.4)
    rng = np.random.default_rng(0)
    poses = np.asarray(ref.poses2)
    refs = [ref] + [ref.replace(poses2=jnp.asarray(
        poses + rng.normal(0.0, s, poses.shape))) for s in (0.1, 0.3)]
    stacked = jpgo.stack_graphs(refs)
    fields = {n: np.asarray(getattr(stacked, n)) for n in FIELDS}
    fleet = tg2o.batch_from_numpy(fields, ref.total_dof, ref.prior2,
                                  ref.prior3, device="cpu")
    ports = [to_port(r) for r in refs]
    kw = dict(num_iterations=14, solver=solver, backend="dense",
              tolerance=0.01 if solver == "lm" else 1e-6, robust="gnc-gm")
    g, errors, it = tpgo.make_optimize_batch(ports[0], device="cpu",
                                             **kw)(fleet)
    g_ref, want, it_ref = jpgo.make_optimize_batch(refs[0], **kw)(stacked)
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_ref))
    # LM rows stop apart (9, 10, 11); GN's converge within the anneal and
    # stop together, past it
    assert len(set(it.tolist())) == (3 if solver == "lm" else 1), it
    assert min(it.tolist()) > tpgo.gnc_iterations(14)
    for i in range(3):
        assert_trace_close(errors[i].numpy(), np.asarray(want[i]))
        g1, e1, i1 = tpgo.make_optimize(ports[0], device="cpu",
                                        **kw)(ports[i])
        assert int(it[i]) == i1
        assert_trace_close(errors[i].numpy(), e1.numpy())
    np.testing.assert_allclose(g.poses2.numpy(), np.asarray(g_ref.poses2),
                               atol=1e-8, rtol=0)


def test_robust_3d_cauchy(tmp_path):
    """A 3D graph with robust="cauchy" (the qq edges weighted, odometry
    kept at L2) through make_optimize and the fleet, against JAX."""
    spec = cs.sphere_graph(rings=4, per_ring=12, seed=2)
    f = spec["fields"]
    z = f["qq_z"].copy()
    z[-3:, :3] += 2.0  # three closures with a 2 m error
    f = {**f, "qq_z": z}
    ref = jg2o.PoseGraphData(**{k: jnp.asarray(v) for k, v in f.items()},
                             total_dof=spec["total_dof"], prior2=-1,
                             prior3=0)
    port = to_port(ref)
    kw = dict(num_iterations=6, solver="lm", backend="banded-direct",
              tolerance=0.0, robust="cauchy", robust_delta=2.0)
    _, want, _ = jpgo.make_optimize_jit(ref, **kw)(ref)
    g, errors, _ = tpgo.make_optimize(port, device="cpu", **kw)(port)
    assert_trace_close(errors.numpy(), want)
    stacked = jpgo.stack_graphs([ref, ref])
    fleet = tpgo.stack_graphs([port, port])
    _, want_b, _ = jpgo.make_optimize_batch(ref, **kw)(stacked)
    _, got_b, _ = tpgo.make_optimize_batch(port, device="cpu", **kw)(fleet)
    for i in range(2):
        assert_trace_close(got_b[i].numpy(), np.asarray(want_b[i]))
