"""The port's SE(3) geometry, linearization, assembly and drivers against
the JAX package, f64 on the CPU.

The 3D graph is ``chip_smoke.sphere_graph`` at 6 rings of 12 poses (432
dof, kb=256, nb=2), written as a g2o file that both parsers load; its
fleet is the graph and two copies with jittered poses."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.geometry import se3 as jse3
from rustrobotics_tpu.mapping import assemble as jasm
from rustrobotics_tpu.mapping import g2o as jg2o
from rustrobotics_tpu.mapping import linearize as jlin
from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu_torch.geometry import se3 as tse3
from rustrobotics_tpu_torch.mapping import assemble as tasm
from rustrobotics_tpu_torch.mapping import g2o as tg2o
from rustrobotics_tpu_torch.mapping import linearize as tlin
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.ops.band_chol import build_band_chol

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = tg2o.FLOAT_FIELDS + tg2o.INDEX_FIELDS
ITERS = 5


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()


def g2o_text(spec):
    """A sphere_graph spec as g2o text (quaternions x y z w in the file)."""
    f = spec["fields"]
    lines = []
    for i, p in enumerate(f["poses3"]):
        t, q = p[:3], p[3:]
        vals = [*t, q[1], q[2], q[3], q[0]]
        lines.append("VERTEX_SE3:QUAT %d " % i
                     + " ".join(repr(float(v)) for v in vals))
    iu = np.triu_indices(6)
    for fr, to, z, om in zip(f["qq_from"], f["qq_to"], f["qq_z"],
                             f["qq_omega"]):
        vals = [*z[:3], z[4], z[5], z[6], z[3], *om[iu]]
        lines.append("EDGE_SE3:QUAT %d %d " % (fr, to)
                     + " ".join(repr(float(v)) for v in vals))
    return "\n".join(lines) + "\n"


def to_port(ref):
    fields = {n: np.asarray(getattr(ref, n)) for n in FIELDS}
    return tg2o.graph_from_numpy(fields, ref.total_dof, ref.prior2,
                                 ref.prior3, device="cpu")


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    path = tmp_path_factory.mktemp("se3") / "sphere-72.g2o"
    path.write_text(g2o_text(cs.sphere_graph(rings=6, per_ring=12, seed=1)))
    return jg2o.load_g2o(str(path)), tg2o.load_g2o(str(path), device="cpu")


def rand_poses(rng, n, scale=1.0):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.normal(size=(n, 3)) * scale, q], axis=1)


# ------------------------------------------------------------ geometry

def _se3_cases():
    rng = np.random.default_rng(0)
    a, b = rand_poses(rng, 16), rand_poses(rng, 16)
    # rotation vectors: generic, small (the series branch) and 0
    omega = np.concatenate([rng.normal(size=(8, 3)),
                            rng.normal(size=(6, 3)) * 1e-7, np.zeros((2, 3))])
    # quaternions with w < 0, near identity and the identity itself
    q = np.concatenate([a[:8, 3:], -np.abs(a[8:12, 3:]),
                        tse3.so3_exp(torch.as_tensor(omega[8:12])).numpy(),
                        np.tile([1.0, 0, 0, 0], (2, 1))])
    v = rng.normal(size=(16, 3))
    delta = rng.normal(size=(16, 6)) * 0.3
    return {
        "quat_normalize": (rng.normal(size=(16, 4)),),
        "quat_mul": (a[:, 3:], b[:, 3:]),
        "quat_conj": (a[:, 3:],),
        "quat_rotate": (a[:, 3:], v),
        "quat_to_mat": (a[:, 3:],),
        "so3_exp": (omega,),
        "so3_log": (q,),
        "skew": (v,),
        "compose": (a, b),
        "inverse": (a,),
        "relative": (a, b),
        "retract": (a, delta),
        "log": (a,),
        "transform": (a, v),
    }


SE3_CASES = _se3_cases()


@pytest.mark.parametrize("name", sorted(SE3_CASES) + ["identity"])
def test_se3_function_matches(name):
    if name == "identity":
        want = np.asarray(jse3.identity((2, 3), dtype=jnp.float64))
        got = tse3.identity((2, 3), dtype=torch.float64)
        np.testing.assert_array_equal(got.numpy(), want)
        return
    args = SE3_CASES[name]
    want = np.asarray(getattr(jse3, name)(*(jnp.asarray(x) for x in args)))
    got = getattr(tse3, name)(*(torch.as_tensor(x) for x in args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_se3_residual_zero_on_consistent_edge():
    rng = np.random.default_rng(0)
    x1 = torch.as_tensor(np.concatenate([rng.normal(size=3), [1.0, 0, 0, 0]]))
    delta = torch.as_tensor(rng.normal(size=6) * 0.3)
    x2 = tse3.retract(x1, delta)
    z = tse3.relative(x1, x2)
    e = tlin.residual_qq(x1, x2, z)
    np.testing.assert_allclose(e.numpy(), 0.0, atol=1e-12)


def test_se3_jacobians_match_finite_differences():
    rng = np.random.default_rng(1)
    q1 = rng.normal(size=4)
    q1 /= np.linalg.norm(q1)
    q2 = rng.normal(size=4)
    q2 /= np.linalg.norm(q2)
    x1 = torch.as_tensor(np.concatenate([rng.normal(size=3), q1]))
    x2 = torch.as_tensor(np.concatenate([rng.normal(size=3), q2]))
    z = tse3.relative(x1, x2)  # near-zero residual point
    a, b = tlin.linearize_qq(x1, x2, z)
    assert a.shape == b.shape == (6, 6)
    eps = 1e-6
    for k in range(6):
        d = torch.zeros(6, dtype=torch.float64)
        d[k] = eps
        fd_a = (tlin.residual_qq(tse3.retract(x1, d), x2, z)
                - tlin.residual_qq(tse3.retract(x1, -d), x2, z)) / (2 * eps)
        fd_b = (tlin.residual_qq(x1, tse3.retract(x2, d), z)
                - tlin.residual_qq(x1, tse3.retract(x2, -d), z)) / (2 * eps)
        np.testing.assert_allclose(a[:, k].numpy(), fd_a.numpy(), atol=1e-6)
        np.testing.assert_allclose(b[:, k].numpy(), fd_b.numpy(), atol=1e-6)


def test_linearize_qq_matches_jax():
    """residual_qq and linearize_qq against JAX's jacfwd under vmap on
    seeded edges, a third of them satisfied (the residual rotation is the
    identity, where the so3_log guards act); a fleet axis in front gives
    the same rows."""
    rng = np.random.default_rng(2)
    x1, x2, z = (rand_poses(rng, 30) for _ in range(3))
    z[:10] = np.asarray(jax.vmap(jse3.relative)(jnp.asarray(x1[:10]),
                                               jnp.asarray(x2[:10])))
    want_e = np.asarray(jax.vmap(jlin.residual_qq)(x1, x2, z))
    want_a, want_b = jax.vmap(jlin.linearize_qq)(x1, x2, z)
    t1, t2, tz = (torch.as_tensor(x) for x in (x1, x2, z))
    got_e = tlin.residual_qq(t1, t2, tz)
    got_a, got_b = tlin.linearize_qq(t1, t2, tz)
    np.testing.assert_allclose(got_e.numpy(), want_e, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0,
                               atol=1e-9)
    assert torch.isfinite(got_a[:10]).all() and torch.isfinite(got_b[:10]).all()
    fleet_a, fleet_b = tlin.linearize_qq(t1.expand(3, 30, 7), t2, tz)
    assert fleet_a.shape == (3, 30, 6, 6)
    torch.testing.assert_close(fleet_a[2], got_a, rtol=0, atol=0)
    torch.testing.assert_close(fleet_b[1], got_b, rtol=0, atol=0)


# ------------------------------------------------------- graph and system

def test_load_g2o_se3_matches(graphs):
    ref, port = graphs
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (port.total_dof, port.prior2, port.prior3) == (432, -1, 0)
    assert port.is_3d and port.num_edges == 71 + 60
    bl = build_band_chol(tasm.build_layout(port))
    assert bl.nb > 1


@pytest.mark.parametrize("lam", [0.0, 0.37])
def test_system_values_3d_match(graphs, lam):
    """vals, b and χ² against JAX, and the dense H each scatters: a value
    vector out of the layout's order would fail the H even where the
    vector's length fits (the 6-value prior3 block included)."""
    ref, port = graphs
    v_ref, b_ref, c_ref = jasm.system_values(ref, jnp.asarray(lam))
    v, b, c = tasm.system_values(port, lam)
    assert v.shape == v_ref.shape
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-10,
                               atol=1e-10 * float(np.abs(v_ref).max()))
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-10,
                               atol=1e-10 * float(np.abs(b_ref).max()))
    np.testing.assert_allclose(float(c), float(c_ref), rtol=1e-10)
    want = np.asarray(jasm.dense_hessian(jasm.build_layout(ref), v_ref))
    got = tasm.dense_hessian(tasm.build_layout(port), v)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=1e-10 * float(np.abs(want).max()))
    layout = tasm.build_layout(port)
    np.testing.assert_array_equal(v[layout.prior_slice].numpy(),
                                  np.full(6, tasm.PRIOR_WEIGHT))


def test_apply_update_3d_and_global_error(graphs):
    ref, port = graphs
    dx = np.random.default_rng(3).normal(scale=0.1, size=ref.total_dof)
    want = jasm.apply_update(ref, jnp.asarray(dx))
    got = tasm.apply_update(port, torch.as_tensor(dx))
    np.testing.assert_allclose(got.poses3.numpy(), np.asarray(want.poses3),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(float(tpgo.global_error(got)),
                               float(jpgo.global_error(want)), rtol=1e-10)
    np.testing.assert_allclose(float(tpgo.max_edge_chi2(got)),
                               float(jpgo.max_edge_chi2(want)), rtol=1e-10)


# --------------------------------------------------------------- drivers

def assert_trace_close(got, want, rtol=1e-9):
    """Same NaN tail; entries above 1e-12 of the first within rtol (the
    converged GN tail is round-off)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    sel = ~np.isnan(want) & (want > 1e-12 * want[0])
    assert sel.sum() >= 3
    np.testing.assert_allclose(got[sel], want[sel], rtol=rtol)


_JAX_RUNS = {}


def jax_run(key, build):
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = build()
    return _JAX_RUNS[key]


@pytest.mark.parametrize("backend", ["dense", "banded-direct"])
@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_make_optimize_3d_matches_jit(graphs, solver, backend):
    ref, port = graphs
    g_ref, want, it_ref = jax_run(("one", solver, backend), lambda: jpgo
                                  .make_optimize_jit(
        ref, num_iterations=ITERS, solver=solver, backend=backend,
        tolerance=0.0)(ref))
    g, errors, it = tpgo.make_optimize(port, num_iterations=ITERS,
                                       solver=solver, backend=backend,
                                       tolerance=0.0, device="cpu")(port)
    assert it == int(it_ref) == ITERS
    assert_trace_close(errors.numpy(), want)
    np.testing.assert_allclose(g.poses3.numpy(), np.asarray(g_ref.poses3),
                               atol=1e-8, rtol=0)


def test_host_optimize_3d_matches(graphs):
    ref, port = graphs
    want = jpgo.optimize(ref, num_iterations=ITERS, solver="lm",
                         backend="host")
    got = tpgo.optimize(port, num_iterations=ITERS, solver="lm",
                        backend="host", device="cpu")
    assert got.iterations == want.iterations
    assert_trace_close(got.errors, want.errors)
    np.testing.assert_allclose(got.norms, want.norms, rtol=1e-9)


def jittered_fleet(ref):
    rng = np.random.default_rng(4)
    refs = [ref] + [ref.replace(poses3=jnp.asarray(cs.jitter_poses3(
        np.asarray(ref.poses3), rng))) for _ in range(2)]
    stacked = jpgo.stack_graphs(refs)
    fields = {n: np.asarray(getattr(stacked, n)) for n in FIELDS}
    fleet = tg2o.batch_from_numpy(fields, ref.total_dof, ref.prior2,
                                  ref.prior3, device="cpu")
    return refs, stacked, fleet, [to_port(r) for r in refs]


@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_make_optimize_batch_3d_matches(graphs, solver):
    """The fleet of 3 against JAX's vmapped loop and against the
    unbatched loop on each graph; the poses3 of every row move."""
    refs, stacked, fleet, ports = jittered_fleet(graphs[0])
    kw = dict(num_iterations=4, solver=solver, backend="banded-direct",
              tolerance=0.0)
    g, errors, it = tpgo.make_optimize_batch(ports[0], device="cpu",
                                             **kw)(fleet)
    g_ref, want, it_ref = jpgo.make_optimize_batch(refs[0], **kw)(stacked)
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_ref))
    for i in range(3):
        assert_trace_close(errors[i].numpy(), np.asarray(want[i]))
        g1, e1, _ = tpgo.make_optimize(ports[0], device="cpu", **kw)(ports[i])
        assert_trace_close(errors[i].numpy(), e1.numpy())
        np.testing.assert_allclose(g.poses3[i].numpy(), g1.poses3.numpy(),
                                   atol=1e-8, rtol=0)
        assert not torch.equal(g.poses3[i], fleet.poses3[i])
    np.testing.assert_allclose(g.poses3.numpy(), np.asarray(g_ref.poses3),
                               atol=1e-8, rtol=0)


def test_sphere_anchors_frozen():
    """chip_smoke's sphere-2500 band plan (kb=384, nb=40) and its frozen
    f64 anchors against the JAX package at 2 iterations; the
    corridor-1728-gnc cell's errors[0] anchor against JAX's global_error."""
    spec = cs.sphere_graph()
    port = cs.port_graph(spec, "cpu")
    bl = build_band_chol(tasm.build_layout(port))
    assert (bl.kb, bl.nb) == (cs.SPHERE_KB, cs.SPHERE_NB)
    ref = jg2o.PoseGraphData(
        **{k: jnp.asarray(v) for k, v in spec["fields"].items()},
        total_dof=spec["total_dof"], prior2=spec["prior2"],
        prior3=spec["prior3"])
    for solver, anchors in (("gauss_newton", cs.SPHERE_GN_CHI2),
                            ("lm", (cs.SPHERE_GN_CHI2[0],
                                    cs.SPHERE_LM_CHI2_1))):
        _, errors, _ = jpgo.make_optimize_jit(
            ref, num_iterations=2, solver=solver, backend="banded-direct",
            tolerance=0.0)(ref)
        np.testing.assert_allclose(np.asarray(errors[:2]), anchors,
                                   rtol=1e-9)
    from rustrobotics_tpu.mapping.synthetic import (
        synthetic_corridor_graph_2d,
    )

    clean = synthetic_corridor_graph_2d(1728, num_landmarks=32,
                                        closure_span=112)
    z, mask = cs.corrupt_closures(np.asarray(clean.pp_from),
                                  np.asarray(clean.pp_to),
                                  np.asarray(clean.pp_z))
    assert mask.sum() == 10
    bad = clean.replace(pp_z=jnp.asarray(z))
    np.testing.assert_allclose(float(jpgo.global_error(bad)),
                               cs.GNC_CHI2_0, rtol=1e-9)
