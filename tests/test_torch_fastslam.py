"""The port's FastSLAM against the JAX package's, f64 on the CPU: every
step form (1.0 with the velocity and the odometry motion model, 2.0, the
unknown-correspondence step) on the JAX FastSLAM 2.0 test's simulation
(tests/test_new_components.py::_fastslam_sim) at 12-32 particles, fed the
draws of JAX's own keys through the private forms, the cloud to atol 1e-9
after every event with the resampled rows equal; the pieces
(``_update_one`` with a per-particle mask, ``_per_slot_likelihood``,
``estimate``) on one cloud; the public forms against the private ones on
a generator's draws."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import fastslam as jfs
from rustrobotics_tpu.models.motion import OdometryMotionModel as JOdo
from rustrobotics_tpu.models import VelocityMotionModel as JVel
from rustrobotics_tpu_torch.mapping import fastslam as tfs
from rustrobotics_tpu_torch.models.motion import OdometryMotionModel as TOdo
from rustrobotics_tpu_torch.models import VelocityMotionModel as TVel

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-9
F64 = jnp.float64
VEL_ALPHA = [0.04, 0.02, 0.015, 0.008, 0.008, 0.004]
ODO_ALPHA = [0.01, 0.002, 0.005, 0.002]
Q = np.diag([0.08, 0.04]) ** 2
SIGMA0 = (0.05, 0.05, 0.02)


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def same_cloud(tp, jp, atol=ATOL):
    for name in ("poses", "lm_mu", "lm_cov", "logw"):
        close(getattr(tp, name), getattr(jp, name), atol)
    assert (tp.seen.numpy() == np.asarray(jp.seen)).all()


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()
fastslam_sim = cs.fastslam_sim  # tests/test_new_components.py::_fastslam_sim


@pytest.fixture(scope="module")
def sim():
    lms, events, dt = fastslam_sim(40)
    # some sightings masked out, and an event without control
    for i, ev in enumerate(events):
        ev[3][(np.arange(6) + i) % 4 == 0] = False
    return lms, events, dt


def slams(model="vel", max_landmarks=6):
    if model == "vel":
        jm, tm = JVel.create(jnp.asarray(VEL_ALPHA)), TVel.create(
            VEL_ALPHA, "cpu", torch.float64)
    else:
        jm, tm = JOdo.create(jnp.asarray(ODO_ALPHA)), TOdo.create(
            ODO_ALPHA, "cpu", torch.float64)
    js = jfs.FastSlam.create(q=jnp.asarray(Q), motion_model=jm,
                             max_landmarks=max_landmarks)
    ts = tfs.FastSlam.create(q=t(Q), motion_model=tm,
                             max_landmarks=max_landmarks)
    return js, ts


def clouds(js, ts, n):
    key = jax.random.key(0)
    jp = js.init_particles(key, jnp.zeros(3), n, SIGMA0)
    tp = ts._init_particles(t(np.zeros(3)),
                            t(jax.random.normal(key, (n, 3), F64)), SIGMA0)
    same_cloud(tp, jp, 0)
    return jp, tp


def motion_draws(model, k_prop, n, u_shape):
    """The standard normals the JAX motion model's ``sample`` draws."""
    if model == "vel":
        kv, kw, kg = jax.random.split(k_prop, 3)
        return t(np.stack([jax.random.normal(k, (n,), F64)
                           for k in (kv, kw, kg)]))
    return t(jax.random.normal(k_prop, u_shape, F64))


def uniform(key):
    return t(jax.random.uniform(key, (), F64))


def controls(model, u):
    """The velocity control, or an odometry [rot1, trans, rot2] step."""
    return u if model == "vel" else np.array([0.009, 0.1, 0.009])


@pytest.mark.parametrize("model,n", [("vel", 32), ("odo", 16)])
def test_step_matches_jax(sim, model, n):
    lms, events, dt = sim
    js, ts = slams(model)
    jstep = jax.jit(lambda k, p, u, hc, ids, z, m: js.step(
        k, p, u, hc, ids, z, m, dt))
    jp, tp = clouds(js, ts, n)
    resampled = 0
    for i, (u, ids, z, vis, _) in enumerate(events):
        u = controls(model, u)
        hc = i % 9 != 4
        key = jax.random.fold_in(jax.random.key(1), i)
        k_prop, k_res = jax.random.split(key)
        jp = jstep(key, jp, jnp.asarray(u), jnp.asarray(hc), jnp.asarray(ids),
                   jnp.asarray(z), jnp.asarray(vis))
        tp = ts._step(tp, t(u), torch.tensor(hc), t(ids), t(z), t(vis), dt,
                      motion_draws(model, k_prop, n, (3,)), uniform(k_res))
        same_cloud(tp, jp)
        resampled += int(np.all(np.asarray(jp.logw) == 0))
    assert resampled > 0  # the ESS gate fired


def test_fastslam2_step_matches_jax(sim):
    lms, events, dt = sim
    js, ts = slams("vel")
    n = 12
    jstep = jax.jit(lambda k, p, u, hc, ids, z, m: jfs.fastslam2_step(
        js, k, p, u, hc, ids, z, m, dt))
    jp, tp = clouds(js, ts, n)
    for i, (u, ids, z, vis, _) in enumerate(events):
        hc = i % 9 != 4
        key = jax.random.fold_in(jax.random.key(1), i)
        k_prop, k_res = jax.random.split(key)
        jp = jstep(key, jp, jnp.asarray(u), jnp.asarray(hc), jnp.asarray(ids),
                   jnp.asarray(z), jnp.asarray(vis))
        tp = tfs._fastslam2_step(
            ts, tp, t(u), torch.tensor(hc), t(ids), t(z), t(vis), dt,
            t(jax.random.normal(k_prop, (n, 3), F64)), uniform(k_res))
        same_cloud(tp, jp)


def test_step_unknown_matches_jax(sim):
    lms, events, dt = sim
    js, ts = slams("vel", max_landmarks=8)
    n = 16
    jstep = jax.jit(lambda k, p, u, z, m: jfs.fastslam_step_unknown(
        js, k, p, u, True, z, m, dt))
    jp, tp = clouds(js, ts, n)
    rng = np.random.default_rng(5)
    for i, (u, _, z, vis, _) in enumerate(events):
        perm = rng.permutation(6)
        key = jax.random.fold_in(jax.random.key(1), i)
        k_prop, k_res = jax.random.split(key)
        jp = jstep(key, jp, jnp.asarray(u), jnp.asarray(z[perm]),
                   jnp.asarray(vis[perm]))
        tp = tfs._fastslam_step_unknown(
            ts, tp, t(u), True, t(z[perm]), t(vis[perm]), dt,
            motion_draws("vel", k_prop, n, (2,)), uniform(k_res))
        same_cloud(tp, jp)
    seen = tp.seen.sum(1)
    assert (seen > 0).all() and (seen < 8).any()


def test_pieces_match_jax(sim):
    """_update_one with a per-particle mask (fresh and seen slots),
    _per_slot_likelihood and estimate on one mid-run cloud."""
    lms, events, dt = sim
    js, ts = slams("vel")
    n = 8
    jstep = jax.jit(lambda k, p, u, ids, z, m: js.step(
        k, p, u, True, ids, z, m, dt))
    jp, _ = clouds(js, ts, n)
    for i, (u, ids, z, vis, _) in enumerate(events[:10]):
        jp = jstep(jax.random.key(i), jp, jnp.asarray(u), jnp.asarray(ids),
                   jnp.asarray(z), jnp.asarray(vis & (ids < 4)))
    tp = tfs.particles_from_numpy(*(np.asarray(getattr(jp, f)) for f in (
        "poses", "lm_mu", "lm_cov", "seen", "logw")), device="cpu")
    same_cloud(tp, jp, 0)
    valid = np.arange(n) % 3 != 0
    z = np.array([4.0, 0.7])
    for k in (1, 5):  # a seen slot and a fresh one
        for kk in (k, torch.tensor(k)):
            jq, jw = js._update_one(jp, k, jnp.asarray(z), jnp.asarray(valid))
            tq, tw = ts._update_one(tp, kk, t(z), t(valid))
            same_cloud(tq, jq)
            close(tw, jw)
    close(tfs._per_slot_likelihood(ts, tp, t(z)),
          jfs._per_slot_likelihood(js, jp, jnp.asarray(z)))
    for a, b in zip(ts.estimate(tp), js.estimate(jp)):
        close(a, b)
    m = np.asarray(jp.poses)
    close(tfs._pose_jacobian_rb(t(m), t(np.asarray(jp.lm_mu)[:, 1])),
          jfs._pose_jacobian_rb(jnp.asarray(m), jp.lm_mu[:, 1]))


def test_public_forms_draw_as_private_forms(sim):
    """step, fastslam2_step, fastslam_step_unknown and init_particles on
    a generator equal their private forms on the same generator's draws,
    drawn in the documented order."""
    lms, events, dt = sim
    u, ids, z, vis, _ = events[3]
    _, ts = slams("vel")
    n = 8
    gen = torch.Generator().manual_seed(3)
    tp = ts.init_particles(gen, t(np.zeros(3)), n, SIGMA0)
    gen2 = torch.Generator().manual_seed(3)
    same = ts._init_particles(t(np.zeros(3)),
                              torch.randn((n, 3), generator=gen2,
                                          dtype=torch.float64), SIGMA0)
    close(tp.poses, same.poses, 0)
    args = (t(u), True, t(ids), t(z), t(vis), dt)

    def draws(seed, first):
        g = torch.Generator().manual_seed(seed)
        a = torch.randn(first, generator=g, dtype=torch.float64)
        return a, torch.rand((), generator=g, dtype=torch.float64)

    out = ts.step(torch.Generator().manual_seed(4), tp, *args)
    ref = ts._step(tp, *args, *draws(4, (3, n)))
    same_cloud(out, ref, 0)
    out = tfs.fastslam2_step(ts, torch.Generator().manual_seed(5), tp, *args)
    ref = tfs._fastslam2_step(ts, tp, *args, *draws(5, (n, 3)))
    same_cloud(out, ref, 0)
    out = tfs.fastslam_step_unknown(ts, torch.Generator().manual_seed(6), tp,
                                    t(u), True, t(z), t(vis), dt)
    ref = tfs._fastslam_step_unknown(ts, tp, t(u), True, t(z), t(vis), dt,
                                     *draws(6, (3, n)))
    same_cloud(out, ref, 0)


def test_odometry_proposal_moves_the_cloud_as_one():
    """A behaviour of the JAX package that the port keeps: the odometry
    model's ``sample`` draws one noise vector of the control's shape for
    the whole cloud, so a FastSLAM 1.0 step moves every particle by the
    same noisy control, and a cloud that starts at one pose (the
    SLAM-course replay's) stays one pose."""
    js, ts = slams("odo")
    n = 16
    key = jax.random.key(2)
    jp = js.init_particles(jax.random.key(0), jnp.zeros(3), n)
    tp = ts._init_particles(t(np.zeros(3)), torch.zeros((n, 3),
                                                        dtype=torch.float64))
    u = np.array([0.1, 0.5, -0.05])
    k_prop, k_res = jax.random.split(key)
    jp = js.step(key, jp, jnp.asarray(u), True, jnp.zeros(0, jnp.int32),
                 jnp.zeros((0, 2)), jnp.zeros(0, bool), 0.0)
    tp = ts._step(tp, t(u), True, [], [], [], 0.0,
                  motion_draws("odo", k_prop, n, (3,)), uniform(k_res))
    same_cloud(tp, jp)
    assert np.ptp(np.asarray(jp.poses), axis=0).max() == 0.0
    assert float((tp.poses - tp.poses[0]).abs().max()) == 0.0


GATE_DRAWS = ROOT / "tests" / "data" / "fastslam2_gate_draws.npz"


def jax_gate_draws(n=12, steps=220):
    """The draws of test_fastslam2_tracks_with_few_particles' keys: the
    initial cloud's normals (key 0), and per event (fold_in(key 1, i)) the
    velocity model's three normal vectors, FastSLAM 2.0's pose normals
    and the resampler's uniform."""
    def one(i):
        k_prop, k_res = jax.random.split(
            jax.random.fold_in(jax.random.key(1), i))
        vel = jnp.stack([jax.random.normal(k, (n,), F64)
                         for k in jax.random.split(k_prop, 3)])
        return (vel, jax.random.normal(k_prop, (n, 3), F64),
                jax.random.uniform(k_res, (), F64))

    vel, eps, res = jax.jit(jax.vmap(one))(jnp.arange(steps))
    return dict(init=np.asarray(jax.random.normal(jax.random.key(0), (n, 3),
                                                  F64)),
                vel=np.asarray(vel), eps=np.asarray(eps),
                resample=np.asarray(res))


def run_gate(ts, events, dt, draws, dtype=torch.float64):
    """The JAX gate's replay on the port: the last-40 mean position error
    of FastSLAM 2.0 and of 1.0."""
    def as_t(a):
        return torch.tensor(np.asarray(a), dtype=dtype)

    out = []
    for version in (2, 1):
        p = ts._init_particles(as_t(np.zeros(3)), as_t(draws["init"]))
        errs = []
        for i, (u, ids, z, vis, pose) in enumerate(events):
            args = (as_t(u), True, torch.tensor(ids), as_t(z),
                    torch.tensor(vis), dt)
            if version == 2:
                p = tfs._fastslam2_step(ts, p, *args, as_t(draws["eps"][i]),
                                        as_t(draws["resample"][i]))
            else:
                p = ts._step(p, *args, as_t(draws["vel"][i]),
                             as_t(draws["resample"][i]))
            est = ts.estimate(p)[0].double().numpy()
            errs.append(np.linalg.norm(est[:2] - pose[:2]))
        out.append(float(np.mean(errs[-40:])))
    return out


def test_fastslam2_gate_on_jax_draws():
    """tests/test_new_components.py::test_fastslam2_tracks_with_few_particles
    on the port, fed the draws of that test's own keys (12 particles, 220
    events; the draws are kept in tests/data for the card, which has no
    JAX, and must equal the keys' draws): FastSLAM 2.0's last-40 mean
    error < 0.35 m and <= 0.8x FastSLAM 1.0's (the JAX test reads 0.18
    and 0.42 m)."""
    draws = jax_gate_draws()
    kept = np.load(GATE_DRAWS)
    for name, value in draws.items():
        assert np.array_equal(kept[name], value), name
    lms, events, dt = fastslam_sim(steps=220)
    _, ts = slams("vel")
    err2, err1 = run_gate(ts, events, dt, draws)
    assert err2 < 0.35, err2
    assert err2 <= err1 * 0.8, (err2, err1)
