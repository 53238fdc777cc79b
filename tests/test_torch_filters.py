"""The port's landmark table, EKF, UKF and particle filters (all three
resamplers, the adaptive filter, the landmark filter) and the simulated
localization episode against the JAX package's, f64 on the CPU, on the
same seeded numpy inputs: deterministic filters to rtol 1e-9, stochastic
ones fed the draws of JAX's own keys to the same tolerance, with the
resampled indices equal. Then the JAX package's statistical filter tests,
mirrored on the port with torch generators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu import localization as jl
from rustrobotics_tpu import models as jm
from rustrobotics_tpu.localization import pf as jpf
from rustrobotics_tpu.localization import simulation as jsim
from rustrobotics_tpu.utils.state import GaussianState as JState
from rustrobotics_tpu_torch import localization as tl
from rustrobotics_tpu_torch import models as tm
from rustrobotics_tpu_torch.localization import pf as tpf
from rustrobotics_tpu_torch.localization import simulation as tsim
from rustrobotics_tpu_torch.utils.state import GaussianState

RTOL, ATOL = 1e-9, 1e-12
F64 = jnp.float64
ALPHA = np.array([1.0, 1.0, 30.0, 30.0, 10.0, 10.0])


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def same_state(got, want, rtol=RTOL, atol=ATOL):
    close(got.x, want.x, rtol, atol)
    close(got.cov, want.cov, rtol, atol)


def normal(key, shape):
    return jax.random.normal(key, shape, dtype=F64)


def uniform(key, shape):
    return jax.random.uniform(key, shape, dtype=F64)


def _sp_noise():
    q = np.diag([0.1, 0.1, np.deg2rad(1.0), 1.0]) ** 2
    r = np.diag([1.0, 1.0]) ** 2
    return q, r


def _sp_inputs(steps, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((steps, 2)) * [1.0, 0.3],
            rng.standard_normal((steps, 2)))


def _kc_world(seed=3):
    rng = np.random.default_rng(seed)
    ids = np.array([11, 2, 7, 13, 5], np.int32)
    pos = np.concatenate([rng.uniform(-4, 4, (5, 2)), np.zeros((5, 1))], 1)
    jt = jl.LandmarkTable.create(ids=ids, positions=pos)
    tt = tl.LandmarkTable.create(ids=ids, positions=pos, device="cpu")
    return rng, jt, tt


def _kc_events(rng, steps, m=3):
    """An event stream with optional controls and masked/unknown slots."""
    us = rng.uniform(-1, 1, (steps, 2)) * [1.0, 0.5]
    us[::5, 1] = 0.0  # straight-line steps
    hcs = rng.random(steps) > 0.3
    ids = rng.choice([2, 5, 7, 11, 99], (steps, m)).astype(np.int32)
    zs = np.stack([rng.uniform(0.5, 5.0, (steps, m)),
                   rng.uniform(-3, 3, (steps, m))], axis=-1)
    masks = rng.random((steps, m)) > 0.4
    dts = rng.uniform(0.05, 0.2, steps)
    return us, hcs, ids, zs, masks, dts


def test_landmark_table_matches_jax():
    _, jt, tt = _kc_world()
    np.testing.assert_array_equal(tt.ids.numpy(), np.asarray(jt.ids))
    np.testing.assert_array_equal(tt.ids_np, np.asarray(jt.ids))
    close(tt.positions, jt.positions)
    q = np.array([[2, 99, 13], [0, 7, 14]], np.int32)
    jpos, jvalid = jt.lookup(jnp.asarray(q))
    tpos, tvalid = tt.lookup(t(q))
    close(tpos, jpos)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    rows, valid = tt.lookup_np(q)
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    close(tt.positions[rows[valid]], np.asarray(jpos)[valid])


def test_ekf_and_ukf_match_jax():
    q, r = _sp_noise()
    us, zs = _sp_inputs(20, 0)
    mods = (jm.SimpleProblemMotionModel.create(),
            jm.SimpleProblemMeasurementModel.create())
    tmods = (tm.SimpleProblemMotionModel.create(),
             tm.SimpleProblemMeasurementModel.create())
    jekf = jl.ExtendedKalmanFilter(r=jnp.asarray(q), q=jnp.asarray(r),
                                   motion_model=mods[0],
                                   measurement_model=mods[1])
    tekf = tl.ExtendedKalmanFilter(r=t(q), q=t(r), motion_model=tmods[0],
                                   measurement_model=tmods[1])
    jukf = jl.UnscentedKalmanFilter.create(
        q=jnp.asarray(q), r=jnp.asarray(r), motion_model=mods[0],
        measurement_model=mods[1], alpha=0.1, beta=2.0, kappa=0.0)
    tukf = tl.UnscentedKalmanFilter.create(
        q=q, r=r, motion_model=tmods[0], measurement_model=tmods[1],
        alpha=0.1, beta=2.0, kappa=0.0, device="cpu")
    for jf, tf in ((jekf, tekf), (jukf, tukf)):
        js = JState(x=jnp.zeros(4), cov=jnp.eye(4))
        ts = GaussianState(x=t(np.zeros(4)), cov=t(np.eye(4)))
        jstep = jax.jit(jf.step)
        for u, z in zip(us, zs):
            js = jstep(js, jnp.asarray(u), jnp.asarray(z), 0.1)
            ts = tf.step(ts, t(u), t(z), 0.1)
            same_state(ts, js)


@pytest.mark.parametrize("algo", ["ekf", "ukf"])
def test_kc_filters_match_jax(algo):
    """EKF-KC / UKF-KC over 25 events with optional controls, masked and
    unknown slots; a batch of 3 states at once equals the rows one by
    one."""
    rng, jt, tt = _kc_world()
    q = np.diag([0.1, 0.2])
    if algo == "ekf":
        jf = jl.ExtendedKalmanFilterKnownCorrespondences(
            q=jnp.asarray(q), landmarks=jt,
            motion_model=jm.VelocityMotionModel.create(jnp.asarray(ALPHA)),
            measurement_model=jm.RangeBearingMeasurementModel.create())
        tf = tl.ExtendedKalmanFilterKnownCorrespondences(
            q=t(q), landmarks=tt,
            motion_model=tm.VelocityMotionModel.create(ALPHA, device="cpu"),
            measurement_model=tm.RangeBearingMeasurementModel.create())
    else:
        jf = jl.UnscentedKalmanFilterKnownCorrespondences.create(
            q=jnp.asarray(q), landmarks=jt,
            motion_model=jm.VelocityMotionModel.create(jnp.asarray(ALPHA)),
            measurement_model=jm.RangeBearingMeasurementModel.create())
        tf = tl.UnscentedKalmanFilterKnownCorrespondences.create(
            q=q, landmarks=tt,
            motion_model=tm.VelocityMotionModel.create(ALPHA, device="cpu"),
            measurement_model=tm.RangeBearingMeasurementModel.create(),
            device="cpu")
    x0 = rng.standard_normal((3, 3)) * 0.5
    cov0 = np.eye(3) * 0.01
    ev = _kc_events(rng, 25)
    tb = GaussianState(x=t(x0), cov=t(np.broadcast_to(cov0, (3, 3, 3))))
    jstep = jax.jit(jf.step)
    rows = []
    for row in range(3):
        js = JState(x=jnp.asarray(x0[row]), cov=jnp.asarray(cov0))
        ts = GaussianState(x=t(x0[row]), cov=t(cov0))
        for k, (u, hc, ids, z, mask, dt) in enumerate(zip(*ev)):
            args = (u, hc, ids, z, mask, dt)
            js = jstep(js, *map(jnp.asarray, args))
            ts = tf.step(ts, *map(t, args))
            same_state(ts, js)
            if row == 0:
                tb = tf.step(tb, *map(t, args))
        rows.append(ts)
    close(tb.x, torch.stack([r.x for r in rows]), 1e-12, 1e-14)
    close(tb.cov, torch.stack([r.cov for r in rows]), 1e-12, 1e-14)


def test_ekf_kc_unknown_landmark_is_noop():
    """Mirror of the JAX package's test: an id absent from the table is
    skipped (bit for bit)."""
    _, _, tt = _kc_world()
    ekf = tl.ExtendedKalmanFilterKnownCorrespondences(
        q=t(np.diag([0.01, 0.01])), landmarks=tt,
        motion_model=tm.VelocityMotionModel.create(np.full(6, 0.01),
                                                   device="cpu"),
        measurement_model=tm.RangeBearingMeasurementModel.create())
    state = GaussianState(x=t(np.zeros(3)), cov=t(np.eye(3)))
    out = ekf.update(state, t(np.array([99], np.int32)), t(np.zeros((1, 2))),
                     torch.tensor([True]))
    assert torch.equal(out.x, state.x) and torch.equal(out.cov, state.cov)


RESAMPLERS = ("multinomial", "stratified", "systematic")


@pytest.mark.parametrize("name", RESAMPLERS)
@pytest.mark.parametrize("kind", ["random", "peaked", "zero"])
def test_resamplers_match_jax(name, kind):
    """Indices equal to JAX's on JAX's draws. ``zero`` pins the reference
    behaviour with every weight underflowed: systematic falls back to a
    uniform pick, multinomial and stratified return particle 0."""
    rng = np.random.default_rng(7)
    n = 64
    w = {"random": rng.random(n), "peaked": np.exp(-rng.random(n) * 40),
         "zero": np.zeros(n)}[kind]
    key = jax.random.key(11)
    ref = np.asarray(getattr(jpf, f"resample_{name}")(key, jnp.asarray(w)))
    draws = uniform(key, () if name == "systematic" else (n,))
    got = tpf._RESAMPLERS[name](t(w), t(draws))
    np.testing.assert_array_equal(got.numpy(), ref)
    if kind == "zero":
        want = np.arange(n) if name == "systematic" else np.zeros(n)
        np.testing.assert_array_equal(got.numpy(), want)
    g = torch.Generator().manual_seed(0)
    assert getattr(tpf, f"resample_{name}")(g, t(w)).shape == (n,)


def test_resampling_degenerate_weight():
    """Mirror: all mass on one particle -> every index points at it."""
    w = t([0.0, 0.0, 1.0, 0.0])
    g = torch.Generator().manual_seed(3)
    for fn in (tl.resample_multinomial, tl.resample_stratified,
               tl.resample_systematic):
        assert torch.all(fn(g, w) == 2)


def test_resampling_distribution():
    """Mirror: all three schemes resample proportionally to the weights."""
    w = np.array([0.1, 0.4, 0.2, 0.3])
    n = 4000
    rng = np.random.default_rng(0)
    labels = np.tile(np.arange(4), n // 4)
    rng.shuffle(labels)
    big_w = t(w[labels] / (n // 4))
    g = torch.Generator().manual_seed(2)
    for fn in (tl.resample_multinomial, tl.resample_stratified,
               tl.resample_systematic):
        idx = fn(g, big_w).numpy()
        freq = np.bincount(labels[idx], minlength=4) / n
        np.testing.assert_allclose(freq, w, atol=0.05)


def _sp_pf_kwargs(resampling, jax_side):
    q, r = _sp_noise()
    if jax_side:
        return dict(r=jnp.asarray(q), q=jnp.asarray(r),
                    motion_model=jm.SimpleProblemMotionModel.create(),
                    measurement_model=jm.SimpleProblemMeasurementModel.create(),
                    resampling=resampling)
    return dict(r=t(q), q=t(r),
                motion_model=tm.SimpleProblemMotionModel.create(),
                measurement_model=tm.SimpleProblemMeasurementModel.create(),
                resampling=resampling)


def _pf_draws(key, n, s, resampling):
    k_noise, k_res = jax.random.split(key)
    return (t(normal(k_noise, (n, s))),
            t(uniform(k_res, () if resampling == "systematic" else (n,))))


@pytest.mark.parametrize("resampling", RESAMPLERS)
def test_particle_filter_matches_jax(resampling):
    jf = jl.ParticleFilter(**_sp_pf_kwargs(resampling, True))
    tf = tl.ParticleFilter(**_sp_pf_kwargs(resampling, False))
    us, zs = _sp_inputs(6, 1)
    p0 = np.random.default_rng(1).standard_normal((64, 4))
    jp, tp = jnp.asarray(p0), t(p0)
    for i, (u, z) in enumerate(zip(us, zs)):
        key = jax.random.key(100 + i)
        jp = jf.step(key, jp, jnp.asarray(u), jnp.asarray(z), 0.1)
        tp = tf._step(tp, t(u), t(z), 0.1, *_pf_draws(key, 64, 4, resampling))
        close(tp, jp)
    g = torch.Generator().manual_seed(0)
    assert tf.step(g, tp, t(us[0]), t(zs[0]), 0.1).shape == (64, 4)


def test_adaptive_particle_filter_matches_jax():
    kw = _sp_pf_kwargs("systematic", True)
    jf = jl.AdaptiveParticleFilter(ess_frac=0.5, **kw)
    tkw = _sp_pf_kwargs("systematic", False)
    tf = tl.AdaptiveParticleFilter(ess_frac=0.5, **tkw)
    us, zs = _sp_inputs(12, 2)
    p0 = np.random.default_rng(2).standard_normal((64, 4))
    jp, jw, tp, tw = jnp.asarray(p0), jnp.zeros(64), t(p0), t(np.zeros(64))
    dids = []
    for i, (u, z) in enumerate(zip(us, zs)):
        key = jax.random.key(200 + i)
        jp, jw, jdid = jf.step(key, jp, jw, jnp.asarray(u), jnp.asarray(z),
                               0.1)
        tp, tw, tdid = tf._step(tp, tw, t(u), t(z), 0.1,
                                *_pf_draws(key, 64, 4, "systematic"))
        close(tp, jp)
        close(tw, jw)
        assert int(tdid) == int(jdid)
        dids.append(int(tdid))
    assert 0 < sum(dids) < len(dids)  # both branches taken


def test_always_resample_matches_plain_sir():
    """Mirror of tests/test_pf_adaptive.py: ess_frac > 1 resamples every
    step, and the trajectory equals ParticleFilter's on the same draws."""
    kw = _sp_pf_kwargs("systematic", False)
    kw["r"] = t(np.diag([0.2, 0.2, np.deg2rad(3.0), 0.1]) ** 2)
    kw["q"] = t(np.diag([0.4, 0.4]) ** 2)
    plain = tl.ParticleFilter(**kw)
    adaptive = tl.AdaptiveParticleFilter(ess_frac=2.0, **kw)
    p0 = torch.randn((256, 4), generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64)
    p_plain, p_adapt, logw = p0, p0, torch.zeros(256, dtype=torch.float64)
    u, z = t([1.0, 0.1]), t([0.3, 0.2])
    for i in range(5):
        g1 = torch.Generator().manual_seed(i + 1)
        g2 = torch.Generator().manual_seed(i + 1)
        p_plain = plain.step(g1, p_plain, u, z, 0.1)
        p_adapt, logw, did = adaptive.step(g2, p_adapt, logw, u, z, 0.1)
        assert int(did) == 1
        assert torch.equal(p_plain, p_adapt)
        assert torch.equal(logw, torch.zeros_like(logw))


def test_pf_kc_matches_jax():
    rng, jt, tt = _kc_world()
    q = np.diag([0.1, 0.2])
    jf = jl.ParticleFilterKnownCorrespondences(
        q=jnp.asarray(q), landmarks=jt,
        motion_model=jm.VelocityMotionModel.create(jnp.asarray(ALPHA)),
        measurement_model=jm.RangeBearingMeasurementModel.create())
    tf = tl.ParticleFilterKnownCorrespondences(
        q=t(q), landmarks=tt,
        motion_model=tm.VelocityMotionModel.create(ALPHA, device="cpu"),
        measurement_model=tm.RangeBearingMeasurementModel.create())
    p0 = rng.standard_normal((64, 3)) * 0.3
    jp, tp = jnp.asarray(p0), t(p0)
    for i, args in enumerate(zip(*_kc_events(rng, 12))):
        key = jax.random.key(300 + i)
        k_prop, k_res = jax.random.split(key)
        motion = np.stack([normal(k, (64,))
                           for k in jax.random.split(k_prop, 3)])
        jp = jf.step(key, jp, *map(jnp.asarray, args))
        u, hc, ids, z, mask, dt = map(t, args)
        tp = tf._step(tp, u, hc, ids, z, mask, dt, t(motion),
                      t(uniform(k_res, (64,))))
        close(tp, jp)
    g = torch.Generator().manual_seed(0)
    assert tf.step(g, tp, u, hc, ids, z, mask, dt).shape == (64, 3)


def _simulation_draws(algo, steps, n):
    """The draws of the JAX package's run_simulation(key(0)), by its own
    key tree."""
    key = jax.random.key(0)
    draws = {}
    if algo == "pf":
        key, k_init = jax.random.split(key)
        draws["init"] = normal(k_init, (n, 4))

    def per_step(k):
        k_obs, k_filt = jax.random.split(k)
        k_gps, k_u = jax.random.split(k_obs)
        k_noise, k_res = jax.random.split(k_filt)
        return (normal(k_gps, (2,)), normal(k_u, (2,)),
                normal(k_noise, (n, 4)), uniform(k_res, (n,)))

    out = jax.vmap(per_step)(jax.random.split(key, steps))
    draws.update(gps=out[0], input=out[1])
    if algo == "pf":
        draws.update(noise=out[2], resample=out[3])
    return {k: t(v) for k, v in draws.items()}


@pytest.mark.parametrize("algo", ["ekf", "ukf", "pf"])
def test_simulation_matches_jax(algo):
    """200 steps (sim_time 20 s), the PF with 64 particles: every history
    entry equal to the JAX package's run on key(0)."""
    ref = jsim.run_simulation_jit(jax.random.key(0), algo=algo, sim_time=20.0,
                                  num_particles=64, dtype=F64)
    got = tsim._run_simulation(_simulation_draws(algo, 200, 64), algo,
                               sim_time=20.0, num_particles=64,
                               dtype=torch.float64, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k])


def _rmse(a, b):
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, -1))))


def _run_port_simulation(algo):
    hist = tsim.run_simulation_jit(torch.Generator().manual_seed(0),
                                   algo=algo, dtype=torch.float64,
                                   device="cpu")
    return {k: v.numpy() for k, v in hist.items()}


def test_simulation_ekf_tracks():
    """Mirrors of the JAX package's tracking tests, on torch draws."""
    hist = _run_port_simulation("ekf")
    err_est = _rmse(hist["x_est"][:, :2], hist["x_true"][:, :2])
    err_dr = _rmse(hist["x_dr"][:, :2], hist["x_true"][:, :2])
    assert err_est < 0.5, err_est
    assert err_est < err_dr
    covs = hist["cov_est"]
    np.testing.assert_allclose(covs, np.swapaxes(covs, -1, -2), atol=1e-8)
    assert np.linalg.eigvalsh(covs[-1]).min() > -1e-9


def test_simulation_ukf_tracks():
    hist = _run_port_simulation("ukf")
    err = _rmse(hist["x_est"][:, :2], hist["x_true"][:, :2])
    assert err < 0.5, err


def test_simulation_pf_tracks():
    hist = _run_port_simulation("pf")
    err = _rmse(hist["x_est"][:, :2], hist["x_true"][:, :2])
    assert err < 0.7, err
