"""The port's EKF-SLAM against the JAX package's, f64 on the CPU, on the
JAX EKF-SLAM tests' simulated circle (tests/test_ekf_slam.py::_simulate,
60 steps): each method on one state (slot k an int and a device tensor),
the known-correspondence step, ML association (a match, a slot that
opens, a measurement that is discarded, a full map), the
unknown-correspondence step and the Schmidt step, every state to atol
1e-9; the selects of a masked step against the skipped slots bit for
bit."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import ekf_slam as jes
from rustrobotics_tpu.models import VelocityMotionModel as JVel
from rustrobotics_tpu_torch.mapping import ekf_slam as tes
from rustrobotics_tpu_torch.models import VelocityMotionModel as TVel

ATOL = 1e-9
ALPHA = [0.005] * 4 + [0.001] * 2
Q = np.diag([0.03 ** 2, 0.01 ** 2])
X0 = np.array([3.0, 0.0, np.pi / 2])


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def same_state(ts, js, atol=ATOL):
    close(ts.x, js.x, atol)
    close(ts.cov, js.cov, atol)
    assert (ts.seen.numpy() == np.asarray(js.seen)).all()


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()


def simulate(num_steps=60):
    """tests/test_ekf_slam.py::_simulate (chip_smoke.ekf_sim) without
    the true poses."""
    return cs.ekf_sim(num_steps)[1:]


def slams(max_landmarks=6, alpha=5.991, beta=25.0):
    js = jes.EkfSlamKnownCorrespondences.create(
        q=jnp.asarray(Q), motion_model=JVel.create(jnp.asarray(ALPHA)),
        max_landmarks=max_landmarks, alpha=alpha, beta=beta)
    ts = tes.EkfSlamKnownCorrespondences.create(
        q=t(Q), motion_model=TVel.create(ALPHA, "cpu", torch.float64),
        max_landmarks=max_landmarks, alpha=alpha, beta=beta)
    return js, ts


def from_jax(js):
    return tes.ekf_slam_state_from_numpy(np.asarray(js.x), np.asarray(js.cov),
                                         np.asarray(js.seen), device="cpu")


@pytest.fixture(scope="module")
def sim():
    return simulate()


def _run_known(sim, steps):
    """Both packages through ``steps`` known-correspondence steps."""
    lms, zs, masks, u, dt = sim
    js, ts = slams()
    jstep = jax.jit(lambda st, hc, ids, z, m: js.step(
        st, jnp.asarray(u), hc, ids, z, m, dt))
    jst = js.init_state(jnp.asarray(X0))
    tst = ts.init_state(t(X0))
    ids = np.arange(6)
    for i in range(steps):
        hc = i % 7 != 3  # some events without control
        jst = jstep(jst, jnp.asarray(hc), jnp.asarray(ids), jnp.asarray(zs[i]),
                    jnp.asarray(masks[i]))
        tst = ts.step(tst, t(u), torch.tensor(hc), t(ids), t(zs[i]),
                      t(masks[i]), dt)
    return js, ts, jst, tst


def test_known_correspondence_steps_match_jax(sim):
    _, _, jst, tst = _run_known(sim, 60)
    same_state(tst, jst)
    # 60 steps see half the circle: the unseen slots keep their prior
    assert int(tst.seen.sum()) == 3 and float(tst.cov[-1, -1]) > 1e5


def test_methods_match_jax(sim):
    """predict, _initialize_landmark, the Jacobian, z_pred and update_one
    on a mid-run state, slot k as an int and as a 0-dim tensor."""
    lms, zs, masks, u, dt = sim
    js, ts, jst, _ = _run_known(sim, 25)
    tst = from_jax(jst)
    same_state(ts.predict(tst, t(u), dt), js.predict(jst, jnp.asarray(u), dt))
    z = np.array([2.5, 0.3])
    for k in (1, 4):
        for kk in (k, torch.tensor(k)):
            same_state(ts._initialize_landmark(tst, kk, t(z)),
                       js._initialize_landmark(jst, k, jnp.asarray(z)))
            close(ts._measurement_jacobian(tst, kk),
                  js._measurement_jacobian(jst, k))
            close(ts._z_pred(tst, kk), js._z_pred(jst, k))
            close(tst.landmark(kk), jst.landmark(k))
            for valid in (True, False):
                same_state(ts.update_one(tst, kk, t(z), torch.tensor(valid)),
                           js.update_one(jst, k, jnp.asarray(z),
                                         jnp.asarray(valid)))
    close(tst.robot, jst.robot, 0)
    close(tst.landmarks, jst.landmarks, 0)


def test_fresh_slot_update_matches_jax():
    """update_one on a never-seen slot initializes it (seen flips)."""
    js, ts = slams()
    jst = js.init_state(jnp.asarray(X0))
    tst = ts.init_state(t(X0))
    z = np.array([3.0, -0.4])
    jn = js.update_one(jst, 2, jnp.asarray(z), jnp.asarray(True))
    tn = ts.update_one(tst, torch.tensor(2), t(z), True)
    same_state(tn, jn)
    assert tn.seen[2] and not tst.seen[2]


def test_skipped_slots_equal_masked_step_bitwise(sim):
    """_update on the valid slots only (a replay's host skip) gives the
    masked step's state bit for bit."""
    lms, zs, masks, u, dt = sim
    _, ts = slams()
    a = b = ts.init_state(t(X0))
    for i in range(20):
        a = ts.step(a, t(u), True, t(np.arange(6)), t(zs[i]), t(masks[i]),
                    dt)
        b = ts.predict(b, t(u), dt)
        for k in np.flatnonzero(masks[i]):
            b = ts._update(b, int(k), t(zs[i][k]))
    assert torch.equal(a.x, b.x) and torch.equal(a.cov, b.cov)
    assert torch.equal(a.seen, b.seen)


def test_associate_match_new_discard_full(sim):
    """The three outcomes of the two-gate scheme, and a map with no free
    slot, equal to JAX's."""
    lms, zs, masks, u, dt = sim
    js, ts, jst, _ = _run_known(sim, 25)
    js8, ts8 = slams(max_landmarks=8)
    # the 6-slot state padded to 8 slots: two free, never seen
    x = np.concatenate([np.asarray(jst.x), np.zeros(4)])
    cov = np.eye(19) * 1e6
    cov[:15, :15] = np.asarray(jst.cov)
    seen = np.concatenate([np.asarray(jst.seen), [False, False]])
    jst8 = jes.EkfSlamState(x=jnp.asarray(x), cov=jnp.asarray(cov),
                            seen=jnp.asarray(seen))
    tst8 = tes.ekf_slam_state_from_numpy(x, cov, seen, device="cpu")
    k0 = int(np.flatnonzero(seen)[0])
    zp = np.asarray(js8._z_pred(jst8, k0))
    outcomes = set()
    for dr in (0.0, 0.02, 0.05, 0.08, 0.12, 0.2, 3.0):
        z = zp + np.array([dr, 0.0])
        kj, nj, uj = js8.associate(jst8, jnp.asarray(z))
        kt, nt, ut = ts8.associate(tst8, t(z))
        assert (int(kt), bool(nt), bool(ut)) == (int(kj), bool(nj), bool(uj))
        outcomes.add(("match" if bool(uj) and not bool(nj) else
                      "new" if bool(uj) else "discard"))
        if dr == 3.0:  # a new track: the first free slot
            assert bool(nt) and int(kt) == int(np.argmin(seen))
    assert outcomes == {"match", "new", "discard"}, outcomes
    # the map of the seen slots alone is full: a new track is not usable
    slots = np.flatnonzero(np.asarray(jst.seen))
    rows = np.concatenate([[0, 1, 2], (3 + 2 * slots[:, None]
                                       + np.arange(2)).ravel()])
    xf = np.asarray(jst.x)[rows]
    covf = np.asarray(jst.cov)[np.ix_(rows, rows)]
    jsf, tsf = slams(max_landmarks=len(slots))
    jfull = jes.EkfSlamState(x=jnp.asarray(xf), cov=jnp.asarray(covf),
                             seen=jnp.ones(len(slots), bool))
    tfull = from_jax(jfull)
    z = zp + np.array([3.0, 0.0])
    kj, nj, uj = jsf.associate(jfull, jnp.asarray(z))
    kt, nt, ut = tsf.associate(tfull, t(z))
    assert (int(kt), bool(nt), bool(ut)) == (int(kj), bool(nj), bool(uj))
    assert bool(nt) and not bool(ut)


def test_unknown_correspondence_steps_match_jax(sim):
    """step_unknown on the shuffled stream: tracks open (and the spare
    slots stay free) as in JAX, state for state."""
    lms, zs, masks, u, dt = sim
    js, ts = slams(max_landmarks=8)
    rng = np.random.default_rng(7)
    jstep = jax.jit(lambda st, z, m: js.step_unknown(
        st, jnp.asarray(u), jnp.asarray(True), z, m, dt))
    jst = js.init_state(jnp.asarray(X0))
    tst = ts.init_state(t(X0))
    for i in range(60):
        p = rng.permutation(6)
        jst = jstep(jst, jnp.asarray(zs[i][p]), jnp.asarray(masks[i][p]))
        tst = ts.step_unknown(tst, t(u), True, t(zs[i][p]),
                              t(masks[i][p]), dt)
        same_state(tst, jst, 1e-8)
    assert 0 < int(tst.seen.sum()) < 8


def test_schmidt_steps_match_jax(sim):
    """schmidt_step with half the landmarks as consider states after a
    warm-up: the frozen landmarks keep their means."""
    lms, zs, masks, u, dt = sim
    js, ts = slams()
    jstep = jax.jit(lambda st, ids, z, m, cl: jes.schmidt_step(
        js, st, jnp.asarray(u), True, ids, z, m, dt, cl))
    jst = js.init_state(jnp.asarray(X0))
    tst = ts.init_state(t(X0))
    ids = np.arange(6)
    for i in range(60):
        cl = np.array([False, False, False, True, True, True]) if i >= 30 \
            else np.zeros(6, bool)
        before = tst.landmarks[3:].clone()
        jst = jstep(jst, jnp.asarray(ids), jnp.asarray(zs[i]),
                    jnp.asarray(masks[i]), jnp.asarray(cl))
        tst = tes.schmidt_step(ts, tst, t(u), True, t(ids), t(zs[i]),
                               t(masks[i]), dt, t(cl))
        # the 1e6 prior of the consider slots' cross terms amplifies
        # rounding: 1.3e-9 after 60 steps
        same_state(tst, jst, 1e-8)
        if i >= 31:
            frozen = tst.seen[3:] & (before.abs().sum(-1) > 0)
            assert torch.equal(tst.landmarks[3:][frozen], before[frozen])
    # one update on a fresh consider slot initializes it
    jst0, tst0 = js.init_state(jnp.asarray(X0)), ts.init_state(t(X0))
    cl = np.ones(6, bool)
    z = np.array([2.0, 0.5])
    jn = jes.schmidt_update_one(js, jst0, 3, jnp.asarray(z), True,
                                jnp.asarray(cl))
    tn = tes.schmidt_update_one(ts, tst0, torch.tensor(3), t(z), True, t(cl))
    same_state(tn, jn)


def _schmidt_errors(step, init, dtype, consider_from=60):
    """tests/test_ekf_slam.py's Schmidt scenario (landmarks 3-5 frozen
    from consider_from) through ``step``: (last-40 mean error, least
    eigenvalue of the final covariance)."""
    lms = np.array([[4.0, 0.0], [0.0, 4.0], [-4.0, 0.0], [0.0, -4.0],
                    [3.0, 3.0], [-3.0, 3.0]])
    rng = np.random.default_rng(0)
    st, pose, errs = init, np.zeros(3), []
    for i in range(200):
        th = pose[2]
        pose = pose + np.array([0.08 * np.cos(th), 0.08 * np.sin(th), 0.025])
        d = lms - pose[:2]
        z = np.stack([np.linalg.norm(d, axis=1) + rng.normal(size=6) * 0.1,
                      np.arctan2(d[:, 1], d[:, 0]) - pose[2]
                      + rng.normal(size=6) * 0.05], -1).astype(dtype)
        cl = np.array([False] * 3 + [i >= consider_from] * 3)
        st = step(st, z, cl)
        errs.append(np.linalg.norm(np.asarray(st.x[:2], np.float64)
                                   - pose[:2]))
    return np.mean(errs[-40:]), np.linalg.eigvalsh(
        np.asarray(st.cov, np.float64)).min()


def test_schmidt_loses_psd_in_f32_as_in_jax():
    """A behaviour of the JAX package that the port keeps: the Schmidt
    update's general-gain form P - K HP - (HP)^T K^T + K S K^T is not
    PSD-preserving in rounding: in f32, against the 1e6 prior of fresh
    slots, the JAX Schmidt test's scenario turns indefinite at its first
    update in both packages; in f64 both meet the test's gate and agree
    (1e-9)."""
    alpha = np.array([0.02, 0.005, 0.01, 0.005])
    q = np.diag([0.1, 0.05]) ** 2
    u = np.array([0.8, 0.25])
    for dtype in (np.float32, np.float64):
        js = jes.EkfSlamKnownCorrespondences.create(
            q=jnp.asarray(q, dtype), motion_model=JVel.create(
                jnp.asarray(alpha, dtype)), max_landmarks=6)
        ts = tes.EkfSlamKnownCorrespondences.create(
            q=torch.tensor(q, dtype=torch.float32 if dtype == np.float32
                           else torch.float64),
            motion_model=TVel.create(alpha, "cpu", torch.float32
                                     if dtype == np.float32
                                     else torch.float64),
            max_landmarks=6)
        jstep = jax.jit(lambda st, z, cl: jes.schmidt_step(
            js, st, jnp.asarray(u, dtype), True, jnp.arange(6), z,
            jnp.ones(6, bool), jnp.asarray(0.1, dtype), cl))
        ej, mj = _schmidt_errors(lambda st, z, cl: jstep(
            st, jnp.asarray(z), jnp.asarray(cl)),
            js.init_state(jnp.zeros(3, dtype)), dtype)
        tdt = torch.float32 if dtype == np.float32 else torch.float64
        et, mt = _schmidt_errors(lambda st, z, cl: tes.schmidt_step(
            ts, st, torch.tensor(u, dtype=tdt), True, torch.arange(6),
            torch.tensor(z), torch.ones(6, dtype=torch.bool), 0.1,
            torch.tensor(cl)), ts.init_state(torch.zeros(3, dtype=tdt)),
            dtype)
        if dtype == np.float32:
            # indefinite from the first update (one f32 unit of the 1e6
            # prior); from there the two f32 runs part by rounding, and
            # their errors are chance (0.17 and 1.02 m on this draw)
            assert mj < 0 and mt < 0, (mj, mt)
        else:
            assert ej < 0.2 and et < 0.2 and abs(ej - et) < 1e-9
            assert mj > 0 and mt > 0
