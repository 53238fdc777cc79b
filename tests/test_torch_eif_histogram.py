"""The port's extended information filters and histogram filter against
the JAX package's, f64 on the CPU, on the same seeded numpy inputs (rtol
1e-9); the bilinear shift against ``map_coordinates``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu import localization as jl
from rustrobotics_tpu import models as jm
from rustrobotics_tpu.localization import eif as jeif
from rustrobotics_tpu.localization import histogram as jh
from rustrobotics_tpu.utils.state import GaussianState as JState
from rustrobotics_tpu_torch import localization as tl
from rustrobotics_tpu_torch import models as tm
from rustrobotics_tpu_torch.localization import eif as teif
from rustrobotics_tpu_torch.localization import histogram as th
from rustrobotics_tpu_torch.utils.state import GaussianState

RTOL, ATOL = 1e-9, 1e-12


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_eif_matches_jax():
    r = np.diag([0.1, 0.1, 0.01, 0.5]) ** 2
    q = np.eye(2) * 0.25
    zs = np.random.default_rng(0).normal(size=(30, 2)) * 0.3
    jf = jeif.ExtendedInformationFilter(
        r=jnp.asarray(r), q=jnp.asarray(q),
        motion_model=jm.SimpleProblemMotionModel.create(),
        measurement_model=jm.SimpleProblemMeasurementModel.create())
    tf = teif.ExtendedInformationFilter(
        r=t(r), q=t(q), motion_model=tm.SimpleProblemMotionModel.create(),
        measurement_model=tm.SimpleProblemMeasurementModel.create())
    start = JState(x=jnp.zeros(4), cov=jnp.eye(4))
    js = jeif.InformationState.from_moments(start)
    ts = teif.InformationState.from_moments(
        GaussianState(x=t(np.zeros(4)), cov=t(np.eye(4))))
    u = np.array([1.0, 0.1])
    for z in zs:
        js = jf.step(js, jnp.asarray(u), jnp.asarray(z), 0.1)
        ts = tf.step(ts, t(u), t(z), 0.1)
        close(ts.eta, js.eta)
        close(ts.lam, js.lam)
    close(ts.x, js.x)
    close(ts.to_moments().cov, js.to_moments().cov)


def test_eif_kc_matches_jax():
    """EIF-KC over 30 events with optional controls and masked/unknown
    slots, and the EKF-KC on the same events stays close (the JAX
    package's duality test: the batched relinearization differs from the
    sequential refinement only slightly)."""
    rng = np.random.default_rng(1)
    ids = np.array([0, 1, 2, 3], np.int32)
    pos = np.array([[2.0, 1.0, 0.0], [-1.0, 3.0, 0.0], [0.5, -2.0, 0.0],
                    [3.0, -1.0, 0.0]])
    alpha = np.array([0.05, 0.01, 0.02, 0.01, 0.01, 0.01])
    q = np.diag([0.1, 0.05]) ** 2
    jkw = dict(q=jnp.asarray(q),
               landmarks=jl.LandmarkTable.create(ids=ids, positions=pos),
               motion_model=jm.VelocityMotionModel.create(jnp.asarray(alpha)),
               measurement_model=jm.RangeBearingMeasurementModel.create())
    tkw = dict(q=t(q),
               landmarks=tl.LandmarkTable.create(ids=ids, positions=pos,
                                                 device="cpu"),
               motion_model=tm.VelocityMotionModel.create(alpha,
                                                          device="cpu"),
               measurement_model=tm.RangeBearingMeasurementModel.create())
    jf = jax.jit(jeif.ExtendedInformationFilterKnownCorrespondences(
        **jkw).step)
    tf = teif.ExtendedInformationFilterKnownCorrespondences(**tkw)
    ekf = tl.ExtendedKalmanFilterKnownCorrespondences(**tkw)
    start = GaussianState(x=t(np.zeros(3)), cov=t(np.eye(3) * 0.01))
    js = jeif.InformationState.from_moments(
        JState(x=jnp.zeros(3), cov=jnp.eye(3) * 0.01))
    ts = teif.InformationState.from_moments(start)
    ks = start
    pose = np.zeros(3)
    for k in range(30):
        pose = pose + np.array([0.07 * np.cos(pose[2]),
                                0.07 * np.sin(pose[2]), 0.025])
        d = pos[:, :2] - pose[:2]
        z = np.stack([np.hypot(d[:, 0], d[:, 1]) + rng.normal(size=4) * 0.1,
                      np.arctan2(d[:, 1], d[:, 0]) - pose[2]
                      + rng.normal(size=4) * 0.05], -1)
        ev = (np.array([0.7, 0.25]), k % 4 != 3,
              np.where(rng.random(4) < 0.2, 9, ids).astype(np.int32), z,
              rng.random(4) > 0.2, 0.1)
        js = jf(js, *map(jnp.asarray, ev))
        ts = tf.step(ts, *map(t, ev))
        ks = ekf.step(ks, *map(t, ev))
        close(ts.eta, js.eta, RTOL, 1e-9)
        close(ts.lam, js.lam)
    assert np.linalg.norm(ts.x.numpy()[:2] - ks.x.numpy()[:2]) < 0.15


def test_bilinear_matches_map_coordinates():
    """Order-1, mode "constant" sampling with corners off the grid."""
    rng = np.random.default_rng(2)
    b = rng.random((9, 7, 5))
    sx = rng.uniform(-3, 3, 5)
    sy = rng.uniform(-3, 3, 5)
    ii, jj = np.arange(9.0), np.arange(7.0)
    want = np.stack([
        np.asarray(jax.scipy.ndimage.map_coordinates(
            jnp.asarray(b[:, :, k]),
            jnp.meshgrid(ii - sx[k], jj - sy[k], indexing="ij"),
            order=1, mode="constant", cval=0.0)) for k in range(5)], -1)
    got = th._bilinear(t(b), t(ii)[:, None, None] - t(sx),
                       t(jj)[None, :, None] - t(sy))
    close(got, want)


def _hist_filters():
    lms = np.array([[2.0, 2.0], [-2.0, 1.0], [0.0, -2.0]])
    q = np.diag([0.15, 0.08]) ** 2
    sig = (0.08, 0.08, 0.06)
    return (jh.HistogramFilter.create(landmarks=jnp.asarray(lms),
                                      q=jnp.asarray(q), motion_sigma=sig),
            th.HistogramFilter.create(landmarks=lms, q=q, motion_sigma=sig,
                                      device="cpu"))


@pytest.mark.parametrize("turn", [0.2, -2.5])
def test_histogram_filter_matches_jax(turn):
    """Five steps on a 24 x 20 x 12 grid from a peaked start, one without
    control; the heading change rolls theta by a fraction of a bin
    (0.2 rad/s) or by more than one bin, backwards (-2.5 rad/s)."""
    jf, tf = _hist_filters()
    shape, origin = (24, 20, 12), (-3.0, -2.5, 0.25, 0.25)
    pose = np.array([0.5, -0.5, 0.4])
    jg = jf.init_at(shape, *origin, jnp.asarray(pose))
    tg = tf.init_at(shape, *origin, pose)
    close(tg.belief, jg.belief)
    rng = np.random.default_rng(3)
    jstep = jax.jit(jf.step)
    u = np.array([0.6, turn])
    for k in range(5):
        z = np.stack([rng.uniform(1, 4, 3), rng.uniform(-2, 2, 3)], -1)
        ev = (u, k != 2, np.array([0, 2, 1], np.int32), z,
              np.array([True, k % 2 == 0, True]), 0.5)
        jg = jstep(jg, *map(jnp.asarray, ev))
        tg = tf.step(tg, *map(t, ev))
        close(tg.belief, jg.belief, RTOL, 1e-14)
    close(tg.estimate(), jg.estimate())


def test_histogram_filter_localizes_from_uniform():
    """Mirror of the JAX package's kidnapped-robot test on the port."""
    _, tf = _hist_filters()
    g = tf.init_uniform((40, 40, 24), -4.0, -4.0, 0.2, 0.2)
    rng = np.random.default_rng(0)
    lms = tf.landmarks.numpy()
    pose = np.array([0.5, -0.5, 0.4])
    for _ in range(30):
        th_ = pose[2]
        pose = pose + np.array([0.06 * np.cos(th_), 0.06 * np.sin(th_), 0.02])
        d = lms - pose[:2]
        z = np.stack([np.linalg.norm(d, axis=1) + rng.normal(size=3) * 0.1,
                      np.arctan2(d[:, 1], d[:, 0]) - pose[2]
                      + rng.normal(size=3) * 0.05], -1)
        g = tf.step(g, t([0.6, 0.2]), True, torch.arange(3), t(z),
                    torch.ones(3, dtype=torch.bool), 0.1)
    est = g.estimate().numpy()
    assert np.linalg.norm(est[:2] - pose[:2]) < 0.35, (est, pose)
    assert abs((est[2] - pose[2] + np.pi) % (2 * np.pi) - np.pi) < 0.35
