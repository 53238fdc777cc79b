"""The port's Gaussian state, MVN, motion and measurement models against
the JAX package's, f64 on the CPU, on the same seeded numpy inputs (rtol
1e-9). Stochastic samplers get the draws of JAX's own keys (the private
``_sample`` forms) and must match JAX's samples to the same tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu import models as jm
from rustrobotics_tpu.utils import mvn as jmvn
from rustrobotics_tpu_torch import models as tm
from rustrobotics_tpu_torch.utils import mvn as tmvn
from rustrobotics_tpu_torch.utils.state import GaussianState, select

RTOL, ATOL = 1e-9, 1e-12
ALPHA = np.array([1.0, 1.0, 30.0, 30.0, 10.0, 10.0])


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def spd(rng, d):
    a = rng.standard_normal((d, d))
    return a @ a.T + d * np.eye(d)


def test_gaussian_state_select():
    a = GaussianState(x=t(np.ones(3)), cov=t(np.eye(3)))
    b = GaussianState(x=t(np.zeros(3)), cov=t(2 * np.eye(3)))
    assert a.dim == 3
    assert select(True, a, b) is a and select(np.bool_(False), a, b) is b
    s = select(torch.tensor(False), a, b)
    close(s.x, np.zeros(3))
    close(s.cov, 2 * np.eye(3))


def test_mvn_matches_jax():
    rng = np.random.default_rng(0)
    mean, cov = rng.standard_normal(3), spd(rng, 3)
    ref = jmvn.MultiVariateNormal.create(jnp.asarray(mean), jnp.asarray(cov))
    got = tmvn.MultiVariateNormal.create(mean, cov, device="cpu")
    for name in ("chol", "chol_inv", "log_norm"):
        close(getattr(got, name), getattr(ref, name))
    pts = rng.standard_normal((5, 7, 3))
    close(got.logpdf(t(pts)), ref.logpdf(jnp.asarray(pts)))
    close(got.pdf(t(pts)), ref.pdf(jnp.asarray(pts)))
    key = jax.random.key(3)
    u = jax.random.normal(key, (11, 3), dtype=jnp.float64)
    close(got._sample(t(u)), ref.sample(key, (11,)))
    g = torch.Generator().manual_seed(0)
    assert got.sample(g, (4, 2)).shape == (4, 2, 3)


def test_mvn_rejects_non_spd():
    with pytest.raises(jmvn.CovarianceNotPositiveDefinite):
        jmvn.MultiVariateNormal.create(jnp.zeros(2),
                                       jnp.asarray([[1.0, 2.0], [2.0, 1.0]]))
    with pytest.raises(tmvn.CovarianceNotPositiveDefinite):
        tmvn.MultiVariateNormal.create(np.zeros(2), [[1.0, 2.0], [2.0, 1.0]],
                                       device="cpu")
    # the step form gives NaN throughout instead, as jnp.linalg.cholesky
    low = tmvn.cholesky(t([[1.0, 2.0], [2.0, 1.0]]))
    assert torch.isnan(low).all()
    close(tmvn.cholesky(t([[4.0, 2.0], [2.0, 3.0]])),
          jnp.linalg.cholesky(jnp.asarray([[4.0, 2.0], [2.0, 3.0]])))


def _velocity_inputs(rng, n=9):
    x = rng.standard_normal((n, 3))
    u = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-0.6, 0.6, n)], -1)
    u[:3, 1] = [0.0, 1e-12, -3e-11]  # the straight-line branch
    return x, u


@pytest.mark.parametrize("dt", [0.1, 0.015])
def test_velocity_model_matches_jax(dt):
    rng = np.random.default_rng(1)
    x, u = _velocity_inputs(rng)
    ref = jm.VelocityMotionModel.create(jnp.asarray(ALPHA))
    got = tm.VelocityMotionModel.create(ALPHA, device="cpu")
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    for name in ("prediction", "jacobian_wrt_state", "jacobian_wrt_input",
                 "pose_noise_cov"):
        close(getattr(got, name)(t(x), t(u), dt),
              getattr(ref, name)(jx, ju, dt))
    close(got.cov_noise_control_space(t(u)), ref.cov_noise_control_space(ju))
    # one step of the sampler on JAX's draws
    key = jax.random.key(5)
    draws = [jax.random.normal(k, (9,), dtype=jnp.float64)
             for k in jax.random.split(key, 3)]
    close(got._sample(t(x), t(u), dt, t(np.stack(draws))),
          ref.sample(key, jx, ju, dt))
    g = torch.Generator().manual_seed(0)
    assert got.sample(g, t(x), t(u), dt).shape == (9, 3)


def test_simple_problem_models_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 4))
    u = rng.standard_normal((6, 2))
    ref, got = jm.SimpleProblemMotionModel.create(), \
        tm.SimpleProblemMotionModel.create()
    for name in ("prediction", "jacobian_wrt_state"):
        close(getattr(got, name)(t(x), t(u), 0.1),
              getattr(ref, name)(jnp.asarray(x), jnp.asarray(u), 0.1))
    close(got.sample(None, t(x), t(u), 0.1),
          ref.sample(jax.random.key(0), jnp.asarray(x), jnp.asarray(u), 0.1))
    jmeas = jm.SimpleProblemMeasurementModel.create()
    tmeas = tm.SimpleProblemMeasurementModel.create()
    close(tmeas.prediction(t(x)), jmeas.prediction(jnp.asarray(x)))
    close(tmeas.jacobian(t(x)), jmeas.jacobian(jnp.asarray(x)))


def test_range_bearing_model_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 3))
    lm = rng.uniform(-5, 5, (8, 3))
    ref, got = jm.RangeBearingMeasurementModel.create(), \
        tm.RangeBearingMeasurementModel.create()
    for name in ("prediction", "jacobian"):
        close(getattr(got, name)(t(x), t(lm)),
              getattr(ref, name)(jnp.asarray(x), jnp.asarray(lm)))
        # one landmark against a cloud, as the particle filters call it
        close(getattr(got, name)(t(x), t(lm[0])),
              jax.vmap(lambda xx: getattr(ref, name)(xx, jnp.asarray(lm[0])))(
                  jnp.asarray(x)))


def test_odometry_model_matches_jax():
    from rustrobotics_tpu.models.motion import OdometryMotionModel as JOdo

    rng = np.random.default_rng(4)
    alphas = np.array([0.05, 0.01, 0.02, 0.01])
    x = rng.standard_normal((5, 3))
    u = np.array([0.1, 0.8, -0.05])
    ref = JOdo.create(jnp.asarray(alphas))
    got = tm.OdometryMotionModel.create(alphas, device="cpu")
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    for name in ("prediction", "jacobian_wrt_state", "jacobian_wrt_input",
                 "pose_noise_cov"):
        close(getattr(got, name)(t(x), t(u), 0.1),
              getattr(ref, name)(jx, ju, 0.1))
    close(got.cov_noise_control_space(t(u)), ref.cov_noise_control_space(ju))
    key = jax.random.key(9)
    noise = jax.random.normal(key, (3,), dtype=jnp.float64)
    close(got._sample(t(x), t(u), 0.1, t(noise)), ref.sample(key, jx, ju, 0.1))
