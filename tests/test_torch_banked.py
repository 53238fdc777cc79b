"""The port's banked (bank-axis-last) filters against the JAX package's
banked filters and against the port's own unbanked filters run with a
leading batch axis, f64 on the CPU, banks of 16-64 from seeded numpy
inputs (rtol 1e-9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu import localization as jl
from rustrobotics_tpu.localization import banked as jb
from rustrobotics_tpu_torch import localization as tl
from rustrobotics_tpu_torch import models as tm
from rustrobotics_tpu_torch.localization import banked as tb
from rustrobotics_tpu_torch.utils.state import GaussianState

RTOL, ATOL = 1e-9, 1e-12
ALPHA = np.array([1.0, 1.0, 30.0, 30.0, 10.0, 10.0])
Q_SP = np.diag([0.1, 0.1, np.deg2rad(1.0), 1.0]) ** 2
R_SP = np.diag([1.0, 1.0]) ** 2


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_banked_primitives():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((3, 4, 32)), rng.standard_normal((4, 2, 32))
    close(tb.bmm(t(a), t(b)), np.einsum("ijb,jkb->ikb", a, b))
    close(tb.bmv(t(a), t(b[:, 0])), np.einsum("ijb,jb->ib", a, b[:, 0]))
    for m in (1, 2, 3):
        s = rng.standard_normal((32, m, m)) + 3 * np.eye(m)
        close(tb.binv(t(s.transpose(1, 2, 0))),
              np.linalg.inv(s).transpose(1, 2, 0), 1e-9, 1e-12)
    g = rng.standard_normal((32, 4, 4))
    spd = g @ g.transpose(0, 2, 1) + 4 * np.eye(4)
    close(tb.bchol(t(spd.transpose(1, 2, 0))),
          np.linalg.cholesky(spd).transpose(1, 2, 0), 1e-10, 1e-12)


def _sp_bank(seed, bank=64):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((bank, 4))
    u = rng.standard_normal((bank, 2)) * [1.0, 0.3]
    z = rng.standard_normal((bank, 2))
    cov0 = np.eye(4) + 0.1 * np.einsum("bi,bj->bij", x0, x0)
    return x0, u, z, cov0


def _sp_unbanked(kind, alpha=0.001):
    mot = tm.SimpleProblemMotionModel.create()
    meas = tm.SimpleProblemMeasurementModel.create()
    if kind == "ekf":
        return tl.ExtendedKalmanFilter(r=t(Q_SP), q=t(R_SP), motion_model=mot,
                                       measurement_model=meas)
    return tl.UnscentedKalmanFilter.create(
        q=Q_SP, r=R_SP, motion_model=mot, measurement_model=meas,
        alpha=alpha, beta=2.0, kappa=0.0, device="cpu")


# At alpha = 0.001 (the JAX package's banked UKF default) the sigma
# weights reach -1e6, so the moments carry ~1e6 f64 rounding units
# (~2e-10) that depend on the order of the sum: there the absolute
# tolerance is 1e-9.
@pytest.mark.parametrize("kind,alpha,atol", [("ekf", None, ATOL),
                                             ("ukf", 0.1, ATOL),
                                             ("ukf", 0.001, 1e-9)])
def test_simple_problem_banked_matches_jax(kind, alpha, atol):
    """One step of a bank of 64 distinct filters: equal to the JAX banked
    step and to the port's unbanked filter over a leading batch axis."""
    x0, u, z, cov0 = _sp_bank(1)
    if kind == "ekf":
        jf = jb.simple_problem_banked(q=jnp.asarray(Q_SP),
                                      r=jnp.asarray(R_SP))
        tf = tb.simple_problem_banked(q=Q_SP, r=R_SP, device="cpu")
    else:
        jf = jb.simple_problem_banked_ukf(q=jnp.asarray(Q_SP),
                                          r=jnp.asarray(R_SP), alpha=alpha)
        tf = tb.simple_problem_banked_ukf(q=Q_SP, r=R_SP, alpha=alpha,
                                          device="cpu")
    args = (x0.T, cov0.transpose(1, 2, 0), u.T, z.T)
    jx, jcov = jf.step(*map(jnp.asarray, args), 0.1)
    x, cov = tf.step(*map(t, args), 0.1)
    close(x, jx, RTOL, atol)
    close(cov, jcov, RTOL, atol)
    ref = _sp_unbanked(kind, alpha).step(GaussianState(x=t(x0), cov=t(cov0)),
                                  t(u), t(z), 0.1)
    close(x.T, ref.x, 1e-8, 1e-10)
    close(cov.permute(2, 0, 1), ref.cov, 1e-7, 1e-10)


def test_banked_chain_matches_unbanked():
    """50 chained steps of a bank of 16 identical filters track one
    unbanked filter."""
    banked = tb.simple_problem_banked(q=Q_SP, r=R_SP, device="cpu")
    bank = 16
    u = t([1.0, 0.1])[:, None].expand(2, bank)
    z = t([0.3, 0.2])[:, None].expand(2, bank)
    x = torch.zeros((4, bank), dtype=torch.float64)
    cov = torch.eye(4, dtype=torch.float64)[:, :, None].expand(4, 4, bank)
    state = GaussianState(x=t(np.zeros(4)), cov=t(np.eye(4)))
    ekf = _sp_unbanked("ekf")
    for _ in range(50):
        x, cov = banked.step(x, cov, u, z, 0.1)
        state = ekf.step(state, t([1.0, 0.1]), t([0.3, 0.2]), 0.1)
    close(x[:, 3], state.x, 1e-8, 1e-8)
    assert torch.isfinite(cov).all()


def _kc_stream(rng, steps, m=3):
    us = rng.uniform(-1, 1, (steps, 2)) * [1.0, 0.5]
    us[::4, 1] = 0.0  # straight-line steps
    hcs = rng.random(steps) > 0.3
    ids = rng.choice([2, 5, 7, 11, 99], (steps, m)).astype(np.int32)
    zs = np.stack([rng.uniform(0.5, 5.0, (steps, m)),
                   rng.uniform(-3, 3, (steps, m))], axis=-1)
    masks = rng.random((steps, m)) > 0.4
    dts = rng.uniform(0.05, 0.2, steps)
    return us, hcs, ids, zs, masks, dts


@pytest.mark.parametrize("kind", ["ekf", "ukf"])
def test_banked_kc_matches_jax_and_unbanked(kind):
    """The velocity EKF-KC / UKF-KC fleet (bank 16) over 20 events with
    optional controls and masked/unknown slots: equal to the JAX banked
    fleet, and to the port's unbanked KC filter over a leading batch
    axis."""
    rng = np.random.default_rng(3)
    ids = np.array([2, 5, 7, 11, 13], np.int32)
    pos = rng.uniform(-4, 4, (5, 3))
    q = np.diag([0.1, 0.2])
    jt = jl.LandmarkTable.create(ids=ids, positions=pos)
    tt = tl.LandmarkTable.create(ids=ids, positions=pos, device="cpu")
    motion = tm.VelocityMotionModel.create(ALPHA, device="cpu")
    meas = tm.RangeBearingMeasurementModel.create()
    if kind == "ekf":
        jf = jb.velocity_banked_ekf_kc(jnp.asarray(ALPHA), jnp.asarray(q), jt)
        tf = tb.velocity_banked_ekf_kc(ALPHA, q, tt, device="cpu")
        unbanked = tl.ExtendedKalmanFilterKnownCorrespondences(
            q=t(q), landmarks=tt, motion_model=motion,
            measurement_model=meas)
    else:
        jf = jb.velocity_banked_ukf_kc(jnp.asarray(ALPHA), jnp.asarray(q), jt)
        tf = tb.velocity_banked_ukf_kc(ALPHA, q, tt, device="cpu")
        unbanked = tl.UnscentedKalmanFilterKnownCorrespondences.create(
            q=q, landmarks=tt, motion_model=motion, measurement_model=meas,
            device="cpu")
    bank = 16
    x0 = rng.standard_normal((bank, 3)) * 0.5
    cov0 = np.broadcast_to(np.eye(3) * 0.01, (bank, 3, 3))
    ev = _kc_stream(rng, 20)
    jstep = jax.jit(jf.step)
    jx, jcov = jnp.asarray(x0.T), jnp.asarray(cov0.transpose(1, 2, 0))
    x, cov = t(x0.T), t(cov0.transpose(1, 2, 0))
    ref = GaussianState(x=t(x0), cov=t(cov0))
    for u, hc, ids_, z, mask, dt in zip(*ev):
        ub = np.broadcast_to(u[:, None], (2, bank))
        args = (ub, hc, ids_, z, mask, dt)
        jx, jcov = jstep(jx, jcov, *map(jnp.asarray, args))
        x, cov = tf.step(x, cov, *map(t, args))
        ref = unbanked.step(ref, t(u), t(hc), t(ids_), t(z), t(mask), t(dt))
        close(x, jx)
        close(cov, jcov)
    close(x.T, ref.x, 1e-8, 1e-10)
    close(cov.permute(2, 0, 1), ref.cov, 1e-7, 1e-12)
