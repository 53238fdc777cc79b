"""The port's control package against the JAX package's, f64 on the CPU:
the DARE fixed point (the iterate the JAX ``while_loop`` stops at, for
every tolerance, though the port reads its convergence test every 8
iterations) and scipy's ``solve_discrete_are``, the LQR gain, the
inverted pendulum's model and rollout, and LQG synthesis with a 400-step
rollout on JAX's own draws; the JAX control tests' gates on the port.
Tolerances: 1e-9 absolute on gains and states unless stated."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.control import inverted_pendulum as jip
from rustrobotics_tpu.control import lqg as jlqg
from rustrobotics_tpu_torch.control import inverted_pendulum as tip
from rustrobotics_tpu_torch.control import lqg as tlqg

# the packages export a function named as this module
jlqr = importlib.import_module("rustrobotics_tpu.control.lqr")
tlqr = importlib.import_module("rustrobotics_tpu_torch.control.lqr")

F64 = jnp.float64


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, atol=1e-9, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def pendulum(dt=0.01):
    jm = jip.InvertedPendulumModel.create(dtype=F64)
    tm = tip.pendulum_from_numpy(*(np.asarray(getattr(jm, f))
                                   for f in ("da", "db", "q", "r")),
                                 device="cpu")
    return jm.linearize(dt), tm.linearize(dt)


@pytest.mark.parametrize("max_iter,epsilon", [
    (500, 0.01), (500, 1e-3), (3, 0.01), (13, 1e-12), (100000, 1e-10)])
def test_solve_dare_stops_where_jax_stops(max_iter, epsilon):
    jl, tl = pendulum()
    pj = jlqr.solve_dare(jl, max_iter, epsilon)
    pt = tlqr.solve_dare(tl, max_iter, epsilon)
    close(pt, pj, rtol=1e-9)


def test_dare_matches_scipy_and_gain_stabilizes():
    from scipy.linalg import solve_discrete_are

    _, tl = pendulum()
    p = tlqr.solve_dare(tl, max_iter=100000, epsilon=1e-10).numpy()
    p_ref = solve_discrete_are(*(getattr(tl, f).numpy()
                                 for f in ("a", "b", "q", "r")))
    np.testing.assert_allclose(p, p_ref, rtol=1e-6)
    k = tlqr.lqr(tl, max_iter=500, epsilon=0.01)
    jl, _ = pendulum()
    close(k, jlqr.lqr(jl, max_iter=500, epsilon=0.01), rtol=1e-9)
    a_cl = tl.a.numpy() - tl.b.numpy() @ k.numpy()
    assert np.all(np.abs(np.linalg.eigvals(a_cl)) < 1.0)


def test_scalar_system_and_from_numpy():
    """The JAX tests' 1-D golden-ratio fixed point, through
    lti_from_numpy."""
    one = np.ones((1, 1))
    tl = tlqr.lti_from_numpy(one, one, one, one, device="cpu")
    golden = (1 + np.sqrt(5)) / 2
    p = float(tlqr.solve_dare(tl, max_iter=10000, epsilon=1e-12)[0, 0])
    assert abs(p - golden) < 1e-6
    k = float(tlqr.lqr(tl, max_iter=10000, epsilon=1e-12)[0, 0])
    assert abs(k - golden / (1 + golden)) < 1e-6


def test_dare_nan_ends_the_loop_as_in_jax():
    """A NaN step ends JAX's while_loop (NaN >= epsilon is false); the
    port returns the same NaN iterate instead of running on."""
    one = np.ones((1, 1))
    jl = jlqr.LinearTimeInvariantModel(a=jnp.asarray(one), b=jnp.asarray(one),
                                       q=jnp.asarray(one * np.nan),
                                       r=jnp.asarray(one))
    tl = tlqr.lti_from_numpy(one, one, one * np.nan, one, device="cpu")
    assert np.isnan(np.asarray(jlqr.solve_dare(jl, 50))).all()
    assert torch.isnan(tlqr.solve_dare(tl, 50)).all()


def test_inverted_pendulum_matches_jax_and_settles():
    jm = jip.InvertedPendulumModel.create(dtype=F64)
    tm = tip.InvertedPendulumModel.create(dtype=torch.float64, device="cpu")
    for f in ("da", "db", "q", "r"):
        close(getattr(tm, f), getattr(jm, f), 0)
    sj, cj = jip.simulate_inverted_pendulum(dtype=F64)
    st, ct = tip.simulate_inverted_pendulum(dtype=torch.float64,
                                            device="cpu")
    close(st, sj, 1e-9)
    close(ct, cj, 1e-9)
    # the JAX tests' gates
    close(st[-1], np.zeros(4), 1e-3)
    assert float(st[-100:, 2].abs().max()) < 1e-2
    assert ct.shape[0] == st.shape[0]
    s32, _ = tip.simulate_inverted_pendulum(dtype=torch.float32,
                                            device="cpu")
    close(s32, sj, 1e-4)


def _lqg_system():
    dt = 0.02
    g0, lp, mc, mp = 9.8, 0.5, 1.0, 0.1
    a = np.array([[1.0, dt, 0.0, 0.0],
                  [0.0, 1.0, -dt * mp * g0 / mc, 0.0],
                  [0.0, 0.0, 1.0, dt],
                  [0.0, 0.0, dt * (mc + mp) * g0 / (lp * mc), 1.0]])
    b = np.array([[0.0], [dt / mc], [0.0], [-dt / (lp * mc)]])
    q, r = np.diag([1.0, 0.1, 10.0, 0.1]), np.eye(1) * 0.1
    c = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0]])
    return a, b, q, r, c, np.eye(4) * 1e-5, np.eye(2) * 1e-4


def test_lqg_synthesis_and_rollout_match_jax():
    """tests/test_new_components.py::test_lqg_stabilizes_under_noise on
    both packages, the port's rollout fed the draws of JAX's keys."""
    a, b, q, r, c, w, v = _lqg_system()
    jm = jlqr.LinearTimeInvariantModel(*map(jnp.asarray, (a, b, q, r)))
    tm = tlqr.lti_from_numpy(a, b, q, r, device="cpu")
    cj = jlqg.lqg(jm, jnp.asarray(c), jnp.asarray(w), jnp.asarray(v))
    ct = tlqg.lqg(tm, t(c), w, v)
    for f in ("k", "l", "a", "b", "c"):
        close(getattr(ct, f), getattr(cj, f), rtol=1e-9)
    close(tlqg.kalman_gain(t(a), t(c), t(w), t(v)),
          jlqg.kalman_gain(jnp.asarray(a), jnp.asarray(c), w, v), rtol=1e-9)
    x0 = np.array([0.3, 0.0, 0.15, 0.0])
    steps = 400
    wc, vc = np.eye(4) * np.sqrt(1e-5), np.eye(2) * np.sqrt(1e-4)
    xj, xhj, uj = jlqg.rollout(cj, jax.random.key(0), jnp.asarray(x0), steps,
                               w_chol=jnp.asarray(wc), v_chol=jnp.asarray(vc))
    keys = jax.random.split(jax.random.key(0), steps)
    kw, kv = zip(*(jax.random.split(k) for k in keys))
    w_noise = np.stack([jax.random.normal(k, (4,), F64) for k in kw])
    v_noise = np.stack([jax.random.normal(k, (2,), F64) for k in kv])
    ct2 = tlqg.lqg_from_numpy(*(np.asarray(getattr(cj, f))
                                for f in ("k", "l", "a", "b", "c")),
                              device="cpu")
    xt, xht, ut = tlqg._rollout(ct2, t(x0), t(w_noise), t(v_noise), t(wc),
                                t(vc))
    close(xt, xj)
    close(xht, xhj)
    close(ut, uj)
    # the JAX test's gates
    assert float(xt[-50:, 2].abs().max()) < 0.1
    assert float(xt[-50:, 0].abs().max()) < 0.6
    assert float((xht[-50:] - xt[-50:]).abs().max()) < 0.1
    close(ct.control(xt[-1]), -ct.k @ xt[-1], 0)
    gen = torch.Generator().manual_seed(1)
    out = tlqg.rollout(ct, gen, t(x0), 20, t(wc), t(vc))
    g2 = torch.Generator().manual_seed(1)
    ref = tlqg._rollout(ct, t(x0), torch.randn((20, 4), generator=g2,
                                               dtype=torch.float64),
                        torch.randn((20, 2), generator=g2,
                                    dtype=torch.float64), t(wc), t(vc))
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


def test_entry_points_need_a_card_by_default():
    """device=None means the card: without one the entry points raise
    instead of running on the CPU."""
    from rustrobotics_tpu_torch.mapping.occupancy import OccupancyGrid
    from rustrobotics_tpu_torch.vision.bundle import bundle_adjust

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    one = np.ones((1, 1))
    for call in (lambda: tip.simulate_inverted_pendulum(),
                 lambda: tip.InvertedPendulumModel.create(),
                 lambda: tlqr.lti_from_numpy(one, one, one, one),
                 lambda: OccupancyGrid.create(4, 4, 0.1),
                 lambda: bundle_adjust(np.eye(3), np.zeros((1, 7)),
                                       np.zeros((1, 3)), [0], [0],
                                       np.zeros((1, 2)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
