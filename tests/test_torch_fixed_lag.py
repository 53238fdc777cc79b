"""The port's fixed-lag smoother against the JAX package's, f64 on the CPU:
every FixedLagState field after every ``advance`` and ``add_closure`` of a
40-step session at W = 8, C = 4 (the window filling, then sliding, and
the closure slots wrapping round the cursor), to 1e-9 relative to each
field's largest entry; and the JAX package's two fixed-lag tests
(tests/test_fixed_lag.py) on the port in f32."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping.fixed_lag import FixedLagSmoother as JSmoother
from rustrobotics_tpu_torch.geometry import se2
from rustrobotics_tpu_torch.mapping.fixed_lag import FixedLagSmoother

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ("poses", "chain_z", "clos_ij", "clos_z", "clos_mask",
          "prior_lambda", "prior_mu", "steps", "clos_cursor")
RTOL = 1e-9


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()


def assert_same_state(got, want, where):
    for name in FIELDS:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, (where, name)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(
                g, w, rtol=0, atol=RTOL * max(np.abs(w).max(), 1.0),
                err_msg=f"{where}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}: {name}")


def test_session_matches_jax_step_by_step():
    w, c, steps, n_circle = 8, 4, 40, 6
    _, odom, sig_odo, sig_clo, rng = cs.circle_data(steps, n_circle, seed=1)
    step = np.array([1.0, 0.0, 2 * np.pi / n_circle])
    two_steps = cs._compose2(step, step)
    chain = np.diag(1.0 / sig_odo ** 2)
    clos = np.diag(1.0 / sig_clo ** 2)
    ref = JSmoother.create(window=w, closure_capacity=c,
                           chain_omega=jnp.asarray(chain),
                           clos_omega=jnp.asarray(clos))
    port = FixedLagSmoother.create(window=w, closure_capacity=c,
                                   chain_omega=torch.tensor(chain),
                                   clos_omega=torch.tensor(clos),
                                   device="cpu")
    jstate = ref.init_state(jnp.zeros(3))
    state = port.init_state(torch.zeros(3, dtype=torch.float64))
    assert_same_state(state, jstate, "init")
    adv, addc = jax.jit(ref.advance), jax.jit(ref.add_closure)
    wrapped = False
    for t in range(steps):
        jstate = adv(jstate, jnp.asarray(odom[t]))
        state = port.advance(state, torch.tensor(odom[t]))
        assert_same_state(state, jstate, f"advance {t}")
        j = min(t + 2, w) - 1
        # a closure two poses back every step: it lives six steps, so the
        # four slots fill and later closures overwrite the cursor's
        if j >= 2:
            z = two_steps + rng.normal(0, sig_clo, 3)
            wrapped |= bool(np.asarray(jstate.clos_mask).all())
            jstate = addc(jstate, j - 2, j, jnp.asarray(z))
            state = port.add_closure(state, j - 2, j, torch.tensor(z))
            assert_same_state(state, jstate, f"add_closure {t}")
        np.testing.assert_allclose(port.current_pose(state).numpy(),
                                   np.asarray(ref.current_pose(jstate)),
                                   rtol=0, atol=RTOL * 100)
    assert wrapped  # a closure overwrote the slot at the cursor
    assert int(state.steps) == steps + 1


def _smoother(w, c, sig_odo, clos_omega):
    return FixedLagSmoother.create(
        window=w, closure_capacity=c,
        chain_omega=torch.diag(torch.tensor(1.0 / sig_odo ** 2,
                                            dtype=torch.float32)),
        clos_omega=clos_omega, device="cpu")


def test_fixed_lag_matches_dead_reckoning_without_closures():
    """Pure odometry carries no extra information: the smoother reproduces
    dead reckoning (guards the window bookkeeping)."""
    _, odom, sig_odo, _, _ = cs.circle_data(48)
    fls = _smoother(16, 4, sig_odo, torch.eye(3))
    state = fls.init_state(torch.zeros(3))
    dr = torch.zeros(3)
    for t in range(30):
        u = torch.tensor(odom[t], dtype=torch.float32)
        state = fls.advance(state, u)
        dr = se2.compose(dr, u)
        cur = fls.current_pose(state)
        assert torch.linalg.vector_norm(cur[:2] - dr[:2]) < 1e-3, (t, cur, dr)


def test_fixed_lag_closures_beat_dead_reckoning():
    """Revisiting a circle with loop closures: the sliding-window
    optimization and the marginalized prior clearly beat dead reckoning."""
    gt, odom, sig_odo, sig_clo, rng = cs.circle_data(48)
    n_circle, w = 12, 16
    fls = _smoother(w, 8, sig_odo, torch.diag(torch.tensor(
        1.0 / sig_clo ** 2, dtype=torch.float32)))
    state = fls.init_state(torch.zeros(3))
    est, dr = [np.zeros(3)], [np.zeros(3)]
    for t in range(len(odom)):
        state = fls.advance(state, torch.tensor(odom[t], dtype=torch.float32))
        dr.append(cs._compose2(dr[-1], odom[t]))
        if t + 1 >= n_circle:
            j = min(int(state.steps), w) - 1
            i = j - n_circle
            if i >= 0:
                z = rng.normal(0, sig_clo, 3)
                state = fls.add_closure(state, i, j, torch.tensor(
                    z, dtype=torch.float32))
        est.append(fls.current_pose(state).numpy())
    est, dr = np.asarray(est), np.asarray(dr)
    e_fls = np.sqrt(np.mean(np.sum((est[:, :2] - gt[:, :2]) ** 2, -1)))
    e_dr = np.sqrt(np.mean(np.sum((dr[:, :2] - gt[:, :2]) ** 2, -1)))
    assert e_fls < e_dr / 2.5, (e_fls, e_dr)
    lam = state.prior_lambda.numpy()
    assert np.isfinite(lam).all()
    np.testing.assert_allclose(lam, lam.T, atol=1e-2 * abs(lam).max())


@pytest.mark.parametrize("busy", [False, True])
def test_add_closure_slot(busy):
    fls = _smoother(4, 2, np.ones(3), torch.eye(3))
    state = fls.init_state(torch.zeros(3))
    if busy:
        state = state.replace(clos_mask=torch.ones(2, dtype=torch.bool),
                              clos_cursor=torch.tensor(1))
    state = fls.add_closure(state, 0, 2, torch.ones(3))
    slot = 1 if busy else 0
    assert state.clos_ij[slot].tolist() == [0, 2]
    assert bool(state.clos_mask[slot])
    assert int(state.clos_cursor) == (slot + 1) % 2


def test_window32_session_matches_jax():
    """chip_smoke's fixed-lag session (circle_data(FL_STEPS), W = 32,
    C = 16, a closure at each revisit) through the JAX smoother and the
    port, f64: the current pose agrees at every step, so the RMSE does
    too. Both land between dead reckoning and its / FL_RMSE_FACTOR, the
    factor the JAX package's test holds at W = 16, C = 8: the W = 32
    session's shortfall is the reference's behaviour."""
    w, c = cs.FL_WINDOW, cs.FL_CAPACITY
    gt, data = cs.closure_plan(w)
    _, odom, sig_odo, sig_clo, closures = data
    ref = JSmoother.create(window=w, closure_capacity=c,
                           chain_omega=jnp.diag(1.0 / sig_odo ** 2),
                           clos_omega=jnp.diag(1.0 / sig_clo ** 2))
    adv, addc = jax.jit(ref.advance), jax.jit(ref.add_closure)
    at = {step: (i, j, z) for step, i, j, z in closures}
    jstate = ref.init_state(jnp.zeros(3))
    want = []
    for t in range(len(odom)):
        jstate = adv(jstate, jnp.asarray(odom[t]))
        if t in at:
            i, j, z = at[t]
            jstate = addc(jstate, i, j, jnp.asarray(z))
        want.append(np.asarray(ref.current_pose(jstate)))
    want = np.asarray(want)
    _, _, poses = cs.fixed_lag_session("cpu", torch.float64, data, w, c)
    np.testing.assert_allclose(poses.numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())
    e_port, e_dr = cs.rmse_against_truth(poses, gt, odom)
    e_jax, _ = cs.rmse_against_truth(torch.tensor(want), gt, odom)
    assert abs(e_port - e_jax) <= RTOL * e_jax, (e_port, e_jax)
    assert e_dr / cs.FL_RMSE_FACTOR < e_jax < e_dr, (e_jax, e_dr)
