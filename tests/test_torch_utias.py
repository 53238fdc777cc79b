"""The port's UTIAS loader and landmark localization against the JAX
package's, f64 on the CPU, on a synthetic MRCLE-shaped dataset
(``chip_smoke.write_utias``: 15 landmarks, 5 robots, epoch stamps near
1.25e9 s): the loaded arrays and merged events equal; the EKF-KC, UKF-KC
and PF-KC replays and the banked fleet replay to rtol 1e-9 over short
prefixes (the PF on the draws of JAX's own keys, 64 particles); the
replay's host-side slot skip bit-equal to the masked step over every
slot; and the ATE bounds of the JAX package's dataset test in f64 and
f32."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.data import utias as ju
from rustrobotics_tpu.localization import landmark_replay as jr
from rustrobotics_tpu_torch.data import EventArrays, load_utias
from rustrobotics_tpu_torch.localization import landmark_replay as tr
from rustrobotics_tpu_torch.localization.pf import gaussian_estimate
from rustrobotics_tpu_torch.utils.state import GaussianState

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-9
EVENTS = 300


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return load_chip_smoke().write_utias(tmp_path_factory.mktemp("utias"),
                                         seed=1)


@pytest.fixture(scope="module")
def datasets(data_dir):
    return ju.load_utias(data_dir), load_utias(data_dir)


def close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_load_utias_matches(datasets):
    ref, got = datasets
    for name in ("groundtruth", "landmark_ids", "landmarks", "measurements",
                 "odometry"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name), err_msg=name)
    assert len(got.landmark_ids) == 15
    assert got.groundtruth[0, 0] > 1.2e9
    # the loader clips what precedes the groundtruth
    assert got.odometry[0, 0] >= got.groundtruth[0, 0]
    assert got.measurements[0, 0] >= got.groundtruth[0, 0]
    ev = got.events(device="cpu")
    assert ev.num_events >= 10000
    counts = ev.meas_mask_np.sum(1)
    assert counts.max() == 6 and counts[counts > 0].min() == 1
    # other robots' sightings: ids the landmark table lacks
    assert not np.isin(ev.meas_ids_np[ev.meas_mask_np],
                       got.landmark_ids).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_events_match(datasets, dtype):
    ref, got = datasets
    want = ref.events(max_events=EVENTS, dtype=np.dtype(dtype))
    ev = got.events(max_events=EVENTS, dtype=getattr(torch, dtype),
                    device="cpu")
    assert isinstance(ev, EventArrays) and ev.num_events == EVENTS
    for name in ("times", "dt", "control", "has_control", "meas_ids",
                 "meas_z", "meas_mask"):
        g, w = getattr(ev, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(ev.has_control_np, np.asarray(
        want.has_control))
    np.testing.assert_array_equal(ev.meas_ids_np, np.asarray(want.meas_ids))
    np.testing.assert_array_equal(ev.meas_mask_np, np.asarray(
        want.meas_mask))
    # relative stamps: f32 keeps ms resolution
    assert float(ev.times[-1]) < 10.0


def _pf_draws(n, t_len, seed=0):
    """The draws of the JAX package's PF replay with key(seed), by its own
    key tree."""
    key, k_init = jax.random.split(jax.random.key(seed))
    init = jax.random.normal(k_init, (n, 3), dtype=jnp.float64)

    def step(k, _):
        k, k_step = jax.random.split(k)
        k_prop, k_res = jax.random.split(k_step)
        motion = jnp.stack([jax.random.normal(kk, (n,), dtype=jnp.float64)
                            for kk in jax.random.split(k_prop, 3)])
        return k, (motion, jax.random.uniform(k_res, (n,),
                                              dtype=jnp.float64))

    _, (motion, resample) = jax.lax.scan(step, key, None, length=t_len)
    return {k: torch.tensor(np.asarray(v)) for k, v in
            (("init", init), ("motion", motion), ("resample", resample))}


@pytest.mark.parametrize("algo", ["ekf", "ukf", "pf"])
def test_run_utias_localization_matches_jax(datasets, algo):
    ref_ds, ds = datasets
    jt, js = jr.run_utias_localization(ref_ds, algo, max_events=EVENTS,
                                       num_particles=64)
    draws = _pf_draws(64, EVENTS) if algo == "pf" else None
    tt, ts = tr._run_utias_localization(ds, algo, EVENTS, 64,
                                        torch.float64, "cpu", draws=draws)
    np.testing.assert_array_equal(tt, jt)
    close(ts.x, js.x)
    close(ts.cov, js.cov, RTOL, 1e-15)
    assert tr.ate_vs_groundtruth(ds, tt, ts) == pytest.approx(
        jr.ate_vs_groundtruth(ref_ds, jt, js), rel=RTOL)
    g = torch.Generator().manual_seed(0)
    _, st = tr.run_utias_localization(ds, algo, max_events=20,
                                      num_particles=8, device="cpu",
                                      generator=g)
    assert st.x.shape == (20, 3)


def test_fleet_matches_jax(datasets):
    ref_ds, ds = datasets
    bank = 32
    jt, jxs = jr.run_utias_localization_fleet(ref_ds, bank=bank,
                                              max_events=EVENTS,
                                              dtype=jnp.float64)
    noise = jax.random.normal(jax.random.key(0), (3, bank), jnp.float64)
    tt, xs = tr._run_utias_localization_fleet(
        ds, torch.tensor(np.asarray(noise)), EVENTS, 0.1, torch.float64,
        "cpu")
    np.testing.assert_array_equal(tt, jt)
    close(xs, jxs)
    _, xs32 = tr.run_utias_localization_fleet(ds, bank=4, max_events=20,
                                              device="cpu")
    assert xs32.shape == (20, 3, 4) and xs32.dtype == torch.float32


def _masked_run(filt, state, ev, dt, kind, draws=None):
    """Every event through the filter's masked step, every slot applied."""
    out = []
    for k in range(ev.num_events):
        args = (ev.control[k], ev.has_control[k], ev.meas_ids[k],
                ev.meas_z[k], ev.meas_mask[k], dt[k])
        if kind == "pf":
            state = filt._step(state, *args, draws["motion"][k],
                               draws["resample"][k])
            out.append(gaussian_estimate(state).x)
        elif kind == "fleet":
            u = args[0][:, None].expand(2, state[0].shape[-1])
            state = filt.step(*state, u, *args[1:])
            out.append(state[0])
        else:
            state = filt.step(state, *args)
            out.append(state.x)
    return torch.stack(out)


@pytest.mark.parametrize("kind", ["ekf", "ukf", "pf", "fleet"])
def test_slot_skip_is_bit_equal(datasets, kind):
    """The replay skips, on the host, predicts without control and slots
    that are padding or unknown ids; the masked step over every slot gives
    the same states bit for bit."""
    _, ds = datasets
    ev = ds.events(max_events=EVENTS, device="cpu")
    dt = tr._first_dt(ev)
    x0 = torch.tensor(ds.groundtruth[0, 1:4])
    if kind == "fleet":
        filt = tr.build_banked_filter(ds, torch.float64, "cpu")
        x = x0[:, None] + 0.1 * torch.randn(
            (3, 8), generator=torch.Generator().manual_seed(0),
            dtype=torch.float64)
        cov = (torch.eye(3, dtype=torch.float64) * 1e-10)[:, :, None].expand(
            3, 3, 8)
        want = _masked_run(filt, (x, cov), ev, dt, kind)
        got = tr._replay_banked(filt, x, cov, ev, dt)
    elif kind == "pf":
        filt = tr.build_filter(ds, "pf", device="cpu")
        draws = _pf_draws(16, EVENTS)
        p0 = x0 + draws["init"] * 0.4
        want = _masked_run(filt, p0, ev, dt, kind, draws)
        got = tr._replay_pf(filt, p0, ev, dt, draws["motion"],
                            draws["resample"]).x
    else:
        filt = tr.build_filter(ds, kind, device="cpu")
        state = GaussianState(x=x0, cov=torch.eye(3, dtype=torch.float64)
                              * 1e-6)
        want = _masked_run(filt, state, ev, dt, kind)
        got = tr._replay_kalman(filt, state, ev, dt).x
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_utias_localization_ate(datasets, dtype):
    """The JAX package's dataset test, on the synthetic data: EKF-KC within
    0.3 m ATE of groundtruth, in f64 and in f32 (which needs the relative
    time origin and the Joseph form), over 2000 events."""
    _, ds = datasets
    times, states = tr.run_utias_localization(ds, "ekf", max_events=2000,
                                              dtype=dtype, device="cpu")
    assert states.x.dtype == dtype
    ate = tr.ate_vs_groundtruth(ds, times, states)
    assert ate < 0.3, ate


def test_entry_points_default_to_the_card(datasets):
    """device=None means the card: without one the localization entry
    points raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    from rustrobotics_tpu_torch.localization.simulation import run_simulation

    _, ds = datasets
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_simulation(sim_time=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.run_utias_localization(ds, max_events=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.run_utias_localization_fleet(ds, bank=2, max_events=5)
