"""The port's SLAM-course replays against the JAX package's, f64 on the
CPU, on a small synthetic log (chip_smoke.write_slam_course: 120 poses
along the corridor path, 8 landmarks, in tmp_path) loaded by each
package's own loader: ``run_slam_course`` (trajectory and state to atol
1e-9), ``landmark_map_error``, and ``run_slam_course_fastslam`` versions 1
and 2 at 24 particles on JAX's own draws (the cloud to atol 1e-9, the map
and seen mask equal); the public FastSLAM replay on a generator against
its private form; the ascending-id assertion."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.data.slam_course import load_slam_course as jload
from rustrobotics_tpu.mapping import slam_replay as jsr
from rustrobotics_tpu_torch.data import load_slam_course as tload
from rustrobotics_tpu_torch.mapping import slam_replay as tsr

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-9
F64 = jnp.float64


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("slam_course")
    path, landmarks = cs.slam_course_world(120, 8)
    cs.write_slam_course(d, path, landmarks, seed=1)
    return jload(d), tload(d)


def test_run_slam_course_matches_jax(logs):
    jds, tds = logs
    traj_j, st_j = jsr.run_slam_course(jds, dtype=jnp.float64)
    traj_t, st_t = tsr.run_slam_course(tds, dtype=torch.float64,
                                       device="cpu")
    close(traj_t, traj_j)
    close(st_t.x, st_j.x)
    close(st_t.cov, st_j.cov)
    assert (st_t.seen.numpy() == np.asarray(st_j.seen)).all()
    err_t = tsr.landmark_map_error(tds, st_t)
    err_j = jsr.landmark_map_error(jds, st_j)
    assert err_t[2] == err_j[2] == 8
    close(err_t[:2], err_j[:2])
    assert np.isfinite(err_t[:2]).all()


def jax_fastslam_draws(seed, t_len, n, version):
    """The draws of run_slam_course_fastslam's key tree, for the port's
    private form."""
    key = jax.random.key(seed)
    key, k0 = jax.random.split(key)
    keys = jax.random.split(key, t_len)
    props, res = zip(*(jax.random.split(k) for k in keys))
    draws = {"init": jax.random.normal(k0, (n, 3), F64),
             "resample": jnp.stack([jax.random.uniform(k, (), F64)
                                    for k in res])}
    if version == 2:
        draws["eps"] = jnp.stack([jax.random.normal(k, (n, 3), F64)
                                  for k in props])
    else:
        draws["motion"] = jnp.stack([jax.random.normal(k, (3,), F64)
                                     for k in props])
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


@pytest.mark.parametrize("version", [1, 2])
def test_run_slam_course_fastslam_matches_jax(logs, version):
    jds, tds = logs
    n = 24
    pj, lm_j, seen_j = jsr.run_slam_course_fastslam(
        jds, num_particles=n, seed=3, dtype=jnp.float64, version=version)
    draws = jax_fastslam_draws(3, len(tds.odometry), n, version)
    pt, lm_t, seen_t = tsr._run_slam_course_fastslam(
        tds, draws, dtype=torch.float64, version=version, device="cpu")
    for name in ("poses", "lm_mu", "lm_cov", "logw"):
        close(getattr(pt, name), getattr(pj, name))
    assert (pt.seen.numpy() == np.asarray(pj.seen)).all()
    assert (seen_t == seen_j).all() and seen_t.all()
    close(lm_t, lm_j)
    assert np.isfinite(lm_t).all()


def test_public_fastslam_replay_draws_as_private(logs):
    _, tds = logs
    n, t_len = 8, len(tds.odometry)
    gen = torch.Generator().manual_seed(5)
    out = tsr.run_slam_course_fastslam(tds, num_particles=n, version=2,
                                       dtype=torch.float64, device="cpu",
                                       generator=gen)
    g = torch.Generator().manual_seed(5)
    kw = dict(generator=g, dtype=torch.float64)
    draws = {"init": torch.randn((n, 3), **kw),
             "eps": torch.randn((t_len, n, 3), **kw),
             "resample": torch.rand((t_len,), **kw)}
    ref = tsr._run_slam_course_fastslam(tds, draws, dtype=torch.float64,
                                        version=2, device="cpu")
    assert torch.equal(out[0].poses, ref[0].poses)
    assert (out[1] == ref[1]).all()
    seeded = tsr.run_slam_course_fastslam(tds, num_particles=n, seed=5,
                                          version=2, dtype=torch.float64,
                                          device="cpu")
    assert torch.equal(seeded[0].poses, out[0].poses)


def test_descending_landmark_ids_raise(logs):
    _, tds = logs
    tds = type(tds)(odometry=tds.odometry, sensors=tds.sensors,
                    landmark_ids=tds.landmark_ids[::-1].copy(),
                    landmarks=tds.landmarks[::-1].copy())
    with pytest.raises(AssertionError, match="strictly ascending"):
        tsr.run_slam_course(tds, dtype=torch.float64, device="cpu")


def test_replay_entry_point_needs_a_card_by_default(logs):
    _, tds = logs
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsr.run_slam_course(tds)


def test_ekf_slam_breaks_down_on_the_corridor_as_in_jax(tmp_path):
    """A behaviour of the JAX package that the port keeps: on a corridor
    log with no revisit (300 poses, 32 landmarks to one side), the
    robot's lateral variance grows past 60 m² by event 120 and the joint
    covariance turns indefinite there; until then the two packages agree
    (1e-8 over the first 100 events), and both end indefinite."""
    path, landmarks = cs.slam_course_world(300, 32)
    cs.write_slam_course(tmp_path, path, landmarks, seed=0)
    traj_j, st_j = jsr.run_slam_course(jload(tmp_path), dtype=jnp.float64)
    traj_t, st_t = tsr.run_slam_course(tload(tmp_path), dtype=torch.float64,
                                       device="cpu")
    close(traj_t[:100], traj_j[:100], 1e-8)
    assert np.linalg.eigvalsh(np.asarray(st_j.cov)).min() < -1.0
    assert float(torch.linalg.eigvalsh(st_t.cov).min()) < -1.0
