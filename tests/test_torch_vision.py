"""The port's vision stack against the JAX package's, f64 on the CPU, on
the JAX vision tests' synthetic cameras (tests/test_vision.py): projection
and its RQ decomposition, DLT, homography, Zhang's calibration and radial
distortion (the least-squares solution equal to JAX's SVD-based lstsq),
triangulation (one batched SVD; a partial visibility mask too), the
cubic/quartic solvers, P3P and RANSAC PnP on JAX's own sample indices,
and bundle adjustment (GN and LM) with its χ² trace. Tolerances are
stated per test; the closed forms hold 1e-9 or better."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu import vision as jv
from rustrobotics_tpu.vision import bundle as jb
from rustrobotics_tpu_torch import vision as tv
from rustrobotics_tpu_torch.vision import bundle as tb

# the packages export functions named as these modules
jp3 = importlib.import_module("rustrobotics_tpu.vision.p3p")
jtri = importlib.import_module("rustrobotics_tpu.vision.triangulate")
tp3 = importlib.import_module("rustrobotics_tpu_torch.vision.p3p")
ttri = importlib.import_module("rustrobotics_tpu_torch.vision.triangulate")

K = np.array([[800.0, 2.0, 320.0], [0.0, 780.0, 240.0], [0.0, 0.0, 1.0]])


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def rot(rx, ry, rz):
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))


def proj(r, tr):
    return K @ np.concatenate([r, tr[:, None]], 1)


def pixels(p, pts):
    uvw = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ p.T
    return uvw[:, :2] / uvw[:, 2:3]


def test_projection_and_decomposition_match_jax():
    r, tr = rot(0.1, -0.2, 0.3), np.array([0.5, -0.2, 2.0])
    pj = jv.projection_matrix(jnp.asarray(K), jnp.asarray(r), jnp.asarray(tr))
    pt = tv.projection_matrix(t(K), t(r), t(tr))
    close(pt, pj, 1e-12)
    pts = np.random.default_rng(0).uniform(-1, 1, (10, 3)) + [0, 0, 4]
    close(tv.project(pt, t(pts)), jv.project(pj, jnp.asarray(pts)), 1e-9)
    for sign in (1.0, -1.0):  # a negative overall scale flips P
        for a, b in zip(tv.decompose_projection(pt * sign),
                        jv.decompose_projection(pj * sign)):
            close(a, b, 1e-9)
    k2, r2, t2 = tv.decompose_projection(pt)
    close(k2, K / K[2, 2], 1e-9)
    close(r2, r, 1e-12)


def test_dlt_and_homography_match_jax():
    rng = np.random.default_rng(0)
    p_true = proj(rot(0.2, 0.1, -0.3), np.array([0.3, 0.1, 3.0]))
    pts = rng.uniform(-1, 1, (24, 3))
    uv = pixels(p_true, pts) + rng.normal(size=(24, 2)) * 0.05
    pj, (kj, rj, tj) = jv.dlt_camera(jnp.asarray(pts), jnp.asarray(uv))
    pt, (kt, rt, tt) = tv.dlt_camera(t(pts), t(uv))
    close(pt, pj, 1e-9)
    close(kt, kj, 1e-6)
    close(rt, rj, 1e-9)
    close(tt, tj, 1e-9)
    h_true = np.array([[1.1, 0.1, 5.0], [-0.2, 0.9, -3.0],
                       [1e-4, -2e-4, 1.0]])
    src = rng.uniform(-10, 10, (12, 2))
    sh = np.concatenate([src, np.ones((12, 1))], 1) @ h_true.T
    dst = sh[:, :2] / sh[:, 2:3] + rng.normal(size=(12, 2)) * 0.01
    close(tv.homography(t(src), t(dst)),
          jv.homography(jnp.asarray(src), jnp.asarray(dst)), 1e-9)


def _planar_views(nx, ny, specs, k1=0.0, k2=0.0, noise=0.05, seed=2):
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(nx) * 0.03, np.arange(ny) * 0.03)
    obj = np.stack([gx.ravel(), gy.ravel()], -1)
    obj3 = np.concatenate([obj, np.zeros((len(obj), 1))], 1)
    views, rs, ts = [], [], []
    for spec in specs:
        r, tr = rot(*spec[:3]), np.array(spec[3:])
        uv = pixels(proj(r, tr), obj3)
        if k1 or k2:
            uv = np.asarray(jv.distort_points(jnp.asarray(K), k1, k2,
                                              jnp.asarray(uv)))
        views.append(uv + rng.normal(size=uv.shape) * noise)
        rs.append(r)
        ts.append(tr)
    return obj, np.stack(views), np.stack(rs), np.stack(ts)


SPECS = [(0.15, -0.2, 0.05, 0.02, 0.01, 0.45),
         (-0.25, 0.1, -0.1, -0.05, 0.03, 0.5),
         (0.1, 0.3, 0.2, 0.03, -0.04, 0.4),
         (-0.1, -0.15, 0.3, -0.02, -0.02, 0.55)]


def test_zhang_calibration_matches_jax():
    obj, views, _, _ = _planar_views(7, 5, SPECS)
    out_j = jv.zhang_calibrate(jnp.asarray(obj), jnp.asarray(views))
    out_t = tv.zhang_calibrate(t(obj), t(views))
    for a, b, tol in zip(out_t, out_j, (1e-6, 1e-9, 1e-9, 1e-9)):
        close(a, b, tol)
    k_est = out_t[0].numpy()
    assert np.abs(k_est[[0, 1, 0, 1], [0, 1, 2, 2]]
                  - K[[0, 1, 0, 1], [0, 1, 2, 2]]).max() < 8.0, k_est


def test_radial_distortion_matches_jax():
    """The port's lstsq (QR; the card has only "gels") reaches JAX's
    SVD-based least-squares solution on the tall full-rank system."""
    k1, k2 = -0.25, 0.08
    obj, views, rs, ts = _planar_views(9, 7, SPECS[:3], k1, k2, 0.02, 7)
    sol_j = jv.estimate_radial_distortion(
        jnp.asarray(K), jnp.asarray(rs), jnp.asarray(ts), jnp.asarray(obj),
        jnp.asarray(views))
    sol_t = tv.estimate_radial_distortion(t(K), t(rs), t(ts), t(obj),
                                          t(views))
    close(sol_t, sol_j, 1e-12)
    close(sol_t, [k1, k2], 0.02)
    uv = np.random.default_rng(1).uniform(0, 600, (20, 2))
    close(tv.distort_points(t(K), k1, k2, t(uv)),
          jv.distort_points(jnp.asarray(K), k1, k2, jnp.asarray(uv)), 1e-9)


@pytest.fixture(scope="module")
def three_views():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (50, 3)) + np.array([0, 0, 4.0])
    ps = np.stack([proj(rot(*s[:3]), np.array(s[3:])) for s in
                   [(0, 0, 0, 0, 0, 0), (0.05, -0.1, 0.02, 0.4, 0, 0.1),
                    (-0.08, 0.12, 0.0, -0.35, 0.1, 0.05)]])
    obs = np.stack([pixels(p, pts) for p in ps], 1)
    return pts, ps, obs + rng.normal(size=obs.shape) * 0.1


def test_triangulation_matches_jax(three_views):
    pts, ps, obs = three_views
    est_j = jv.triangulate(jnp.asarray(ps), jnp.asarray(obs))
    est_t = tv.triangulate(t(ps), t(obs))
    close(est_t, est_j, 1e-9)
    assert float((est_t - t(pts)).abs().max()) < 0.02
    close(tv.triangulate_pair(t(ps[0]), t(ps[1]), t(obs[:, 0]),
                              t(obs[:, 1])),
          jv.triangulate_pair(jnp.asarray(ps[0]), jnp.asarray(ps[1]),
                              jnp.asarray(obs[:, 0]),
                              jnp.asarray(obs[:, 1])), 1e-9)


def test_triangulation_mask_weights_match_jax(three_views):
    """A behaviour of the JAX package that the port keeps: the system's
    rows are [u_0..u_V-1, v_0..v_V-1] but ``repeat(mask, 2)`` weights them
    [m_0, m_0, m_1, m_1, ...], so a partial mask drops the wrong rows
    (with view 2 masked out, view 2's u row stays and view 1's v row
    goes). The port equals JAX, and both differ from masking each view's
    own two rows."""
    pts, ps, obs = three_views
    mask = np.ones((50, 3), bool)
    mask[:, 2] = False
    est_j = jv.triangulate(jnp.asarray(ps), jnp.asarray(obs),
                           jnp.asarray(mask))
    est_t = tv.triangulate(t(ps), t(obs), t(mask))
    close(est_t, est_j, 1e-9)
    own = tv.triangulate(t(ps[:2]), t(obs[:, :2]))  # views 0 and 1 alone
    assert float((est_t - own).abs().max()) > 1e-3
    close(ttri._triangulate_one(t(ps), t(obs[0]), t(mask[0])),
          jtri._triangulate_one(jnp.asarray(ps), jnp.asarray(obs[0]),
                                jnp.asarray(mask[0])), 1e-9)


def test_cubic_and_quartic_roots_match_jax():
    rng = np.random.default_rng(9)
    for _ in range(20):
        b, c, d = rng.normal(size=3) * 3
        close(tp3._real_cubic_roots(t(b), t(c), t(d)),
              jp3._real_cubic_roots(b, c, d), 1e-9)
        co = rng.normal(size=5)
        vt, mt = tp3._quartic_roots(*map(t, co))
        vj, mj = jp3._quartic_roots(*map(jnp.asarray, co))
        assert (mt.numpy() == np.asarray(mj)).all()
        ok = np.asarray(mj)
        close(vt.numpy()[ok], np.asarray(vj)[ok], 1e-8)


def test_p3p_matches_jax():
    rng = np.random.default_rng(3)
    r, tr = rot(0.2, -0.1, 0.4), np.array([0.2, -0.3, 1.5])
    world = rng.uniform(-1, 1, (4, 3)) + np.array([0, 0, 3.0])
    cam = world @ r.T + tr
    bear = cam / np.linalg.norm(cam, axis=1, keepdims=True)
    rj, tj, okj = jv.p3p(jnp.asarray(world[:3]), jnp.asarray(bear[:3]))
    rt, tt, okt = tv.p3p(t(world[:3]), t(bear[:3]))
    ok = np.asarray(okj)
    assert (okt.numpy() == ok).all() and ok.any()
    close(rt.numpy()[ok], np.asarray(rj)[ok], 1e-8)
    close(tt.numpy()[ok], np.asarray(tj)[ok], 1e-8)
    bj = jv.p3p_best(*map(jnp.asarray, (world[:3], bear[:3], world[3],
                                        bear[3])))
    bt = tv.p3p_best(*map(t, (world[:3], bear[:3], world[3], bear[3])))
    for a, b in zip(bt, bj):
        close(a, b, 1e-8)
    close(bt[0], r, 1e-4)
    close(bt[1], tr, 1e-3)


def test_pnp_ransac_matches_jax():
    """30% outliers, 64 hypotheses on JAX's own sample indices (repeated
    indices included: their P3P is NaN and rejected in both)."""
    rng = np.random.default_rng(6)
    r, tr = rot(0.15, -0.25, 0.3), np.array([0.1, 0.2, 1.2])
    world = rng.uniform(-1, 1, (60, 3)) + np.array([0, 0, 3.0])
    cam = world @ r.T + tr
    bear = cam / np.linalg.norm(cam, axis=1, keepdims=True)
    bad = rng.choice(60, 18, replace=False)
    nd = rng.normal(size=(18, 3))
    bear[bad] = nd / np.linalg.norm(nd, axis=1, keepdims=True)
    key = jax.random.key(0)
    rj, tj, inj = jv.pnp_ransac(jnp.asarray(world), jnp.asarray(bear), key,
                                num_hypotheses=64)
    ks, _ = jax.random.split(key)
    idx = t(jax.random.randint(ks, (64, 3), 0, 60))
    rt, tt, int_ = tp3._pnp_ransac(t(world), t(bear), idx)
    assert (int_.numpy() == np.asarray(inj)).all()
    # the refinement's SVD on 42 inliers: 1.9e-9 on t
    close(rt, rj, 1e-8)
    close(tt, tj, 1e-8)
    close(rt, r, 5e-3)
    assert int(int_.sum()) >= 38 and not int_.numpy()[bad].any()
    g = torch.Generator().manual_seed(0)
    out = tv.pnp_ransac(t(world), t(bear), g, num_hypotheses=64)
    ref = tp3._pnp_ransac(t(world), t(bear), torch.randint(
        0, 60, (64, 3), generator=torch.Generator().manual_seed(0)))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def _mat_to_quat(r):
    tr_ = np.trace(r)
    s = np.sqrt(tr_ + 1.0) * 2
    return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                     (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])


@pytest.mark.parametrize("solver", ["lm", "gn"])
def test_bundle_adjust_matches_jax(solver):
    """The JAX BA test's scene at 4 cameras and 24 points."""
    rng = np.random.default_rng(5)
    n_cams, n_pts = 4, 24
    pts = rng.uniform(-1, 1, (n_pts, 3)) + np.array([0, 0, 4.0])
    cams = np.asarray([np.concatenate([
        [0.5 * i - 1.2, 0.1 * rng.normal(), 0.0],
        _mat_to_quat(rot(*rng.normal(size=3) * 0.1))]) for i in range(n_cams)])
    obs_cam, obs_pt = np.meshgrid(np.arange(n_cams), np.arange(n_pts),
                                  indexing="ij")
    obs_cam, obs_pt = obs_cam.ravel(), obs_pt.ravel()
    clean = np.stack([np.asarray(jb.project_point(
        jnp.asarray(K), jnp.asarray(cams[c]), jnp.asarray(pts[p])))
        for c, p in zip(obs_cam, obs_pt)])
    close(tb.project_point(t(K), t(cams[obs_cam]), t(pts[obs_pt])), clean,
          1e-9)
    uv = clean + rng.normal(size=clean.shape) * 0.1
    cams0 = cams.copy()
    cams0[1:, :3] += rng.normal(size=(n_cams - 1, 3)) * 0.05
    pts0 = pts + rng.normal(size=pts.shape) * 0.05
    cj, pj, ej = jb.bundle_adjust(jnp.asarray(K), jnp.asarray(cams0),
                                  jnp.asarray(pts0), obs_cam, obs_pt, uv,
                                  num_iterations=6, solver=solver)
    ct, pt, et = tb.bundle_adjust(t(K), t(cams0), t(pts0), obs_cam, obs_pt,
                                  t(uv), num_iterations=6, solver=solver)
    if solver == "lm":
        np.testing.assert_allclose(et, ej, rtol=1e-7, atol=1e-9)
        close(ct, cj, 1e-7)
        close(pt, pj, 1e-7)
    else:
        # undamped, the global scale is a free direction of the Schur
        # system (only the first camera is pinned), so GN's first steps
        # amplify rounding (errors[1] 16.423 against JAX's 16.446); both
        # reach the same minimum, the poses within 1e-3 along that
        # direction (2.1e-4 on the points after 6 steps)
        np.testing.assert_allclose(et[3:], ej[3:], rtol=1e-9)
        close(ct, cj, 1e-3)
        close(pt, pj, 1e-3)
    assert et[-1] < et[0] * 1e-2
    pairs_t = tb._build_pairs(obs_pt, n_pts)
    pairs_j = jb._build_pairs(obs_pt, n_pts)
    assert (pairs_t.pair_i == pairs_j.pair_i).all()
    assert (pairs_t.pair_j == pairs_j.pair_j).all()
