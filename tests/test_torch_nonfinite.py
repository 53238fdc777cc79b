"""Non-finite input: the port gives NaN where the JAX package does, and
raises nowhere it does not (f64 on the CPU, the same inputs through both).

``torch.linalg.svd`` and ``torch.linalg.lstsq`` raise on a non-finite
operand and ``torch.linalg.inv`` on a singular one, where JAX returns
NaN/inf; the port zeroes the bad entries, factors, and sets each affected
problem's outputs to NaN (``utils.linalg``), or inverts with ``inv_ex``.
Each repaired site is run on a bad input: the result must be non-finite
exactly where JAX's is, and the finite entries within 1e-10 of JAX's.
"""

import importlib

import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import assemble as jasm
from rustrobotics_tpu.mapping import icp as jicp
from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping import solvers as jsol
from rustrobotics_tpu.mapping.synthetic import synthetic_pose_graph_2d
from rustrobotics_tpu.ops import band_chol as jband
from rustrobotics_tpu.vision import calibrate as jcal
from rustrobotics_tpu.vision import cameras as jcam
from rustrobotics_tpu_torch.mapping import assemble as tasm
from rustrobotics_tpu_torch.mapping import icp as ticp
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping import solvers as tsol
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    graph_from_numpy,
)
from rustrobotics_tpu_torch.ops import band_chol as tband
from rustrobotics_tpu_torch.utils import linalg as tlin
from rustrobotics_tpu_torch.vision import calibrate as tcal
from rustrobotics_tpu_torch.vision import cameras as tcam

ATOL = 1e-10

# the packages export functions named as these modules
jtri = importlib.import_module("rustrobotics_tpu.vision.triangulate")
ttri = importlib.import_module("rustrobotics_tpu_torch.vision.triangulate")


def t(a):
    return torch.tensor(np.asarray(a))


def same_nonfinite(got, want):
    """got non-finite exactly where want is, the rest within ATOL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(~np.isfinite(got), ~np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=ATOL)


def to_port(ref):
    fields = {n: np.asarray(getattr(ref, n))
              for n in FLOAT_FIELDS + INDEX_FIELDS}
    return graph_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                            device="cpu")


def cameras(rng, views=3):
    """(V, 3, 4) cameras looking at the origin from ~4 m, and 5 points."""
    k = np.array([[800.0, 0.0, 320.0], [0.0, 800.0, 240.0], [0, 0, 1.0]])
    ps = []
    for v in range(views):
        a = 0.3 * (v - 1)
        r = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        tr = np.array([0.2 * v, -0.1, 4.0])
        ps.append(k @ np.concatenate([r, tr[:, None]], 1))
    ps = np.stack(ps)
    pts = rng.uniform(-1, 1, (5, 3))
    uvw = np.einsum("vij,nj->nvi", ps, np.concatenate([pts, np.ones((5, 1))],
                                                      1))
    return ps, uvw[..., :2] / uvw[..., 2:3]


@pytest.mark.parametrize("masked", [False, True])
def test_triangulate_nan_pixel_matches_jax(masked):
    ps, obs = cameras(np.random.default_rng(0))
    obs[2, 1, 0] = np.nan  # point 2's pixel in view 1
    mask = np.ones(obs.shape[:2], bool)
    if masked:
        mask[2, 1] = False  # hidden, but 0 * NaN is NaN in both
    want = np.asarray(jtri.triangulate(ps, obs, mask))
    got = ttri.triangulate(t(ps), t(obs), t(mask)).numpy()
    assert np.isnan(want[2]).all() and np.isfinite(np.delete(want, 2, 0)).all()
    same_nonfinite(got, want)


@pytest.mark.parametrize("reject", [None, 0.9])
def test_icp_nan_point_matches_jax(reject):
    rng = np.random.default_rng(1)
    dst = rng.uniform(-2, 2, (50, 2))
    a = 0.1
    r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    src = (dst - [0.1, -0.05]) @ r
    src[7] = np.nan
    want = jicp.icp(src, dst, 10, reject_quantile=reject)
    got = ticp.icp(t(src), t(dst), 10, reject_quantile=reject)
    for g, w in zip(got, want):
        assert np.isnan(np.asarray(w)).all()
        same_nonfinite(g.numpy(), w)
    want_se2 = jicp.icp_se2(src, dst, 10, reject_quantile=reject)
    got_se2 = ticp.icp_se2(t(src), t(dst), 10, reject_quantile=reject)
    for g, w in zip(got_se2, want_se2):
        same_nonfinite(g.numpy(), w)
    # in a batch, only the problem with the NaN point is NaN
    clean = src.copy()
    clean[7] = dst[7] @ r - [0.1, -0.05] @ r
    rb, tb, eb = ticp.icp(t(np.stack([clean, src])), t(dst), 10,
                          reject_quantile=reject)
    rw, tw, ew = jicp.icp(clean, dst, 10, reject_quantile=reject)
    same_nonfinite(rb[0].numpy(), rw)
    same_nonfinite(tb[0].numpy(), tw)
    assert torch.isnan(rb[1]).all() and torch.isnan(eb[1])


def landmark_graph():
    """A circle with 3 landmarks, landmark 1 unobserved: its edges keep
    their place with Ω = 0, so its H block is zero and H is singular."""
    g = synthetic_pose_graph_2d(num_poses=12, num_landmarks=3, seed=2)
    omega = np.asarray(g.pl_omega).copy()
    omega[np.asarray(g.pl_lm) == 1] = 0.0
    return g.replace(pl_omega=omega)


def systems(g):
    jl, tg = jasm.build_layout(g), to_port(g)
    tl = tasm.build_layout(tg)
    jv, jb, _ = jasm.system_values(g, 0.0)
    tv, tb, _ = tasm.system_values(tg, 0.0)
    return jl, jv, jb, tl, tv, tb


def test_solve_schur_unobserved_landmark_matches_jax():
    jl, jv, jb, tl, tv, tb = systems(landmark_graph())
    want = np.asarray(jsol.solve_schur(jl, jv, jb))
    got = tsol.solve_schur(tl, tv, tb).numpy()
    assert not np.isfinite(want).all()
    same_nonfinite(got, want)


def test_block_jacobi_zero_block_matches_jax():
    jl, jv, jb, tl, tv, tb = systems(landmark_graph())
    r = np.random.default_rng(3).normal(size=jl.n)
    want = np.asarray(jsol.make_block_jacobi(jl, jv)(r))
    got = tsol.make_block_jacobi(tl, tv)(t(r)).numpy()
    assert not np.isfinite(want).all() and np.isfinite(want).any()
    same_nonfinite(got, want)


@pytest.mark.parametrize("which", ["variances", "pose_covariances"])
def test_dense_marginals_of_singular_system_match_jax(which, monkeypatch):
    # no band plan: both packages take the dense inverse
    monkeypatch.setattr(jband, "build_band_chol", lambda *a, **k: None)
    monkeypatch.setattr(tband, "build_band_chol", lambda *a, **k: None)
    g = landmark_graph()
    if which == "variances":
        want = np.asarray(jpgo.marginal_variances(g))
        got = tpgo.marginal_variances(to_port(g), device="cpu").numpy()
    else:
        want = np.asarray(jpgo.pose_covariances(g))
        got = tpgo.pose_covariances(to_port(g), device="cpu").numpy()
    assert not np.isfinite(want).all()
    same_nonfinite(got, want)


def calibration_scene():
    rng = np.random.default_rng(4)
    k = np.array([[700.0, 0.0, 320.0], [0.0, 700.0, 240.0], [0, 0, 1.0]])
    pts3 = rng.uniform(-1, 1, (12, 3)) + [0, 0, 5.0]
    p = k @ np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    uvw = np.concatenate([pts3, np.ones((12, 1))], 1) @ p.T
    return k, pts3, uvw[:, :2] / uvw[:, 2:3], p


def test_dlt_and_decomposition_with_nan_match_jax():
    _, pts3, pts2, p = calibration_scene()
    pts2[3, 1] = np.nan
    wp, wkrt = jcal.dlt_camera(pts3, pts2)
    gp, gkrt = tcal.dlt_camera(t(pts3), t(pts2))
    for g, w in zip((gp, *gkrt), (wp, *wkrt)):
        assert not np.isfinite(np.asarray(w)).all()
        same_nonfinite(g.numpy(), w)
    # QR does not raise on NaN; the decomposition is NaN in both
    p = p.copy()
    p[1, 2] = np.nan
    for g, w in zip(tcam.decompose_projection(t(p)),
                    jcam.decompose_projection(p)):
        same_nonfinite(g.numpy(), w)


def test_zhang_and_distortion_with_nan_match_jax():
    rng = np.random.default_rng(6)
    k = np.array([[650.0, 0.0, 320.0], [0.0, 640.0, 240.0], [0, 0, 1.0]])
    grid = np.stack(np.meshgrid(np.arange(5), np.arange(4)), -1).reshape(
        -1, 2) * 0.1
    obj3 = np.concatenate([grid, np.zeros((len(grid), 1))], 1)
    views = []
    for v in range(4):
        a, b = 0.3 * np.sin(v + 1), 0.25 * np.cos(2 * v)
        r = (np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                       [0, np.sin(a), np.cos(a)]])
             @ np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                         [-np.sin(b), 0, np.cos(b)]]))
        tr = np.array([-0.2, -0.15, 1.5]) + rng.uniform(-0.05, 0.05, 3)
        uvw = (obj3 @ r.T + tr) @ k.T
        views.append(uvw[:, :2] / uvw[:, 2:3])
    img = np.stack(views)
    img[2, 5, 0] = np.nan
    want = jcal.zhang_calibrate(grid, img)
    got = tcal.zhang_calibrate(t(grid), t(img))
    for g, w in zip(got, want):
        same_nonfinite(g.numpy(), w)
    # the distortion stage's least squares, on finite intrinsics
    clean = img.copy()
    clean[2, 5, 0] = 320.0
    kk, rs, ts, _ = jcal.zhang_calibrate(grid, clean)
    want = jcal.estimate_radial_distortion(kk, rs, ts, grid, img)
    got = tcal.estimate_radial_distortion(t(kk), t(rs), t(ts), t(grid),
                                          t(img))
    assert np.isnan(np.asarray(want)).all()
    same_nonfinite(got.numpy(), want)


def test_linalg_helpers_match_plain_calls_on_finite_problems():
    """The helpers give NaN for the bad problems of a batch and the plain
    call's result, within 1e-10, for the rest."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(4, 5, 3))
    b = rng.normal(size=(4, 5, 2))
    a[1, 2, 0] = np.nan
    b[3, 0, 1] = np.inf
    u, s, vh = tlin.svd(t(a), full_matrices=False)
    x = tlin.lstsq(t(a), t(b))
    for i in range(4):
        bad = i in (1, 3)
        if i == 1:
            assert torch.isnan(u[i]).all() and torch.isnan(s[i]).all()
        if bad:
            assert torch.isnan(x[i]).all()
            continue
        # one problem alone: a batched LAPACK call may round apart
        ui, si, vi = torch.linalg.svd(t(a[i]), full_matrices=False)
        for got, want in ((u[i], ui), (s[i], si), (vh[i], vi),
                          (x[i], torch.linalg.lstsq(t(a[i]),
                                                    t(b[i])).solution)):
            same_nonfinite(got.numpy(), want.numpy())
