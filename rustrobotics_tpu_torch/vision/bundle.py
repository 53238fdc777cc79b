"""Bundle adjustment (counterpart of ``rustrobotics_tpu/vision/bundle.py``).

Joint refinement of SE(3) camera poses and 3D points minimizing
reprojection error:

- residuals and both Jacobians (pose tangent (2, 6), point (2, 3)) of
  every observation come from one ``torch.func.jacfwd`` through the
  projection and ``se3.retract`` at 0, under ``torch.func.vmap`` over the
  observations;
- the point block Hpp is (P, 3, 3) block-diagonal, inverted as a batch;
- the Schur complement on the cameras S = Hcc - W Hpp^-1 W^T is assembled
  by scatter-adds over a host-precomputed list of observation pairs that
  share a point, then solved by Jacobi-scaled dense Cholesky on (6C, 6C);
- Levenberg-Marquardt accept/reject mirrors ``mapping.pgo``, reading the
  χ² on the host once an iteration, as the JAX package does.

Gauge: the first camera carries a +1e7 prior, which pins 6 of the 7
similarity dofs; the global scale is left soft.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rustrobotics_tpu_torch.device import as_tensor
from rustrobotics_tpu_torch.geometry import se3

PRIOR_WEIGHT = 1e7


def project_point(k, cam, pt):
    """Pixel of world point ``pt`` in camera ``cam`` ([t(3), q_wxyz(4)]:
    the WORLD->CAMERA transform, PoseGraphData's se3 layout); leading
    axes broadcast."""
    pc = se3.transform(cam, pt)
    uvw = torch.einsum("ij,...j->...i", k, pc)
    return uvw[..., :2] / uvw[..., 2:3]


def _residual(k, cam, pt, uv):
    return project_point(k, cam, pt) - uv


def _perturbed(delta_cam, delta_pt, k, cam, pt, uv):
    return _residual(k, se3.retract(cam, delta_cam), pt + delta_pt, uv)


# both Jacobians at a zero perturbation, one observation a vmap lane
_JACS = torch.func.vmap(torch.func.jacfwd(_perturbed, argnums=(0, 1)),
                        in_dims=(None, None, None, 0, 0, 0))


@dataclasses.dataclass(frozen=True)
class _PairIndex:
    """Host-side static index lists for the Schur products."""

    pair_i: np.ndarray  # (Q,) obs index
    pair_j: np.ndarray  # (Q,) obs index, same point as pair_i


def _build_pairs(obs_pt, num_points):
    by_pt = [[] for _ in range(num_points)]
    for o, p in enumerate(np.asarray(obs_pt)):
        by_pt[int(p)].append(o)
    pi, pj = [], []
    for lst in by_pt:
        arr = np.asarray(lst)
        if len(arr) == 0:
            continue
        gi, gj = np.meshgrid(arr, arr, indexing="ij")
        pi.append(gi.ravel())
        pj.append(gj.ravel())
    return _PairIndex(
        pair_i=np.concatenate(pi) if pi else np.zeros(0, np.int64),
        pair_j=np.concatenate(pj) if pj else np.zeros(0, np.int64),
    )


def _host_ints(a):
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, np.int64)


def bundle_adjust(
    k,
    cam_poses,
    points,
    obs_cam,
    obs_pt,
    obs_uv,
    num_iterations: int = 20,
    solver: str = "lm",
    prior_weight: float = PRIOR_WEIGHT,
    device=None,
):
    """Returns (cam_poses', points', errors list).

    k (3, 3) shared intrinsics; cam_poses (C, 7) [t, q_wxyz]
    world->camera; points (P, 3); obs_cam/obs_pt (O,) int; obs_uv (O, 2).
    Tensors stay on their device; arrays go to ``device`` (None: the
    card).
    """
    points = as_tensor(points, device)
    dev, dtype = points.device, points.dtype
    k = as_tensor(k, dev, dtype)
    cam_poses = as_tensor(cam_poses, dev, dtype)
    obs_uv = as_tensor(obs_uv, dev, dtype)
    obs_cam_np, obs_pt_np = _host_ints(obs_cam), _host_ints(obs_pt)
    obs_cam = torch.as_tensor(obs_cam_np, device=dev)
    obs_pt = torch.as_tensor(obs_pt_np, device=dev)
    c = cam_poses.shape[0]
    p = points.shape[0]
    pairs = _build_pairs(obs_pt_np, p)
    pair_i = torch.as_tensor(pairs.pair_i, device=dev)
    pair_j = torch.as_tensor(pairs.pair_j, device=dev)
    cam_i, cam_j = obs_cam[pair_i], obs_cam[pair_j]
    lm = solver in ("lm", "levenberg_marquardt")
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    zero6 = torch.zeros(6, dtype=dtype, device=dev)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)

    def chi2_of(cams, pts):
        r = _residual(k, cams[obs_cam], pts[obs_pt], obs_uv)
        return torch.sum(r * r)

    def gn_step(cams, pts, lam):
        cams_o, pts_o = cams[obs_cam], pts[obs_pt]
        r = _residual(k, se3.retract(cams_o, zero6), pts_o + zero3, obs_uv)
        jc, jp = _JACS(zero6, zero3, k, cams_o, pts_o, obs_uv)
        hcc_o = torch.einsum("oki,okj->oij", jc, jc)   # (O, 6, 6)
        hpp_o = torch.einsum("oki,okj->oij", jp, jp)   # (O, 3, 3)
        w_o = torch.einsum("oki,okj->oij", jc, jp)     # (O, 6, 3)
        bc_o = torch.einsum("oki,ok->oi", jc, r)       # (O, 6)
        bp_o = torch.einsum("oki,ok->oi", jp, r)       # (O, 3)

        hpp = torch.zeros((p, 3, 3), dtype=dtype, device=dev).index_add(
            0, obs_pt, hpp_o)
        hpp = hpp + eye3 * lam + eye3 * 1e-9
        bp = torch.zeros((p, 3), dtype=dtype, device=dev).index_add(
            0, obs_pt, bp_o)
        hpp_inv = torch.linalg.inv_ex(hpp).inverse

        # S = Hcc + damping + prior - sum_{obs pairs sharing a point}
        #     W_i Hpp^-1 W_j^T  at block (cam_i, cam_j)
        hcc = torch.zeros((c, c, 6, 6), dtype=dtype, device=dev)
        hcc.index_put_((obs_cam, obs_cam), hcc_o, accumulate=True)
        a_o = torch.einsum("oij,ojk->oik", w_o, hpp_inv[obs_pt])
        uu = torch.einsum("qik,qjk->qij", a_o[pair_i], w_o[pair_j])
        hcc.index_put_((cam_i, cam_j), -uu, accumulate=True)
        s = hcc.permute(0, 2, 1, 3).reshape(6 * c, 6 * c)
        diag_add = torch.full((6 * c,), lam, dtype=dtype, device=dev)
        diag_add[:6] += prior_weight  # gauge: cam 0
        s = s + torch.diag(diag_add)

        bc = torch.zeros((c, 6), dtype=dtype, device=dev).index_add(
            0, obs_cam, bc_o)
        rhs = bc - torch.zeros((c, 6), dtype=dtype, device=dev).index_add(
            0, obs_cam, torch.einsum("oik,ok->oi", a_o, bp[obs_pt]))
        rhs = -rhs.reshape(-1)

        d = torch.sqrt(torch.clamp(torch.diagonal(s), min=1e-12))
        ss = s / (d[:, None] * d[None, :])
        cf = torch.linalg.cholesky_ex(ss).L
        dxc = (torch.cholesky_solve((rhs / d)[:, None], cf)[:, 0]
               / d).reshape(c, 6)

        # back-substitute points: dx_p = Hpp^-1 (-bp - W^T dx_c)
        wt_dxc = torch.zeros((p, 3), dtype=dtype, device=dev).index_add(
            0, obs_pt, torch.einsum("oij,oi->oj", w_o, dxc[obs_cam]))
        dxp = torch.einsum("pij,pj->pi", hpp_inv, -bp - wt_dxc)
        return se3.retract(cams, dxc), pts + dxp

    errors = [float(chi2_of(cam_poses, points))]
    lam = 1e-3 if lm else 0.0
    for _ in range(num_iterations):
        new_cams, new_pts = gn_step(cam_poses, points, lam)
        err = float(chi2_of(new_cams, new_pts))
        if lm and not (err <= errors[-1]):
            lam *= 4.0
            errors.append(errors[-1])
            continue
        if lm:
            lam = max(lam / 4.0, 1e-12)
        cam_poses, points = new_cams, new_pts
        errors.append(err)
    return cam_poses, points, errors
