"""Chordal initialization for pose graphs (counterpart of
``rustrobotics_tpu/mapping/initialization.py``).

Gauss-Newton/LM converge only locally; from a bad initial guess (e.g.
zeroed poses) they can stall in a local minimum. The standard fix is a
two-stage linear bootstrap:

1. **Rotation averaging (chordal relaxation)**: drop the unit-norm
   constraint and solve the LINEAR least squares
   ``min sum_e | r_to - R(z_e) r_from |^2`` over per-node rotation
   vectors (2-vector cos/sin for SE2, the 3x3 matrix rows for SE3), with
   the first pose's rotation fixed; then project back onto SO(2)/SO(3).
2. **Translation recovery**: with rotations fixed, positions solve the
   linear least squares ``t_to - t_from = R_from z_t``.

Both stages are sparse SPD solves that run once on the host in f64
(scipy, as in the JAX package); the graph's tensors are read to the host
and the result comes back on the graph's device in its dtype, for the
optimizer to refine there.
"""

from __future__ import annotations

import numpy as np
import torch

from rustrobotics_tpu_torch.geometry import se3
from rustrobotics_tpu_torch.mapping.g2o import PoseGraphData


def _host(t, dtype):
    return t.detach().cpu().numpy().astype(dtype)


def _like(a, t):
    """numpy a as a tensor on t's device in t's dtype."""
    return torch.as_tensor(a, dtype=t.dtype, device=t.device)


def _solve_anchored(rows, cols, vals, b, n, anchor_dofs):
    """Solve the normal equations with anchor dofs pinned (weight 1e6)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    h = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    h = h + sp.diags(np.isin(np.arange(n), anchor_dofs) * 1e6)
    return spla.spsolve(h, b)


def chordal_init_se2(graph: PoseGraphData) -> PoseGraphData:
    """Chordal initialization of the SE2 poses (landmarks re-initialized
    from their first sighting afterwards)."""
    n = int(graph.poses2.shape[0])
    frm = _host(graph.pp_from, np.int64)
    to = _host(graph.pp_to, np.int64)
    z = _host(graph.pp_z, np.float64)

    # ---- stage 1: rotation vectors r_i = (cos, sin), residual
    #      r_to - R(z_theta) r_from; unknowns x = [r_0 | r_1 | ...] (2n)
    c, s = np.cos(z[:, 2]), np.sin(z[:, 2])
    rows, cols, vals = [], [], []
    b = np.zeros(2 * n)

    def add(r_, c_, v_):
        rows.append(r_), cols.append(c_), vals.append(v_)

    # normal equations of each 2-row residual block:
    # J_from = -R, J_to = I  ->  H_ff += R^T R = I, H_tt += I,
    # H_ft += -R^T, H_tf += -R
    for e in range(len(frm)):
        f2, t2 = 2 * frm[e], 2 * to[e]
        r_mat = np.array([[c[e], -s[e]], [s[e], c[e]]])
        for a in range(2):
            add(f2 + a, f2 + a, 1.0)
            add(t2 + a, t2 + a, 1.0)
            for d in range(2):
                add(f2 + a, t2 + d, -r_mat[d, a])  # -R^T
                add(t2 + a, f2 + d, -r_mat[a, d])  # -R
    # anchor r_0 = (1, 0) through the rhs of the pinning weight
    b[0] = 1e6
    x = _solve_anchored(
        np.concatenate([np.asarray(rows)]),
        np.concatenate([np.asarray(cols)]),
        np.concatenate([np.asarray(vals)]),
        b, 2 * n, np.array([0, 1]),
    )
    thetas = np.arctan2(x[1::2], x[0::2])  # SO(2) projection

    # ---- stage 2: translations with rotations fixed:
    #      t_to - t_from = R(theta_from) z_t
    cf, sf = np.cos(thetas[frm]), np.sin(thetas[frm])
    dx = cf * z[:, 0] - sf * z[:, 1]
    dy = sf * z[:, 0] + cf * z[:, 1]
    rows, cols, vals = [], [], []
    b = np.zeros(2 * n)
    for e in range(len(frm)):
        f2, t2 = 2 * frm[e], 2 * to[e]
        for a, d in [(0, dx[e]), (1, dy[e])]:
            add(f2 + a, f2 + a, 1.0)
            add(t2 + a, t2 + a, 1.0)
            add(f2 + a, t2 + a, -1.0)
            add(t2 + a, f2 + a, -1.0)
            b[t2 + a] += d
            b[f2 + a] -= d
    t = _solve_anchored(
        np.asarray(rows), np.asarray(cols), np.asarray(vals),
        b, 2 * n, np.array([0, 1]),
    )
    poses = np.stack([t[0::2], t[1::2], thetas], axis=-1)

    updates = {"poses2": _like(poses, graph.poses2)}
    # landmarks: first-sighting inverse measurement from the new poses
    if graph.landmarks2.shape[0]:
        lm = np.zeros((graph.landmarks2.shape[0], 2))
        seen = np.zeros(lm.shape[0], bool)
        pl_pose = _host(graph.pl_pose, np.int64)
        pl_lm = _host(graph.pl_lm, np.int64)
        pl_z = _host(graph.pl_z, np.float64)
        for e in range(len(pl_pose)):
            k = pl_lm[e]
            if not seen[k]:
                p = poses[pl_pose[e]]
                ce, se = np.cos(p[2]), np.sin(p[2])
                lm[k] = p[:2] + [ce * pl_z[e, 0] - se * pl_z[e, 1],
                                 se * pl_z[e, 0] + ce * pl_z[e, 1]]
                seen[k] = True
        updates["landmarks2"] = _like(lm, graph.landmarks2)
    return graph.replace(**updates)


def _mat_to_quat(m):
    """(3,3) rotation matrix -> quaternion [w, x, y, z] (numpy, host)."""
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diagonal(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def chordal_init_se3(graph: PoseGraphData) -> PoseGraphData:
    """Chordal initialization for SE3 graphs. The rotation residual
    ``R_to - R_from R_z`` decouples by ROW (row_a(R_to) = Rz^T applied to
    row_a(R_from)), so rotation averaging is three independent sparse
    linear solves sharing one normal matrix, followed by an SVD projection
    onto SO(3); translations then solve ``t_to - t_from = R_from z_t``
    (three more shared-matrix solves)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = int(graph.poses3.shape[0])
    frm = _host(graph.qq_from, np.int64)
    to = _host(graph.qq_to, np.int64)
    z = _host(graph.qq_z, np.float64)
    rz = se3.quat_to_mat(torch.from_numpy(z[:, 3:])).numpy()  # (E, 3, 3)

    # shared normal matrix over 3n unknowns: blocks
    # H_ff += I, H_tt += I, H_ft += -Rz (residual r_to - Rz^T r_from,
    # J_from = -Rz^T, J_to = I -> H_ft = J_f^T J_t = -Rz)
    e_cnt = len(frm)
    eye_rows = np.repeat(np.concatenate([frm * 3, to * 3]), 3) + np.tile(
        np.arange(3), 2 * e_cnt)
    rows = [eye_rows]
    cols = [eye_rows]
    vals = [np.ones(6 * e_cnt)]
    a_first = np.arange(3)[None, :, None]
    b_second = np.arange(3)[None, None, :]
    shape = (e_cnt, 3, 3)
    fr_a = np.broadcast_to(frm[:, None, None] * 3 + a_first, shape).ravel()
    to_b = np.broadcast_to(to[:, None, None] * 3 + b_second, shape).ravel()
    to_a = np.broadcast_to(to[:, None, None] * 3 + a_first, shape).ravel()
    fr_b = np.broadcast_to(frm[:, None, None] * 3 + b_second, shape).ravel()
    # H[f+a, t+b] = -Rz[a, b]; H[t+a, f+b] = -(Rz^T)[a, b]
    rows += [fr_a, to_a]
    cols += [to_b, fr_b]
    vals += [-rz.reshape(-1), -rz.transpose(0, 2, 1).reshape(-1)]
    h = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(3 * n, 3 * n),
    ).tocsc()
    h = h + sp.diags((np.arange(3 * n) < 3) * 1e6)
    lu = spla.splu(h)
    rot_rows = np.zeros((n, 3, 3))
    for a in range(3):
        b = np.zeros(3 * n)
        b[a] = 1e6  # anchor row a of R_0 to e_a
        x = lu.solve(b)
        rot_rows[:, a, :] = x.reshape(n, 3)
    # SO(3) projection
    u, _, vt = np.linalg.svd(rot_rows)
    det = np.linalg.det(u @ vt)
    u[:, :, 2] *= np.sign(det)[:, None]
    r = u @ vt  # (n, 3, 3)

    # translations: t_to - t_from = R_from z_t (graph Laplacian, shared)
    lap_vals = [np.ones(2 * e_cnt), -np.ones(e_cnt), -np.ones(e_cnt)]
    lap_rows = [np.concatenate([frm, to]), frm, to]
    lap_cols = [np.concatenate([frm, to]), to, frm]
    lap = sp.coo_matrix(
        (np.concatenate(lap_vals),
         (np.concatenate(lap_rows), np.concatenate(lap_cols))),
        shape=(n, n),
    ).tocsc()
    lap = lap + sp.diags((np.arange(n) < 1) * 1e6)
    lu_t = spla.splu(lap)
    d = np.einsum("eij,ej->ei", r[frm], z[:, :3])  # (E, 3)
    t = np.zeros((n, 3))
    for a in range(3):
        b = np.zeros(n)
        np.add.at(b, to, d[:, a])
        np.add.at(b, frm, -d[:, a])
        t[:, a] = lu_t.solve(b)

    quats = np.stack([_mat_to_quat(r[i]) for i in range(n)])
    poses = np.concatenate([t, quats], axis=1)
    return graph.replace(poses3=_like(poses, graph.poses3))
