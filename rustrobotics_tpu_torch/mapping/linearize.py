"""Per-edge residuals and Jacobians for pose-graph optimization
(counterpart of ``rustrobotics_tpu/mapping/linearize.py``).

- SE2 pose-pose residual ``e = chart(z^-1 x1^-1 x2)`` and its closed-form
  Jacobians;
- SE2 pose-landmark residual ``R^T (l - t) - z`` and its Jacobians;
- SE3 pose-pose residual ``[t, so3_log(q)]`` of ``z^-1 x1^-1 x2`` and its
  Jacobians by ``torch.func.jacfwd`` through the retraction at 0, under
  ``torch.func.vmap`` over the edges (the JAX package's ``jax.jacfwd``
  under ``jax.vmap``).

Every function maps over a leading edge axis by broadcasting.

Component form (the ``*_soa`` functions): a per-edge "matrix" is an
(r, c, E) tensor, entry-major, so the normal-equation values flatten
straight into the triplet order of ``assemble.build_layout``. A fleet's
leading batch axis rides in front: (B, r, c, E).
"""

from __future__ import annotations

import torch

from rustrobotics_tpu_torch.geometry import se2, se3
from rustrobotics_tpu_torch.utils.angles import wrap_angle

# ----------------------------------------------------------------- SE2


def residual_pp(x1, x2, z):
    """Pose-pose residual, (..., 3)."""
    return se2.compose(se2.inverse(z), se2.relative(x1, x2))


def _deriv(like):
    return torch.tensor([[0.0, -1.0], [1.0, 0.0]], dtype=like.dtype,
                        device=like.device)


def linearize_pp(x1, x2, z):
    """Closed-form (A, B) = (de/dx1, de/dx2), each (..., 3, 3)."""
    rz = se2.rotmat(z[..., 2])
    r1 = se2.rotmat(x1[..., 2])
    rz_r1_t = rz.transpose(-1, -2) @ r1.transpose(-1, -2)
    dr1 = _deriv(x1) @ r1  # d R1 / d theta1
    a12 = rz.transpose(-1, -2) @ dr1.transpose(-1, -2) @ (
        x2[..., :2] - x1[..., :2])[..., None]
    a = x1.new_zeros(x1.shape[:-1] + (3, 3))
    a[..., :2, :2] = -rz_r1_t
    a[..., :2, 2] = a12[..., 0]
    a[..., 2, 2] = -1.0
    b = x1.new_zeros(x1.shape[:-1] + (3, 3))
    b[..., :2, :2] = rz_r1_t
    b[..., 2, 2] = 1.0
    return a, b


def residual_pl(x, landmark, z):
    """Pose-landmark residual, (..., 2)."""
    r_t = se2.rotmat(x[..., 2]).transpose(-1, -2)
    return torch.einsum("...ij,...j->...i", r_t, landmark - x[..., :2]) - z


def linearize_pl(x, landmark):
    """(A, B) = (de/dpose (..., 2, 3), de/dlandmark (..., 2, 2))."""
    r = se2.rotmat(x[..., 2])
    dr = _deriv(x) @ r
    a2 = torch.einsum("...ji,...j->...i", dr, landmark - x[..., :2])
    a = torch.cat([-r.transpose(-1, -2), a2[..., None]], dim=-1)
    return a, r.transpose(-1, -2)


# ----------------------------------------------------------------- SE3


def residual_qq(x1, x2, z):
    """SE(3) pose-pose residual, (..., 6): [translation part of z^-1 x1^-1
    x2, so3_log of its rotation]. Zero iff the edge is satisfied."""
    err = se3.compose(se3.inverse(z), se3.relative(x1, x2))
    return torch.cat([err[..., :3], se3.so3_log(err[..., 3:])], dim=-1)


def _residual_perturbed(delta1, delta2, x1, x2, z):
    return residual_qq(se3.retract(x1, delta1), se3.retract(x2, delta2), z)


_JAC_QQ = torch.func.vmap(
    torch.func.jacfwd(_residual_perturbed, argnums=(0, 1)),
    in_dims=(None, None, 0, 0, 0))


def linearize_qq(x1, x2, z):
    """(A, B) each (..., 6, 6): the derivative of residual_qq with respect
    to the boxplus perturbations of x1 and x2 (se3.retract) at 0, by
    forward-mode AD. The leading axes (edges, and a fleet's batch axis
    before them) are flattened into one for the vmap and restored after."""
    lead = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1],
                                  z.shape[:-1])
    flat = [t.expand(lead + (7,)).reshape(-1, 7) for t in (x1, x2, z)]
    if flat[0].shape[0] == 0:
        empty = x1.new_zeros(lead + (6, 6))
        return empty, empty.clone()
    zero = x1.new_zeros(6)
    a, b = _JAC_QQ(zero, zero, *flat)
    return a.reshape(lead + (6, 6)), b.reshape(lead + (6, 6))


# ------------------------------------------------- component (SoA) path


def _vec(parts):
    """Components (..., E) each -> (..., d, E)."""
    return torch.stack(parts, dim=-2)


def _mat(rows):
    """Rows of components -> (..., r, c, E)."""
    return torch.stack([_vec(r) for r in rows], dim=-3)


def _mat_tmul(a, b):
    """A^T B per edge: a (..., r, m, E), b (..., r, n, E) -> (..., m, n, E)."""
    return (a[..., :, :, None, :] * b[..., :, None, :, :]).sum(-4)


def _mat_tvec(a, v):
    """A^T v per edge: a (..., r, m, E), v (..., r, E) -> (..., m, E)."""
    return (a * v[..., :, None, :]).sum(-3)


def _omega_components(omega):
    """(..., E, d, d) -> (..., d, d, E)."""
    return omega.movedim(-3, -1)


def edge_terms_pp_soa(poses, pp_from, pp_to, pp_z, pp_omega):
    """SE2-SE2 terms in component form. Returns (e (..., 3, E), hii, hij,
    hjj (..., 3, 3, E) each, bi, bj (..., 3, E) each, chi2 (..., E)).
    Same math as residual_pp / linearize_pp. A leading batch axis on
    poses, pp_z and pp_omega carries through; the edge indices are
    shared."""
    x1 = poses[..., pp_from, :]
    x2 = poses[..., pp_to, :]
    th1, thz = x1[..., 2], pp_z[..., 2]
    c1, s1 = torch.cos(th1), torch.sin(th1)
    cz, sz = torch.cos(thz), torch.sin(thz)
    dx = x2[..., 0] - x1[..., 0]
    dy = x2[..., 1] - x1[..., 1]
    # relative translation in x1's frame
    rel_x = c1 * dx + s1 * dy
    rel_y = -s1 * dx + c1 * dy
    zx, zy = pp_z[..., 0], pp_z[..., 1]
    # residual e = z^-1 * (x1^-1 x2)
    e_x = cz * (rel_x - zx) + sz * (rel_y - zy)
    e_y = -sz * (rel_x - zx) + cz * (rel_y - zy)
    e_th = wrap_angle(x2[..., 2] - th1 - thz)
    e = _vec([e_x, e_y, e_th])

    # A = de/dx1, B = de/dx2; cp/sp = cos/sin(th1 + thz)
    cp = torch.cos(th1 + thz)
    sp = torch.sin(th1 + thz)
    zero = torch.zeros_like(cp)
    one = torch.ones_like(cp)
    a12x = cz * rel_y - sz * rel_x
    a12y = -sz * rel_y - cz * rel_x
    a = _mat([[-cp, -sp, a12x], [sp, -cp, a12y], [zero, zero, -one]])
    b = _mat([[cp, sp, zero], [-sp, cp, zero], [zero, zero, one]])

    om = _omega_components(pp_omega)
    om_a = _mat_tmul(om, a)  # Ω^T A = Ω A (Ω symmetric)
    om_b = _mat_tmul(om, b)
    hii = _mat_tmul(a, om_a)  # A^T Ω A
    hij = _mat_tmul(a, om_b)  # A^T Ω B
    hjj = _mat_tmul(b, om_b)  # B^T Ω B
    om_e = _mat_tvec(om, e)
    bi = _mat_tvec(a, om_e)  # A^T Ω e
    bj = _mat_tvec(b, om_e)
    chi2 = (e * om_e).sum(-2)
    return e, hii, hij, hjj, bi, bj, chi2


def edge_terms_pl_soa(poses, landmarks, pl_pose, pl_lm, pl_z, pl_omega):
    """SE2-XY terms in component form: hii (..., 3, 3, E), hij (..., 3, 2,
    E), hjj (..., 2, 2, E), bi (..., 3, E), bj (..., 2, E), chi2 (..., E).
    Same math as residual_pl / linearize_pl; batches as edge_terms_pp_soa."""
    x = poses[..., pl_pose, :]
    lm = landmarks[..., pl_lm, :]
    th = x[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    dx = lm[..., 0] - x[..., 0]
    dy = lm[..., 1] - x[..., 1]
    # e = R^T (l - t) - z
    e0 = c * dx + s * dy - pl_z[..., 0]
    e1 = -s * dx + c * dy - pl_z[..., 1]
    e = _vec([e0, e1])
    # A (2x3) = [-R^T | dR^T (l - t)], B (2x2) = R^T
    a02 = -s * dx + c * dy
    a12 = -c * dx - s * dy
    a = _mat([[-c, -s, a02], [s, -c, a12]])
    b = _mat([[c, s], [-s, c]])
    om = _omega_components(pl_omega)
    om_a = _mat_tmul(om, a)
    om_b = _mat_tmul(om, b)
    hii = _mat_tmul(a, om_a)  # 3x3
    hij = _mat_tmul(a, om_b)  # 3x2
    hjj = _mat_tmul(b, om_b)  # 2x2
    om_e = _mat_tvec(om, e)
    bi = _mat_tvec(a, om_e)
    bj = _mat_tvec(b, om_e)
    chi2 = (e * om_e).sum(-2)
    return e, hii, hij, hjj, bi, bj, chi2


# ------------------------------------------------------------- batched


def edge_terms_pp(poses, pp_from, pp_to, pp_z, pp_omega):
    """SE2-SE2 terms: residuals (E, 3), A (E, 3, 3), B (E, 3, 3), chi2
    contributions (E,)."""
    x1 = poses[pp_from]
    x2 = poses[pp_to]
    e = residual_pp(x1, x2, pp_z)
    a, b = linearize_pp(x1, x2, pp_z)
    chi2 = torch.einsum("ei,eij,ej->e", e, pp_omega, e)
    return e, a, b, chi2


def quad_form(e, omega):
    """e^T Ω e per edge: e (..., E, d), omega (..., E, d, d) -> (..., E),
    as products and sums (no matmul, so no reduced-precision pass)."""
    return (e[..., :, None] * omega * e[..., None, :]).sum((-1, -2))


def edge_terms_qq(poses3, qq_from, qq_to, qq_z, qq_omega):
    """SE3-SE3 terms: residuals (..., E, 6), A and B (..., E, 6, 6), chi2
    contributions (..., E). A leading batch axis on poses3, qq_z and
    qq_omega carries through; the edge indices are shared."""
    x1 = poses3[..., qq_from, :]
    x2 = poses3[..., qq_to, :]
    e = residual_qq(x1, x2, qq_z)
    a, b = linearize_qq(x1, x2, qq_z)
    return e, a, b, quad_form(e, qq_omega)


def edge_terms_pl(poses, landmarks, pl_pose, pl_lm, pl_z, pl_omega):
    """SE2-XY terms: residuals (E, 2), A (E, 2, 3), B (E, 2, 2), chi2 (E,)."""
    x = poses[pl_pose]
    lm = landmarks[pl_lm]
    e = residual_pl(x, lm, pl_z)
    a, b = linearize_pl(x, lm)
    chi2 = torch.einsum("ei,eij,ej->e", e, pl_omega, e)
    return e, a, b, chi2
