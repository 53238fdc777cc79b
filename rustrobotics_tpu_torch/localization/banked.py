"""Banked batched Kalman filters: the bank axis is the last one
(counterpart of ``rustrobotics_tpu/localization/banked.py``).

A bank of B independent filters stores x as ``(D, B)`` and cov as
``(D, D, B)``, so every operand of a step is contiguous in B. The small
products are elementwise sweeps over the D axes (``bmm``: D multiply-adds
of (i, k, B) slabs); ``torch.einsum("ijb,jkb->ikb")`` permutes B to the
front for one batched GEMM of B (D, D) products and returns the result
laid out B-first, with stride D² along B. Innovation inverses are
closed-form adjugates (M <= 3, ``binv``) and the UKF's square root is an
unrolled Cholesky (``bchol``), so a step calls no ``torch.linalg``.

The known-correspondence filters apply their updates slot by slot;
``_update_one`` is one slot without the mask, for a caller that skips
invalid slots on the host (the ids are shared by the whole bank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from rustrobotics_tpu_torch.device import as_tensor, tensor_fields
from rustrobotics_tpu_torch.utils.angles import wrap_angle


def bmm(a, b):
    """(i,j,B) @ (j,k,B) -> (i,k,B): banked matmul as j sweeps."""
    out = a[:, 0, None] * b[None, 0]
    for j in range(1, a.shape[1]):
        out = torch.addcmul(out, a[:, j, None], b[None, j])
    return out


def bmv(a, x):
    """(i,j,B) @ (j,B) -> (i,B): banked matvec as j sweeps."""
    out = a[:, 0] * x[0]
    for j in range(1, a.shape[1]):
        out = torch.addcmul(out, a[:, j], x[j])
    return out


def bt(a):
    """Banked transpose: (i,j,B) -> (j,i,B)."""
    return a.transpose(0, 1)


def binv(s):
    """Closed-form banked inverse of (m,m,B) for m in {1,2,3}."""
    m = s.shape[0]
    if m == 1:
        return 1.0 / s
    if m == 2:
        det = s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]
        return torch.stack([
            torch.stack([s[1, 1], -s[0, 1]]),
            torch.stack([-s[1, 0], s[0, 0]]),
        ]) / det
    if m == 3:
        c00 = s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]
        c01 = s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]
        c02 = s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]
        det = s[0, 0] * c00 + s[0, 1] * c01 + s[0, 2] * c02
        c10 = s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]
        c11 = s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]
        c12 = s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]
        c20 = s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]
        c21 = s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]
        c22 = s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]
        adj = torch.stack([
            torch.stack([c00, c10, c20]),
            torch.stack([c01, c11, c21]),
            torch.stack([c02, c12, c22]),
        ])
        return adj / det
    raise NotImplementedError(
        f"banked closed-form inverse supports m <= 3, got {m}")


def bchol(a):
    """Banked lower Cholesky of (D,D,B) SPD stacks, D small: unrolled
    Cholesky-Crout, D(D+1)/2 elementwise sqrt/div/FMA sweeps over B."""
    d = a.shape[0]
    zero = torch.zeros_like(a[0, 0])
    low = [[None] * d for _ in range(d)]
    for j in range(d):
        s = a[j, j] - sum((low[j][k] * low[j][k] for k in range(j)), zero)
        low[j][j] = torch.sqrt(s)
        inv_ljj = 1.0 / low[j][j]
        for i in range(j + 1, d):
            s = a[i, j] - sum((low[i][k] * low[j][k] for k in range(j)),
                              zero)
            low[i][j] = s * inv_ljj
    return torch.stack([
        torch.stack([low[i][j] if j <= i else zero for j in range(d)])
        for i in range(d)
    ])


def _noise3(a):
    """(D,D) shared noise as (D,D,1); (D,D,B) per-filter noise as is."""
    return a if a.ndim == 3 else a[:, :, None]


def _wmean(w, sp):
    """sum_k w_k sp_k: (K,) x (K,I,B) -> (I,B)."""
    return (w[:, None, None] * sp).sum(0)


def _wcov(w, a, b):
    """sum_k w_k a_k b_k^T: (K,I,B), (K,J,B) -> (I,J,B)."""
    return (w[:, None, None, None] * a[:, :, None] * b[:, None]).sum(0)


def _wrap(innov, components):
    innov = innov.clone()
    for c in components:
        innov[c] = wrap_angle(innov[c])
    return innov


@dataclasses.dataclass(frozen=True)
class BankedEKF:
    """EKF over a bank of B independent filters, bank axis last.

    Model callbacks follow the banked contract (batch LAST everywhere):
      predict(x (D,B), u (U,B), dt)            -> x_pred (D,B)
      jac_x(x (D,B), u (U,B), dt)              -> F (D,D,B)
      measure(x (D,B))                          -> z_pred (M,B)
      jac_z(x (D,B))                            -> H (M,D,B)
    ``q`` (D,D) process noise, ``r`` (M,M) measurement noise (shared
    across the bank; pass (D,D,B)/(M,M,B) for per-filter noise).
    """

    predict: Callable
    jac_x: Callable
    measure: Callable
    jac_z: Callable
    q: torch.Tensor
    r: torch.Tensor

    def __post_init__(self):
        tensor_fields(self, "q", "r")

    def step(self, x, cov, u, z, dt):
        """One predict+update across the whole bank. x (D,B), cov
        (D,D,B), u (U,B), z (M,B) -> (x', cov')."""
        x_pred = self.predict(x, u, dt)
        f = self.jac_x(x, u, dt)
        cov_pred = bmm(bmm(f, cov), bt(f)) + _noise3(self.q)

        h = self.jac_z(x_pred)
        y = z - self.measure(x_pred)
        s = bmm(bmm(h, cov_pred), bt(h)) + _noise3(self.r)
        k = bmm(bmm(cov_pred, bt(h)), binv(s))
        x_new = x_pred + bmv(k, y)
        cov_new = cov_pred - bmm(k, bmm(h, cov_pred))
        return x_new, cov_new


def _fold(sp):
    """(K, D', B) -> (D', K*B): the sigma axis into the bank."""
    k, d, b = sp.shape
    return sp.transpose(0, 1).reshape(d, k * b)


def _unfold(y, k, b):
    """(D', K*B) -> (K, D', B)."""
    return y.reshape(y.shape[0], k, b).transpose(0, 1)


def _fold_u(u, k):
    """(U, B) -> (U, K*B): the control of each filter for its K points."""
    return u[:, None].expand(u.shape[0], k, u.shape[1]).reshape(
        u.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class BankedUKF:
    """Scaled-sigma-point UKF over a bank of B filters, bank axis last.

    Same math as ``ukf.UnscentedKalmanFilter``; every per-point model
    evaluation runs with the sigma axis folded into the bank: the
    (2D+1, D, B) cloud is reshaped to (D, (2D+1)·B), and the weighted
    moments are sums over the sigma axis.

    Model callbacks follow the banked contract (batch LAST):
      predict(x (D,Bf), u (U,Bf), dt) -> (D,Bf)
      measure(x (D,Bf))               -> (M,Bf)
    """

    predict: Callable
    measure: Callable
    q: torch.Tensor  # (D, D) process noise
    r: torch.Tensor  # (M, M) measurement noise
    mw: torch.Tensor  # (2D+1,) mean weights
    cw: torch.Tensor  # (2D+1,) cov weights
    gamma: float

    def __post_init__(self):
        tensor_fields(self, "q", "r", "mw", "cw")

    @classmethod
    def create(cls, predict, measure, q, r,
               alpha=0.001, beta=2.0, kappa=0.0, device=None, dtype=None):
        from rustrobotics_tpu_torch.localization.ukf import sigma_weights

        q = as_tensor(q, device, dtype)
        mw, cw, gamma = sigma_weights(q.shape[-1], alpha, beta, kappa)
        return cls(predict=predict, measure=measure, q=q,
                   r=as_tensor(r, q.device, q.dtype),
                   mw=torch.as_tensor(mw, dtype=q.dtype, device=q.device),
                   cw=torch.as_tensor(cw, dtype=q.dtype, device=q.device),
                   gamma=float(gamma))

    def _sigma(self, x, cov):
        """(D,B),(D,D,B) -> (2D+1, D, B): [x, x+gamma*L_j, x-gamma*L_j]."""
        cols = bt(bchol(cov)) * self.gamma  # row j = gamma * L[:, j]
        return torch.cat([x[None], x[None] + cols, x[None] - cols], dim=0)

    def step(self, x, cov, u, z, dt):
        """One predict+update across the bank. x (D,B), cov (D,D,B),
        u (U,B), z (M,B) -> (x', cov')."""
        d, b = x.shape
        k = 2 * d + 1

        # predict
        sp = self._sigma(x, cov)
        sp_pred = _unfold(self.predict(_fold(sp), _fold_u(u, k), dt), k, b)
        mean_pred = _wmean(self.mw, sp_pred)
        dxp = sp_pred - mean_pred[None]
        cov_pred = _wcov(self.cw, dxp, dxp) + _noise3(self.q)

        # update (fresh sigma points around the prediction)
        sp2 = self._sigma(mean_pred, cov_pred)
        sp_z = _unfold(self.measure(_fold(sp2)), k, b)
        mean_z = _wmean(self.mw, sp_z)
        dz = sp_z - mean_z[None]
        cov_z = _wcov(self.cw, dz, dz) + _noise3(self.r)
        dx2 = sp2 - mean_pred[None]
        cross = _wcov(self.cw, dx2, dz)

        gain = bmm(cross, binv(cov_z))
        x_new = mean_pred + bmv(gain, z - mean_z)
        cov_new = cov_pred - bmm(gain, bmm(cov_z, bt(gain)))
        return x_new, cov_new


@dataclasses.dataclass(frozen=True)
class BankedEKFKC:
    """Banked EKF with known correspondences: the bank-last variant of
    ``ExtendedKalmanFilterKnownCorrespondences`` for a fleet of B filters:
    predict with ``G cov G^T + V M V^T``, then sequential masked
    per-landmark Joseph-form updates; x ``(D, B)``, cov ``(D, D, B)``.

    Model callbacks follow the banked contract (batch LAST):
      predict(x (D,B), u (U,B), dt)  -> (D,B)
      jac_x(x (D,B), u (U,B), dt)    -> (D,D,B)
      jac_u(x (D,B), u (U,B), dt)    -> (D,U,B)
      noise_ctrl(u (U,B))            -> (U,U,B) control-space noise M
      measure(x (D,B), lm (L,))      -> (Z,B)
      jac_z(x (D,B), lm (L,))        -> (Z,D,B)
    ``q`` (Z,Z) measurement noise; ``wrap_components``: innovation
    components that are angles (wrapped to [-pi, pi]).
    """

    predict: Callable
    jac_x: Callable
    jac_u: Callable
    noise_ctrl: Callable
    measure: Callable
    jac_z: Callable
    q: torch.Tensor
    landmarks: Any  # LandmarkTable
    wrap_components: tuple = (1,)

    def __post_init__(self):
        tensor_fields(self, "q")

    def predict_step(self, x, cov, u, dt):
        g = self.jac_x(x, u, dt)
        v = self.jac_u(x, u, dt)
        m = self.noise_ctrl(u)
        x_pred = self.predict(x, u, dt)
        cov_pred = bmm(bmm(g, cov), bt(g)) + bmm(bmm(v, m), bt(v))
        return x_pred, cov_pred

    def _update_one(self, x, cov, lm, z):
        """One landmark's Joseph-form update across the bank, unmasked.
        z: (Z,) shared or (Z, B); lm: (L,) shared landmark."""
        qb = self.q.to(x.dtype)[:, :, None]
        z_pred = self.measure(x, lm)
        h = self.jac_z(x, lm)
        if z.ndim == 1:
            z = z[:, None]
        innov = _wrap(z - z_pred, self.wrap_components)
        s = bmm(bmm(h, cov), bt(h)) + qb
        k = bmm(bmm(cov, bt(h)), binv(s))
        x_new = x + bmv(k, innov)
        # Joseph form (PSD-preserving in f32)
        eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
        ikh = eye[:, :, None] - bmm(k, h)
        cov_new = bmm(bmm(ikh, cov), bt(ikh)) + bmm(bmm(k, qb), bt(k))
        return x_new, cov_new

    def update(self, x, cov, ids, z, mask):
        """Sequential masked updates over the event's measurement slots.
        ids (M,) shared across the bank; z (M, Z) shared or (M, Z, B)
        banked; mask (M,) slot validity."""
        lms, valid = self.landmarks.lookup(ids)
        valid = torch.logical_and(valid, mask)
        for m in range(ids.shape[0]):
            x_new, cov_new = self._update_one(x, cov, lms[m], z[m])
            x = torch.where(valid[m], x_new, x)
            cov = torch.where(valid[m], cov_new, cov)
        return x, cov

    def step(self, x, cov, u, has_control, ids, z, mask, dt):
        """One merged event across the bank (control optional via
        ``has_control``)."""
        x_pred, cov_pred = self.predict_step(x, cov, u, dt)
        x = torch.where(has_control, x_pred, x)
        cov = torch.where(has_control, cov_pred, cov)
        return self.update(x, cov, ids, z, mask)


@dataclasses.dataclass(frozen=True)
class BankedUKFKC:
    """Banked UKF with known correspondences: the bank-last fleet variant
    of ``UnscentedKalmanFilterKnownCorrespondences``. Predict folds the
    sigma axis into the bank and adds control-space noise via the input
    Jacobian (V M V^T); updates are sequential masked per-landmark sigma
    updates with circular-bearing re-centering. x (D, B), cov (D, D, B).
    """

    predict: Callable      # (x (D,Bf), u (U,Bf), dt) -> (D,Bf)
    jac_u: Callable        # (x (D,B), u (U,B), dt) -> (D,U,B)
    noise_ctrl: Callable   # (u (U,B)) -> (U,U,B)
    measure: Callable      # (x (D,Bf), lm (L,)) -> (Z,Bf)
    q: torch.Tensor        # (Z, Z)
    landmarks: Any
    mw: torch.Tensor       # (2D+1,)
    cw: torch.Tensor
    gamma: float
    wrap_components: tuple = (1,)

    def __post_init__(self):
        tensor_fields(self, "q", "mw", "cw")

    def _sigma(self, x, cov):
        """(D,B),(D,D,B) -> (2D+1, D, B)."""
        cols = bt(bchol(cov)) * self.gamma
        return torch.cat([x[None], x[None] + cols, x[None] - cols], dim=0)

    def predict_step(self, x, cov, u, dt):
        d, b = x.shape
        k = 2 * d + 1
        sp = self._sigma(x, cov)
        sp_pred = _unfold(self.predict(_fold(sp), _fold_u(u, k), dt), k, b)
        mean = _wmean(self.mw, sp_pred)
        dx = sp_pred - mean[None]
        v = self.jac_u(mean, u, dt)
        m = self.noise_ctrl(u)
        cov_new = _wcov(self.cw, dx, dx) + bmm(bmm(v, m), bt(v))
        return mean, cov_new

    def _update_one(self, x, cov, lm, z):
        d, b = x.shape
        k = 2 * d + 1
        qb = self.q.to(x.dtype)[:, :, None]
        sp = self._sigma(x, cov)
        sp_z = _unfold(self.measure(_fold(sp), lm), k, b)
        # circular bearings: re-center on the first sigma point's
        for c in self.wrap_components:
            b0 = sp_z[0, c]
            sp_z[:, c] = b0[None] + wrap_angle(sp_z[:, c] - b0[None])
        mean_z = _wmean(self.mw, sp_z)
        dz = sp_z - mean_z[None]
        cov_z = _wcov(self.cw, dz, dz) + qb
        dx = sp - x[None]
        cross = _wcov(self.cw, dx, dz)
        gain = bmm(cross, binv(cov_z))
        if z.ndim == 1:
            z = z[:, None]
        innov = _wrap(z - mean_z, self.wrap_components)
        x_new = x + bmv(gain, innov)
        cov_new = cov - bmm(gain, bmm(cov_z, bt(gain)))
        return x_new, cov_new

    update = BankedEKFKC.update
    step = BankedEKFKC.step


def velocity_banked_ukf_kc(alpha, q, landmarks, ukf_alpha=1.0,
                           beta=2.0, kappa=0.0, device=None):
    """Banked UKF-KC on the velocity motion model + range-bearing
    measurement: the bank-last analog of
    ``UnscentedKalmanFilterKnownCorrespondences.create``."""
    from rustrobotics_tpu_torch.localization.ukf import sigma_weights

    ekc = velocity_banked_ekf_kc(alpha, q, landmarks, device)
    qz = ekc.q
    mw, cw, gamma = sigma_weights(3, ukf_alpha, beta, kappa)
    return BankedUKFKC(predict=ekc.predict, jac_u=ekc.jac_u,
                       noise_ctrl=ekc.noise_ctrl, measure=ekc.measure,
                       q=qz, landmarks=ekc.landmarks,
                       mw=torch.as_tensor(mw, dtype=qz.dtype,
                                          device=qz.device),
                       cw=torch.as_tensor(cw, dtype=qz.dtype,
                                          device=qz.device),
                       gamma=float(gamma), wrap_components=(1,))


def velocity_banked_ekf_kc(alpha, q, landmarks, device=None):
    """Banked EKF-KC on the velocity motion model + range-bearing
    measurement: the fleet analog of ``landmark_replay.build_filter``'s
    EKF. ``alpha`` (6,) noise coefficients, ``q`` (2,2) measurement noise,
    ``landmarks`` a LandmarkTable."""
    a = as_tensor(alpha, device)
    eps_w = 1e-10  # straight-line branch threshold (models.motion)
    eps_m = 1e-5   # control-noise floor

    def predict(x, u, dt):
        px, py, th = x
        v, w = u
        straight = torch.abs(w) < eps_w
        ws = torch.where(straight, torch.ones_like(w), w)
        arc_dx = v / ws * (-torch.sin(th) + torch.sin(th + w * dt))
        arc_dy = v / ws * (torch.cos(th) - torch.cos(th + w * dt))
        dx = torch.where(straight, v * torch.cos(th) * dt, arc_dx)
        dy = torch.where(straight, v * torch.sin(th) * dt, arc_dy)
        return torch.stack([px + dx, py + dy, wrap_angle(th + w * dt)])

    def jac_x(x, u, dt):
        th = x[2]
        v, w = u
        straight = torch.abs(w) < eps_w
        ws = torch.where(straight, torch.ones_like(w), w)
        j02 = torch.where(straight, -v * torch.sin(th) * dt,
                          v / ws * (-torch.cos(th) + torch.cos(th + w * dt)))
        j12 = torch.where(straight, v * torch.cos(th) * dt,
                          v / ws * (-torch.sin(th) + torch.sin(th + w * dt)))
        zz = torch.zeros_like(th)
        oo = torch.ones_like(th)
        return torch.stack([
            torch.stack([oo, zz, j02]),
            torch.stack([zz, oo, j12]),
            torch.stack([zz, zz, oo]),
        ])

    def jac_u(x, u, dt):
        th = x[2]
        v, w = u
        straight = torch.abs(w) < eps_w
        ws = torch.where(straight, torch.ones_like(w), w)
        sint, cost = torch.sin(th), torch.cos(th)
        sintdt, costdt = torch.sin(th + w * dt), torch.cos(th + w * dt)
        w2 = ws * ws
        zz = torch.zeros_like(th)
        j00 = torch.where(straight, cost * dt, (-sint + sintdt) / ws)
        j10 = torch.where(straight, sint * dt, (cost - costdt) / ws)
        j01 = torch.where(straight, zz,
                          v * ((sint - sintdt) / w2 + costdt * dt / ws))
        j11 = torch.where(straight, zz,
                          v * (-(cost - costdt) / w2 + sintdt * dt / ws))
        return torch.stack([
            torch.stack([j00, j01]),
            torch.stack([j10, j11]),
            torch.stack([zz, zz + dt]),
        ])

    def noise_ctrl(u):
        v2 = torch.square(u[0])
        w2 = torch.square(u[1])
        d0 = a[0] * v2 + a[1] * w2 + eps_m
        d1 = a[2] * v2 + a[3] * w2 + eps_m
        zz = torch.zeros_like(d0)
        return torch.stack([torch.stack([d0, zz]), torch.stack([zz, d1])])

    def rb_measure(x, lm):
        dx = lm[0] - x[0]
        dy = lm[1] - x[1]
        qq = dx * dx + dy * dy
        return torch.stack([torch.sqrt(qq), torch.atan2(dy, dx) - x[2]])

    def rb_jac(x, lm):
        dx = lm[0] - x[0]
        dy = lm[1] - x[1]
        qq = dx * dx + dy * dy
        qs = torch.sqrt(qq)
        zz = torch.zeros_like(dx)
        mone = -torch.ones_like(dx)
        return torch.stack([
            torch.stack([-dx / qs, -dy / qs, zz]),
            torch.stack([dy / qq, -dx / qq, mone]),
        ])

    return BankedEKFKC(predict=predict, jac_x=jac_x, jac_u=jac_u,
                       noise_ctrl=noise_ctrl, measure=rb_measure,
                       jac_z=rb_jac, q=as_tensor(q, a.device),
                       landmarks=landmarks, wrap_components=(1,))


def _sp_predict(x, u, dt):
    """SimpleProblem banked prediction."""
    px, py, yaw, v = x
    return torch.stack([
        px + v * torch.cos(yaw) * dt,
        py + v * torch.sin(yaw) * dt,
        yaw + u[1] * dt,
        u[0],
    ])


def _sp_measure(x):
    """GPS-like (x, y) observation."""
    return x[:2]


def simple_problem_banked_ukf(q, r, alpha=0.001, beta=2.0, kappa=0.0,
                              device=None):
    """Banked UKF for the SimpleProblem model: the bank-last analog of
    ``UnscentedKalmanFilter.create(...)`` on SimpleProblem models."""
    return BankedUKF.create(predict=_sp_predict, measure=_sp_measure,
                            q=q, r=r, alpha=alpha, beta=beta, kappa=kappa,
                            device=device)


def simple_problem_banked(q, r, dt_default=0.1, device=None):
    """Banked EKF for the SimpleProblem 4-state [x, y, yaw, v] model:
    constant-velocity unicycle prediction, GPS-like (x, y) observation."""
    q = as_tensor(q, device)
    r = as_tensor(r, q.device)

    def jac_x(x, u, dt):
        yaw = x[2]
        v = u[0]  # reference quirk: the Jacobian reads v from the CONTROL
        zz = torch.zeros_like(yaw)
        oo = torch.ones_like(yaw)
        return torch.stack([
            torch.stack([oo, zz, -dt * v * torch.sin(yaw),
                         dt * torch.cos(yaw)]),
            torch.stack([zz, oo, dt * v * torch.cos(yaw),
                         dt * torch.sin(yaw)]),
            torch.stack([zz, zz, oo, zz]),
            torch.stack([zz, zz, zz, zz]),
        ])

    def jac_z(x):
        h = torch.zeros((2, 4), dtype=x.dtype, device=x.device)
        h[0, 0] = 1.0
        h[1, 1] = 1.0
        return h[:, :, None].expand(2, 4, x.shape[1])

    return BankedEKF(predict=_sp_predict, jac_x=jac_x, measure=_sp_measure,
                     jac_z=jac_z, q=q, r=r)
