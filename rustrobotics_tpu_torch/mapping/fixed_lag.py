"""Fixed-lag smoother: sliding-window pose-graph optimization with
marginalization (counterpart of ``rustrobotics_tpu/mapping/fixed_lag.py``).

Online SLAM keeps a bounded window of recent poses, optimizes it each
step, and marginalizes the oldest pose into a dense Gaussian prior instead
of dropping its information.

Everything is fixed-shape: W window poses, W-1 chain (odometry) edges, a
C-capacity masked set of in-window loop closures, and a dense (3W, 3W)
prior information matrix. ``advance`` and ``add_closure`` read nothing
back to the host: the window's fill state (``steps``, ``clos_cursor``) is
a device tensor and every branch on it is a ``torch.where``, the
factorizations are the ``_ex`` forms that skip the host-side error check
(a Cholesky breakdown gives NaN, as in the JAX package),
and a row is picked by a one-element index tensor. So a step can be
captured in a CUDA graph. The inner Gauss-Newton solve is a dense 3W
Cholesky of the Jacobi-scaled system, ``gn_iters`` times.

Marginalization: at the window optimum the factors' information is
assembled into H (3W, 3W); eliminating the oldest pose's 3x3 block by
Schur complement gives the new prior Lambda' = H_rr - H_r0 H_00^-1 H_0r
anchored at the converged estimates (eta = 0, the
relinearize-at-convergence approximation of fixed-lag smoothers). The
package keeps TF32 off, so these products run at full f32 on the card,
as the JAX package's run at "highest" precision.
"""

from __future__ import annotations

import dataclasses

import torch

from rustrobotics_tpu_torch.device import resolve_device
from rustrobotics_tpu_torch.geometry import se2
from rustrobotics_tpu_torch.mapping.linearize import edge_terms_pp_soa
from rustrobotics_tpu_torch.ops.batched_tri import _cholesky
from rustrobotics_tpu_torch.utils.angles import wrap_angle


@dataclasses.dataclass
class FixedLagState:
    poses: torch.Tensor         # (W, 3) current window estimates
    chain_z: torch.Tensor       # (W-1, 3) odometry measurements i -> i+1
    clos_ij: torch.Tensor       # (C, 2) int64 window indices (i, j)
    clos_z: torch.Tensor        # (C, 3)
    clos_mask: torch.Tensor     # (C,) bool
    prior_lambda: torch.Tensor  # (3W, 3W) information of the marginal prior
    prior_mu: torch.Tensor      # (W, 3) anchor of the prior chart
    steps: torch.Tensor         # () int64: poses consumed so far
    clos_cursor: torch.Tensor   # () int64: round-robin insertion cursor

    def replace(self, **updates) -> "FixedLagState":
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass
class FixedLagSmoother:
    """window: W poses; closure_capacity: C masked slots. The information
    matrices are cast to the state's dtype where they are used."""

    window: int
    closure_capacity: int
    chain_omega: torch.Tensor   # (3, 3) odometry information
    clos_omega: torch.Tensor    # (3, 3) closure information
    anchor_weight: float = 1e6
    gn_iters: int = 3

    @classmethod
    def create(cls, window, closure_capacity, chain_omega, clos_omega,
               device=None, **kw):
        """The smoother on ``device`` (None: the card)."""
        device = resolve_device(device)
        return cls(window=window, closure_capacity=closure_capacity,
                   chain_omega=torch.as_tensor(chain_omega, device=device),
                   clos_omega=torch.as_tensor(clos_omega, device=device),
                   **kw)

    @property
    def device(self) -> torch.device:
        return self.chain_omega.device

    def init_state(self, pose0) -> FixedLagState:
        w, c = self.window, self.closure_capacity
        pose0 = torch.as_tensor(pose0, device=self.device)
        dtype, dev = pose0.dtype, self.device
        lam = torch.zeros((3 * w, 3 * w), dtype=dtype, device=dev)
        # gauge anchor on the first pose of the first window
        lam[:3, :3] = torch.eye(3, dtype=dtype, device=dev) * self.anchor_weight
        window = pose0.expand(w, 3).clone()
        return FixedLagState(
            poses=window,
            chain_z=torch.zeros((w - 1, 3), dtype=dtype, device=dev),
            clos_ij=torch.zeros((c, 2), dtype=torch.long, device=dev),
            clos_z=torch.zeros((c, 3), dtype=dtype, device=dev),
            clos_mask=torch.zeros(c, dtype=torch.bool, device=dev),
            prior_lambda=lam,
            prior_mu=window.clone(),
            steps=torch.ones((), dtype=torch.long, device=dev),
            clos_cursor=torch.zeros((), dtype=torch.long, device=dev),
        )

    # ----------------------------------------------------------- internals

    def _chart(self, poses, mu):
        """Window chart: translation difference + wrapped angle diff."""
        d = poses - mu
        return torch.cat([d[:, :2], wrap_angle(d[:, 2:3])], -1).reshape(-1)

    def _assemble(self, state: FixedLagState):
        """H (3W, 3W), b (3W,) at the current estimates; active edges =
        chain edges with index < steps-1 (young windows are short) and the
        closures whose slot is set."""
        w = self.window
        dtype = state.poses.dtype
        dev = state.poses.device
        n = 3 * w
        h = torch.zeros(n * n, dtype=dtype, device=dev)
        b = torch.zeros(n, dtype=dtype, device=dev)
        k3 = torch.arange(3, device=dev)

        # the chain edges and the closure slots as one edge set; a masked
        # edge has Ω = 0 and adds exact zeros, so its indices (a dead
        # closure's run below 0) are clamped into the window
        chain_from = torch.arange(w - 1, device=dev)
        frm = torch.cat([chain_from, state.clos_ij[:, 0]]).clamp(0, w - 1)
        to = torch.cat([chain_from + 1, state.clos_ij[:, 1]]).clamp(0, w - 1)
        mask = torch.cat([chain_from + 1 < state.steps, state.clos_mask])
        om = torch.cat([self.chain_omega.to(dtype).expand(w - 1, 3, 3),
                        self.clos_omega.to(dtype).expand(
                            self.closure_capacity, 3, 3)])
        om = om * mask.to(dtype)[:, None, None]
        _, hii, hij, hjj, bi, bj, _ = edge_terms_pp_soa(
            state.poses, frm, to, torch.cat([state.chain_z, state.clos_z]),
            om)
        ri = frm * 3 + k3[:, None]  # (3, E) rows of each edge's i block
        rj = to * 3 + k3[:, None]
        blocks = ((ri, ri, hii), (ri, rj, hij),
                  (rj, ri, hij.transpose(0, 1)), (rj, rj, hjj))
        idx = torch.cat([(r[:, None, :] * n + c[None, :, :]).reshape(-1)
                         for r, c, _ in blocks])
        h.index_add_(0, idx, torch.cat([v.reshape(-1) for _, _, v in blocks]))
        # b convention: H dx = b with b = -J^T Omega e
        b.index_add_(0, torch.cat([ri.reshape(-1), rj.reshape(-1)]),
                     -torch.cat([bi.reshape(-1), bj.reshape(-1)]))
        h = h.view(n, n)

        # prior factor: E = 0.5 (v - mu)^T Lambda (v - mu)
        e_prior = self._chart(state.poses, state.prior_mu)
        h = h + state.prior_lambda
        b = b - state.prior_lambda @ e_prior  # b convention is -J^T Ω e

        # pin factor-free dofs (window slots beyond `steps` while the
        # window is still filling) so H stays SPD
        inactive = (torch.arange(n, device=dev) >= 3 * state.steps).to(dtype)
        return h + torch.diag(inactive), b

    def _gn(self, state: FixedLagState) -> FixedLagState:
        poses = state.poses
        for _ in range(self.gn_iters):
            h, b = self._assemble(state.replace(poses=poses))
            d = torch.sqrt(torch.clamp(torch.diagonal(h), min=1e-12))
            hs = h / (d[:, None] * d[None, :])
            chol = _cholesky(hs)  # NaN on a breakdown, as in JAX
            dx = torch.cholesky_solve((b / d)[:, None], chol)[:, 0] / d
            poses = se2.retract(poses, dx.reshape(-1, 3))
        return state.replace(poses=poses)

    # ------------------------------------------------------------- stepping

    def add_closure(self, state: FixedLagState, i, j, z) -> FixedLagState:
        """Register a loop closure between window poses i -> j (oldest
        window pose is index 0). Takes the first free slot; with all slots
        busy the closure at the round-robin cursor (the oldest insertion)
        is overwritten."""
        dev = state.poses.device
        free = torch.argmin(state.clos_mask.to(torch.int32))  # first False, else 0
        all_busy = torch.all(state.clos_mask)
        slot = torch.where(all_busy, state.clos_cursor, free)[None]
        ij = torch.stack([torch.as_tensor(i, device=dev),
                          torch.as_tensor(j, device=dev)]).to(torch.long)
        z = torch.as_tensor(z, dtype=state.clos_z.dtype, device=dev)
        return state.replace(
            clos_ij=state.clos_ij.index_copy(0, slot, ij[None]),
            clos_z=state.clos_z.index_copy(0, slot, z[None]),
            clos_mask=state.clos_mask.index_fill(0, slot, True),
            clos_cursor=(slot[0] + 1) % self.closure_capacity,
        )

    def advance(self, state: FixedLagState, odom_z) -> FixedLagState:
        """Optimize the window, marginalize the oldest pose, slide, and
        append the new odometry edge/pose."""
        w = self.window
        dtype, dev = state.poses.dtype, state.poses.device
        odom_z = torch.as_tensor(odom_z, dtype=dtype, device=dev)
        state = self._gn(state)

        # marginalize pose 0 out of the information at the optimum
        h, _ = self._assemble(state)
        h00 = h[:3, :3] + torch.eye(3, dtype=dtype, device=dev) * 1e-9
        k = torch.linalg.solve_ex(h00, h[:3, 3:]).result
        lam_marg = h[3:, 3:] - h[3:, :3] @ k  # (3(W-1), 3(W-1))
        lam_new = torch.zeros((3 * w, 3 * w), dtype=dtype, device=dev)
        lam_new[: 3 * (w - 1), : 3 * (w - 1)] = lam_marg

        # slide the window; predict the new pose from odometry off the
        # last ACTIVE pose (index steps-1 while the window is filling)
        full = state.steps >= w
        last = _row(state.poses, state.steps - 1)
        new_pose = se2.compose(last, odom_z)
        poses = torch.where(
            full, torch.cat([state.poses[1:], new_pose[None]]),
            _insert_at(state.poses, state.steps, new_pose))
        chain_z = torch.where(
            full, torch.cat([state.chain_z[1:], odom_z[None]]),
            _insert_at(state.chain_z, state.steps - 1, odom_z))
        # closures shift with the window once it is full; expired ones die
        ij = torch.where(full, state.clos_ij - 1, state.clos_ij)
        mask = state.clos_mask & (ij.amin(dim=1) >= 0)
        return FixedLagState(
            poses=poses, chain_z=chain_z, clos_ij=ij, clos_z=state.clos_z,
            clos_mask=mask,
            prior_lambda=torch.where(full, lam_new, state.prior_lambda),
            prior_mu=torch.where(full, poses, state.prior_mu),
            steps=state.steps + 1, clos_cursor=state.clos_cursor,
        )

    def current_pose(self, state: FixedLagState):
        return _row(state.poses, state.steps - 1)


def _row(arr, idx):
    """arr[clip(idx)] for a 0-d index tensor, as a gather (indexing by a
    0-d tensor would read it back to the host)."""
    idx = torch.clamp(idx, 0, arr.shape[0] - 1)
    return arr.index_select(0, idx[None])[0]


def _insert_at(arr, idx, row):
    idx = torch.clamp(idx, 0, arr.shape[0] - 1)
    return arr.index_copy(0, idx[None], row[None])
