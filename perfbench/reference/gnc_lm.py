"""The plain robust reference: Levenberg-Marquardt with graduated
non-convexity over the Geman-McClure loss (GNC-GM) on an SE2 pose graph
with false loop closures, in plain PyTorch.

It takes the graph's structure as ``gen/se2_corridor_outliers.py`` made
it (numpy arrays, the outlier mask, ``robust`` "gnc-gm" and
``robust_delta``) and a guess. Residuals, their Jacobians, the gauge prior,
the retraction and the solves are ``gauss_newton.py``'s; on top of them:

- the cost of an edge with squared Mahalanobis error c^2 is, for a loop
  closure (|to - from| != 1), rho_mu(c^2) = s c^2 / (s + c^2), s = mu
  delta^2, and for odometry c^2; a closure's IRLS weight is
  (s / (c^2 + s))^2, odometry's 1;
- mu0 = 2 max c^2 / delta^2 over every edge at the guess, clamped to [1,
  1e3]; at iteration it (from 0) mu = mu0^max(0, 1 - it / k), k =
  round(0.6 iterations) (12 of 20): mu reaches 1 at 60% of the budget;
- iteration it solves (H + lambda I) dx = -b, H and b weighted at mu(it)
  with the gauge prior, by gauss_newton.py's Jacobi-scaled dense solve;
  lambda starts at 0.01; the step is accepted when rho_mu(trial) <=
  rho_mu(current) summed over the edges at the same mu (a trial whose
  cost is not finite is rejected), then lambda halves, else it doubles and
  the poses stay;
- the trace holds the plain chi^2 (every edge, outliers too) of the guess
  and then of each trial, accepted or not.

``chi2(poses)`` is the chi^2 of the inlier edges alone (odometry and the
true closures, from the generator's mask): 0 at the ground truth, since
the inliers' measurements are exact, so it judges whether the outliers
were rejected.

Departures from Yang et al., "Graduated Non-Convexity for Robust Spatial
Perception" (RA-L 2020): the paper solves each weighted problem to
convergence and then divides mu by 1.4; here one damped step is taken per
mu, and mu follows the schedule above (the program's); the paper's mu0
is not capped; the weights apply to the loop closures alone (odometry is
trusted); the accept test on the surrogate is LM's, as GTSAM's
GncOptimizer runs LM within each mu, not the paper's.

``precision`` as in ``gauss_newton.py``: "f64" is the reference; "tf32"
and "tf32-cholesky" compute in float32 with TF32 products in the
factorization, the controls.

This module imports nothing of the program.
"""

from __future__ import annotations

import torch

from perfbench.reference import gauss_newton as gn

LAMBDA0 = 0.01
MU0_CAP = 1e3


def gnc_iterations(iterations):
    """The iteration at which mu reaches 1: 60% of the budget."""
    return max(1, int(round(0.6 * iterations)))


class Problem(gn.Problem):
    """One robust SE2 graph structure on a device, in one precision."""

    def __init__(self, struct, device, precision="f64"):
        if struct.get("robust") != "gnc-gm":
            raise ValueError("gnc_lm takes a structure with robust 'gnc-gm'")
        super().__init__(struct, device, precision)
        if self.se3:
            raise ValueError("gnc_lm takes SE2 graphs")
        self.delta = float(struct["robust_delta"])
        self.closure = (self.to - self.fr).abs() != 1
        self.inlier = ~torch.as_tensor(struct["outlier"], device=device)

    def edge_chi2(self, poses):
        """e^T W e of every edge, (E,)."""
        e = self._residual(poses[self.fr], poses[self.to], self.z)[..., None]
        return (e.mT @ (self.omega @ e))[:, 0, 0]

    def chi2(self, poses):
        """chi^2 of the inlier edges at poses (nodes, 3)."""
        poses = torch.as_tensor(poses, device=self.device).to(self.dtype)
        return float(self.edge_chi2(poses)[self.inlier].sum())

    def cost(self, c2, mu):
        """sum of rho_mu over the edges, odometry quadratic."""
        s = mu * self.delta ** 2
        return float(torch.where(self.closure, s * c2 / (s + c2), c2).sum())

    def weights(self, c2, mu):
        s = mu * self.delta ** 2
        return torch.where(self.closure, (s / (c2 + s)) ** 2,
                           torch.ones_like(c2))

    def damped_step(self, poses, mu, lam):
        """The damped step dx of (H + lam I) dx = -b at mu."""
        x1, x2 = poses[self.fr], poses[self.to]
        zero = poses.new_zeros(self.dim)
        ja, jb = (j.to(self.dtype) for j in
                  self._jac(zero, zero, x1, x2, self.z))
        e = self._residual(x1, x2, self.z)[..., None]
        om_e = self.omega @ e
        w = self.weights((e.mT @ om_e)[:, 0, 0], mu)[:, None, None]
        om_a, om_b = self.omega @ ja, self.omega @ jb
        blocks = (ja.mT @ om_a, ja.mT @ om_b, jb.mT @ om_a, jb.mT @ om_b)
        h = poses.new_zeros(self.n, self.n)
        for r, c, blk in zip(self._rows, self._cols, blocks):
            h.index_put_((r.reshape(-1), c.reshape(-1)),
                         (w * blk).reshape(-1), accumulate=True)
        h[self.prior_dofs, self.prior_dofs] += gn.PRIOR_WEIGHT
        h.diagonal().add_(lam)
        b = poses.new_zeros(self.n)
        b.index_add_(0, self._oi.reshape(-1), (w * (ja.mT @ om_e)).reshape(-1))
        b.index_add_(0, self._oj.reshape(-1), (w * (jb.mT @ om_e)).reshape(-1))
        s = torch.rsqrt(torch.diagonal(h))
        a, rhs = h * s[:, None] * s[None, :], -b * s
        solve = {"f64": torch.linalg.solve, "tf32": gn._lu_solve_tf32,
                 "tf32-cholesky": gn._cholesky_solve_tf32}[self.precision]
        return (solve(a, rhs) * s).reshape(self.n_nodes, self.dim)

    def solve(self, guess, iterations):
        """(final poses, plain chi^2 trace of iterations + 1 entries) from
        a guess (nodes, 3), in this problem's precision."""
        poses = torch.as_tensor(guess, device=self.device).to(self.dtype)
        c2 = self.edge_chi2(poses)
        trace = [float(c2.sum())]
        mu0 = min(max(2.0 * float(c2.max()) / self.delta ** 2, 1.0), MU0_CAP)
        k = gnc_iterations(iterations)
        lam = LAMBDA0
        for it in range(iterations):
            mu = mu0 ** max(0.0, 1.0 - it / k)
            trial = self.retract(poses, self.damped_step(poses, mu, lam))
            c2_trial = self.edge_chi2(trial)
            trace.append(float(c2_trial.sum()))
            if self.cost(c2_trial, mu) <= self.cost(c2, mu):
                poses, c2, lam = trial, c2_trial, lam / 2.0
            else:
                lam *= 2.0
        return poses, trace
