"""Sharded particle filter: a particle cloud partitioned across the ranks
of a mesh (counterpart of ``rustrobotics_tpu/parallel/pf_sharded.py``).

Each rank holds its contiguous shard of the cloud, in and out.
Propagation and weighting are local; the weights are stabilized by a
global max (``all_reduce(MAX)``, JAX's ``pmax``), and systematic
resampling runs on one global draw grid: rank r owns draws
[r N / D, (r + 1) N / D). ``make_sharded_pf_step`` gathers the
propagated cloud and weights (``all_gather``) and searches the global
cumulative weights; ``make_sharded_pf_step_bounded`` circulates cloud
chunks around the ring (``batch_isend_irecv``, JAX's ``ppermute``) only
until every rank has claimed its draws, and returns the ring rounds.

Randomness: a step takes two ``torch.Generator``s, the rank's own for the
process noise and one seeded alike on every rank for the grid's shared
offset u0. ``step._step(noise, u0, ...)`` takes the draws instead, in
JAX's shapes: the rank's standard normals (N / D, S) (JAX draws them
from ``fold_in(key, rank)``) and the 0-d uniform u0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_gather(t, size, group):
    """(size, *t.shape): every rank's t, in rank order."""
    out = t.new_empty(size * t.numel())
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, t.reshape(-1).contiguous(), group=group)
    return out.view((size,) + tuple(t.shape))


def _all_reduce(t, op, group):
    dist.all_reduce(t, op=op, group=group)
    return t


class _ShardedStep:
    """A sharded PF step: ``step(noise_generator, u0_generator, particles,
    u, z, dt)``, and ``step._step(noise, u0, particles, u, z, dt)`` on
    given draws."""

    def __init__(self, mesh, pf, num_particles: int, body):
        self.rank = mesh.get_local_rank(0)
        self.size = mesh.size(0)
        self.group = mesh.get_group(0)
        if num_particles % self.size:
            raise ValueError(
                "num_particles must divide evenly across the mesh")
        self.pf = pf
        self.num_particles = num_particles
        self.n_local = num_particles // self.size
        self._body = body

    def __call__(self, noise_generator, u0_generator, particles, u, z, dt):
        noise = torch.randn(particles.shape, generator=noise_generator,
                            dtype=particles.dtype, device=particles.device)
        u0 = torch.rand((), generator=u0_generator, dtype=particles.dtype,
                        device=particles.device)
        return self._step(noise, u0, particles, u, z, dt)

    def _step(self, noise, u0, particles, u, z, dt):
        if particles.shape[0] != self.n_local:
            raise ValueError(f"a rank holds {self.n_local} particles, got "
                             f"{particles.shape[0]}")
        # local propagate + additive noise, local log-weights
        pred, logw = self.pf._propagate_weigh(particles, u, z, dt, noise)
        gmax = _all_reduce(torch.max(logw), dist.ReduceOp.MAX, self.group)
        w = torch.exp(logw - gmax)
        # this rank's draws on the global systematic grid (sorted)
        gidx = self.rank * self.n_local + torch.arange(
            self.n_local, dtype=w.dtype, device=w.device)
        return self._body(self, pred, w, u0, gidx)


def _gather_body(step, pred, w, u0, gidx):
    sums = _all_gather(torch.sum(w), step.size, step.group)  # (D,)
    total = torch.sum(sums)
    draws = (gidx + u0) / step.num_particles * total
    # global inverse CDF over the gathered cloud
    cloud = _all_gather(pred, step.size, step.group).reshape(
        step.num_particles, -1)
    wall = _all_gather(w, step.size, step.group).reshape(step.num_particles)
    cum = torch.cumsum(wall, 0)
    idx = torch.clamp(torch.searchsorted(cum, draws, side="left"),
                      0, step.num_particles - 1)
    return cloud[idx]


def make_sharded_pf_step(mesh, pf, num_particles: int):
    """A sharded SIR step with systematic resampling over the gathered
    cloud for a ``localization.pf.ParticleFilter`` ``pf``; each rank passes
    and gets back its (num_particles / D, S) shard."""
    return _ShardedStep(mesh, pf, num_particles, _gather_body)


def sharded_pf_step(mesh, pf, noise_generator, u0_generator, particles, u,
                    z, dt):
    """One-off convenience wrapper; ``particles`` is this rank's shard."""
    step = make_sharded_pf_step(mesh, pf,
                                particles.shape[0] * mesh.size(0))
    return step(noise_generator, u0_generator, particles, u, z, dt)


def _ring(tensors, step, forward: bool):
    """Each rank sends ``tensors`` to its next rank (forward) or previous
    one, and returns what it receives from the other side."""
    if step.size == 1:
        return tensors
    me = step.rank
    to = (me + (1 if forward else -1)) % step.size
    frm = (me - (1 if forward else -1)) % step.size
    to_g = dist.get_global_rank(step.group, to)
    frm_g = dist.get_global_rank(step.group, frm)
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, recv):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), to_g, step.group))
        ops.append(dist.P2POp(dist.irecv, r, frm_g, step.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _bounded_body(step, pred, w, u0, gidx):
    n_dev, my = step.size, step.rank
    # a fully depleted cloud degrades to uniform, not NaN
    total_raw = _all_reduce(torch.sum(w), dist.ReduceOp.SUM, step.group)
    w = torch.where(total_raw > 0, w, torch.ones_like(w))
    # global prefix offsets of every shard's weight mass: all chunk
    # boundaries come from one cumsum, so the intervals (csum[d-1],
    # csum[d]] tile [0, total] exactly
    csum = torch.cumsum(_all_gather(torch.sum(w), n_dev, step.group), 0)
    total = csum[-1]
    draws = (gidx + u0) / step.num_particles * total

    def claim(out, filled, cloud, wvis, owner):
        lo = csum[owner - 1] if owner > 0 else torch.zeros_like(total)
        cum = lo + torch.cumsum(wvis, 0)
        hi = csum[owner]
        # draw v is sourced from the visiting chunk iff v in (lo, hi]
        in_range = (draws > lo) & (draws <= hi)
        idx = torch.clamp(torch.searchsorted(cum, draws, side="left"),
                          0, step.n_local - 1)
        newly = in_range & ~filled
        return (torch.where(newly[:, None], cloud[idx], out),
                filled | in_range)

    # claim from the own chunk first: with balanced weights most draws
    # resolve locally and the loop ends after 0-1 ring hops
    out, filled = claim(torch.zeros_like(pred),
                        torch.zeros(step.n_local, dtype=torch.bool,
                                    device=pred.device), pred, w, my)
    fwd, of, bwd, ob = (pred, w), my, (pred, w), my
    rounds = 0
    while rounds < (n_dev + 1) // 2:
        unfilled = _all_reduce(torch.sum(~filled), dist.ReduceOp.SUM,
                               step.group)
        if int(unfilled) == 0:
            break
        # counter-rotating buffers: round r covers owners my - r and
        # my + r, so boundary draws on either side resolve in one hop
        fwd = _ring(fwd, step, forward=True)
        of = (of - 1) % n_dev
        out, filled = claim(out, filled, *fwd, of)
        bwd = _ring(bwd, step, forward=False)
        ob = (ob + 1) % n_dev
        out, filled = claim(out, filled, *bwd, ob)
        rounds += 1
    return out, rounds


def make_sharded_pf_step_bounded(mesh, pf, num_particles: int):
    """Bounded-exchange sharded step: systematic resampling WITHOUT
    gathering the cloud. The sources of a rank's (sorted) draws form a
    contiguous chunk of the global cloud, near its own shard when the
    weights are balanced, so cloud chunks circulate around the ring only
    until every rank has claimed all its draws (an all-reduced count of
    unfilled draws, read on the host each round). Degenerate weights take
    more rounds; correctness never depends on balance.

    Returns a step giving (particles', rounds), ``rounds`` the ring hops
    executed (the same on every rank; each hop moves two local chunks)."""
    return _ShardedStep(mesh, pf, num_particles, _bounded_body)
