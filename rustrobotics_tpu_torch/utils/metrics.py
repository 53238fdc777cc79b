"""Observability: per-phase timing, per-iteration optimizer metrics, the
optimizer's spans and a profiler trace (counterpart of
``rustrobotics_tpu/utils/metrics.py``).

``PhaseTimer`` waits for the device of its ``block_on`` tensors before it
stops the clock, so a phase's time is the device's, not the enqueue's.
``span`` names a stage of the optimizer step (``SPAN_PREFIX`` + name) on
the profiler's timeline while a profiler records, and costs one flag test
otherwise. ``xla_trace`` keeps the JAX name for its counterpart: a
``torch.profiler`` context (CPU and, where there is one, CUDA activity)
that writes a Chrome/TensorBoard trace, spans included, into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from collections import defaultdict

import torch

from rustrobotics_tpu_torch.utils.tree import leaves


def _synchronize(tree):
    devices = {leaf.device for leaf in leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates wall time per named phase; waits on its outputs."""

    totals: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    counts: dict = dataclasses.field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }


SPAN_PREFIX = "rrt."
# the one context every span returns while no profiler records
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``SPAN_PREFIX + name`` while a
    ``torch.profiler`` (or ``torch.autograd.profiler``) session records,
    else a shared null context: no range is created and nothing is
    recorded. The profiler is the only switch. Device work launched inside
    the range is linked to it on the trace through its launch call.

    The optimizer step's spans, innermost first where they nest:
    ``linearize`` (``assemble.system_values``), ``band.assemble``,
    ``band.factorize`` and ``band.substitute`` (``band_chol.solve_banded``),
    ``update`` (``assemble.apply_update``, ``pgo.global_error``,
    ``pgo.robust_global_cost``), ``lm.accept`` (LM's accept test in
    ``make_optimize`` and ``make_optimize_batch``: the trial's and the
    current graph's costs, the select and λ; ``update`` nests in it off the
    cost kernel's path), all inside ``request`` (one ``run(graph)`` of
    ``make_optimize`` or ``make_optimize_batch``, or one ``optimize``
    call)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """The operator's way to record the optimizer's spans: ``with
    xla_trace(log_dir): run(graph)`` profiles the block and writes a
    Chrome/TensorBoard trace into ``log_dir`` (open with TensorBoard or
    chrome://tracing) in which every ``span`` entered (``rrt.request``,
    ``rrt.linearize``, ``rrt.band.*``, ``rrt.update``) is a range, and each
    kernel is linked to its launch call inside one. Yields the profiler,
    whose ``key_averages()`` sums time by operation and span."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


@dataclasses.dataclass
class OptimizerMetrics:
    """Structured per-iteration PGO metrics (the reference's log lines as
    data); ``callback`` is ``mapping.pgo.optimize``'s."""

    chi2: list = dataclasses.field(default_factory=list)
    norm_dx: list = dataclasses.field(default_factory=list)
    lam: list = dataclasses.field(default_factory=list)

    def callback(self, it, graph, error, norm_dx, lam):
        del it, graph
        self.chi2.append(float(error))
        self.norm_dx.append(float(norm_dx))
        self.lam.append(float(lam))

    def as_dict(self) -> dict:
        return {"chi2": self.chi2, "norm_dx": self.norm_dx, "lam": self.lam}
