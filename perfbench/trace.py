"""Reduction of a profiler trace of the traced slice to the numbers the
per-layer readers take.

The slice is the interval of the harness's ``SLICE`` span. Device events
(kernels, copies, fills) are clipped to it; the device is busy on the
union of their intervals (the arithmetic of the port's smoke run's
``busy_window``), idle elsewhere. Kernel launches are the host's launch
runtime calls inside the slice. Every idle gap is labelled by what the
host was doing at its middle: the innermost harness layer span and the
innermost host operation open then.

``reduce`` takes plain tuples, so the arithmetic is tested on synthetic
events; ``from_profiler`` turns a ``torch.profiler.profile`` into them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

SLICE = "perfbench.slice"
LAYER_PREFIX = "perfbench.layer."
# host events of the profiler itself, never what the program waits on
PROFILER_EVENTS = frozenset({"Activity Buffer Request"})
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"})


@dataclasses.dataclass
class Slice:
    """What the traced slice shows; times in seconds."""

    window_s: float
    busy_s: float
    device_s: dict          # device time by event name, in the window
    launches: int           # launch runtime calls in the window
    idle_by_host: dict      # idle seconds by what the host was doing
    iterations: int = 0     # optimizer iterations the slice completed

    def kernel_s(self, names):
        """Device seconds of the events whose name holds one of ``names``
        as a whole identifier, and whether any matched."""
        pats = [re.compile(rf"(?<![A-Za-z0-9_]){re.escape(n)}"
                           rf"(?![A-Za-z0-9_])") for n in names]
        hits = [t for k, t in self.device_s.items()
                if any(p.search(k) for p in pats)]
        return sum(hits), bool(hits)


def union(intervals):
    """Total length covered by a list of (start, end) intervals, and the
    merged intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _label_gaps(host, gaps):
    """Label each (start, end) gap, in order, by the innermost harness
    span and host operation open at its middle. ``host`` is (start, end,
    name) sorted by start, properly nested as one thread's events are."""
    labels, stack, i = [], [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        spans = [n[len(LAYER_PREFIX):] for _, _, n in stack
                 if n.startswith(LAYER_PREFIX)]
        ops = [n for _, _, n in stack
               if n != SLICE and not n.startswith(LAYER_PREFIX)]
        parts = spans[-1:] + ops[-1:]
        labels.append(" / ".join(parts) or "(no host op)")
    return labels


def reduce(device, host, us=1e-6):
    """``device``: (name, start, end) of every device event; ``host``:
    (name, start, end) of the host events of the thread that ran the
    slice, the ``SLICE`` span among them. Times in units of ``us``
    seconds. Returns a ``Slice`` without its iteration counts."""
    spans = [(s, e) for n, s, e in host if n == SLICE]
    if len(spans) != 1:
        raise ValueError(f"expected one {SLICE!r} span, found {len(spans)}")
    ws, we = spans[0]
    clipped = [(n, max(s, ws), min(e, we)) for n, s, e in device
               if e > ws and s < we]
    busy, merged = union([(s, e) for _, s, e in clipped])
    device_s = {}
    for n, s, e in clipped:
        device_s[n] = device_s.get(n, 0.0) + (e - s) * us
    launches = sum(1 for n, s, _ in host if n in LAUNCH_CALLS and ws <= s < we)
    edges = [ws] + [x for m in merged for x in m] + [we]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    ordered = sorted(((s, e, n) for n, s, e in host),
                     key=lambda r: (r[0], -r[1]))
    idle = {}
    for (a, b), label in zip(gaps, _label_gaps(ordered, gaps)):
        idle[label] = idle.get(label, 0.0) + (b - a) * us
    return Slice(window_s=(we - ws) * us, busy_s=busy * us,
                 device_s=device_s, launches=launches, idle_by_host=idle)


def from_profiler(prof):
    """(device, host) tuples of a finished ``torch.profiler.profile``, in
    µs: ``device`` the device's kernels, copies and fills (not the device
    copies of the host's annotations), ``host`` the events of the thread
    that ran the slice (not the profiler's own)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host_all = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type != cuda:
            if e.name not in PROFILER_EVENTS:
                host_all.append((rec, e.thread))
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name == SLICE or e.name.startswith(LAYER_PREFIX)):
            device.append(rec)
    thread = next(t for (n, _, _), t in host_all if n == SLICE)
    return device, [r for r, t in host_all if t == thread]


def top(d, k=10):
    """The k largest entries of {name: seconds} as [[name, seconds]]."""
    return [[n[:160], v] for n, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]


@contextlib.contextmanager
def layer_spans(module, functions, makers=()):
    """While the block runs, wrap each of ``functions`` of ``module`` that
    exists in a profiler span ``LAYER_PREFIX + name``, and likewise the
    function that each of ``makers`` returns; a maker's span takes its
    name without underscores and ``make``."""
    import torch

    def spanned(fn, label):
        def inner(*a, **kw):
            with torch.profiler.record_function(LAYER_PREFIX + label):
                return fn(*a, **kw)
        return inner

    def maker(fn, label):
        def inner(*a, **kw):
            return spanned(fn(*a, **kw), label)
        return inner

    saved = {name: getattr(module, name)
             for name in (*functions, *makers) if hasattr(module, name)}
    for name, fn in saved.items():
        setattr(module, name, maker(fn, name.strip("_").removeprefix("make_"))
                if name in makers else spanned(fn, name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
