"""The traced slice put down to the program's own spans: device time,
launches and device-idle time by layer, and a command that reads them in
one cell.

    python3 -m perfbench.spans --workload intel-solve --seed <n> \
        [--seconds 3]

From the root of a checkout, on the CUDA card; the last line of standard
output is a JSON object: the 18 readings (``METRICS``), ``outside``, the
identities below and the existing per-layer readings of the same slice.

The port names the stages of its optimizer step with profiler ranges
``rrt.<name>`` (``rustrobotics_tpu_torch.utils.metrics.span``) while a
profiler records. A layer is the innermost of them open:

    request     rrt.request          one run(graph)
    linearize   rrt.linearize        assemble.system_values
    assemble    rrt.band.assemble    band_chol.solve_banded: block rows
                                     (K4), padding, Jacobi scaling, the
                                     mirror
    factorize   rrt.band.factorize   the factorization (K1's host loop)
    substitute  rrt.band.substitute  the right-hand side scaled in, the
                                     substitution (K2), unscaling
    update      rrt.update           apply_update, global_error,
                                     robust_global_cost
    outside     no rrt. span open

``by_span`` takes the tuples of ``trace.from_profiler`` and ``links``, the
runtime call that launched each device event (``launch_links``: the
correlation id a kernel, copy or fill shares with its launch call):

- device seconds: each device event clipped to the slice goes to the
  layer open when its launch call started; an event without a launch call
  is ``unlinked``;
- launches: each launch runtime call (``trace.LAUNCH_CALLS``, and a CUDA
  graph's ``cudaGraphLaunch`` as one) that starts in the slice goes to
  the layer open at its start;
- idle seconds: each idle interval of the slice is split by its overlap
  with the layers open on the host.

So the layers' device seconds and ``unlinked`` add up to the slice's
device time, their launches to every launch call in it, and their idle
seconds to the window less the busy time. A layer's numbers follow its
span whatever kernels implement it.

The prefix is copied here, not imported: the benchmark runs against a
program without spans too, whose slice then holds no ``rrt.request``.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import math
import os
import sys

from perfbench import trace

SPAN_PREFIX = "rrt."
SPANS = {"rrt.request": "request", "rrt.linearize": "linearize",
         "rrt.band.assemble": "assemble", "rrt.band.factorize": "factorize",
         "rrt.band.substitute": "substitute", "rrt.update": "update"}
LAYERS = tuple(SPANS.values())
OUTSIDE = "outside"
REQUEST = "rrt.request"
GRAPH_LAUNCH = "cudaGraphLaunch"
LAUNCHES = trace.LAUNCH_CALLS | {GRAPH_LAUNCH}
# metric family: (the BySpan field it reads, its scale to the unit)
FAMILIES = {"device_ms": ("device_s", 1e3), "launches": ("launches", 1),
            "idle_ms": ("idle_s", 1e3)}
METRICS = tuple(f"{f}.{layer}" for f in FAMILIES for layer in LAYERS)


@dataclasses.dataclass
class BySpan:
    """The slice by layer (``LAYERS`` and ``OUTSIDE``); seconds."""

    device_s: dict
    launches: dict
    idle_s: dict
    unlinked_s: float   # device time with no launch call on the trace
    requests: int       # rrt.request spans that overlap the slice


def _timeline(host):
    """The host's time cut into pieces by the innermost span of ``SPANS``
    open: (starts, layers), piece k from starts[k] to starts[k + 1] (the
    last one open-ended), the first piece ``OUTSIDE`` from -inf. ``host``
    is one thread's events, properly nested."""
    spans = sorted(((s, e, SPANS[n]) for n, s, e in host if n in SPANS),
                   key=lambda r: (r[0], -r[1]))
    starts, layers, stack = [-math.inf], [OUTSIDE], []

    def piece(t, layer):
        if starts[-1] == t:
            layers[-1] = layer
        else:
            starts.append(t)
            layers.append(layer)

    def close(until):
        while stack and stack[-1][0] <= until:
            end = stack.pop()[0]
            piece(end, stack[-1][1] if stack else OUTSIDE)

    for s, e, layer in spans:
        close(s)
        stack.append((e, layer))
        piece(s, layer)
    close(math.inf)
    return starts, layers


def by_span(device, host, links, us=1e-6):
    """``device`` and ``host`` as ``trace.reduce`` takes them (the
    ``trace.SLICE`` span among ``host``), ``links`` {device tuple: host
    tuple of its launch call}; times in units of ``us`` seconds."""
    spans = [(s, e) for n, s, e in host if n == trace.SLICE]
    if len(spans) != 1:
        raise ValueError(f"expected one {trace.SLICE!r} span, found "
                         f"{len(spans)}")
    ws, we = spans[0]
    starts, layers = _timeline(host)

    def layer_at(t):
        return layers[bisect.bisect_right(starts, t) - 1]

    names = LAYERS + (OUTSIDE,)
    dev, launches, idle = (dict.fromkeys(names, 0.0),
                           dict.fromkeys(names, 0), dict.fromkeys(names, 0.0))
    unlinked = 0.0
    clipped = []
    for rec in device:
        if not (rec[2] > ws and rec[1] < we):
            continue
        s, e = max(rec[1], ws), min(rec[2], we)
        clipped.append((s, e))
        call = links.get(rec)
        if call is None:
            unlinked += (e - s) * us
        else:
            dev[layer_at(call[1])] += (e - s) * us
    for n, s, _ in host:
        if n in LAUNCHES and ws <= s < we:
            launches[layer_at(s)] += 1
    _, merged = trace.union(clipped)
    edges = [ws] + [x for m in merged for x in m] + [we]
    for a, b in zip(edges[::2], edges[1::2]):
        k = bisect.bisect_right(starts, a) - 1
        while k < len(starts) and starts[k] < b:
            end = starts[k + 1] if k + 1 < len(starts) else math.inf
            lo, hi = max(a, starts[k]), min(b, end)
            if hi > lo:
                idle[layers[k]] += (hi - lo) * us
            k += 1
    requests = sum(1 for n, s, e in host
                   if n == REQUEST and e > ws and s < we)
    return BySpan(device_s=dev, launches=launches, idle_s=idle,
                  unlinked_s=unlinked, requests=requests)


def launch_links(prof):
    """{device tuple: host tuple of its launch call}, both (name, start,
    end) in µs as ``trace.from_profiler`` gives them, for a finished
    ``torch.profiler.profile``: a kernel, copy or fill carries the
    correlation id of the runtime call (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ``cudaGraphLaunch``, ...) that launched it. The
    device copies of the host's annotations launch nothing."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    calls, device = {}, []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.id, rec))
        elif e.name.startswith("cu"):
            calls[e.id] = rec
    return {rec: calls[i] for i, rec in device if i in calls}


def reading(sp, name, iterations):
    """The metric ``name`` (``<family>.<layer>`` of ``METRICS``, or of
    the layer ``outside``) an iteration of the slice: 0.0 for a layer
    that saw nothing; None when the slice holds no ``rrt.request`` span,
    as a program that lost its spans gives, or completed no iteration."""
    family, layer = name.split(".", 1)
    if sp is None or sp.requests == 0 or iterations == 0:
        return None
    field, scale = FAMILIES[family]
    return scale * getattr(sp, field)[layer] / iterations


def measure(p, seed, seconds, device):
    """A traced slice of the cell ``p`` (``harness.plan``) run as the
    harness runs one, its own layer spans included. Returns (the
    ``trace.Slice`` with its iterations, ``by_span``'s result)."""
    from perfbench import harness

    with harness._layer_spans(True):
        run, graphs, _, _ = harness.setup(p, seed, device)
        requests, _, _, prof, sliced = harness.window(
            run, graphs, seconds, device, p["traffic"], True)
    device_ev, host = trace.from_profiler(prof)
    s = trace.reduce(device_ev, host)
    s.iterations = sum(r.iterations for r in requests[sliced[0]:sliced[1]])
    return s, by_span(device_ev, host, launch_links(prof))


def summary(s, sp, p):
    """The 18 readings, ``outside``, the identities against the slice and
    the existing per-layer readings of the same slice, as one dict."""
    from perfbench import harness, kernels

    it = s.iterations
    total = sum(s.device_s.values())
    k1, _ = s.kernel_s(kernels.FACTOR)
    out = {
        "metrics": {m: reading(sp, m, it) for m in METRICS},
        "outside": {f: reading(sp, f"{f}.{OUTSIDE}", it) for f in FAMILIES},
        "iterations": it,
        "requests": sp.requests,
        "unlinked_share": sp.unlinked_s / total if total else None,
        "launches_sum": sum(sp.launches.values()),
        "launches_slice": s.launches,
        "device_ms_sum": 1e3 * (sum(sp.device_s.values()) + sp.unlinked_s),
        "device_ms_slice": 1e3 * total,
        "idle_ms_sum": 1e3 * sum(sp.idle_s.values()),
        "idle_ms_slice": 1e3 * (s.window_s - s.busy_s),
        "k1_by_name_ms": 1e3 * k1 / it if it else None,
        # device copies of the spans, which the slice's device time must
        # not hold
        "span_device_events": sorted(n for n in s.device_s
                                     if n.startswith(SPAN_PREFIX)),
        "window_s": s.window_s,
        "busy_s": s.busy_s,
    }
    out["existing"] = {m["name"]: harness.reader("metrics", m["name"]).read(
        s, p["config"]) for m in p["per_layer"]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from perfbench import harness, run

    for var, sub in run.CACHE_ENV.items():
        os.environ[var] = str(run.CACHE / sub)
    for var in run.THREAD_ENV:
        os.environ[var] = "1"
    import torch

    if not torch.cuda.is_available():
        print("perfbench.spans: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    p = harness.plan(args.workload)
    s, sp = measure(p, args.seed, args.seconds, torch.device("cuda", 0))
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": run._power_limit(), **summary(s, sp, p)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
