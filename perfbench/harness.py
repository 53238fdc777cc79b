"""The benchmark of the port: one cell, one seed, one run.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration (its generator in
  ``gen/<generator>.py``, its reference in ``reference/<reference>.py``,
  its fixed work counts);
- ``traffic/<traffic>.json``: the traffic mix, read by the one closed loop
  below: the loop (``fleet``: B graphs a request, one
  ``make_optimize_batch`` call; absent: one graph, ``make_optimize``) and
  the optimizer's keyword arguments (``options``);
- ``workloads/<cell>.json``: the cell's configuration, traffic, the limits
  of its correctness check, and why it exists;
- ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader a metric, a
  function ``read``.

``BENCHMARK.json`` alone says which metrics a cell reports, and each
metric's unit: an end-to-end metric in the cells its ``workloads`` lists,
or in every cell without that key; a per-layer metric in the cells its
``workloads`` lists, or without that key in every cell that reports the
end-to-end metric it ``moves``.

A run: set-up (the graph structure, the pool of guesses drawn from the
seed on the device, stacked into fleets of B in pool order for a fleet
cell, the optimizer built once, the warm requests), then the window (a
closed loop with one client: each request is ``run(graph)`` on one guess
or one fleet, ended by a synchronize, the next sent when it returns,
cycling through the pool),
then, with ``trace``, the profiler over a fixed slice of the window's
requests, and after the window the correctness check against the plain
reference on a sample of the requests drawn from the seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time

import numpy as np

from perfbench import check, trace as tracing

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "rustrobotics_tpu")
# the port's layers as the optimizer loop calls them (mapping.pgo's
# names), spanned in a traced run; the solve is what _make_solve returns
LAYER_FUNCTIONS = ("system_values", "apply_update", "global_error")
LAYER_MAKERS = ("_make_solve",)


def banned_modules(modules=None):
    """The loaded modules whose top-level name is banned, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in BANNED})


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_spec():
    return load_json(ROOT / "BENCHMARK.json")


def load_config(name):
    return load_json(PKG / "configs" / f"{name}.json")


def generator(config):
    return importlib.import_module(f"perfbench.gen.{config['generator']}")


def reference(config):
    return importlib.import_module(
        f"perfbench.reference.{config['reference']}")


def reader(kind, name):
    """The module of ``<kind>/<name>.py``. A metric's name may hold dots
    (``mfu.train``), which an import by name cannot take."""
    path = PKG / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plan(cell, spec=None):
    """Everything a run of ``cell`` needs, resolved by name: its file in
    ``workloads/``, the configuration and traffic that file names, and the
    entries of the metrics ``BENCHMARK.json`` gives the cell."""
    spec = load_spec() if spec is None else spec
    workload = load_json(PKG / "workloads" / f"{cell}.json")
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return dict(cell=cell, workload=workload,
                config=load_config(workload["config"]),
                traffic=load_json(PKG / "traffic" /
                                  f"{workload['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer)


@dataclasses.dataclass
class Request:
    start: float
    end: float
    iterations: int
    poses: object   # the answer: final poses (device tensor)
    trace: object   # and chi^2 trace


@dataclasses.dataclass
class Window:
    """What the e2e readers take."""

    requests: list
    start: float
    end: float
    setup_s: float


def nearest_rank(values, q):
    """The q-quantile of values by nearest rank (q in (0, 1])."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _optimizer(p, template, device):
    """``make_optimize_batch`` for a fleet cell, ``make_optimize``
    otherwise, with the traffic's ``options`` as keyword arguments."""
    from rustrobotics_tpu_torch.mapping import pgo

    t = p["traffic"]
    make = pgo.make_optimize_batch if "fleet" in t else pgo.make_optimize
    return make(
        template, num_iterations=t["num_iterations"], solver=t["solver"],
        backend=t["backend"], tolerance=t["tolerance"], device=device,
        **t.get("options", {}))


def rows(traffic, i):
    """The pool indices of request i's graphs, in row order: guess
    i mod pool, or row b of fleet f = i mod (pool / B) is guess f·B + b."""
    b = traffic.get("fleet", 1)
    f = i % (traffic["pool"] // b)
    return list(range(f * b, (f + 1) * b))


def request_graphs(template, struct, pool, traffic):
    """The graphs the requests cycle through: one a guess of ``pool``, or
    for a fleet cell its pool / B fleets (``pgo.stack_graphs``)."""
    field = struct["node_field"]
    graphs = [template.replace(**{field: guess}) for guess in pool]
    if "fleet" not in traffic:
        return graphs
    from rustrobotics_tpu_torch.mapping import pgo

    b = traffic["fleet"]
    if b < 1 or len(pool) % b:
        raise ValueError(f"a pool of {len(pool)} does not split into "
                         f"fleets of {b}")
    return [pgo.stack_graphs(graphs[f:f + b])
            for f in range(0, len(pool), b)]


def setup(p, seed, device):
    """The structure, the pool of guesses, the optimizer and the warm
    requests. Returns (optimizer, graphs, pool, structure)."""
    import torch

    from rustrobotics_tpu_torch.mapping.g2o import graph_from_numpy

    cfg, t = p["config"], p["traffic"]
    dtype = getattr(torch, t["dtype"])
    gen = generator(cfg)
    struct = gen.structure(cfg)
    template = graph_from_numpy(struct["fields"], struct["total_dof"],
                                struct["prior2"], struct["prior3"],
                                device=device, dtype=dtype)
    pool = gen.guesses(cfg, struct, seed, t["pool"], device).to(dtype)
    graphs = request_graphs(template, struct, pool, t)
    run = _optimizer(p, template, device)
    for i in range(t["warm_requests"]):
        run(graphs[i % len(graphs)])
    _sync(device)
    return run, graphs, pool, struct


def _request(run, graph, device):
    """One request; its iterations are graph-iterations, summed over a
    fleet's rows."""
    start = time.perf_counter()
    g, errors, it = run(graph)
    _sync(device)
    end = time.perf_counter()
    poses = g.poses3 if g.is_3d else g.poses2
    iterations = it if isinstance(it, int) else sum(it.tolist())
    return Request(start, end, iterations, poses, errors)


def window(run, graphs, seconds, device, traffic, traced):
    """The closed loop: requests back to back until ``seconds`` have
    passed; the window ends when the last request sent in it returns.
    With ``traced``, requests trace_first .. trace_first + trace_requests
    run under the profiler inside one ``SLICE`` span. Returns (requests,
    start, end, profiler or None, traced request range)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    requests, prof, sliced = [], None, None
    first = traffic["trace_first"]
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline or (traced and sliced is None):
        i = len(requests)
        if traced and i == first:
            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                with record_function(tracing.SLICE):
                    for k in range(traffic["trace_requests"]):
                        requests.append(_request(
                            run, graphs[(i + k) % len(graphs)], device))
            sliced = (i, len(requests))
        else:
            requests.append(_request(run, graphs[i % len(graphs)], device))
    return requests, t0, requests[-1].end, prof, sliced


def row_answers(traffic, request):
    """A request's answer on the host, one (final poses, chi^2 trace) a
    row."""
    poses = request.poses.double().cpu().numpy()
    trace = request.trace.double().cpu().numpy()
    if "fleet" not in traffic:
        return [(poses, trace)]
    return list(zip(poses, trace))


def sample_answers(p, requests, pool, seed):
    """(failed, answers, guesses): the requests with a chi^2 trace that is
    not finite in any row; the answers of a sample of the requests drawn
    from the seed, one a row of each (pool index, final poses, trace) on
    the host; the sampled guesses on the host."""
    import torch

    t = p["traffic"]
    finite = torch.stack([r.trace for r in requests]).isfinite()
    failed = int((~finite.flatten(1).all(-1)).sum())
    k = min(t["check_requests"], len(requests))
    rng = np.random.default_rng(seed)
    sample = sorted(rng.choice(len(requests), size=k, replace=False))
    answers = [(j, *a) for i in sample
               for j, a in zip(rows(t, i), row_answers(t, requests[i]))]
    guesses = {j: pool[j].double().cpu() for j, _, _ in answers}
    return failed, answers, guesses


def compare_answers(p, struct, answers, guesses, device):
    """Run the reference once on each sampled guess; the worst of each
    number over the sample's answers."""
    ref = reference(p["config"]).Problem(struct, device, "f64")
    iters = p["traffic"]["num_iterations"]
    solved = {}
    readings = []
    for j, poses, trace in answers:
        if j not in solved:
            rp, rt = ref.solve(guesses[j], iters)
            solved[j] = (rp.cpu().numpy(), rt)
        readings.append(check.gaps(poses, trace, *solved[j],
                                   ref.chi2(poses)))
    return check.worst(readings)


def _layer_spans(traced):
    """In a traced run, the harness's spans around the calls into the
    port's layers (a name the port lacks is skipped)."""
    if not traced:
        return contextlib.nullcontext()
    from rustrobotics_tpu_torch.mapping import pgo

    return tracing.layer_spans(pgo, LAYER_FUNCTIONS, LAYER_MAKERS)


def run_cell(p, seed, seconds, traced, device, t_start=None, log=None):
    """One run of the cell ``p`` (from ``plan``). Returns the result
    object of the last line; ``log`` (a function of a string) gets the
    earlier lines."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    with _layer_spans(traced):
        run, graphs, pool, struct = setup(p, seed, device)
        setup_s = time.perf_counter() - t_start
        requests, t0, t1, prof, sliced = window(run, graphs, seconds, device,
                                                p["traffic"], traced)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = banned_modules()
    if found:
        raise SystemExit(f"perfbench: banned modules loaded: {found}")
    failed, answers, guesses = sample_answers(p, requests, pool, seed)
    times_ms = [1e3 * (r.end - r.start) for r in requests]
    log(f"[window] {len(requests)} requests in {t1 - t0:.6f} s, p50 "
        f"{nearest_rank(times_ms, 0.5):.4f} ms, p95 "
        f"{nearest_rank(times_ms, 0.95):.4f} ms over {len(times_ms)} "
        f"samples; set-up {setup_s:.4f} s")
    win = Window([dataclasses.replace(r, poses=None, trace=None)
                  for r in requests], t0, t1, setup_s)
    slice_ = None
    if traced:
        slice_ = tracing.reduce(*tracing.from_profiler(prof))
        slice_.iterations = sum(r.iterations
                                for r in requests[sliced[0]:sliced[1]])
        log(f"[trace] slice of requests {sliced[0]}..{sliced[1] - 1}: "
            f"{slice_.window_s:.6f} s, device busy {slice_.busy_s:.6f} s, "
            f"{slice_.launches} launch calls, {slice_.iterations} "
            f"iterations")
    del run, graphs, requests, prof
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare_answers(p, struct, answers, guesses, device)
    ok, checks = check.judge(numbers, p["workload"]["limits"])
    log("[compare] " + ", ".join(f"{n} {v!r}" for n, v in numbers.items()))
    metrics = {}
    for m in p["per_layer"] if traced else p["end_to_end"]:
        mod = reader("metrics" if traced else "e2e", m["name"])
        value = mod.read(slice_, p["config"]) if traced else mod.read(win)
        if value is None:
            raise SystemExit(f"perfbench: metric {m['name']!r} found "
                             f"nothing to read in cell {p['cell']!r}")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(ok and failed == 0),
        "attempted": len(win.requests),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if traced:
        result["device"]["busy_s"] = slice_.busy_s
        result["device"]["window_s"] = slice_.window_s
        result["breakdown"] = {
            "device_ops": tracing.top(slice_.device_s),
            "idle_gaps": tracing.top(slice_.idle_by_host)}
    result["checks"] = {"failed_requests": {"value": failed, "limit": 0},
                        **checks}
    return result
