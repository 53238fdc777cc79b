"""Readings that the limits of a cell's correctness check are set from.

    python3 -m perfbench.calibrate --workload <cell> --seeds 12 \
        --control-seeds 3 --first-seed <n> [--out FILE]

In one process on the card: the cell's optimizer is built once; for each
of ``--seeds`` seeds from ``--first-seed`` on, the guess pool of that seed
is drawn and as many requests as a run compares are sent back to back
(the window's own call at its own load: one guess, or one fleet of B, a
request), and every row of their answers is compared with the f64
reference, as a run compares them. Then each of
``--controls``: the reference in that precision
(``reference.<name>.Problem(precision=...)``: ``tf32``, the control, and
``tf32-cholesky``, the program's method in TF32) put in the program's
place on the same guesses of the first ``--control-seeds`` seeds,
compared the same way. A control that gives NaN, or whose factorization
raises, has failed and sets no upper reading. Prints one JSON line a seed
and side (the worst of each number, the seconds of each reference solve,
and each answer's chi^2 trace beside the reference's), and the largest
program reading and smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

from perfbench import check, harness


def control_answer(low, guess, iterations):
    """The answer (final poses, chi^2 trace) of the reference ``low`` put
    in the program's place, on the host. A control whose factorization
    raises (an exactly zero pivot) has failed: its answer is NaN."""
    import torch

    try:
        cp, ct = low.solve(guess, iterations)
    except torch.linalg.LinAlgError:
        return (np.full(tuple(guess.shape), np.nan),
                [math.nan] * (iterations + 1))
    return cp.double().cpu().numpy(), ct


def readings(p, seeds, device, control=None):
    """{seed: the numbers of the worst answer} for the program, or for the
    reference in the precision ``control`` put in its place."""
    import torch

    cfg, t = p["config"], p["traffic"]
    gen = harness.generator(cfg)
    run, graphs, pool, struct = harness.setup(p, seeds[0], device)
    ref_mod = harness.reference(cfg)
    ref = ref_mod.Problem(struct, device, "f64")
    low = ref_mod.Problem(struct, device, control) if control else None
    out = {}
    for seed in seeds:
        pool = gen.guesses(cfg, struct, seed, t["pool"], device).to(
            pool.dtype)
        gaps, traces, ref_s = [], [], []
        for j in range(t["check_requests"]):
            idx = harness.rows(t, j)
            if control:
                answers = [control_answer(low, pool[i], t["num_iterations"])
                           for i in idx]
            else:
                guesses = pool[idx] if "fleet" in t else pool[idx[0]]
                g = graphs[j % len(graphs)].replace(
                    **{struct["node_field"]: guesses})
                answers = harness.row_answers(
                    t, harness._request(run, g, device))
            for i, answer in zip(idx, answers):
                t0 = time.perf_counter()
                rp, rt = ref.solve(pool[i].double(), t["num_iterations"])
                ref_s.append(time.perf_counter() - t0)
                gaps.append(check.gaps(*answer, rp.cpu().numpy(), rt,
                                       ref.chi2(answer[0])))
                traces.append({"trace": [float(v) for v in answer[1]],
                               "reference": [float(v) for v in rt]})
        worst = check.worst(gaps)
        out[seed] = worst
        print(json.dumps({"side": control or "program",
                          "seed": seed, "reference_s": ref_s, **worst,
                          "traces": traces}), flush=True)
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--controls", default="tf32,tf32-cholesky",
                    help="the reference's precisions put in the program's "
                    "place, comma-separated")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    p = harness.plan(args.workload)
    seeds = [args.first_seed + i for i in range(args.seeds)]
    prog = readings(p, seeds, device)
    ctrl = {c: readings(p, seeds[:args.control_seeds], device, c)
            for c in args.controls.split(",")}
    summary = {
        "workload": args.workload,
        "program_max": {n: max(r[n] for r in prog.values())
                        for n in check.NAMES},
        "control_min": {c: {n: min((r[n] for r in v.values()
                                    if math.isfinite(r[n])),
                                   default=math.nan) for n in check.NAMES}
                        for c, v in ctrl.items()},
        "program": prog, "control": ctrl}
    print(json.dumps({k: summary[k] for k in
                      ("workload", "program_max", "control_min")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
