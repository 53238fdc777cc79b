"""Run one cell of the benchmark on the CUDA card and print its result.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Exits non-zero, printing no result, when
CUDA is unavailable, when the cell asks for more cards than there are, or
when a module of JAX or of the JAX package is loaded once the window has
closed. The last line of standard output is the result; the compared
numbers, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# caches at fixed paths inside the checkout: PyTorch's inductor cache
# directory and CUDA's compute cache, which a run creates; the port builds
# its kernels in rustrobotics_tpu_torch/_build/ itself
CACHE = ROOT / "perfbench" / "_cache"
CACHE_ENV = {"TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "nv"}
# one host thread for every CPU thread pool: the window's work is on the
# card, and idle pool threads only compete with the thread that launches
THREAD_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable: {err}"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(CACHE / sub)
    for var in THREAD_ENV:
        os.environ[var] = "1"

    from perfbench import harness

    spec = harness.load_spec()
    entry = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: the cell needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    print(f"[device] {_power_limit()}", file=sys.stderr, flush=True)
    result = harness.run_cell(harness.plan(args.workload, spec), args.seed,
                              args.seconds, bool(args.trace),
                              torch.device("cuda", 0), t_start=T_START)
    found = harness.banned_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package loaded: "
              f"{found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
