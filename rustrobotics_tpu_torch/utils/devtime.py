"""Device timing on the card (counterpart of
``rustrobotics_tpu/utils/devtime.py``).

CUDA calls return before the card has run them, so a host clock around a
call measures the enqueue unless something waits. These keep the JAX
package's names and recipe:

- ``fetch`` waits for a result: it synchronizes the current stream of the
  device of the result's first tensor;
- ``scalar_fetch_rtt`` is the cost of one tiny launch read back by
  ``.item()``, the floor under any timed call that ends in a read;
- ``time_scalar_program`` times a program that returns a scalar tensor
  and runs its body ``reps`` times: a warm call, the best of ``calls``
  timed calls each ending in ``float()``, less the RTT, over ``reps``.

On the CPU the calls are synchronous and the same recipe is exact.
"""

from __future__ import annotations

import time

import torch

from rustrobotics_tpu_torch.device import resolve_device
from rustrobotics_tpu_torch.utils.tree import leaves


def _first_tensor(out):
    for leaf in leaves(out):
        if isinstance(leaf, torch.Tensor):
            return leaf
    return None


def fetch(out):
    """Wait until ``out`` (a tensor, or tuples, lists, dicts and
    dataclasses of them) is computed, and return it. One stream holds a
    call's work, so waiting for the first tensor's stream waits for all."""
    leaf = _first_tensor(out)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.current_stream(leaf.device).synchronize()
    return out


def scalar_fetch_rtt(samples: int = 5, device=None) -> float:
    """Seconds for one trivial launch and its scalar read (best of
    ``samples``); ``device`` None is the card."""
    x = torch.zeros((), dtype=torch.float32, device=resolve_device(device))
    (x + 1.0).item()
    best = float("inf")
    for k in range(samples):
        t0 = time.perf_counter()
        (x + float(k)).item()
        best = min(best, time.perf_counter() - t0)
    return best


def time_scalar_program(prog, *args, reps: int = 1, calls: int = 3,
                        rtt: float | None = None) -> float:
    """Per-body seconds for ``prog`` (which returns a scalar and runs its
    body ``reps`` times): warm call first, best of ``calls`` timed
    executions, less the scalar-fetch RTT on the result's device."""
    out = prog(*args)
    device = out.device if isinstance(out, torch.Tensor) else "cpu"
    float(out)
    if rtt is None:
        rtt = scalar_fetch_rtt(device=device)
    best = float("inf")
    for _ in range(calls):
        t0 = time.perf_counter()
        float(prog(*args))
        best = min(best, time.perf_counter() - t0)
    return max(best - rtt, 1e-9) / reps
