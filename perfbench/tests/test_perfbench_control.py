"""The controls, the plain reference computed with TF32 products in the
program's place (its own blocked LU, ``tf32``, and the program's method,
a blocked Cholesky, ``tf32-cholesky``), come out not correct against each
cell's limits.

On the CPU at 1100 poses of intel-1728 (TF32's errors grow with the
corridor's length: at 64 poses both controls read like float32);
sphere2500's graph stays well conditioned at every size a CPU test holds,
so its controls are held to its limits on the card, at the cell's size:

    python -m pytest -m cuda perfbench/tests/test_perfbench_control.py
"""

import pytest
import torch

from perfbench import calibrate, check, harness

CONTROLS = ("tf32", "tf32-cholesky")
INTEL_1100 = dict(poses=1100, closures=1975)


@pytest.mark.parametrize("control", CONTROLS)
def test_control_fails_the_limits(control):
    p = harness.plan("intel-solve")
    cfg, t = {**p["config"], **INTEL_1100}, p["traffic"]
    gen, ref_mod = harness.generator(cfg), harness.reference(cfg)
    struct = gen.structure(cfg)
    ref = ref_mod.Problem(struct, "cpu", "f64")
    low = ref_mod.Problem(struct, "cpu", control)
    pool = gen.guesses(cfg, struct, 2**31 + 9, 2, "cpu")
    readings = []
    for guess in pool:
        rp, rt = ref.solve(guess.double(), t["num_iterations"])
        cp, ct = low.solve(guess, t["num_iterations"])
        readings.append(check.gaps(cp.double().numpy(), ct, rp.numpy(), rt,
                                   ref.chi2(cp.double())))
    ok, checks = check.judge(check.worst(readings), p["workload"]["limits"])
    assert not ok, checks


def test_control_that_raises_has_failed():
    """A control whose factorization raises (an exactly zero pivot, as
    the TF32 Cholesky meets on some intel-1728 guesses) gives a NaN
    answer, which the limits judge not correct."""
    class ZeroPivot:
        def solve(self, guess, iterations):
            raise torch.linalg.LinAlgError("the diagonal element is zero")

    guess = torch.zeros(12, 3)
    poses, trace = calibrate.control_answer(ZeroPivot(), guess, 10)
    assert poses.shape == (12, 3) and len(trace) == 11
    numbers = check.gaps(poses, trace, guess.double().numpy(), [1.0] * 11,
                         float("nan"))
    limits = harness.plan("intel-fleet8")["workload"]["limits"]
    assert not check.judge(numbers, limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["intel-solve", "sphere2500-solve",
                                  "intel-fleet8"])
def test_controls_fail_on_card(cell):
    """At the cell's own size, on three seeds: the program's answers pass
    the limits and each control's fail them (of a fleet cell, every row
    of the requests a run compares)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = harness.plan(cell)
    limits = p["workload"]["limits"]
    seeds = [2**31 + 301, 2**31 + 302, 2**31 + 303]
    device = torch.device("cuda", 0)
    for numbers in calibrate.readings(p, seeds, device).values():
        assert check.judge(numbers, limits)[0], numbers
    for control in CONTROLS:
        for numbers in calibrate.readings(p, seeds, device, control).values():
            assert not check.judge(numbers, limits)[0], (control, numbers)
