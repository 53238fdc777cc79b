"""The plain reference against the port's dense optimizer in f64 on a
64-pose graph: the same chi^2 trace and final poses.

The SE3 guesses' quaternions are unit only to float32's rounding: the
reference rotates by the unit quaternion, the port by the raw one, so the
first entries of an SE3 trace differ by ~1e-8 (guess) and ~4e-6 (one
step) relative; every step's retraction normalizes, and the final poses
agree to f64's rounding."""

import numpy as np
import torch

from perfbench import harness


def _graph(struct, guess):
    from rustrobotics_tpu_torch.mapping.g2o import graph_from_numpy

    fields = {**struct["fields"], struct["node_field"]: guess.numpy()}
    return graph_from_numpy(fields, struct["total_dof"], struct["prior2"],
                            struct["prior3"], device="cpu",
                            dtype=torch.float64)


def test_reference_matches_port_dense_f64(small_plan):
    from rustrobotics_tpu_torch.mapping.pgo import optimize

    for cell in ("intel-solve", "sphere2500-solve"):
        cfg = small_plan(cell)["config"]
        struct = harness.generator(cfg).structure(cfg)
        guess = harness.generator(cfg).guesses(cfg, struct, 2**31 + 77, 1,
                                               "cpu")[0].double()
        port = optimize(_graph(struct, guess), num_iterations=10,
                        backend="dense", tolerance=0.0, device="cpu")
        ref = harness.reference(cfg).Problem(struct, "cpu", "f64")
        poses, trace = ref.solve(guess, 10)
        rtol = 1e-5 if struct["node_field"] == "poses3" else 1e-9
        np.testing.assert_allclose(trace, port.errors, rtol=rtol, atol=1e-12)
        got = getattr(port.graph, struct["node_field"])
        assert float((poses - got).abs().max()) < 1e-9
        assert trace[-1] < 1e-12 * trace[0]


def test_control_precision_rounds_products():
    from perfbench.reference.gauss_newton import tf32

    x = torch.tensor([1.0 + 2**-12, 1.0 + 3 * 2**-12, -3.0 - 2**-12])
    assert tf32(x).tolist() == [1.0, 1.0 + 2**-10, -3.0]
