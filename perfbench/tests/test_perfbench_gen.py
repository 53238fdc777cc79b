"""The generators reproduce the published counts, and one seed gives one
pool of guesses."""

import numpy as np
import torch

from perfbench import harness


def _struct(name):
    cfg = harness.load_config(name)
    return cfg, harness.generator(cfg).structure(cfg)


def test_intel_counts():
    cfg, s = _struct("intel-1728")
    f = s["fields"]
    fr, to = f["pp_from"], f["pp_to"]
    assert len(s["truth"]) == 1728 and len(fr) == 4830
    odo = (to - fr) == 1
    assert odo.sum() == 1727 and (~odo).sum() == 3103
    span = fr[~odo] - to[~odo]
    assert span.min() >= 2 and span.max() <= 112
    assert len(set(zip(fr[~odo], to[~odo]))) == 3103
    assert s["total_dof"] == 3 * 1728 and s["prior2"] == 0


def test_sphere_counts():
    cfg, s = _struct("sphere2500")
    f = s["fields"]
    fr, to = f["qq_from"], f["qq_to"]
    assert len(s["truth"]) == 2500 and len(fr) == 4949
    assert ((to - fr) == 1).sum() == 2499 and ((to - fr) == 50).sum() == 2450
    assert s["total_dof"] == 6 * 2500 and s["prior3"] == 0


def test_measurements_exact():
    for name in ("intel-1728", "sphere2500"):
        cfg, s = _struct(name)
        ref = harness.reference(cfg).Problem(s, "cpu", "f64")
        assert ref.chi2(torch.as_tensor(s["truth"])) < 1e-18


def test_structure_ignores_seed_and_guesses_follow_it():
    for name in ("intel-1728", "sphere2500"):
        cfg, s = _struct(name)
        _, s2 = _struct(name)
        for k, v in s["fields"].items():
            assert np.array_equal(v, s2["fields"][k]), k
        gen = harness.generator(cfg)
        big = 2**31 + 12345
        a = gen.guesses(cfg, s, big, 3, "cpu")
        b = gen.guesses(cfg, s, big, 3, "cpu")
        c = gen.guesses(cfg, s, big + 1, 3, "cpu")
        assert a.dtype == torch.float32 and torch.equal(a, b)
        assert not torch.equal(a, c)
        truth = torch.as_tensor(s["truth"], dtype=torch.float32)
        assert torch.equal(a[:, 0], truth[0].expand(3, -1))
        dev = (a - truth)[:, 1:, :3].std()
        sigma = cfg.get("guess_sigma", cfg.get("guess_sigma_m"))
        assert abs(float(dev) / sigma - 1) < 0.05
