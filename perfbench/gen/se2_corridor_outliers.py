"""``se2_corridor``'s graph with false loop closures: a share of the
closures carry garbage measurements, as a place-recognition front end
gives under perceptual aliasing.

The closures to corrupt are drawn without repetition by numpy
default_rng(outlier_seed) among the pose-pose edges with |to - from| != 1,
``round(outlier_share * closures)`` of them; each gets a measurement drawn
uniform in [-15, 15) m, [-15, 15) m, [-pi, pi) from the same generator (the
rule of the port's smoke run's ``corrupt_closures``). The edges, and so the
band, stay the corridor's. The structure also carries what the robust
reference reads: ``outlier`` (a mask over the pose-pose edges), ``robust``
and ``robust_delta``, from the configuration.

``structure(cfg)`` depends on the configuration alone; ``guesses`` is
``se2_corridor``'s: ground truth plus noise, drawn from the run's seed.
"""

from __future__ import annotations

import numpy as np

from perfbench.gen import se2_corridor

guesses = se2_corridor.guesses


def corrupt_closures(pp_from, pp_to, pp_z, seed, share):
    """(pp_z with ``share`` of the closures' measurements garbage, the
    mask of the corrupted edges)."""
    closures = np.flatnonzero(np.abs(pp_to - pp_from) != 1)
    rng = np.random.default_rng(seed)
    bad = rng.choice(closures, size=int(round(share * len(closures))),
                     replace=False)
    z = np.array(pp_z, dtype=np.float64)
    z[bad] = np.stack([rng.uniform(-15.0, 15.0, len(bad)),
                       rng.uniform(-15.0, 15.0, len(bad)),
                       rng.uniform(-np.pi, np.pi, len(bad))], axis=-1)
    mask = np.zeros(len(z), bool)
    mask[bad] = True
    return z, mask


def structure(cfg):
    """``se2_corridor.structure`` with the false closures, and ``outlier``,
    ``robust``, ``robust_delta``."""
    s = se2_corridor.structure(cfg)
    f = s["fields"]
    f["pp_z"], s["outlier"] = corrupt_closures(
        f["pp_from"], f["pp_to"], f["pp_z"], cfg["outlier_seed"],
        cfg["outlier_share"])
    s.update(robust=cfg["robust"], robust_delta=cfg["robust_delta"])
    return s
