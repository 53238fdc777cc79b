"""The comparison that decides ``correct``: the program's answers to a
sample of the window's requests against the plain reference's answers on
the same guesses.

Each sampled answer is a request's final poses and chi^2 trace. The
numbers, each the largest over the sample:

- ``chi2_0_rel``: the relative gap of the trace's first entry, the chi^2
  of the guess (linearization and ``global_error``);
- ``chi2_1_rel``: the relative gap of the second entry, the chi^2 after
  one whole step (linearization, assembly, band assembly, factorization,
  substitution, retraction);
- ``final_chi2``: the reference's f64 chi^2 of the program's final poses
  (0 at the optimum: the measurements are exact), which judges the poses
  returned whatever the program reports;
- ``pose_gap_m``: the largest translation gap of a final pose, in m;
- ``pose_gap_rad``: the largest rotation gap of a final pose, in rad.

A cell's file gives the limit of each number it compares; a number it
gives none is printed and not judged. A number that is not finite fails
its limit.
"""

from __future__ import annotations

import math

import numpy as np

NAMES = ("chi2_0_rel", "chi2_1_rel", "final_chi2", "pose_gap_m",
         "pose_gap_rad")


def _rotation_gap(p, r):
    """Largest angle between the rotations of (N, 7) pose arrays."""
    qp = p[:, 3:] / np.linalg.norm(p[:, 3:], axis=1, keepdims=True)
    qr = r[:, 3:] / np.linalg.norm(r[:, 3:], axis=1, keepdims=True)
    dot = np.clip(np.abs((qp * qr).sum(1)), 0.0, 1.0)
    return float((2.0 * np.arccos(dot)).max())


def gaps(poses, trace, ref_poses, ref_trace, final_chi2):
    """The numbers for one answer: poses (N, 3 or 7) and traces as numpy
    arrays or lists, the program's first, and the reference's chi^2 of the
    program's final poses."""
    p, r = np.asarray(poses, np.float64), np.asarray(ref_poses, np.float64)
    t, rt = np.asarray(trace, np.float64), np.asarray(ref_trace, np.float64)
    if p.shape[1] == 3:
        d = p[:, 2] - r[:, 2]
        rot = float(np.abs((d + np.pi) % (2 * np.pi) - np.pi).max())
        trans = float(np.abs(p[:, :2] - r[:, :2]).max())
    else:
        rot = _rotation_gap(p, r)
        trans = float(np.abs(p[:, :3] - r[:, :3]).max())
    return {
        "chi2_0_rel": float(abs(t[0] - rt[0]) / rt[0]),
        "chi2_1_rel": float(abs(t[1] - rt[1]) / rt[1]),
        "final_chi2": float(final_chi2),
        "pose_gap_m": trans,
        "pose_gap_rad": rot,
    }


def worst(readings):
    """The largest of each number over a list of ``gaps`` results; NaN
    wins."""
    out = {}
    for name in NAMES:
        vals = [g[name] for g in readings]
        out[name] = (math.nan if any(math.isnan(v) for v in vals)
                     else max(vals))
    return out


def judge(numbers, limits):
    """(ok, {name: {"value", "limit"}}) over the numbers ``limits`` names:
    ok when each is finite and at most its limit."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in NAMES
              if n in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
