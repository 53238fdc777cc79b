"""The fixed work of one optimizer iteration, counted from a
configuration's band shape and edge counts, and the chip's peaks.

A configuration file holds these counts as numbers, computed once from
the layout the port gave when the configuration was added
(``python -m perfbench.work <config>`` prints them), so that a later
change of ordering or kernels does not move the yardstick. The counts are
what the mathematics needs, whatever implements it:

- factorization: a blocked Cholesky of the (nb, kb) band: a dense Cholesky
  of each of the nb diagonal blocks (kb^3 / 3), and for each of the nb - 1
  coupling blocks a triangular solve (kb^3) and a symmetric rank-kb update
  of the next diagonal block (kb^3). The band is read once and the factor
  written once, each as nb block rows of kb x 2kb f32;
- substitution: the forward and the backward sweep, each a triangular
  matvec of every diagonal block (kb^2) and a matvec of every coupling
  block (2 kb^2); the factor read once, the right-hand side read and the
  solution written once;
- assembly: the kept (lower-triangle) triplet values read once and the
  band written once;
- linearization: 600 FLOPs a SE2 pose-pose edge, 400 a pose-landmark edge
  and 6000 a SE3 pose-pose edge (the port's ``linearize_flops``).
"""

from __future__ import annotations

F32 = 4  # bytes

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit: f32 outside the
# tensor cores, and HBM3's rate.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def band_bytes(nb, kb):
    return F32 * nb * kb * 2 * kb


def factor_flops(nb, kb):
    return nb * kb**3 / 3.0 + (nb - 1) * 2.0 * kb**3


def factor_bytes(nb, kb):
    return 2 * band_bytes(nb, kb)


def subst_flops(nb, kb):
    return 2.0 * (nb * kb**2 + (nb - 1) * 2.0 * kb**2)


def subst_bytes(nb, kb):
    return band_bytes(nb, kb) + 2 * F32 * nb * kb


def assembly_bytes(nb, kb, kept):
    return F32 * kept + band_bytes(nb, kb)


def linearize_flops(n_pp, n_pl, n_qq):
    return 600.0 * n_pp + 400.0 * n_pl + 6000.0 * n_qq


def counts(nb, kb, kept, n_pp, n_pl, n_qq):
    """The ``work`` entry of a configuration file."""
    return {
        "factor_flops": factor_flops(nb, kb),
        "factor_bytes": factor_bytes(nb, kb),
        "subst_flops": subst_flops(nb, kb),
        "subst_bytes": subst_bytes(nb, kb),
        "assembly_flops": 0.0,
        "assembly_bytes": assembly_bytes(nb, kb, kept),
        "linearize_flops": linearize_flops(n_pp, n_pl, n_qq),
    }


def bound_s(flops, nbytes):
    """The least time the chip could take: the larger of the operations
    over the f32 peak and the bytes over the HBM peak."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def step_flops(work):
    """FLOPs of one iteration: linearization, factorization, substitution."""
    return work["linearize_flops"] + work["factor_flops"] + work["subst_flops"]


def _layout_of(config):
    """The layout the port gives today: (n, kb, nb, kept, edge counts).
    Imports the port; used only to write a new configuration's counts."""
    import torch

    from perfbench import harness
    from rustrobotics_tpu_torch.mapping.assemble import build_layout
    from rustrobotics_tpu_torch.mapping.g2o import graph_from_numpy
    from rustrobotics_tpu_torch.ops.band_chol import build_band_chol

    s = harness.generator(config).structure(config)
    g = graph_from_numpy(s["fields"], s["total_dof"], s["prior2"],
                         s["prior3"], device="cpu", dtype=torch.float32)
    bl = build_band_chol(build_layout(g))
    return dict(n=bl.n, kb=bl.kb, nb=bl.nb, kept=len(bl.sel),
                n_pp=int(g.pp_from.shape[0]), n_pl=int(g.pl_pose.shape[0]),
                n_qq=int(g.qq_from.shape[0]))


if __name__ == "__main__":
    import json
    import sys

    from perfbench import harness

    lay = _layout_of(harness.load_config(sys.argv[1]))
    print(json.dumps({"layout": lay, "work": counts(
        lay["nb"], lay["kb"], lay["kept"], lay["n_pp"], lay["n_pl"],
        lay["n_qq"])}, indent=1))
