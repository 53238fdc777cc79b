"""Roofline / MFU accounting for the PGO solver backends (counterpart of
``rustrobotics_tpu/roofline.py``).

Counts the FLOPs each backend touches per Gauss-Newton iteration
(analytic formulas from the static layout, the JAX package's formula for
formula) and turns measured iteration times into model-FLOP utilization
against the card's peak. The solver runs f32 at full precision (TF32 is
off), so the f32 rate outside the tensor cores is the honest denominator.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): f32 outside the
# tensor cores, and HBM3's rate.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# f32 peak per device type, FLOP/s
PEAK_F32 = {
    "cuda": PEAK_F32_FLOPS,
    "cpu": None,      # no meaningful single number; MFU reported as None
}


def banded_solve_flops(n: int, kb: int, nb: int) -> float:
    """Banded blocked Cholesky solve (ops/band_chol.solve_band_chol):
    per block row: chol kb^3/3, panel triangular solve kb^3, symmetric
    update 2 kb^3; substitutions 4*2 kb^2 per row (lower order)."""
    fact = nb * ((1.0 / 3.0 + 1.0 + 2.0) * kb**3)
    subs = nb * (8.0 * kb**2)
    return fact + subs


def _cr_eliminated_blocks(nb: int) -> int:
    """Total eliminated blocks over all native-length CR levels:
    m -> ceil(m/2) per level eliminates floor(m/2); sums to nb - 1."""
    return max(0, nb - 1)


def banded_cr_flops(n: int, kb: int, nb: int) -> float:
    """Cyclic-reduction banded solve (ops/band_chol.cr_factorize +
    cr_substitute): per level with h odd blocks, batched chol h kb^3/3,
    two batched trsm 2 h kb^3, three batched gemms 6 h kb^3; the levels
    eliminate nb - 1 blocks in total. Substitution: ~10 kb^2 per block
    per direction (lower order)."""
    fact = _cr_eliminated_blocks(nb) * ((1.0 / 3.0 + 2.0 + 6.0) * kb**3)
    subs = nb * (10.0 * kb**2)
    return fact + subs


def banded_pallas_flops(n: int, kb: int, nb: int) -> float:
    """The fused inverse-factor chain (the JAX package's Pallas kernels,
    the port's K1/K2, ``ops/band_chol_kernels``): the banded-direct chain
    plus the explicit inverse factors. Per block row: base-case chol and
    inverse ~2/3 kb^3, sub-panel solves and trailing updates ~3 kb^3,
    coupling panel and Schur update 4 kb^3; the substitution sweeps are
    8 kb^2 matvecs per row."""
    fact = nb * ((2.0 / 3.0 + 3.0 + 4.0) * kb**3)
    subs = nb * (8.0 * kb**2)
    return fact + subs


def banded_mixed_flops(n: int, kb: int, nb: int,
                       rounds: int = 10) -> float:
    """Mixed-precision banded solve (solvers.make_banded_mixed): one CR
    factorization (banded_cr_flops' factorization term) plus ``rounds``
    CG iterations, each an exact block-tridiagonal matvec (6 nb kb^2), one
    CR-substitution preconditioner apply (~10 kb^2 per block) and ~10 n of
    vector work. ``rounds`` defaults to the JAX package's count of 10."""
    fact = _cr_eliminated_blocks(nb) * ((1.0 / 3.0 + 2.0 + 6.0) * kb**3)
    per_round = nb * 6.0 * kb**2 + nb * 10.0 * kb**2 + 10.0 * n
    return fact + rounds * per_round


def dense_solve_flops(n: int) -> float:
    """Dense Cholesky n^3/3 + two triangular solves 2 n^2."""
    return n**3 / 3.0 + 2.0 * n**2


def schur_solve_flops(n_pose: int, n_lm: int) -> float:
    """Schur elimination (solvers.solve_schur): W = Hll^-1 Hlp per
    landmark (2x2 inverse + 2 x n_pose panel), S = Hpp - Hpl W
    (2 n_pose^2 n_lm_dof), reduced dense Cholesky."""
    nl_dof = 2 * n_lm
    return (
        n_lm * (8 + 2 * 2 * 2 * n_pose)          # Hll^-1, W panels
        + 2.0 * n_pose * n_pose * nl_dof          # S formation
        + dense_solve_flops(n_pose)
    )


def linearize_flops(n_pp: int, n_pl: int, n_qq: int) -> float:
    """Per-edge residual+Jacobian+A^T Omega A work (entry-level count of
    the SoA component products; ~small vs the solve)."""
    return 600.0 * n_pp + 400.0 * n_pl + 6000.0 * n_qq


def _kernels_take(band_layout) -> bool:
    """K1/K2 take every layout whose kb is a multiple of their 128-wide
    panel, up to K2's largest kb."""
    from rustrobotics_tpu_torch.ops.band_chol_kernels import MAX_KB, PANEL

    return band_layout.kb <= MAX_KB and band_layout.kb % PANEL == 0


def pgo_iteration_flops(graph, backend: str, band_layout=None) -> float:
    """Total FLOPs of one GN iteration (linearize + assemble + solve).
    ``banded-kernel`` (and the JAX name ``banded-pallas``) counts the
    fused chain where K1/K2 take the layout, the plain chain otherwise."""
    n = graph.total_dof
    lin = linearize_flops(
        graph.pp_from.shape[0], graph.pl_pose.shape[0],
        graph.qq_from.shape[0],
    )
    if backend == "banded-direct" and band_layout is not None:
        solve = banded_solve_flops(n, band_layout.kb, band_layout.nb)
    elif backend == "banded-cr" and band_layout is not None:
        solve = banded_cr_flops(n, band_layout.kb, band_layout.nb)
    elif backend in ("banded-kernel", "banded-pallas") \
            and band_layout is not None:
        if _kernels_take(band_layout):
            solve = banded_pallas_flops(n, band_layout.kb, band_layout.nb)
        else:
            solve = banded_solve_flops(n, band_layout.kb, band_layout.nb)
    elif backend == "banded-mixed" and band_layout is not None:
        solve = banded_mixed_flops(n, band_layout.kb, band_layout.nb)
    elif backend == "schur":
        n_lm = graph.landmarks2.shape[0]
        solve = schur_solve_flops(n - 2 * n_lm, n_lm)
    else:
        solve = dense_solve_flops(n)
    return lin + solve


def mfu(flops_per_sec: float, platform: str):
    """Model FLOP utilization against the device type's f32 peak ("cuda"
    or "cpu"; None on the CPU)."""
    peak = PEAK_F32.get(platform)
    if not peak:
        return None
    return flops_per_sec / peak
