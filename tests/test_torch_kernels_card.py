"""The port's CUDA kernels against their plain PyTorch versions on a card.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed; the suite's conftest imports JAX, so on such a
machine run it without conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_card.py

Every test here needs a CUDA card and skips without one.
"""

import pytest
import torch

from rustrobotics_tpu_torch.mapping.assemble import build_layout, system_values
from rustrobotics_tpu_torch.mapping.pgo import make_optimize
from rustrobotics_tpu_torch.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
from rustrobotics_tpu_torch.ops import banded
from rustrobotics_tpu_torch.ops import banded_kernels as bmk
from rustrobotics_tpu_torch.ops.band_chol import build_band_chol, solve_band_chol


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_band(nb, kb, device):
    """Well-conditioned block-tridiagonal f32 inputs (cond ~ 2)."""
    gen = torch.Generator(device=device).manual_seed(0)
    noise = torch.randn(nb, kb, kb, generator=gen, device=device) * (
        0.1 / kb ** 0.5)
    dsym = 2.0 * torch.eye(kb, device=device) + noise + noise.mT
    lcoup = torch.randn(nb, kb, kb, generator=gen, device=device) * (
        0.2 / kb ** 0.5)
    bp = torch.randn(nb, kb, generator=gen, device=device)
    return dsym, lcoup, bp


@pytest.mark.cuda
@pytest.mark.parametrize("kb", [256, 384, 512])
def test_kernels_match_plain(cuda_device, kb):
    dsym, lcoup, bp = _random_band(3, kb, cuda_device)
    before = dict(bk.LAUNCHES)
    ld_k, lp_k = bk.factorize_kernel(dsym, lcoup)
    ld_p, lp_p = bk.factorize_plain(dsym, lcoup)
    torch.testing.assert_close(ld_k, ld_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lp_k, lp_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bk.substitute_kernel(ld_p, lp_p, bp),
                               bk.substitute_plain(ld_p, lp_p, bp),
                               atol=1e-5, rtol=1e-5)
    assert bk.LAUNCHES["factorize"] == before["factorize"] + 1
    assert bk.LAUNCHES["substitute"] == before["substitute"] + 1


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda_device):
    dsym, lcoup, _ = _random_band(2, 256, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        bk.factorize_kernel(dsym.double(), lcoup.double())
    with pytest.raises(ValueError, match="multiple"):
        bk.factorize_kernel(dsym[:, :200, :200].contiguous(),
                            lcoup[:, :200, :200].contiguous())


@pytest.mark.cuda
def test_kernel_gn_tracks_plain(cuda_device):
    g = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=32,
                                    device=cuda_device, dtype=torch.float32)
    bl = build_band_chol(build_layout(g)).to(cuda_device)
    vals, b, _ = system_values(g, 0.0)
    x_plain = solve_band_chol(bl, vals, b)
    x_kern = bk.solve_band_kernel(bl, vals, b)
    assert torch.isfinite(x_kern).all()
    assert x_kern.shape == x_plain.shape
    runs = {be: make_optimize(g, num_iterations=6, backend=be, tolerance=0.0)(g)
            for be in ("banded-kernel", "banded-direct")}
    err_k, err_p = runs["banded-kernel"][1], runs["banded-direct"][1]
    big = err_p > 1.0
    assert big.sum() >= 2
    torch.testing.assert_close(err_k[big], err_p[big], rtol=1e-2, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,kb", [(7, 5), (41, 9), (3, 1)])
def test_banded_matvec_matches_plain(cuda_device, nb, kb):
    """K3 against its plain version in f32: only the summation order
    differs, so 1e-5 of max|y| (~100 f32 ulps over 128*kb terms)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    hb = torch.randn(nb, kb, 128, 128, generator=gen, device=cuda_device)
    xp = torch.randn(nb + kb - 1, 128, generator=gen, device=cuda_device)
    before = bmk.LAUNCHES["banded_matvec"]
    y = bmk.banded_matvec_kernel(hb, xp)
    torch.cuda.synchronize()
    assert bmk.LAUNCHES["banded_matvec"] == before + 1
    want = banded.banded_matvec_plain(hb, xp)
    err = float((y - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err


@pytest.mark.cuda
def test_banded_matvec_rejects_bad_input(cuda_device):
    hb = torch.zeros(3, 5, 128, 128, device=cuda_device)
    xp = torch.zeros(7, 128, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        bmk.banded_matvec_kernel(hb.double(), xp.double())
    with pytest.raises(ValueError, match="shape"):
        bmk.banded_matvec_kernel(hb, xp[:6])
    with pytest.raises(ValueError, match="odd"):
        bmk.banded_matvec_kernel(hb[:, :4].contiguous(), xp[:6].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        bmk.banded_matvec_kernel(hb.transpose(2, 3), xp)


@pytest.mark.cuda
def test_cg_banded_runs_the_kernel(cuda_device, monkeypatch):
    """make_optimize(backend="cg-banded") on the card launches K3 and
    never the plain SpMV, and tracks the plain backend's χ² trace."""
    g = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=96,
                                    device=cuda_device, dtype=torch.float32)
    kw = dict(num_iterations=4, tolerance=0.0, cg_tol=1e-6, cg_maxiter=400)
    err_plain = make_optimize(g, backend="cg-banded-jnp", **kw)(g)[1]

    def no_plain(*args):
        raise AssertionError("the plain SpMV ran on the card's path")

    monkeypatch.setattr(banded, "banded_matvec_plain", no_plain)
    monkeypatch.setattr(bmk, "banded_matvec_plain", no_plain)
    before = bmk.LAUNCHES["banded_matvec"]
    err_k = make_optimize(g, backend="cg-banded", **kw)(g)[1]
    assert bmk.LAUNCHES["banded_matvec"] > before
    big = err_plain > 1.0
    assert big.sum() >= 2
    torch.testing.assert_close(err_k[big], err_plain[big], rtol=1e-3, atol=0)
