"""The port's CUDA kernels against their plain PyTorch versions on a card.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed; the suite's conftest imports JAX, so on such a
machine run it without conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_card.py

Every test here needs a CUDA card and skips without one.
"""

import functools
import hashlib
import importlib.util
import pathlib
import re

import pytest
import torch

from rustrobotics_tpu_torch.mapping import assemble, linearize
from rustrobotics_tpu_torch.mapping.assemble import build_layout, system_values
from rustrobotics_tpu_torch.mapping.pgo import (
    make_optimize,
    make_optimize_batch,
    stack_graphs,
)
from rustrobotics_tpu_torch.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu_torch.ops import band_assemble_kernels as bak
from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
from rustrobotics_tpu_torch.ops import banded
from rustrobotics_tpu_torch.ops import banded_kernels as bmk
from rustrobotics_tpu_torch.ops import linearize_kernels as lk
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
@pytest.mark.parametrize("kb", [128, 256, 384, 512, 768, 1024, 2048])
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


def _fleet(device, batch=3, num_poses=256, num_landmarks=4, closure_span=32):
    """A corridor graph and jittered copies (f32, numpy seed)."""
    import numpy as np

    g = synthetic_corridor_graph_2d(num_poses, num_landmarks=num_landmarks,
                                    closure_span=closure_span, device=device,
                                    dtype=torch.float32)
    rng = np.random.default_rng(0)
    poses = g.poses2.cpu().numpy()
    graphs = [g] + [g.replace(poses2=torch.as_tensor(
        poses + rng.normal(0.0, 0.05, poses.shape), dtype=torch.float32,
        device=device)) for _ in range(batch - 1)]
    return graphs, stack_graphs(graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_band_assemble_matches_plain(cuda_device, batched):
    """K4 (one graph) and K5 (a fleet) against the plain index_add_: each
    destination within 16 f32 units of the sum of its |contributions|
    (only the summation order differs; f32 against exact reads 1.3 units
    on this graph on the CPU), and bit-equal between runs."""
    graphs, fleet = _fleet(cuda_device)
    bl = build_band_chol(build_layout(graphs[0])).to(cuda_device)
    vals = system_values(fleet if batched else graphs[0], 0.01)[0]
    key = "assemble_batch" if batched else "assemble_b1"
    before = bak.LAUNCHES[key]
    got = bak.band_assemble_kernel(bl, vals)
    again = bak.band_assemble_kernel(bl, vals)
    torch.cuda.synchronize()
    assert bak.LAUNCHES[key] == before + 2
    want = bak.band_assemble_plain(bl, vals)
    scale = bak.band_assemble_plain(bl, vals.abs())
    assert got.shape == want.shape
    assert torch.equal(got, again)
    assert bool(((got - want).abs() <= 16 * 2.0 ** -24 * scale).all())


@pytest.mark.cuda
def test_band_assemble_rejects_bad_input(cuda_device):
    graphs, _ = _fleet(cuda_device, batch=1)
    bl = build_band_chol(build_layout(graphs[0])).to(cuda_device)
    vals = system_values(graphs[0], 0.0)[0]
    with pytest.raises(ValueError, match="float32"):
        bak.band_assemble_kernel(bl, vals.double())
    with pytest.raises(ValueError, match="contiguous"):
        bak.band_assemble_kernel(bl, torch.stack([vals, vals], 1).T)
    with pytest.raises(ValueError, match=r"bl\.to"):
        bak.band_assemble_kernel(build_band_chol(build_layout(graphs[0])),
                                 vals)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("corridor,kb", [((256, 4, 32), 256),
                                         ((640, 8, 160), 512)])
def test_band_assemble_bit_equal_to_cpu_plain(cuda_device, batched, corridor,
                                              kb):
    """K4 (one graph) and K5 (a batch of 3) give the band of the plain
    index_add_ on the CPU copy of the same f32 values bit for bit: each
    entry is summed from 0 in plan order. At kb = 256 the batch is 192
    CTAs, not a whole number of waves."""
    num_poses, num_landmarks, closure_span = corridor
    graphs, fleet = _fleet(cuda_device, num_poses=num_poses,
                           num_landmarks=num_landmarks,
                           closure_span=closure_span)
    bl = build_band_chol(build_layout(graphs[0]))
    assert bl.kb == kb
    vals = system_values(fleet if batched else graphs[0], 0.01)[0]
    got = bak.band_assemble_kernel(bl.to(cuda_device), vals).cpu()
    want = bak.band_assemble_plain(bl, vals.cpu())
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_band_assemble_is_one_device_op(cuda_device, batched):
    """One K4 or K5 call runs exactly one device kernel (counted by
    torch.profiler): no memset and no copy."""
    from torch.profiler import ProfilerActivity, profile

    graphs, fleet = _fleet(cuda_device)
    bl = build_band_chol(build_layout(graphs[0])).to(cuda_device)
    vals = system_values(fleet if batched else graphs[0], 0.01)[0]
    bak.band_assemble_kernel(bl, vals)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bak.band_assemble_kernel(bl, vals)
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(dev) == 1 and "band_assemble" in dev[0], dev


@pytest.mark.cuda
def test_factorize_launches_per_block_row(cuda_device):
    """One K1 call at kb=512, nb=3 issues at most 12 device kernels a
    block row (counted by torch.profiler), and no copy or memset."""
    from torch.profiler import ProfilerActivity, profile

    nb = 3
    dsym, lcoup, _ = _random_band(nb, 512, cuda_device)
    bk.factorize_kernel(dsym, lcoup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bk.factorize_kernel(dsym, lcoup)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev if "emcpy" not in e.name
               and "emset" not in e.name]
    assert dev, "the profiler recorded no device events"
    assert len(kernels) == len(dev)
    assert len(kernels) <= 12 * nb, len(kernels)


def _k1_band(kb, batch, device):
    """A seeded _random_band system of 3 block rows a graph: (3, kb, kb)
    at batch 1, else (batch, 3, kb, kb)."""
    dsym, lcoup, _ = _random_band(3 * batch, kb, device)
    if batch == 1:
        return dsym, lcoup
    return dsym.view(batch, 3, kb, kb), lcoup.view(batch, 3, kb, kb)


def _sha256(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# SHA-256 of (dsym, lcoup) and of K1's (ldinv, lp) on an H100 at commit
# 2cd3f7bb0cf97ea97ca7a0b58741fd67b0fa9a5c, whose K1 formed the strips of
# L inside each 32x32 trailing tile: "kb,batch" keys are _k1_band's
# systems, the others chip_smoke's front-end band (kb 256, nb 21) at
# λ = FE_BREAK_LAM and at λ = LM_LAMBDA0.
K1_SHA256 = {
    "256,1": (
        "6311ed01a05aa04f65a2a08997b72da0d530abe809a6cc9d2c436f386d41a540",
        "a5e04776d01905ac82002d684052de00cf9e89a4a8e755327a716e36a20c57b8"),
    "256,8": (
        "d9cb6f113ed5270ca978cb762c309404c9ae76ed8af16bfb08933eca08a970ca",
        "d086c96dacffb0a91b7c027ef842252072ac15cb181f37845c56a7c4484e2db0"),
    "384,1": (
        "c194063ca0ccaa2bc4af7e9577944946965aab5f7924870c2edcc4c11fd83081",
        "ec8c27360754268ad3612e90010768e69725db6ddcdfdf555e5f3a5f929f6c06"),
    "384,8": (
        "1ba24a1eb8c4c85fb236e992e85dd7f27ac393d619ba72f8c6280f433b99fccf",
        "07ea7a5edebc931b1083aa244c9c7065a78e39d29828b85f298dbc021c9b7566"),
    "512,1": (
        "f38e8df8483363ba51b39f0ed1ec3fa58e6568d5738a455ca2bd07f23a98285c",
        "8e6b852c9c234910a00ea8deed49daac49a62ee306cfdb4e8fc946502b08a666"),
    "512,8": (
        "45ad9efce28c7333071f951466de2e928aaf72d8f2048c1aff96bf624558babf",
        "93f55d863f02817dbb9b8461e738aaad115893eeea9f369df6559d9e77b3b7fc"),
    "1024,1": (
        "961f9fee770ae61c1b700c59fb362491a942b156ebac932636c4a24c574cda05",
        "94d86132ac80e58d736231ab199e10b98b3784f78f0dd8777adae18601e1db82"),
    "1024,8": (
        "b3314a4b033e554ad31180366de48fcbb77d8ec02196480b51ef95e11f2ab26f",
        "3c26845a85ea11c31dd380567566728d4703b1b9693cc5e08120d67f46c7c72b"),
    "512,32": (
        "339dfbffd692ac54b300a022d622f91ed739424898e1ec39bbb7c9a21f8e7c63",
        "d26f7ff3b3a953af0390c840ac72fac32b5c5eead14e6f9b0ae0acfdc1341f8d"),
    "frontend_break": (
        "e5b0559633cb9bae8f984ec7ec235d8e123a4936afa84669ca6a48fef5131d4b",
        "8b88a553bb2f43a35cdf752d6f61f85183b3ebbbbbf4d37c5ccb455fb2ea1457"),
    "frontend_lm0": (
        "ce4e6ee59b5589ee6ae7a1dd60fad652fc6316ab3e0d44a85ac2168f24041758",
        "154ac89b0cc4701ace0e543469b4d4752106df43b5b371e31f99504a4b3b0d91"),
}


@functools.lru_cache(maxsize=1)
def _frontend_gate_spec():
    """chip_smoke.frontend_gate_graph()'s graph spec (built in f64 on the
    CPU, bit-reproducible), with torch's thread count left as it was."""
    threads = torch.get_num_threads()
    try:
        return _chip_smoke().frontend_gate_graph()[0]
    finally:
        torch.set_num_threads(threads)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_SHA256))
def test_k1_bits_as_before_the_strip_work_list(cuda_device, case):
    """K1 gives (ldinv, lp) bit for bit as the commit of K1_SHA256 did on
    the same inputs: its sums run in the same order whatever its tiles."""
    want_in, want_out = K1_SHA256[case]
    if case.startswith("frontend"):
        cs = _chip_smoke()
        graph = cs.port_graph(_frontend_gate_spec(), cuda_device).to(
            dtype=torch.float32)
        bl = build_band_chol(build_layout(graph))
        assert (bl.kb, bl.nb) == (256, 21)
        lam = cs.FE_BREAK_LAM if case == "frontend_break" else cs.LM_LAMBDA0
        dsym, lcoup = cs.gate_band(graph, bl, cuda_device, lam)
    else:
        kb, batch = map(int, case.split(","))
        dsym, lcoup = _k1_band(kb, batch, cuda_device)
    assert _sha256(dsym, lcoup) == want_in
    assert _sha256(*bk.factorize_kernel(dsym, lcoup)) == want_out


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 32])
def test_k1_work_tally(cuda_device, batch):
    """One K1 call at kb=512, nb=3 adds to K1_WORK exactly what k1_work
    computes from the shapes and the strip height K1 reports (each strip
    of L once a panel step), and issues at most 12 device kernels a block
    row, no copy or memset, each under one of the names the benchmark
    counts as K1's."""
    from torch.profiler import ProfilerActivity, profile

    nb = 3
    dsym, lcoup = _k1_band(512, batch, cuda_device)
    bk.factorize_kernel(dsym, lcoup)
    torch.cuda.synchronize()
    before, calls = dict(bk.K1_WORK), dict(bk.K1_STRIP_ROWS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bk.factorize_kernel(dsym, lcoup)
        torch.cuda.synchronize()
    added = {k: bk.K1_WORK[k] - before[k] for k in before}
    heights = {r: bk.K1_STRIP_ROWS[r] - calls[r] for r in calls}
    assert sorted(heights.values()) == [0, 1], heights
    rows = max(heights, key=heights.get)
    assert added == bk.k1_work(nb, 512, batch, rows)
    assert added["strips"] == batch * nb * (384 + 256 + 128) // rows
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert dev and not [n for n in dev if "emcpy" in n or "emset" in n], dev
    assert len(dev) <= 12 * nb, len(dev)
    k1_name = re.compile(r"\b(gemm_nt|panel_chol_inv|trail_offdiag)\b")
    assert all(k1_name.search(n) for n in dev), set(dev)


# Strip heights of the shapes timed with both on an H100 (132 SMs): the
# faster of the two at each.
K1_TIMED_ROWS = {(384, 1): 32, (512, 1): 32, (512, 8): 32, (512, 16): 64,
                 (512, 32): 64, (1024, 1): 64, (1024, 8): 64}


@pytest.mark.cuda
@pytest.mark.parametrize("kb,batch", list(K1_TIMED_ROWS))
def test_k1_strip_rows_follow_the_timed_shapes(cuda_device, kb, batch):
    """On a card of 132 SMs K1 takes, at each shape timed with both strip
    heights, the faster one."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if sms != 132:
        pytest.skip(f"the heights were timed on 132 SMs, this card has {sms}")
    dsym, lcoup, _ = _random_band(batch, kb, cuda_device)
    calls = dict(bk.K1_STRIP_ROWS)
    bk.factorize_kernel(dsym.view(batch, 1, kb, kb),
                        lcoup.view(batch, 1, kb, kb))
    added = {r: bk.K1_STRIP_ROWS[r] - calls[r] for r in calls}
    want = K1_TIMED_ROWS[kb, batch]
    assert added == {r: int(r == want) for r in calls}


@pytest.mark.cuda
@pytest.mark.parametrize("batch,kb", [(3, 256), (4, 384), (8, 512),
                                      (32, 512), (2, 2048)])
def test_batched_kernels_match_per_graph(cuda_device, batch, kb):
    """K1/K2 over a batch axis: graph i of the batch equals the unbatched
    kernels on graph i bit for bit, with one launch a call."""
    dsym, lcoup, bp = _random_band(batch * 3, kb, cuda_device)
    dsym, lcoup = dsym.view(batch, 3, kb, kb), lcoup.view(batch, 3, kb, kb)
    bp = bp.view(batch, 3, kb)
    before = dict(bk.LAUNCHES)
    ld_b, lp_b = bk.factorize_kernel(dsym, lcoup)
    x_b = bk.substitute_kernel(ld_b, lp_b, bp)
    assert bk.LAUNCHES["factorize"] == before["factorize"] + 1
    assert bk.LAUNCHES["substitute"] == before["substitute"] + 1
    for i in range(batch):
        ld_1, lp_1 = bk.factorize_kernel(dsym[i].contiguous(),
                                         lcoup[i].contiguous())
        assert torch.equal(ld_b[i], ld_1) and torch.equal(lp_b[i], lp_1)
        assert torch.equal(x_b[i], bk.substitute_kernel(ld_1, lp_1,
                                                        bp[i].contiguous()))


@pytest.mark.cuda
def test_fleet_runs_the_kernels(cuda_device, monkeypatch):
    """make_optimize_batch(backend="banded-kernel") launches K5 and one
    K1 and K2 an iteration for the whole fleet, never the plain scatter,
    and every row tracks the unbatched banded-kernel run."""
    from rustrobotics_tpu_torch.ops import band_chol

    graphs, fleet = _fleet(cuda_device)
    kw = dict(num_iterations=4, backend="banded-kernel", tolerance=0.0)
    runs = [make_optimize(graphs[0], **kw)(g)[1] for g in graphs]

    def no_plain(*args):
        raise AssertionError("the plain band scatter ran on the card's path")

    monkeypatch.setattr(band_chol, "scatter_add", no_plain)
    monkeypatch.setattr(bak, "band_assemble_plain", no_plain)
    before = {**bk.LAUNCHES, **bak.LAUNCHES}
    _, errors, it = make_optimize_batch(graphs[0], **kw)(fleet)
    assert it.tolist() == [4, 4, 4]
    assert bak.LAUNCHES["assemble_batch"] == before["assemble_batch"] + 4
    assert bk.LAUNCHES["factorize"] == before["factorize"] + 4
    assert bk.LAUNCHES["substitute"] == before["substitute"] + 4
    for i, want in enumerate(runs):
        big = want > 1.0
        assert big.sum() >= 2
        torch.testing.assert_close(errors[i][big], want[big], rtol=1e-2,
                                   atol=0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke",
        pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _sphere(device, rings=30):
    """chip_smoke.sphere_graph at 30 rings of 50 poses (n = 9000): its
    band plan is kb = 384, nb = 24, the block size of sphere-2500."""
    import numpy as np

    cs = _chip_smoke()
    g = cs.port_graph(cs.sphere_graph(rings=rings), device)
    rng = np.random.default_rng(0)
    copies = [g] + [g.replace(poses3=torch.as_tensor(
        cs.jitter_poses3(g.poses3.cpu().numpy(), rng), device=device))
        for _ in range(3)]
    return [c.to(dtype=torch.float32) for c in copies]


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_band_assemble_kb384_matches_plain(cuda_device, batched):
    """K4 (one 3D graph) and K5 (B = 4) at kb = 384 against the plain
    index_add_ with the kb = 512 tolerance (16 f32 units of the sum of
    each entry's |contributions|), and bit-equal to the CPU's plan-order
    index_add_."""
    graphs = _sphere(cuda_device)
    bl = build_band_chol(build_layout(graphs[0]))
    assert (bl.kb, bl.nb) == (384, 24)
    vals = system_values(stack_graphs(graphs) if batched else graphs[0],
                         0.01)[0]
    key = "assemble_batch" if batched else "assemble_b1"
    before = bak.LAUNCHES[key]
    dev_bl = bl.to(cuda_device)
    got = bak.band_assemble_kernel(dev_bl, vals)
    torch.cuda.synchronize()
    assert bak.LAUNCHES[key] == before + 1
    want = bak.band_assemble_plain(dev_bl, vals)
    scale = bak.band_assemble_plain(dev_bl, vals.abs())
    assert bool(((got - want).abs() <= 16 * 2.0 ** -24 * scale).all())
    on_cpu = bak.band_assemble_plain(bl, vals.cpu())
    assert torch.equal(got.cpu().view(torch.int32), on_cpu.view(torch.int32))


@pytest.mark.cuda
def test_sphere_kernels_track_plain(cuda_device):
    """A 3D graph at kb = 384 through banded-kernel: K4, K1 and K2
    launch, the solve at the first LM step's damping agrees with the plain
    f32 solve (PARITY_TOL["solve"] of chip_smoke), and the LM χ² trace
    tracks banded-direct's; the fleet of 4 launches K5."""
    graphs = _sphere(cuda_device)
    g = graphs[0]
    bl = build_band_chol(build_layout(g)).to(cuda_device)
    vals, b, _ = system_values(g, 0.01)
    x_plain = solve_band_chol(bl, vals, b)
    before = {**bk.LAUNCHES, **bak.LAUNCHES}
    x_kern = bk.solve_band_kernel(bl, vals, b)
    rel = float((x_kern - x_plain).abs().max() / x_plain.abs().max())
    assert rel <= 3e-3, rel
    kw = dict(num_iterations=4, solver="lm", tolerance=0.0)
    err_k = make_optimize(g, backend="banded-kernel", **kw)(g)[1]
    err_p = make_optimize(g, backend="banded-direct", **kw)(g)[1]
    for key in ("assemble_b1", "factorize", "substitute"):
        assert {**bk.LAUNCHES, **bak.LAUNCHES}[key] > before[key], key
    big = err_p > 1.0
    assert big.sum() >= 2
    torch.testing.assert_close(err_k[big], err_p[big], rtol=1e-2, atol=0)
    before = bak.LAUNCHES["assemble_batch"]
    _, errors, it = make_optimize_batch(g, backend="banded-kernel",
                                        **kw)(stack_graphs(graphs))
    assert it.tolist() == [4] * 4
    assert bak.LAUNCHES["assemble_batch"] == before + 4
    assert torch.isfinite(errors).all()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batched_banded_matvec_bit_equal(cuda_device, batch):
    """K3 over a fleet axis (B, nb, kb, 128, 128) at corridor-1728's band
    shape: one launch a call, and graph i equals the one-graph call on
    graph i bit for bit (each warp sums in the same order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    nb, kb = 41, 9
    hb = torch.randn(batch, nb, kb, 128, 128, generator=gen,
                     device=cuda_device)
    xp = torch.randn(batch, nb + kb - 1, 128, generator=gen,
                     device=cuda_device)
    before = bmk.LAUNCHES["banded_matvec"]
    y = bmk.banded_matvec_kernel(hb, xp)
    torch.cuda.synchronize()
    assert bmk.LAUNCHES["banded_matvec"] == before + 1
    assert y.shape == (batch, nb * 128)
    for i in range(batch):
        assert torch.equal(y[i], bmk.banded_matvec_kernel(hb[i].contiguous(),
                                                          xp[i].contiguous()))


@pytest.mark.cuda
def test_batched_banded_matvec_matches_plain(cuda_device):
    """Batched K3 against the batched plain version: 1e-5 of max|y|, the
    one-graph tolerance; a second batch axis is refused."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    hb = torch.randn(3, 7, 5, 128, 128, generator=gen, device=cuda_device)
    xp = torch.randn(3, 11, 128, generator=gen, device=cuda_device)
    y = bmk.banded_matvec_kernel(hb, xp)
    want = banded.banded_matvec_plain(hb, xp)
    err = float((y - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err
    with pytest.raises(ValueError, match="one batch axis"):
        bmk.banded_matvec_kernel(hb[None], xp[None])


@pytest.mark.cuda
def test_fleet_cg_banded_runs_the_kernel(cuda_device, monkeypatch):
    """make_optimize_batch(backend="cg-banded") launches K3 once a PCG
    round for the whole fleet, never the plain SpMV, and every row tracks
    its one-graph cg-banded run."""
    from rustrobotics_tpu_torch.mapping import solvers

    graphs, fleet = _fleet(cuda_device, closure_span=96)
    kw = dict(num_iterations=3, tolerance=0.0, backend="cg-banded",
              cg_tol=1e-6, cg_maxiter=400)
    runs = [make_optimize(graphs[0], **kw)(g)[1] for g in graphs]
    pcg, rounds = solvers.pcg, []

    def recording(*args, **kwargs):
        x, k = pcg(*args, **kwargs)
        rounds.append(int(k.max()))
        return x, k

    def no_plain(*args):
        raise AssertionError("the plain SpMV ran on the card's path")

    monkeypatch.setattr(solvers, "pcg", recording)
    monkeypatch.setattr(banded, "banded_matvec_plain", no_plain)
    monkeypatch.setattr(bmk, "banded_matvec_plain", no_plain)
    before = bmk.LAUNCHES["banded_matvec"]
    _, errors, it = make_optimize_batch(graphs[0], **kw)(fleet)
    assert it.tolist() == [3, 3, 3]
    assert bmk.LAUNCHES["banded_matvec"] - before == sum(rounds) > 0
    for i, want in enumerate(runs):
        big = want > 1.0
        assert big.sum() >= 2
        torch.testing.assert_close(errors[i][big], want[big], rtol=1e-3,
                                   atol=0)


@pytest.mark.cuda
def test_marginals_through_kernels_match_plain(cuda_device):
    """marginal_variances and pose_covariances of an f32 graph on the
    card assemble with K4 and factor with K1, and agree with the plain f32
    chain on the card: 3e-2 of the largest variance and block entry,
    about 10x the H100's reading (3.2e-3; the undamped system is at f32's
    edge, and K1's factor differs from the plain chain's there)."""
    from rustrobotics_tpu_torch.mapping.pgo import (
        marginal_variances,
        pose_covariances,
    )
    from rustrobotics_tpu_torch.ops.band_chol import (
        marginal_covariances,
        marginal_node_blocks,
    )

    g = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=32,
                                    device=cuda_device, dtype=torch.float32)
    bl = build_band_chol(build_layout(g)).to(cuda_device)
    vals, _, _ = system_values(g, 0.0)
    before = {**bk.LAUNCHES, **bak.LAUNCHES}
    var = marginal_variances(g)
    blocks = pose_covariances(g)
    torch.cuda.synchronize()
    after = {**bk.LAUNCHES, **bak.LAUNCHES}
    assert after["factorize"] == before["factorize"] + 2
    assert after["assemble_b1"] == before["assemble_b1"] + 2
    var_p = marginal_covariances(bl, vals)
    offs = g.pose2_offsets.cpu().numpy()
    blocks_p = marginal_node_blocks(bl, vals, offs, [3] * len(offs),
                                    pad_size=3)
    assert torch.isfinite(var).all() and (var > 0).all()
    for got, want in ((var, var_p), (blocks, blocks_p)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 3e-2, err


@pytest.mark.cuda
def test_k1_keeps_pivots_on_frontend_band(cuda_device):
    """The front end's graph of chip_smoke (n = 5248, kb = 256, nb = 21)
    after LM 30 on banded-direct, as chip_smoke's front-end K1 gate reads
    it (``frontend_gate_graph``: built in f64 on the CPU, bit-reproducible,
    cast to f32), K4's band at λ = FE_BREAK_LAM and at λ = LM_LAMBDA0:
    near singular in f32, and a K1 whose sub-panel steps scaled X and the
    update with two roundings of the pivot lost pivots on it from block
    row 5 or 6 on. K1 keeps every pivot the f64 chain keeps, as the plain
    chain does, and stays within FE_K1_TOL of it (``pivot_gate``)."""
    from rustrobotics_tpu_torch.mapping import (
        build_pose_graph_from_slam_course,
    )

    cs = _chip_smoke()
    g = build_pose_graph_from_slam_course(cs.frontend_dataset(),
                                          device=cuda_device)
    bl = build_band_chol(build_layout(g))
    assert (bl.kb, bl.nb) == (256, 21)
    threads = torch.get_num_threads()
    try:
        spec, _ = cs.frontend_gate_graph()
    finally:
        torch.set_num_threads(threads)
    graph = cs.port_graph(spec, cuda_device).to(dtype=torch.float32)
    for lam in (cs.FE_BREAK_LAM, cs.LM_LAMBDA0):
        res = cs.pivot_gate(*cs.gate_band(graph, bl, cuda_device, lam),
                            bk.factorize_kernel, bk.factorize_plain)
        assert res["r64"] >= 1 and res["ok"], (lam, res)


@pytest.mark.cuda
def test_bench_graph_slam_runs_the_kernels(cuda_device, tmp_path):
    """benchmarks.bench_graph_slam on a small corridor (a g2o file from
    chip_smoke's writer) with banded-kernel launches K4, K1 and K2, gives
    its row, and banded-kernel's χ² trace tracks banded-direct's
    (PARITY_TOL["solve"] relative on the entries above 1)."""
    from rustrobotics_tpu_torch import benchmarks
    from rustrobotics_tpu_torch.mapping import load_g2o

    cs = _chip_smoke()
    (tmp_path / "g2o").mkdir()
    graph = synthetic_corridor_graph_2d(256, num_landmarks=4,
                                        closure_span=32, device="cpu")
    path = tmp_path / "g2o" / "corridor256.g2o"
    path.write_text(cs.g2o_text(cs.graph_spec(graph)))
    before = {**bk.LAUNCHES, **bak.LAUNCHES}
    rows = []
    benchmarks.bench_graph_slam(rows, dataset_root=str(tmp_path),
                                graphs=("corridor256",),
                                backends=("banded-kernel",),
                                device=cuda_device)
    for key in ("assemble_b1", "factorize", "substitute"):
        launches = {**bk.LAUNCHES, **bak.LAUNCHES}[key] - before[key]
        assert launches > 0, key
    assert [r["metric"] for r in rows] == ["graph_slam_corridor256_banded-kernel"]
    assert rows[0]["value"] > 0 and 0 < rows[0]["mfu"] <= 1.05
    g32 = load_g2o(str(path), dtype=torch.float32, device=cuda_device)
    traces = {b: benchmarks._graph_slam_run(g32, b, 10, cuda_device)(g32)[1]
              for b in ("banded-kernel", "banded-direct")}
    want = traces["banded-direct"]
    big = want > 1.0
    assert big.sum() >= 2
    torch.testing.assert_close(traces["banded-kernel"][big], want[big],
                               rtol=cs.PARITY_TOL["solve"], atol=0)


def _se2_case(device, name):
    """(graph, λ) of the SE2 linearization kernel's cases, f32 on the card:
    an Intel-sized corridor (1728 poses, a closure a pose), a landmark
    graph, a fleet of 8, and LM's λ as a tensor for a fleet of 3 (a λ a
    row) and for one graph (0-d)."""
    if name == "corridor1728":
        return synthetic_corridor_graph_2d(
            1728, closure_stride=1, closure_span=64, device=device,
            dtype=torch.float32), 0.0
    if name == "landmarks":
        return synthetic_corridor_graph_2d(
            512, num_landmarks=32, closure_span=32, device=device,
            dtype=torch.float32), 0.01
    if name == "fleet8":
        return _fleet(device, batch=8, num_landmarks=8)[1], 0.0
    if name == "lm_fleet3":
        return _fleet(device)[1], torch.tensor([0.01, 0.02, 0.04],
                                               device=device)
    g, _ = _se2_case(device, "landmarks")
    return g, torch.tensor(0.005, device=device)


def _rhs_scale(graph):
    """Per dof, the sum of |parts| that index_add_ adds into b."""
    *_, bi, bj, _ = linearize.edge_terms_pp_soa(
        graph.poses2, graph.pp_from, graph.pp_to, graph.pp_z, graph.pp_omega)
    *_, li, lj, _ = linearize.edge_terms_pl_soa(
        graph.poses2, graph.landmarks2, graph.pl_pose, graph.pl_lm,
        graph.pl_z, graph.pl_omega)
    scale = torch.zeros(graph.batch_shape + (graph.total_dof,),
                        device=graph.device)
    for off, d, part in ((graph.pose2_offsets[graph.pp_from], 3, bi),
                         (graph.pose2_offsets[graph.pp_to], 3, bj),
                         (graph.pose2_offsets[graph.pl_pose], 3, li),
                         (graph.lm2_offsets[graph.pl_lm], 2, lj)):
        idx = off[None, :] + torch.arange(d, device=graph.device)[:, None]
        scale.index_add_(-1, idx.reshape(-1),
                         part.abs().reshape(graph.batch_shape + (-1,)))
    return scale


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["corridor1728", "landmarks", "fleet8",
                                  "lm_fleet3", "lm_one"])
def test_se2_linearize_matches_plain(cuda_device, name):
    """system_values on the kernel path against the plain CUDA path
    (system_values_plain): vals bit for bit (the same f32 operations in the
    same order); b bit for bit equal to the plain version's plan-order
    gather on the card, and within 2 max_degree f32 units of each dof's
    sum of |parts| of the plain path's atomic index_add_ (two orders of at
    most max_degree terms); χ² within 1e-5 relative (a fixed tree against
    torch.sum's order, each ~20 units deep); the same bits on a second
    call; one LAUNCHES count a call."""
    graph, lam = _se2_case(cuda_device, name)
    plan = build_layout(graph).linearize_plan.to(cuda_device)
    vals_p, b_p, chi2_p = assemble.system_values_plain(graph, lam)
    before = lk.LAUNCHES["se2_linearize"]
    vals_k, b_k, chi2_k = system_values(graph, lam, plan=plan)
    again = system_values(graph, lam, plan=plan)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["se2_linearize"] == before + 2
    for got, want in ((vals_k, vals_p), (b_k, b_p), (chi2_k, chi2_p)):
        assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(vals_k.view(torch.int32), vals_p.view(torch.int32))
    _, b_m, _ = lk.se2_linearize_plain(graph, lam, assemble.PRIOR_WEIGHT,
                                       plan)
    assert torch.equal(b_k.view(torch.int32), b_m.view(torch.int32))
    tol = 2 * plan.max_degree * 2.0 ** -24 * _rhs_scale(graph)
    assert bool(((b_k - b_p).abs() <= tol).all())
    torch.testing.assert_close(chi2_k, chi2_p, rtol=1e-5, atol=0)
    for got, first in zip(again, (vals_k, b_k, chi2_k)):
        assert torch.equal(got, first)


@pytest.mark.cuda
def test_se2_linearize_rejects_bad_input(cuda_device):
    graph, _ = _se2_case(cuda_device, "landmarks")
    w = assemble.PRIOR_WEIGHT
    plan = build_layout(graph).linearize_plan
    with pytest.raises(ValueError, match="float32"):
        lk.se2_linearize_kernel(graph.to(dtype=torch.float64), 0.0, w, plan)
    with pytest.raises(ValueError, match="must be on"):
        lk.se2_linearize_kernel(graph.replace(pp_z=graph.pp_z.cpu()), 0.0, w,
                                plan)
    with pytest.raises(ValueError, match="int64"):
        lk.se2_linearize_kernel(graph.replace(pl_lm=graph.pl_lm.int()), 0.0,
                                w, plan)
    with pytest.raises(ValueError, match="SE3"):
        lk.se2_linearize_kernel(graph.replace(
            qq_from=torch.zeros(1, dtype=torch.long, device=cuda_device)),
            0.0, w, plan)
    other, _ = _se2_case(cuda_device, "corridor1728")
    with pytest.raises(ValueError, match="not this graph's"):
        lk.se2_linearize_kernel(graph, 0.0, w,
                                build_layout(other).linearize_plan)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["corridor1728", "fleet8"])
def test_se2_linearize_is_two_device_ops(cuda_device, name):
    """system_values on the kernel path runs the two kernels and nothing
    else on the device (counted by torch.profiler over 4 calls): no fill,
    copy or memset. The profiler can miss the first kernel after it
    starts (seen on the card in a full run of this file), so 7 events
    pass; a third device operation a call would give 11 or 12."""
    from torch.profiler import ProfilerActivity, profile

    graph, lam = _se2_case(cuda_device, name)
    plan = build_layout(graph).linearize_plan.to(cuda_device)
    system_values(graph, lam, plan=plan)
    torch.cuda.synchronize()
    calls = 4
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            system_values(graph, lam, plan=plan)
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 2 * calls - 1 <= len(dev) <= 2 * calls, dev
    assert all("se2_edge_terms" in n or "se2_rhs_gather" in n
               for n in dev), dev


@pytest.mark.cuda
def test_gn10_runs_the_se2_kernel_every_iteration(cuda_device, monkeypatch):
    """make_optimize(banded-kernel, GN 10, f32, tolerance 0), the shape of
    the benchmark's request, on an Intel-sized corridor: the kernel runs
    once an iteration, and the χ² trace tracks the plain path's."""
    graph, _ = _se2_case(cuda_device, "corridor1728")
    run = make_optimize(graph, num_iterations=10, backend="banded-kernel",
                        tolerance=0.0)
    before = lk.LAUNCHES["se2_linearize"]
    _, err_k, it = run(graph)
    torch.cuda.synchronize()
    assert it == 10
    assert lk.LAUNCHES["se2_linearize"] == before + 10
    monkeypatch.setattr(lk, "takes_kernel", lambda *args: False)
    _, err_p, _ = run(graph)
    assert lk.LAUNCHES["se2_linearize"] == before + 10
    big = err_p > 1.0
    assert big.sum() >= 2
    torch.testing.assert_close(err_k[big], err_p[big], rtol=1e-2, atol=0)
    assert float(err_k[-1]) <= 1e-2 * float(err_k[0])


def _gnc10(device, fleet=None):
    """perfbench's intel-1728-gnc10 (310 of 3103 closures false) in f32 on
    the card at a guess of its generator: one graph, or a fleet of
    ``fleet`` guesses."""
    from perfbench import harness
    from rustrobotics_tpu_torch.mapping.g2o import graph_from_numpy

    cfg = harness.load_config("intel-1728-gnc10")
    gen = harness.generator(cfg)
    s = gen.structure(cfg)
    g = graph_from_numpy(s["fields"], s["total_dof"], s["prior2"],
                         s["prior3"], device=device, dtype=torch.float32)
    pool = gen.guesses(cfg, s, 2**31 + 7, fleet or 1, device)
    if fleet is None:
        return g.replace(poses2=pool[0])
    return stack_graphs([g.replace(poses2=p) for p in pool])


def _gnc_mu(graph, at):
    """GNC's μ as the LM loops pass it at iteration 0 (μ0), 6 of 12 and
    past 12 (1): a 0-d tensor for one graph, one a fleet row."""
    from rustrobotics_tpu_torch.mapping import pgo

    mu0 = pgo.gnc_mu0(graph, 1.0)
    it = {"mu0": 0, "mid": 6, "one": 13}[at]
    if graph.batch_shape:
        it = torch.full(graph.batch_shape, it, device=graph.device)
    return pgo._gnc_mu(mu0, it, pgo.gnc_iterations(20))


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [None, 16])
@pytest.mark.parametrize("at", ["mu0", "mid", "one"])
def test_gnc_linearize_matches_plain(cuda_device, fleet, at):
    """Under GNC Geman-McClure on intel-1728-gnc10 (one graph, a fleet of
    16), at μ0, at μ halfway and at μ = 1: system_values runs the robust
    kernel once and gives system_values_plain's vals bit for bit (the same
    f32 operations: the weight (s / (c² + s))² with torch's pow(q, 2) =
    q q, then each block entry times it); b bit for bit the plain
    version's plan-order gather of the weighted parts; χ² unweighted,
    within 1e-5 of the plain path's; the same bits on a second call."""
    graph = _gnc10(cuda_device, fleet)
    mu = _gnc_mu(graph, at)
    lam = 0.01 if fleet is None else torch.full((fleet,), 0.01,
                                                device=cuda_device)
    kw = dict(robust="gnc-gm", robust_delta=1.0, mu=mu)
    plan = build_layout(graph).linearize_plan.to(cuda_device)
    vals_p, b_p, chi2_p = assemble.system_values_plain(graph, lam, **kw)
    before = lk.LAUNCHES["se2_linearize"]
    got = system_values(graph, lam, plan=plan, **kw)
    again = system_values(graph, lam, plan=plan, **kw)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["se2_linearize"] == before + 2
    vals_k, b_k, chi2_k = got
    assert torch.equal(vals_k.view(torch.int32), vals_p.view(torch.int32))
    _, b_m, _ = lk.se2_linearize_plain(graph, lam, assemble.PRIOR_WEIGHT,
                                       plan, **kw)
    assert torch.equal(b_k.view(torch.int32), b_m.view(torch.int32))
    torch.testing.assert_close(chi2_k, chi2_p, rtol=1e-5, atol=0)
    for x, first in zip(again, got):
        assert torch.equal(x, first)


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [None, 16])
@pytest.mark.parametrize("form", ["number", "none", "tensor"])
def test_gnc_kernels_take_every_form_of_mu(cuda_device, fleet, form):
    """At δ = 1.5, with μ a number (pgo.optimize's form), None (1) or a
    tensor (the LM loops'), on intel-1728-gnc10 (one graph, a fleet of
    16): system_values runs the robust kernel and gives
    system_values_plain's vals bit for bit and the plain version's
    plan-order b bit for bit, χ² within 1e-5; the cost kernel's sums at
    the trial and at the current graph lie within 1e-5 of its plain
    version's."""
    graph = _gnc10(cuda_device, fleet)
    mu = _gnc_mu(graph, "mid")
    mu = {"number": float(mu.reshape(-1)[0]), "none": None,
          "tensor": mu}[form]
    lam = 0.01 if fleet is None else torch.full((fleet,), 0.01,
                                                device=cuda_device)
    kw = dict(robust="gnc-gm", robust_delta=1.5, mu=mu)
    plan = build_layout(graph).linearize_plan.to(cuda_device)
    vals_p, _, chi2_p = assemble.system_values_plain(graph, lam, **kw)
    before = lk.LAUNCHES["se2_linearize"]
    vals_k, b_k, chi2_k = system_values(graph, lam, plan=plan, **kw)
    torch.cuda.synchronize()
    assert lk.LAUNCHES["se2_linearize"] == before + 1
    assert torch.equal(vals_k.view(torch.int32), vals_p.view(torch.int32))
    _, b_m, _ = lk.se2_linearize_plain(graph, lam, assemble.PRIOR_WEIGHT,
                                       plan, **kw)
    assert torch.equal(b_k.view(torch.int32), b_m.view(torch.int32))
    torch.testing.assert_close(chi2_k, chi2_p, rtol=1e-5, atol=0)
    trial = graph.replace(poses2=graph.poses2 + 1e-3)
    got = lk.se2_cost_kernel(trial, current=graph, **kw)
    want = lk.se2_cost_plain(trial, current=graph, **kw)
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_gnc_kernel_at_unit_weights_is_the_gn_kernel(cuda_device):
    """On intel-1728-gnc10's odometry chain alone, where GNC weighs no
    edge (robust_edges="closures"), the robust kernel gives the least
    squares kernel's vals, b and χ² bit for bit: one edge body, the GN
    form's operations unchanged."""
    g = _gnc10(cuda_device, 4)
    odo = (g.pp_to - g.pp_from).abs() == 1
    g = g.replace(pp_from=g.pp_from[odo], pp_to=g.pp_to[odo],
                  pp_z=g.pp_z[..., odo, :], pp_omega=g.pp_omega[..., odo, :, :])
    plan = build_layout(g).linearize_plan.to(cuda_device)
    gn = system_values(g, 0.01, plan=plan)
    gnc = system_values(g, 0.01, plan=plan, robust="gnc-gm",
                        mu=_gnc_mu(g, "mu0"))
    for x, y in zip(gnc, gn):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [None, 16])
@pytest.mark.parametrize("robust", [None, "gnc-gm"])
def test_lm_cost_matches_global_error(cuda_device, fleet, robust):
    """The cost kernel, one launch a call, against the tensor code of
    global_error and robust_global_cost (another arithmetic for e^T Ω e
    and torch.sum's order against a fixed one: 1e-5 relative) at the trial
    and at the current graph; equal nodes give equal sums bit for bit;
    pgo's functions take the kernel."""
    from rustrobotics_tpu_torch.mapping import pgo

    cur = _gnc10(cuda_device, fleet)
    trial = cur.replace(poses2=cur.poses2 + 1e-3)
    mu = _gnc_mu(cur, "mid") if robust else None
    before = lk.LAUNCHES["se2_lm_cost"]
    chi2, rho, rho_cur = lk.se2_cost_kernel(
        trial, robust, 1.0, mu, current=cur if robust else None)
    assert lk.LAUNCHES["se2_lm_cost"] == before + 1
    close = dict(rtol=1e-5, atol=0)

    def tensor_chi2(g):
        return sum(c.sum(-1) for c in pgo._edge_chi2(g))

    torch.testing.assert_close(chi2, tensor_chi2(trial), **close)
    assert torch.equal(pgo.global_error(trial), chi2)
    if robust is None:
        assert rho is None and rho_cur is None
        return
    for got, g in ((rho, trial), (rho_cur, cur)):
        c_pp, _, _ = pgo._edge_chi2(g)
        want = torch.where(assemble.odometry(g.pp_from, g.pp_to), c_pp,
                           assemble.robust_rho(robust, c_pp, 1.0, mu=mu))
        torch.testing.assert_close(got, want.sum(-1), **close)
    assert torch.equal(pgo.robust_global_cost(trial, robust, 1.0, mu=mu),
                       rho)
    _, same, same_cur = lk.se2_cost_kernel(trial, robust, 1.0, mu,
                                           current=trial)
    assert torch.equal(same, same_cur) and torch.equal(same, rho)


@pytest.mark.cuda
def test_lm_gnc_fleet_runs_the_kernels(cuda_device, monkeypatch):
    """make_optimize_batch, LM 20 with gnc-gm on banded-kernel, on a fleet
    of 4 of intel-1728-gnc10 (the cell's request, narrower): the robust
    kernel once an iteration, the cost kernel once an iteration and once
    for the guess's χ², and every row rejects the outliers (inlier χ²
    below 1e-2) as the tensor code's run does."""
    from rustrobotics_tpu_torch.mapping import pgo

    fleet = _gnc10(cuda_device, 4)
    run = make_optimize_batch(fleet, num_iterations=20, solver="lm",
                              tolerance=0.0, backend="banded-kernel",
                              robust="gnc-gm", robust_delta=1.0)
    before = dict(lk.LAUNCHES)
    out_k, err_k, it = run(fleet)
    torch.cuda.synchronize()
    assert it.tolist() == [20] * 4
    assert lk.LAUNCHES["se2_linearize"] == before["se2_linearize"] + 20
    assert lk.LAUNCHES["se2_lm_cost"] == before["se2_lm_cost"] + 21
    monkeypatch.setattr(lk, "takes_kernel", lambda *args: False)
    out_p, err_p, _ = run(fleet)
    torch.testing.assert_close(err_k[:, 0], err_p[:, 0], rtol=1e-5, atol=0)
    from perfbench import harness

    cfg = harness.load_config("intel-1728-gnc10")
    outlier = torch.as_tensor(harness.generator(cfg).structure(cfg)[
        "outlier"], device=cuda_device)
    for out in (out_k, out_p):
        c_pp, _, _ = pgo._edge_chi2(out)
        assert bool((c_pp[:, ~outlier].sum(-1) < 1e-2).all()), c_pp.shape
