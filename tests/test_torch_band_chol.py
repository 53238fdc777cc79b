"""The port's banded solver against the JAX package: host plan, band
assembly, the triangular routines, the plain chain of the CUDA kernels
against the XLA chain (f64) and against the Pallas kernels in interpret
mode (f32), and the whole kernel solve against the f64 host solve.

The CUDA kernels themselves run only on a card: see
tests/test_torch_kernels_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping.assemble import build_layout as jbuild_layout
from rustrobotics_tpu.mapping.assemble import system_values as jsystem_values
from rustrobotics_tpu.mapping.solvers import solve_host
from rustrobotics_tpu.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu.ops import band_chol as jbc
from rustrobotics_tpu.ops import batched_tri as jtri
from rustrobotics_tpu.ops.band_chol_pallas import (
    factorize_pallas,
    solve_band_pallas,
    substitute_pallas,
)
from rustrobotics_tpu_torch.mapping.assemble import build_layout, system_values
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    graph_from_numpy,
)
from rustrobotics_tpu_torch.mapping.solvers import make_banded_kernel
from rustrobotics_tpu_torch.mapping.synthetic import _to_graph
from rustrobotics_tpu_torch.ops import band_chol as tbc
from rustrobotics_tpu_torch.ops import band_chol_kernels as bk
from rustrobotics_tpu_torch.ops import batched_tri as ttri


@pytest.fixture(scope="module")
def sys_():
    """Corridor graph (n=776, kb=256, nb=4): JAX and port layouts and the
    f64 normal equations of each."""
    ref = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=32)
    fields = {n: np.asarray(getattr(ref, n)) for n in FLOAT_FIELDS + INDEX_FIELDS}
    port = graph_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                            device="cpu")
    jlay = jbuild_layout(ref)
    jbl = jbc.build_band_chol(jlay)
    jvals, jb, _ = jsystem_values(ref, jnp.asarray(0.0))
    lay = build_layout(port)
    bl = tbc.build_band_chol(lay)
    vals, b, _ = system_values(port, 0.0)
    return dict(jlay=jlay, jbl=jbl, jvals=jvals, jb=jb, lay=lay, bl=bl,
                vals=vals, b=b)


def rel_to_max(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_build_band_chol_identical(sys_):
    jbl, bl = sys_["jbl"], sys_["bl"]
    assert (bl.n, bl.kb, bl.nb, bl.q, bl.strips_ok) == (
        jbl.n, jbl.kb, jbl.nb, jbl.q, jbl.strips_ok)
    assert (bl.kb, bl.nb) == (256, 4)
    for name in ("perm", "inv_perm", "sel", "flat_idx", "pad_rows"):
        np.testing.assert_array_equal(getattr(bl, name), getattr(jbl, name),
                                      err_msg=name)
    dev = bl.to("cpu")
    np.testing.assert_array_equal(dev.perm.numpy(), jbl.perm)


def test_prepare_blocks_match(sys_):
    want_r, want_d = jbc._prepare_blocks(sys_["jbl"], sys_["jvals"])
    got_r, got_d = tbc._prepare_blocks(sys_["bl"], sys_["vals"])
    assert rel_to_max(got_r.numpy(), want_r) < 1e-12
    assert rel_to_max(got_d.numpy(), want_d) < 1e-12


def _spd(seed, batch=2, n=256):
    m = np.random.default_rng(seed).normal(size=(batch, n, n))
    return m @ np.swapaxes(m, -1, -2) / n + np.eye(n)


@pytest.mark.parametrize("blocked", [False, True])
def test_chol_and_tril_inv_match(blocked):
    a = _spd(1)
    want_l = np.asarray(jtri.chol_blocked(jnp.asarray(a), blocked=blocked))
    got_l = ttri.chol_blocked(torch.as_tensor(a), blocked=blocked).numpy()
    assert rel_to_max(got_l, want_l) < 1e-10
    want_i = np.asarray(jtri.tril_inv(jnp.asarray(want_l), blocked=blocked))
    got_i = ttri.tril_inv(torch.tensor(want_l), blocked=blocked).numpy()
    assert rel_to_max(got_i, want_i) < 1e-10


def test_cholesky_breakdown_is_nan():
    a = -torch.eye(4, dtype=torch.float64)
    assert torch.isnan(ttri.chol_blocked(a)).all()


def _chain_inputs(sys_, dtype):
    r_blocks, dinv = tbc._prepare_blocks(sys_["bl"], sys_["vals"].to(dtype))
    return tbc.split_blocks(r_blocks), r_blocks, dinv


def test_factorize_plain_matches_xla_chain(sys_):
    (dsym, lcoup), _, _ = _chain_inputs(sys_, torch.float64)
    jr, _ = jbc._prepare_blocks(sys_["jbl"], sys_["jvals"])
    _, j_ldinv, j_lps = jbc._factorize_inv(jr)
    ldinv, lp = bk.factorize_plain(dsym, lcoup)
    assert rel_to_max(ldinv.numpy(), j_ldinv) < 1e-8
    assert float(lp[0].abs().max()) == 0.0
    assert rel_to_max(lp[1:].numpy(), j_lps) < 1e-8


def test_substitute_plain_matches_xla_chain(sys_):
    jr, jd = jbc._prepare_blocks(sys_["jbl"], sys_["jvals"])
    _, j_ldinv, j_lps = jbc._factorize_inv(jr)
    bp = np.random.default_rng(2).normal(size=(sys_["bl"].nb, sys_["bl"].kb))
    want = jbc.band_substitute_inv(j_ldinv, j_lps, jnp.asarray(bp))
    lp = np.concatenate([np.zeros_like(np.asarray(j_lps[:1])),
                         np.asarray(j_lps)])
    got = bk.substitute_plain(torch.tensor(np.asarray(j_ldinv)),
                              torch.as_tensor(lp), torch.as_tensor(bp))
    assert rel_to_max(got.numpy(), want) < 1e-8


@pytest.fixture(scope="module")
def wide_band():
    """A random well-conditioned band at kb=768, nb=3, f64: past the TPU
    kernels' kb <= 512 and inside the CUDA kernels' range. Diagonal
    blocks M M^T / kb + 2 I, couplings N(0, 0.3² / kb), coupling 0 zero;
    the JAX chain's (nb, kb, 2kb) block rows are [coupling | diagonal]."""
    nb, kb = 3, 768
    rng = np.random.default_rng(5)
    m = rng.normal(size=(nb, kb, kb))
    dsym = m @ np.swapaxes(m, -1, -2) / kb + 2.0 * np.eye(kb)
    lcoup = rng.normal(scale=0.3 / np.sqrt(kb), size=(nb, kb, kb))
    lcoup[0] = 0.0
    bp = rng.normal(size=(nb, kb))
    jr = jnp.asarray(np.concatenate([lcoup, dsym], axis=-1))
    _, j_ldinv, j_lps = jbc._factorize_inv(jr)
    return dict(dsym=dsym, lcoup=lcoup, bp=bp, j_ldinv=j_ldinv, j_lps=j_lps)


def test_factorize_plain_matches_xla_chain_kb768(wide_band):
    ldinv, lp = bk.factorize_plain(torch.as_tensor(wide_band["dsym"]),
                                   torch.as_tensor(wide_band["lcoup"]))
    assert rel_to_max(ldinv.numpy(), wide_band["j_ldinv"]) < 1e-8
    assert float(lp[0].abs().max()) == 0.0
    assert rel_to_max(lp[1:].numpy(), wide_band["j_lps"]) < 1e-8


def test_substitute_plain_matches_xla_chain_kb768(wide_band):
    j_ldinv, j_lps = wide_band["j_ldinv"], wide_band["j_lps"]
    want = jbc.band_substitute_inv(j_ldinv, j_lps,
                                   jnp.asarray(wide_band["bp"]))
    lp = np.concatenate([np.zeros_like(np.asarray(j_lps[:1])),
                         np.asarray(j_lps)])
    got = bk.substitute_plain(torch.tensor(np.asarray(j_ldinv)),
                              torch.as_tensor(lp),
                              torch.as_tensor(wide_band["bp"]))
    assert rel_to_max(got.numpy(), want) < 1e-8


def test_solve_band_chol_f64_matches(sys_):
    want = jbc.solve_band_chol(sys_["jbl"], sys_["jvals"], sys_["jb"])
    got = tbc.solve_band_chol(sys_["bl"], sys_["vals"], sys_["b"])
    assert rel_to_max(got.numpy(), want) < 1e-9


def test_solve_band_kernel_cpu_within_f32_class(sys_):
    """solve_band_kernel on CPU tensors (the plain chain, f32 inside) and
    the Pallas solve in interpret mode both land within the f32 XLA
    chain's class of error against the f64 host solve."""
    x_true = np.asarray(solve_host(sys_["jlay"], sys_["jvals"], sys_["jb"]))
    scale = np.abs(x_true).max()
    x_chain = np.asarray(jbc.solve_band_chol(
        sys_["jbl"], sys_["jvals"].astype(jnp.float32),
        sys_["jb"].astype(jnp.float32)))
    x_pal = np.asarray(solve_band_pallas(sys_["jbl"], sys_["jvals"],
                                         sys_["jb"], interpret=True))
    x_port = bk.solve_band_kernel(sys_["bl"], sys_["vals"], sys_["b"])
    assert x_port.dtype == torch.float64
    tol = max(4.0 * np.abs(x_chain - x_true).max() / scale, 1e-4)
    assert np.abs(x_port.numpy() - x_true).max() / scale < tol
    assert np.abs(x_pal - x_true).max() / scale < tol


def test_factorize_plain_matches_pallas_f32(sys_):
    (dsym, lcoup), _, _ = _chain_inputs(sys_, torch.float32)
    jr, _ = jbc._prepare_blocks(sys_["jbl"], sys_["jvals"].astype(jnp.float32))
    j_ldinv, j_lp = factorize_pallas(jr, interpret=True)
    ldinv, lp = bk.factorize_plain(dsym, lcoup)
    kb = sys_["bl"].kb
    # the port's Cholesky factors: inverses of its ldinv, in f64
    eye = torch.eye(kb, dtype=torch.float64).expand(ldinv.shape)
    ld_port = torch.linalg.solve_triangular(ldinv.double(), eye, upper=False)
    prod = np.asarray(j_ldinv, np.float64) @ ld_port.numpy()
    assert np.abs(prod - np.eye(kb)).max() <= 1e-2
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=5e-3)


def _random_factor(nb, kb, seed):
    """Well-conditioned f32 inputs of the substitution: unit-ish lower
    triangular ldinv, small lp (lp[0] = 0), N(0, 1) right-hand side."""
    rng = np.random.default_rng(seed)
    ldinv = np.tril(rng.normal(scale=0.05 / np.sqrt(kb), size=(nb, kb, kb)))
    ldinv += np.eye(kb)
    lp = rng.normal(scale=0.1 / np.sqrt(kb), size=(nb, kb, kb))
    lp[0] = 0.0
    bp = rng.normal(size=(nb, kb))
    return (ldinv.astype(np.float32), lp.astype(np.float32),
            bp.astype(np.float32))


def test_substitute_plain_matches_pallas_f32():
    ldinv, lp, bp = _random_factor(3, 256, 3)
    want = substitute_pallas(jnp.asarray(ldinv), jnp.asarray(lp),
                             jnp.asarray(bp), interpret=True)
    got = bk.substitute_plain(torch.as_tensor(ldinv), torch.as_tensor(lp),
                              torch.as_tensor(bp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _star_layout(num_poses):
    """Pose 0 tied to every other pose: RCM cannot narrow that band."""
    z, omega = np.zeros(3), np.eye(3)
    pp = (np.zeros(num_poses - 1, np.int64), np.arange(1, num_poses),
          [z] * (num_poses - 1), [omega] * (num_poses - 1))
    graph = _to_graph(np.zeros((num_poses, 3)), np.zeros((0, 2)), pp,
                      ([], [], [], []), num_poses, 0, torch.float64, "cpu")
    return build_layout(graph)


def test_kernel_gate(sys_):
    # the kernels take every kb that build_band_chol gives; beyond its
    # bandwidth limit the caller gets None and takes the dense solve
    assert make_banded_kernel(sys_["lay"], device="cpu") is not None
    wide = _star_layout(1400)
    assert tbc.build_band_chol(wide) is None
    assert make_banded_kernel(wide, device="cpu") is None


def test_wrappers_take_plain_only_on_cpu():
    ldinv, lp, bp = (torch.as_tensor(a) for a in _random_factor(2, 128, 4))
    torch.testing.assert_close(bk.substitute_kernel(ldinv, lp, bp),
                               bk.substitute_plain(ldinv, lp, bp))
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        bk.substitute_kernel(ldinv.to("meta"), lp.to("meta"), bp.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        bk.factorize_kernel(ldinv.to("meta"), lp.to("meta"))
    assert bk.LAUNCHES == before


def test_strip_plan_identical(sys_):
    jbl, bl = sys_["jbl"], sys_["bl"]
    assert bl.strips_ok and bl.strip_count == jbl.strip_count > 0
    for name in ("strip_src", "strip_seg", "strip_row", "strip_c0"):
        np.testing.assert_array_equal(getattr(bl, name), getattr(jbl, name),
                                      err_msg=name)


@pytest.mark.parametrize("mode", ["strips", "sorted"])
def test_prepare_blocks_scatter_modes_match(sys_, monkeypatch, mode):
    """_prepare_blocks under each scatter mode against the JAX package's
    under the same mode (to 1e-12 of the largest entry), and bit-equal to
    the port's own "add" band."""
    want_r, want_d = jbc._prepare_blocks(sys_["jbl"], sys_["jvals"])
    add_r, add_d = tbc._prepare_blocks(sys_["bl"], sys_["vals"])
    monkeypatch.setattr(jbc, "BAND_SCATTER_MODE", mode)
    monkeypatch.setattr(tbc, "BAND_SCATTER_MODE", mode)
    mode_r, _ = jbc._prepare_blocks(sys_["jbl"], sys_["jvals"])
    got_r, got_d = tbc._prepare_blocks(sys_["bl"], sys_["vals"])
    assert rel_to_max(got_r.numpy(), mode_r) < 1e-12
    assert rel_to_max(got_r.numpy(), want_r) < 1e-12
    assert rel_to_max(got_d.numpy(), want_d) < 1e-12
    torch.testing.assert_close(got_r, add_r, rtol=0, atol=0)
    torch.testing.assert_close(got_d, add_d, rtol=0, atol=0)
    # a fleet's batch axis: each row its graph's band
    vals2 = torch.stack([sys_["vals"], 2.0 * sys_["vals"]])
    batch_r, _ = tbc._prepare_blocks(sys_["bl"], vals2)
    torch.testing.assert_close(batch_r[0], add_r, rtol=0, atol=0)


@pytest.mark.parametrize("unroll_max_nb", [64, 2])
def test_solve_band_chol_trsm_matches(sys_, monkeypatch, unroll_max_nb):
    """SUBSTITUTE_MODE = "trsm" (the triangular-solve chain; its stacked
    form when nb > UNROLL_MAX_NB) against the JAX package's, f64."""
    for module in (jbc, tbc):
        monkeypatch.setattr(module, "SUBSTITUTE_MODE", "trsm")
        monkeypatch.setattr(module, "UNROLL_MAX_NB", unroll_max_nb)
    want = jbc.solve_band_chol(sys_["jbl"], sys_["jvals"], sys_["jb"])
    got = tbc.solve_band_chol(sys_["bl"], sys_["vals"], sys_["b"])
    assert rel_to_max(got.numpy(), want) < 1e-9
    monkeypatch.setattr(tbc, "SUBSTITUTE_MODE", "inv")
    inv = tbc.solve_band_chol(sys_["bl"], sys_["vals"], sys_["b"])
    assert rel_to_max(got.numpy(), inv.numpy()) < 1e-9
