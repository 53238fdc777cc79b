"""The tile plan of the band assembly K4/K5 on the CPU: ``tile_ptr`` cuts
the sorted-scatter plan into the ``ASSEMBLE_TILE``-float tiles that the
kernel's CTAs own, and a numpy walk of that plan, step for step as the
kernel takes it (zero the tile, sum each destination's segment from 0 in
plan order, store the tile), gives the plain version's band bit for bit
and, through ``_prepare_blocks``, the JAX package's scaled block rows.

The kernel itself runs only on a card: tests/test_torch_kernels_card.py
holds it to the plain version bit for bit there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping.assemble import build_layout as jbuild_layout
from rustrobotics_tpu.mapping.synthetic import (
    synthetic_corridor_graph_2d as jcorridor,
)
from rustrobotics_tpu.ops import band_chol as jbc
from rustrobotics_tpu_torch.mapping.assemble import build_layout, system_values
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    graph_from_numpy,
)
from rustrobotics_tpu_torch.mapping.pgo import stack_graphs
from rustrobotics_tpu_torch.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu_torch.ops import band_chol as tbc
from rustrobotics_tpu_torch.ops.band_assemble_kernels import band_assemble_plain

TILE = tbc.ASSEMBLE_TILE

# corridor graphs: (num_poses, num_landmarks, closure_span) -> (kb, nb,
# whether the band ends in padded rows, so its last tile is empty)
PLANS = {
    "kb256": ((1024, 8, 32), (256, 13, True)),
    "kb512": ((640, 8, 160), (512, 4, True)),
    "no-padding": ((256, 0, 32), (256, 3, False)),
}

_PLANS = {}


def plan(name):
    if name not in _PLANS:
        (poses, lms, span), _ = PLANS[name]
        g = synthetic_corridor_graph_2d(poses, num_landmarks=lms,
                                        closure_span=span, device="cpu")
        _PLANS[name] = tbc.build_band_chol(build_layout(g))
    return _PLANS[name]


def tile_walk(bl, vals, reverse=False):
    """K4/K5's walk of the tile plan in numpy, in vals' dtype: vals (...,
    nnz) -> the flat band (..., nb·kb·2kb). ``reverse`` sums each segment
    from its end instead (a wrong order, for the tests' teeth)."""
    v = vals.numpy()
    lead = v.shape[:-1]
    v = v.reshape(-1, v.shape[-1])
    src, seg_ptr, dest, tile_ptr = (np.asarray(a) for a in (
        bl.sel_sorted, bl.seg_ptr, bl.uniq_idx, bl.tile_ptr))
    band = bl.nb * bl.kb * 2 * bl.kb
    out = np.empty((v.shape[0], band), v.dtype)
    for t in range(len(tile_ptr) - 1):
        u = np.arange(tile_ptr[t], tile_ptr[t + 1])
        tile = np.zeros((v.shape[0], TILE), v.dtype)
        first, length = seg_ptr[u], seg_ptr[u + 1] - seg_ptr[u]
        sums = np.zeros((v.shape[0], len(u)), v.dtype)
        for p in range(int(length.max(initial=0))):
            live = length > p
            k = (first + length - 1 - p) if reverse else (first + p)
            sums[:, live] += v[:, src[k[live]]]
        tile[:, dest[u] - t * TILE] = sums
        out[:, t * TILE:(t + 1) * TILE] = tile
    return torch.from_numpy(out.reshape(lead + (band,)))


def bits_equal(a, b):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return a.shape == b.shape and torch.equal(a.view(ints[a.dtype]),
                                              b.view(ints[b.dtype]))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_tile_plan_partitions_destinations(name):
    """tile_ptr is monotone from 0 to len(uniq_idx), and every destination
    of tile t lies in [t·TILE, (t+1)·TILE); the last tile is empty where
    the band ends in padded rows and holds the last diagonal otherwise."""
    bl = plan(name)
    kb, nb, padded = PLANS[name][1]
    assert (bl.kb, bl.nb) == (kb, nb)
    band = nb * kb * 2 * kb
    tp = bl.tile_ptr
    assert tp.dtype == np.int64 and len(tp) == band // TILE + 1
    assert band % TILE == 0
    assert tp[0] == 0 and tp[-1] == len(bl.uniq_idx)
    counts = np.diff(tp)
    assert (counts >= 0).all()
    tile_of = np.repeat(np.arange(len(counts)), counts)
    np.testing.assert_array_equal(bl.uniq_idx // TILE, tile_of)
    assert (bl.n < nb * kb) == padded
    last_diag = (bl.n - 1) * 2 * kb + kb + (bl.n - 1) % kb
    if padded:
        assert counts[-1] == 0
        assert bl.uniq_idx[-1] <= last_diag < band - TILE
    else:
        assert counts[-1] > 0 and bl.uniq_idx[-1] == last_diag
        assert last_diag // TILE == len(counts) - 1
    moved = bl.to("cpu")
    assert moved.tile_ptr.dtype == torch.long
    np.testing.assert_array_equal(moved.tile_ptr.numpy(), tp)


@pytest.fixture(scope="module")
def values():
    """Values the size of the kb = 256 plan's triplet list, three rows,
    magnitudes spread over six decades so that the order of each sum shows
    in its last bits (numpy seed)."""
    bl = plan("kb256")
    nnz = int(bl.sel.max()) + 1
    rng = np.random.default_rng(0)
    return rng.normal(size=(3, nnz)) * 10.0 ** rng.uniform(-3, 3, (3, nnz))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_walk_equals_plain(values, dtype, batch):
    """The kernel's walk gives band_assemble_plain's band bit for bit,
    f32 and f64, one graph and three; summing each segment the other way
    round does not."""
    bl = plan("kb256")
    vals = torch.as_tensor(values[:batch], dtype=dtype)
    if batch == 1:
        vals = vals[0]
    want = band_assemble_plain(bl, vals)
    assert bits_equal(tile_walk(bl, vals), want)
    assert bits_equal(tile_walk(bl.to("cpu"), vals), want)
    assert not bits_equal(tile_walk(bl, vals, reverse=True), want)


@pytest.fixture(scope="module")
def fleet():
    """A JAX corridor graph (n=776, kb=256, nb=4), the port's copy of it
    and of two jittered ones (numpy seed), the port's plan and the f64
    LM-damped triplet values of the three."""
    ref = jcorridor(256, num_landmarks=4, closure_span=32)
    fields = {n: np.asarray(getattr(ref, n)) for n in FLOAT_FIELDS + INDEX_FIELDS}
    rng = np.random.default_rng(1)
    graphs = []
    for jitter in (0.0, 0.05, 0.2):
        f = dict(fields)
        f["poses2"] = fields["poses2"] + rng.normal(0.0, jitter,
                                                    fields["poses2"].shape)
        graphs.append(graph_from_numpy(f, ref.total_dof, ref.prior2,
                                       ref.prior3, device="cpu"))
    bl = tbc.build_band_chol(build_layout(graphs[0]))
    vals, _, _ = system_values(stack_graphs(graphs), 0.01)
    return dict(jbl=jbc.build_band_chol(jbuild_layout(ref)), bl=bl, vals=vals)


@pytest.mark.parametrize("batched", [False, True])
def test_tile_walk_prepare_blocks_matches_jax(fleet, batched):
    """Scaled block rows and scaling from the tile walk's band against the
    JAX package's _prepare_blocks (under jax.vmap for three graphs), f64."""
    bl, jbl = fleet["bl"], fleet["jbl"]
    vals = fleet["vals"] if batched else fleet["vals"][0]
    jvals = jnp.asarray(vals.numpy())
    prep = (jax.vmap(lambda v: jbc._prepare_blocks(jbl, v)) if batched
            else lambda v: jbc._prepare_blocks(jbl, v))
    want_r, want_d = prep(jvals)
    got_r, got_d = tbc._prepare_blocks(bl, vals, tile_walk)
    assert got_r.shape == tuple(want_r.shape)
    for got, want in ((got_r, want_r), (got_d, want_d)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * float(np.abs(want).max()))
