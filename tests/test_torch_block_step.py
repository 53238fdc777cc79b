"""The port's map-block GN step (``parallel.pgo_blocks.make_block_step``)
against the JAX package's on the same inputs, f64.

JAX runs on sub-meshes of the 8 virtual CPU devices (``conftest``,
``make_mesh(D, axis="blocks")``); the port runs as gloo ranks over a
``file://`` store (``test_torch_blocks_worker.py``, which imports no
JAX), started once a world size (1, 2, 4) for the module and running
every case of ``STEP_CASES`` while JAX computes. Each case names the
branch it takes (``test_cases_take_their_branch``):

- ``overlap``: the corridor at D = 2, 8h <= ndof: the overlapped matvec;
- ``jacobi_*``, ``schwarz2``, ``schur`` at D = 2 on the circle: h <= ndof
  < 8h: the plain exchange-then-multiply matvec, the coarse space engaged;
- ``multihop_*`` at D = 4: h > ndof, so the halos take ceil(h/ndof) hops
  (and schwarz2 falls back to Schwarz);
- ``se3``: a 5 x 5 SE3 sphere at D = 2.

Tolerances: dx (through ``dx_to_reference``) within 1e-10 of its largest
entry of JAX's, χ² within 1e-10 relative; both solve to cg_tol 1e-13, so
the difference is the two programs' rounding.

The module's helpers (the JAX graphs, the inputs' file) serve the other
block test files too.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_blocks_worker as W
from rustrobotics_tpu.mapping import g2o as jg2o
from rustrobotics_tpu.mapping.synthetic import (
    synthetic_corridor_graph_2d,
    synthetic_pose_graph_2d,
)
from rustrobotics_tpu.parallel.block_layout import build_block_layout
from rustrobotics_tpu.parallel.mesh import make_mesh
from rustrobotics_tpu.parallel.pgo_blocks import (
    dx_to_reference,
    layout_device_arrays,
    make_block_step,
)
from rustrobotics_tpu_torch.mapping.g2o import FLOAT_FIELDS, INDEX_FIELDS

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLDS = (1, 2, 4)
TOL = 1e-10


def _noisy(g, seed):
    """g with its measured translations given noise, so that the χ² stays
    well above f64's rounding as the optimizer converges."""
    rng = np.random.default_rng(seed)
    up = {}
    for field, cols in (("pp_z", 2), ("pl_z", 2), ("qq_z", 3)):
        z = np.asarray(getattr(g, field)).copy()
        if z.shape[0]:
            z[:, :cols] += rng.normal(scale=0.05, size=(z.shape[0], cols))
        up[field] = jnp.asarray(z)
    return g.replace(**up)


def jax_graphs(directory):
    """The block tests' graphs as JAX graphs: ``circle`` (24 poses, 3
    landmarks), ``corridor`` (96 poses, closures 8 apart: a narrow band)
    and ``sphere`` (a 5 x 5 SE3 sphere, chip_smoke.sphere_graph)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    path = pathlib.Path(directory) / "sphere-25.g2o"
    path.write_text(cs.g2o_text(cs.sphere_graph(rings=5, per_ring=5,
                                                seed=2)))
    return {
        "circle": _noisy(synthetic_pose_graph_2d(
            num_poses=24, num_landmarks=3, noise=0.1, seed=0,
            dtype=jnp.float64), 5),
        "corridor": _noisy(synthetic_corridor_graph_2d(
            num_poses=96, closure_span=8, num_landmarks=0,
            dtype=jnp.float64), 6),
        "sphere": _noisy(jg2o.load_g2o(str(path)), 7),
    }


def graph_inputs(graphs):
    """The graphs' arrays under ``{name}_{field}`` for the ranks."""
    out = {}
    for name, g in graphs.items():
        out.update({f"{name}_{k}": np.asarray(getattr(g, k))
                    for k in FLOAT_FIELDS + INDEX_FIELDS})
        out.update({f"{name}_total_dof": g.total_dof,
                    f"{name}_prior2": g.prior2, f"{name}_prior3": g.prior3})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("block_step")
    graphs = jax_graphs(d)
    np.savez(d / "in.npz", **graph_inputs(graphs))
    procs = W.spawn("step", WORLDS, d, d / "in.npz")
    try:
        ref = {}
        for name, gname, dev, kw in W.STEP_CASES:
            kw = dict(kw)
            schur = kw.pop("schur", False)
            layout = build_block_layout(graphs[gname], dev, schur=schur)
            state, edges, maps = layout_device_arrays(layout, jnp.float64)
            solve = make_block_step(make_mesh(dev, axis="blocks"), layout,
                                    cg_tol=W.STEP_CG_TOL, **kw)
            dx, chi2 = solve(state, edges, maps, jnp.asarray(W.STEP_LAM))
            ref[(name, dev)] = (dx_to_reference(layout, dx), float(chi2))
    finally:
        port = W.collect(procs, "step", WORLDS, d)
    return graphs, ref, port


@pytest.mark.parametrize("name,gname,dev", [c[:3] for c in W.STEP_CASES],
                         ids=[f"{c[0]}-D{c[2]}" for c in W.STEP_CASES])
def test_block_step_matches_jax(runs, name, gname, dev):
    _, ref, port = runs
    dx_ref, chi2_ref = ref[(name, dev)]
    assert np.abs(dx_ref).max() > 1e-3  # a real step
    for rank in range(dev):  # every rank holds the gathered dx
        got = port[(dev, rank)]
        np.testing.assert_allclose(got[f"{name}_dx"], dx_ref, rtol=0,
                                   atol=TOL * np.abs(dx_ref).max())
        np.testing.assert_allclose(got[f"{name}_chi2"], chi2_ref, rtol=TOL,
                                   atol=0)


def test_cases_take_their_branch(runs):
    """Which halo path and preconditioner each case exercises."""
    graphs, _, _ = runs
    lay = {(g, d, s): build_block_layout(graphs[g], d, schur=s)
           for g, d, s in (("corridor", 2, False), ("circle", 2, False),
                           ("circle", 2, True), ("circle", 4, False),
                           ("circle", 4, True), ("sphere", 2, False))}
    c = lay[("corridor", 2, False)]
    assert 0 < 8 * c.h <= c.ndof  # overlapped matvec
    for key in (("circle", 2, False), ("circle", 2, True),
                ("sphere", 2, False)):
        lo = lay[key]
        assert 8 * lo.h > lo.ndof and lo.h <= lo.ndof  # plain, one hop
    for key in (("circle", 4, False), ("circle", 4, True)):
        lo = lay[key]
        assert -(-lo.h // lo.ndof) > 1  # multi-hop halos
    assert np.asarray(graphs["sphere"].poses3).shape[0] == 25
