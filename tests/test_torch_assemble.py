"""The port's linearization and normal-equation assembly against the JAX
package, f64 on the CPU, on a small corridor graph with landmarks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import assemble as jasm
from rustrobotics_tpu.mapping import linearize as jlin
from rustrobotics_tpu.mapping import pgo as jpgo
from rustrobotics_tpu.mapping.synthetic import synthetic_corridor_graph_2d
from rustrobotics_tpu_torch.mapping import assemble as tasm
from rustrobotics_tpu_torch.mapping import linearize as tlin
from rustrobotics_tpu_torch.mapping import pgo as tpgo
from rustrobotics_tpu_torch.mapping.g2o import (
    FLOAT_FIELDS,
    INDEX_FIELDS,
    graph_from_numpy,
)


def to_port(ref):
    fields = {n: np.asarray(getattr(ref, n)) for n in FLOAT_FIELDS + INDEX_FIELDS}
    return graph_from_numpy(fields, ref.total_dof, ref.prior2, ref.prior3,
                            device="cpu")


@pytest.fixture(scope="module")
def graphs():
    ref = synthetic_corridor_graph_2d(256, num_landmarks=4, closure_span=32)
    return ref, to_port(ref)


def test_build_layout_identical(graphs):
    ref, port = graphs
    want = jasm.build_layout(ref)
    got = tasm.build_layout(port)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    for name in ("dof_block", "dof_pos", "pad_eye", "ell_order", "ell_seg",
                 "ell_pos", "ell_nbr"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for name in ("n", "prior_slice", "lam_slice", "ell_nnz", "ell_width",
                 "n_blocks"):
        assert getattr(got, name) == getattr(want, name), name
    moved = got.to("cpu")
    assert moved.ell_nbr.dtype == torch.int64
    np.testing.assert_array_equal(moved.ell_nbr.numpy(), want.ell_nbr)


@pytest.mark.parametrize("lam", [0.0, 0.37])
def test_system_values_match(graphs, lam):
    ref, port = graphs
    v_ref, b_ref, c_ref = jasm.system_values(ref, jnp.asarray(lam))
    v, b, c = tasm.system_values(port, lam)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-10,
                               atol=1e-10 * float(np.abs(v_ref).max()))
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-10,
                               atol=1e-10 * float(np.abs(b_ref).max()))
    np.testing.assert_allclose(float(c), float(c_ref), rtol=1e-10)
    # λ as a 0-d tensor (the LM device loop) gives the same values
    v_t, _, _ = tasm.system_values(port, torch.tensor(lam, dtype=torch.float64))
    np.testing.assert_array_equal(v_t.numpy(), v.numpy())


def test_dense_hessian_matches(graphs):
    ref, port = graphs
    v_ref, _, _ = jasm.system_values(ref, jnp.asarray(0.0))
    want = np.asarray(jasm.dense_hessian(jasm.build_layout(ref), v_ref))
    layout = tasm.build_layout(port)
    got = tasm.dense_hessian(layout, tasm.system_values(port, 0.0)[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=1e-10 * float(np.abs(want).max()))


def test_apply_update_and_global_error(graphs):
    ref, port = graphs
    dx = np.random.default_rng(0).normal(scale=0.1, size=ref.total_dof)
    want = jasm.apply_update(ref, jnp.asarray(dx))
    got = tasm.apply_update(port, torch.as_tensor(dx))
    np.testing.assert_allclose(got.poses2.numpy(), np.asarray(want.poses2),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(got.landmarks2.numpy(),
                               np.asarray(want.landmarks2), atol=1e-12, rtol=0)
    np.testing.assert_allclose(float(tpgo.global_error(got)),
                               float(jpgo.global_error(want)), rtol=1e-10)


def test_edge_terms_match(graphs):
    ref, port = graphs
    want = jlin.edge_terms_pp(ref.poses2, ref.pp_from, ref.pp_to, ref.pp_z,
                              ref.pp_omega)
    got = tlin.edge_terms_pp(port.poses2, port.pp_from, port.pp_to,
                             port.pp_z, port.pp_omega)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9,
                                   rtol=1e-10)
    want = jlin.edge_terms_pl(ref.poses2, ref.landmarks2, ref.pl_pose,
                              ref.pl_lm, ref.pl_z, ref.pl_omega)
    got = tlin.edge_terms_pl(port.poses2, port.landmarks2, port.pl_pose,
                             port.pl_lm, port.pl_z, port.pl_omega)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9,
                                   rtol=1e-10)


def test_unported_features_raise(graphs):
    """An unknown robust kernel raises ValueError, in the assembly and in
    the robust cost; SE3 edges and the robust kernels run (their parity
    is in tests/test_torch_se3.py and tests/test_torch_robust.py)."""
    _, port = graphs
    with pytest.raises(ValueError, match="robust"):
        tasm.system_values(port, 0.0, robust="tukey")
    with pytest.raises(ValueError, match="robust"):
        tpgo.robust_global_cost(port, "tukey", 1.0)
    v, _, c = tasm.system_values(port, 0.0, robust="huber")
    assert v.shape == tasm.system_values(port, 0.0)[0].shape
    assert float(c) == pytest.approx(float(tpgo.global_error(port)),
                                     rel=1e-12)
