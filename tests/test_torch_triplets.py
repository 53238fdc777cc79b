"""The port's device-side triplet generation against the JAX package's, f64
on the CPU: a 2D corridor with landmarks and a 3D sphere. rows and cols
equal; vals, b and χ² to 1e-12 relative to their largest entry."""

import importlib.util
import pathlib

import numpy as np
import pytest

from rustrobotics_tpu.mapping import g2o as jg2o
from rustrobotics_tpu.mapping import synthetic as jsyn
from rustrobotics_tpu.mapping import triplets as jtrip
from rustrobotics_tpu_torch.mapping import g2o as tg2o
from rustrobotics_tpu_torch.mapping import synthetic as tsyn
from rustrobotics_tpu_torch.mapping import triplets as ttrip

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-12


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", params=["corridor", "sphere"])
def graphs(request, tmp_path_factory):
    if request.param == "corridor":
        args = dict(num_poses=120, num_landmarks=5, closure_span=24, seed=4)
        return (jsyn.synthetic_corridor_graph_2d(**args),
                tsyn.synthetic_corridor_graph_2d(**args, device="cpu"))
    cs = load_chip_smoke()
    path = tmp_path_factory.mktemp("trip") / "sphere.g2o"
    path.write_text(cs.g2o_text(cs.sphere_graph(rings=4, per_ring=6,
                                                seed=5)))
    return jg2o.load_g2o(str(path)), tg2o.load_g2o(str(path), device="cpu")


def test_edge_triplets_match(graphs):
    ref, port = graphs
    want = jtrip.graph_edge_triplets(ref)
    got = ttrip.graph_edge_triplets(port)
    for name, g, w in zip(("rows", "cols"), got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    for name, g, w in zip(("vals", "b", "chi2"), got[2:], want[2:]):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max(), err_msg=name)
    assert float(got[4]) > 0  # the graphs start off their optimum


def test_block_idx_edge_major():
    import torch

    r, c = ttrip._block_idx(torch.tensor([0, 10]), torch.tensor([5, 20]),
                            2, 3)
    jr, jc = jtrip._block_idx(np.array([0, 10]), np.array([5, 20]), 2, 3)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
