"""The port's map-block layout (``parallel.block_layout``, host numpy copied
from the JAX package's) against the JAX package's: every field of
``BlockLayout`` equal bit for bit, at D in {1, 2, 4, 8}, with and without
Schur elimination, on an SE2 graph with landmarks and an SE3 sphere. The
port reads its graph from tensors (``.cpu().numpy()``); the JAX package
from its arrays. No ranks are involved."""

import dataclasses

import numpy as np
import pytest

from rustrobotics_tpu.parallel.block_layout import (
    build_block_layout as jax_layout,
)
from rustrobotics_tpu_torch.parallel import build_block_layout
from rustrobotics_tpu_torch.parallel.block_layout import BlockLayout
from test_torch_block_step import graph_inputs, jax_graphs
from test_torch_blocks_worker import graph_of


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("block_layout")
    jax = jax_graphs(d)
    inp = graph_inputs(jax)
    return {name: (g, graph_of(inp, name)) for name, g in jax.items()}


@pytest.mark.parametrize("schur", [False, True])
@pytest.mark.parametrize("devices", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["circle", "sphere", "corridor"])
def test_layout_equals_jax(graphs, name, devices, schur):
    jg, pg = graphs[name]
    want = jax_layout(jg, devices, schur=schur)
    got = build_block_layout(pg, devices, schur=schur)
    assert isinstance(got, BlockLayout)
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for field in names:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert a == b, field

