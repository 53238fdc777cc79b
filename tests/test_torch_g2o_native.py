"""The port's native C++ g2o parser and ``load_g2o_with_meta`` against its
Python tokenizer and the JAX package's parser: bit-identical arrays and
G2OMeta on a 2D corridor with landmarks and on a small 3D sphere, the
native parser's rejection of unknown records, forward edge references,
and its build into the port's ``_build/`` (never ``native/libg2o.so``)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from rustrobotics_tpu.mapping import g2o as jg2o
from rustrobotics_tpu_torch.mapping import g2o as tg2o
from rustrobotics_tpu_torch.mapping import g2o_native as tnat
from rustrobotics_tpu_torch.mapping.synthetic import (
    synthetic_corridor_graph_2d,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_LIB = ROOT / "native" / "libg2o.so"


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = load_chip_smoke()


def _stat(path):
    return path.stat().st_mtime_ns if path.exists() else None


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("g2o")
    corridor = d / "corridor.g2o"
    corridor.write_text(cs.g2o_text(cs.graph_spec(synthetic_corridor_graph_2d(
        200, num_landmarks=6, closure_span=24, device="cpu"))))
    sphere = d / "sphere.g2o"
    sphere.write_text(cs.g2o_text(cs.sphere_graph(rings=4, per_ring=8,
                                                  seed=2)))
    return {"corridor": corridor, "sphere": sphere}


def test_native_builds_into_the_package():
    before = _stat(JAX_LIB)
    assert tnat.native_available()
    lib = tnat._build()
    assert lib.parent == ROOT / "rustrobotics_tpu_torch" / "_build"
    assert lib.name.startswith("libg2o-")
    assert tnat.SOURCE == ROOT / "native" / "g2o_parser.cpp"
    assert _stat(JAX_LIB) == before


def assert_same_dict(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, (int, np.integer)):
            assert int(got[k]) == int(v), k
        else:
            assert got[k].dtype == v.dtype, k
            assert got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["corridor", "sphere"])
def test_three_parsers_bitwise(files, name):
    path = str(files[name])
    before = _stat(JAX_LIB)
    native = tnat.parse_native(path)
    python = tg2o._parse_python(path)
    graph, meta = tg2o.load_g2o_with_meta(path, device="cpu")
    assert _stat(JAX_LIB) == before  # the port never writes native/
    assert native is not None
    assert_same_dict(native, python)
    assert_same_dict(python, jg2o._parse_python(path))
    if name == "corridor":  # pose-landmark edges interleaved in the file
        assert len(native["pl_file_index"]) and (
            np.diff(native["pp_file_index"]) > 1).any()

    jgraph, jmeta = jg2o.load_g2o_with_meta(path)
    for field in tg2o.FLOAT_FIELDS + tg2o.INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(graph, field).numpy(),
                                      np.asarray(getattr(jgraph, field)),
                                      err_msg=field)
    for field in ("total_dof", "prior2", "prior3"):
        assert getattr(graph, field) == getattr(jgraph, field)
    for field in ("pp_file_index", "pl_file_index", "qq_file_index"):
        np.testing.assert_array_equal(getattr(meta, field),
                                      getattr(jmeta, field), err_msg=field)


def test_python_fallback_when_native_disabled(files, monkeypatch):
    path = str(files["corridor"])
    monkeypatch.setattr(tnat, "_LIB", {})
    monkeypatch.setenv("RUSTROBOTICS_NO_NATIVE", "1")
    assert not tnat.native_available()
    assert tnat.parse_native(path) is None
    graph, meta = tg2o.load_g2o_with_meta(path, device="cpu")
    want, want_meta = tg2o._build_graph(tg2o._parse_python(path),
                                        torch.float64, "cpu")
    np.testing.assert_array_equal(graph.pl_z.numpy(), want.pl_z.numpy())
    np.testing.assert_array_equal(meta.pl_file_index,
                                  want_meta.pl_file_index)


def test_native_rejects_unknown_record(tmp_path):
    """Unknown tags: native returns None; the Python fallback raises."""
    bad = tmp_path / "bad.g2o"
    bad.write_text("VERTEX_SE2 0 0.0 0.0 0.0\nFIXED 0\n")
    assert tnat.parse_native(str(bad)) is None
    with pytest.raises(ValueError, match="unsupported g2o record"):
        tg2o.load_g2o(str(bad), device="cpu")


def test_native_handles_forward_edge_reference(tmp_path):
    """Edges may cite vertices declared later in the file."""
    f = tmp_path / "fwd.g2o"
    f.write_text(
        "EDGE_SE2 0 1 1.0 0.0 0.0 1 0 0 1 0 1\n"
        "VERTEX_SE2 0 0.0 0.0 0.0\n"
        "VERTEX_SE2 1 1.0 0.0 0.0\n"
    )
    dn = tnat.parse_native(str(f))
    dp = tg2o._parse_python(str(f))
    assert dn is not None
    np.testing.assert_array_equal(dn["pp_from"], dp["pp_from"])
    np.testing.assert_array_equal(dn["pp_to"], dp["pp_to"])
    assert dn["prior2"] == dp["prior2"] == 0
