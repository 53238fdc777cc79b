"""No module a run imports has the top-level name jax, jaxlib, flax or
rustrobotics_tpu, compared whole; the reference imports nothing of the
program."""

import ast
import subprocess
import sys

from perfbench import harness


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_banned_names_compared_whole():
    assert harness.banned_modules(["rustrobotics_tpu_torch.mapping.pgo",
                                   "jaxtyping", "torch"]) == []
    assert harness.banned_modules(["rustrobotics_tpu.mapping", "jax.numpy",
                                   "flax", "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "rustrobotics_tpu.mapping"]


def test_sources_import_no_banned_module():
    for path in harness.PKG.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in harness.BANNED, (path, name)
            if "reference" in path.parts:
                assert name.split(".")[0] != "rustrobotics_tpu_torch", path


PROBE = """
import sys
from perfbench import harness
p = harness.plan("intel-solve")
p["config"].update(poses=32, closures=40, max_span=10)
harness.run_cell(p, 5, 0.1, False, "cpu", log=lambda s: None)
print(harness.banned_modules())
import perfbench.reference.gauss_newton
"""

REF_ONLY = """
import sys
import perfbench.reference.gauss_newton
print(sorted({m.split('.')[0] for m in sys.modules}
             & {'rustrobotics_tpu_torch', 'rustrobotics_tpu', 'jax'}))
"""


def test_a_run_loads_no_banned_module():
    for probe, want in ((PROBE, "[]"), (REF_ONLY, "[]")):
        out = subprocess.run([sys.executable, "-c", probe],
                             cwd=harness.ROOT, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip().splitlines()[-1] == want
