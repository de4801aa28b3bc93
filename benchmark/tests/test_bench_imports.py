"""No module the harness loads on the card is JAX's or ``jpeg_tpu``'s,
and the reference loads nothing of the program at all.  Top-level module
names are compared whole: ``jpeg_tpu_torch`` is not ``jpeg_tpu``."""
from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
PROBE = """
import sys
sys.path.insert(0, {root!r})
{imports}
bad = sorted({{m for m in sys.modules if m.split('.')[0] in {names!r}}})
print(','.join(bad))
"""


def _loaded(imports: str, names) -> list[str]:
    code = PROBE.format(root=ROOT, imports=imports, names=tuple(names))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return [m for m in out.stdout.strip().split(",") if m]


def test_the_harness_loads_no_jax_and_no_jpeg_tpu():
    imports = "\n".join([
        "import benchmark.run, benchmark.control, benchmark.devtrace",
        "import benchmark.drivers.stream_encode",
        "import benchmark.drivers.batch_decode",
        "import benchmark.drivers.sharded_encode",
        "from benchmark import harness",
        "spec = harness.load_spec()",
        "[harness.load_cell(spec, w['name']) for w in spec['workloads']]",
        "import jpeg_tpu_torch, jpeg_tpu_torch.parallel.sharded",
        "import jpeg_tpu_torch.pipelines.speculative",
    ])
    assert _loaded(imports, harness.FORBIDDEN) == []


def test_the_reference_loads_nothing_of_the_program():
    imports = ("import benchmark.reference.check, "
               "benchmark.reference.decode, benchmark.reference.jpeg")
    assert _loaded(imports, harness.FORBIDDEN + ("jpeg_tpu_torch",
                                                 "torch")) == []


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(BENCH, "reference", "*.py"))))
def test_the_reference_sources_import_only_numpy(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops = [] if node.level else [node.module.split(".")[0]]
        else:
            continue
        assert set(tops) <= {"numpy", "dataclasses", "__future__"}, \
            (path, tops)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jpeg_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jpeg_tpu.core", sys)
    assert harness.forbidden_modules() == ["jpeg_tpu.core"]
