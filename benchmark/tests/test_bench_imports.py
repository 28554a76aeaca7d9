"""Nothing the benchmark runs imports JAX or the JAX package bella_tpu,
and the reference imports nothing of the port. Top-level module names
are compared whole: bella_tpu_torch, the port, begins with bella_tpu."""

import ast
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "bella_tpu"}
BENCH = ROOT / "benchmark"
# the reference's modules: the generator, the recompute, the comparison
REFERENCE = [BENCH / "gen", BENCH / "reference", BENCH / "check.py"]


def top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(paths):
    for p in paths:
        yield from ([p] if p.is_file() else sorted(p.rglob("*.py")))


def test_no_module_of_the_benchmark_imports_jax():
    for path in sources([BENCH]):
        assert not set(top_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in sources(REFERENCE):
        assert "bella_tpu_torch" not in set(top_imports(path)), path


def test_a_tiny_cell_loads_no_jax(tiny_root):
    """A run in a fresh process (the port and the check included) leaves
    no JAX module in sys.modules; the reference alone loads no module of
    the port."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(1)
from benchmark import check, cells
loaded = sorted({{m.split('.')[0] for m in sys.modules}})
from benchmark.run import run_cell
r = run_cell(cells.load('clr-ecoli-30x.tiny', {str(tiny_root)!r}), 3, 0.01,
             True, device='cpu', workers=1)
print(json.dumps([r['correct'], loaded,
                  sorted({{m.split('.')[0] for m in sys.modules}})]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, before, after = json.loads(out.stdout.splitlines()[-1])
    assert correct
    assert "bella_tpu_torch" not in before
    assert "bella_tpu_torch" in after
    assert not set(after) & FORBIDDEN
