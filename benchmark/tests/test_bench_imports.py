"""Nothing the benchmark runs loads JAX or the JAX package, comparing
top-level module names whole; the reference loads nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "overlapnet_tpu"}


def top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    return [p for p in glob.glob(os.path.join(BENCH, sub, "**", "*.py"), recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not set(top_level_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert not set(top_level_imports(path)) & (FORBIDDEN | {"overlapnet_torch"}), path


def run_python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_loaded_harness_holds_no_jax():
    """Every driver and reader loaded, every driver's imports of the
    program made: the process's top-level modules hold none of the JAX
    stack. The name check is whole: ``overlapnet_torch`` is not
    ``overlapnet_tpu``."""
    code = """
import sys
from benchmark import harness, controls
import json
man = harness.manifest('.')
for w in man['workloads']:
    harness.find_cell(w['name'])
import overlapnet_torch.lcd.infer, overlapnet_torch.lcd.online, overlapnet_torch.train.trainer
import overlapnet_torch.data.dataset, overlapnet_torch.geometry.overlap
print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))
"""
    tops = run_python(code)
    assert "overlapnet_torch" in tops and not tops & FORBIDDEN


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "overlapnet_tpu_extra", sys)
    assert "overlapnet_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_loaded()


def test_the_reference_alone_loads_no_program():
    tops = run_python("import sys, benchmark.reference.model, benchmark.reference.train, "
                      "benchmark.reference.gt, benchmark.reference.lcd\n"
                      "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not tops & (FORBIDDEN | {"overlapnet_torch"})
