"""Nothing under bench/ imports JAX, jaxlib, flax or the JAX package
``repro`` (top-level names compared whole: the port is ``repro_torch``),
nothing reads the JAX package's benchmark folder, and the references import nothing of the
port either."""
import ast
import subprocess
import sys

import pytest

from bench.common import BENCH, FORBIDDEN_MODULES, ROOT, forbidden_loaded

FILES = sorted(BENCH.rglob("*.py"))
OLD_BENCHMARKS = "bench" + "marks/"     # the JAX package's benchmark folder


def imported(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_forbidden_import(path):
    tops = {m.split(".")[0] for m in imported(path) if m}
    assert not tops & set(FORBIDDEN_MODULES), (path, tops)
    if path.parent.name == "reference":
        assert "repro_torch" not in tops, path
    assert OLD_BENCHMARKS not in path.read_text(), path


def test_forbidden_names_compared_whole():
    assert forbidden_loaded(["repro_torch.models", "numpy"]) == []
    assert forbidden_loaded(["repro.models", "jaxlib.xla"]) == \
        ["jaxlib", "repro"]


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = ["bench.run", "bench.calibrate", "bench.sweep", "bench.trace",
            "bench.runners.ps_train", "bench.runners.engine_serve",
            "repro_torch.runtime.learner", "repro_torch.serving.engine"]
    tops = _loaded_after("\n".join(f"import {m}" for m in mods))
    assert not tops & set(FORBIDDEN_MODULES), tops


def test_references_load_nothing_of_the_port():
    tops = _loaded_after("import bench.reference.lm, bench.reference.ps, "
                         "bench.weights, bench.cost, bench.traffic")
    assert "repro_torch" not in tops and not tops & set(FORBIDDEN_MODULES)
