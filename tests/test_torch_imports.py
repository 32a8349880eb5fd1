"""The port stands alone: importing every module of ``repro_torch``
loads neither ``jax`` nor anything of ``repro``, and no source of the
port (nor ``chip_smoke.py``, nor the scripts that run its phases) imports
them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_import_loads_no_jax_and_no_repro():
    mods = _modules()
    assert "repro_torch.serving.engine" in mods
    for new in ("repro_torch.launch.mesh", "repro_torch.distributed.sharding",
                "repro_torch.runtime.trainer", "repro_torch.core.ps",
                "repro_torch.core.solvers", "repro_torch.launch.dryrun",
                "repro_torch.runtime.spmd"):
        assert new in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(bad), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("0 []"), res.stdout


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_no_repro():
    files = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("*.py")))
    assert (ROOT / "chip_smoke.py").is_file()
    assert ROOT / "scripts" / "pjit_phase.py" in files
    assert ROOT / "scripts" / "solvers_phase.py" in files
    assert ROOT / "scripts" / "dense_phase.py" in files
    assert PKG / "core" / "ps.py" in files and PKG / "core" / "solvers.py" \
        in files
    assert PKG / "runtime" / "spmd.py" in files
    bad = []
    for f in files:
        for name in _imported_names(f):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {name}")
    assert bad == []
