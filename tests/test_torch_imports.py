"""The torch port must stand alone: importing every module of
``repro_torch`` leaves ``jax`` (and ``repro``, whose import installs JAX
shims) out of ``sys.modules``, and no source file imports either."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_module_leaves_jax_out():
    mods = _modules()
    assert "repro_torch.runtime.engine" in mods and len(mods) > 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_source_file_imports_jax_or_repro():
    offenders = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(SRC)}: {n}")
    assert not offenders, offenders
