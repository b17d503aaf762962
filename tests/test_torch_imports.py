"""The torch port must stand alone: importing every module of
``repro_torch`` leaves ``jax`` (and ``repro``, whose import installs JAX
shims) out of ``sys.modules``, and no source file imports either."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

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


LM_SLICE = ["repro_torch.configs.granite_34b", "repro_torch.configs.lm_common",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref",
            "repro_torch.models.transformer.attention",
            "repro_torch.models.transformer.config",
            "repro_torch.models.transformer.layers",
            "repro_torch.models.transformer.model",
            "repro_torch.models.transformer.steps"]


SEGMENT_AGG_SLICE = ["repro_torch.kernels.segment_agg.ops",
                     "repro_torch.kernels.segment_agg.ref"]


def _imports_alone_without_jax(mod):
    assert mod in _modules()
    code = (f"import importlib, sys\nimportlib.import_module({mod!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("mod", LM_SLICE)
def test_lm_slice_module_imports_alone_without_jax(mod):
    """Each module of the LM serving slice is one that the walk above finds,
    and imports in a fresh interpreter with neither ``jax`` nor ``repro``."""
    _imports_alone_without_jax(mod)


@pytest.mark.parametrize("mod", SEGMENT_AGG_SLICE)
def test_segment_agg_slice_module_imports_alone_without_jax(mod):
    """The same for the modules of the dst-aligned edge-MLP op."""
    _imports_alone_without_jax(mod)


MULTILEVEL_SLICE = ["repro_torch.core.coarsen", "repro_torch.core.consistent_mp",
                    "repro_torch.core.graph_state", "repro_torch.core.partition",
                    "repro_torch.graph.segment"]


@pytest.mark.parametrize("mod", MULTILEVEL_SLICE)
def test_multilevel_slice_module_imports_alone_without_jax(mod):
    """The same for the modules of the multilevel V-cycle (the hierarchy
    is the port's own copy of the reference's numpy-only module)."""
    _imports_alone_without_jax(mod)


PLAN_SLICE = ["repro_torch.core.partition_quality", "repro_torch.core.halo",
              "repro_torch.core.consistent_mp", "repro_torch.core.partition",
              "repro_torch.launch.mesh", "repro_torch.launch.consistency",
              "repro_torch.kernels.halo_pack.ops"]


@pytest.mark.parametrize("mod", PLAN_SLICE)
def test_plan_slice_module_imports_alone_without_jax(mod):
    """The same for the modules of the exchange's remaining forms and the
    plan's choice (the spectral partitioner is the port's own copy of the
    reference's numpy-only module)."""
    _imports_alone_without_jax(mod)


RESILIENCE_SLICE = ["repro_torch.runtime.fault_tolerance",
                    "repro_torch.launch.resilience_checks"]


@pytest.mark.parametrize("mod", RESILIENCE_SLICE)
def test_resilience_slice_module_imports_alone_without_jax(mod):
    """The same for the new modules of checkpoint resilience (the driver is
    the port's own copy of the reference's)."""
    _imports_alone_without_jax(mod)


GRAPHCAST_SLICE = ["repro_torch.configs", "repro_torch.configs.paper_gnn",
                   "repro_torch.configs.graphcast", "repro_torch.models.gnn_zoo.graphcast",
                   "repro_torch.examples.graphcast_weather", "repro_torch.convert"]


@pytest.mark.parametrize("mod", GRAPHCAST_SLICE)
def test_graphcast_slice_module_imports_alone_without_jax(mod):
    """The same for the modules of GraphCast and the paper's config module
    (the icosphere and grid builders are the port's own copies of the
    reference's numpy code)."""
    _imports_alone_without_jax(mod)


GRAPHCAST_TRAIN_SLICE = ["repro_torch.configs.gnn_common", "repro_torch.launch.graphcast_checks"]


@pytest.mark.parametrize("mod", GRAPHCAST_TRAIN_SLICE)
def test_graphcast_train_slice_module_imports_alone_without_jax(mod):
    """The same for the new modules of GraphCast's training cells (the
    step builder and dry-run cells, the edge-parallel checks)."""
    _imports_alone_without_jax(mod)


GNN_ZOO_SLICE = ["repro_torch.configs.gat_cora", "repro_torch.configs.nequip",
                 "repro_torch.configs.mace", "repro_torch.models.gnn_zoo.gat",
                 "repro_torch.models.gnn_zoo.irreps", "repro_torch.models.gnn_zoo.nequip",
                 "repro_torch.models.gnn_zoo.mace", "repro_torch.graph.sampler",
                 "repro_torch.graph.datasets"]


@pytest.mark.parametrize("mod", GNN_ZOO_SLICE)
def test_gnn_zoo_slice_module_imports_alone_without_jax(mod):
    """The same for the modules of the rest of the GNN zoo (the irreps'
    host part, the sampler and the datasets are the port's own copies of
    the reference's numpy code)."""
    _imports_alone_without_jax(mod)
