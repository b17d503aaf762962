"""Architecture registry (port of ``repro.configs``), holding the
architectures the port has (every GNN arch of the reference's), and the
paper's own GNN.  Modules are imported lazily, so that e.g. LM-only
workflows don't pull the equivariant-irreps machinery."""
from __future__ import annotations

import importlib
from typing import Dict

# arch id -> (module path, family)
ARCHS: Dict[str, tuple] = {
    "llama3.2-3b": ("repro_torch.configs.llama3_2_3b", "lm"),
    "granite-34b": ("repro_torch.configs.granite_34b", "lm"),
    "gemma2-2b": ("repro_torch.configs.gemma2_2b", "lm"),
    "mace": ("repro_torch.configs.mace", "gnn"),
    "graphcast": ("repro_torch.configs.graphcast", "gnn"),
    "gat-cora": ("repro_torch.configs.gat_cora", "gnn"),
    "nequip": ("repro_torch.configs.nequip", "gnn"),
    "dlrm-rm2": ("repro_torch.configs.dlrm_rm2", "recsys"),
    # the paper's own architecture (not part of the assigned matrix)
    "paper-gnn": ("repro_torch.configs.paper_gnn", "gnn"),
}


def get_arch(arch_id: str):
    path, family = ARCHS[arch_id]
    return importlib.import_module(path), family


def family_of(arch_id: str) -> str:
    return ARCHS[arch_id][1]


def assigned_archs():
    return [a for a in ARCHS if a != "paper-gnn"]
