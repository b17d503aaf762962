"""Architecture registry (port of ``repro.configs``), holding the
architectures the port has.  Modules are imported lazily."""
from __future__ import annotations

import importlib
from typing import Dict

# arch id -> (module path, family)
ARCHS: Dict[str, tuple] = {
    "dlrm-rm2": ("repro_torch.configs.dlrm_rm2", "recsys"),
    "granite-34b": ("repro_torch.configs.granite_34b", "lm"),
}


def get_arch(arch_id: str):
    path, family = ARCHS[arch_id]
    return importlib.import_module(path), family
