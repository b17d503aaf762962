"""MACE [arXiv:2206.07697]: 2L, 128 channels, l_max=2, correlation 3, 8 RBF
(port of ``repro.configs.mace``), with NequIP's overrides
(``configs/nequip.py::with_overrides``)."""
from __future__ import annotations

import torch

from repro_torch.configs import gnn_common as G
from repro_torch.configs.nequip import _inputs_factory, equivariant_loss_factory
from repro_torch.models.gnn_zoo.mace import MACEConfig, init_mace, mace_forward

ARCH_ID = "mace"
FAMILY = "gnn"


def config(shape: dict | None = None) -> MACEConfig:
    return MACEConfig(n_layers=2, hidden_mul=128, l_max=2, correlation=3,
                      n_rbf=8, cutoff=5.0)


def smoke_config() -> MACEConfig:
    return MACEConfig(n_layers=2, hidden_mul=8, l_max=1, correlation=3,
                      n_rbf=4, cutoff=3.0, n_species=4)


_loss_local_factory = equivariant_loss_factory(mace_forward, config)


def _param_factory(shape):
    """The cell's parameters as meta tensors (shapes only)."""
    with torch.device("meta"):
        return init_mace(None, config(shape), device="meta")


def build_dryrun_cell(shape_id, mesh, overrides=None):
    return G.build_gnn_dryrun_cell(
        shape_id, mesh,
        loss_local_factory=_loss_local_factory,
        inputs_factory=_inputs_factory,
        param_factory=_param_factory,
        overrides=overrides)
