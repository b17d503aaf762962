"""GraphCast [arXiv:2212.12794]: 16L d512 encoder-processor-decoder (port
of ``repro.configs.graphcast``).

The weather configuration (``weather_config``: 227 variables, icosahedral
multimesh) runs through ``repro_torch.examples.graphcast_weather`` and
``chip_smoke.py``'s GraphCast phase.  The dry-run cells of the reference
(``_inputs_factory``, ``_loss_local_factory``, ``build_dryrun_cell``) need
``configs/gnn_common.py`` and a device mesh: ROADMAP queue 1 item 1.
"""
from __future__ import annotations

from repro_torch.models.gnn_zoo.graphcast import GraphCastConfig

ARCH_ID = "graphcast"
FAMILY = "gnn"
EDGE_IN = 4
# the reference's default shape, repro/configs/gnn_common.py GNN_SHAPES
# "full_graph_sm" (a copy: the port imports nothing of repro)
FULL_GRAPH_SM = dict(kind="full", n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)


def config(shape: dict | None = None) -> GraphCastConfig:
    shape = shape or FULL_GRAPH_SM
    if shape["kind"] == "molecule":
        return GraphCastConfig(in_dim=8, hidden=512, n_layers=16, out_dim=1,
                               edge_in=EDGE_IN)
    return GraphCastConfig(in_dim=shape["d_feat"], hidden=512, n_layers=16,
                           out_dim=shape["n_classes"], edge_in=EDGE_IN)


def weather_config(refinement: int = 6) -> GraphCastConfig:
    return GraphCastConfig(in_dim=227, hidden=512, n_layers=16, out_dim=227,
                           edge_in=EDGE_IN, name=f"graphcast-weather-r{refinement}")


def smoke_config() -> GraphCastConfig:
    return GraphCastConfig(in_dim=16, hidden=32, n_layers=3, out_dim=4,
                           mlp_hidden_layers=1)
