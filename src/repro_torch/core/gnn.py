"""The paper's encode-process-decode consistent GNN (Sec. III, Table I),
port of ``repro.core.gnn``.

  1) node & edge encoders: local MLPs lifting F_x / F_e -> N_H;
  2) M consistent NMP layers (Sec. II-B);
  3) node decoder: local MLP N_H -> F_y (edge features discarded).

Configs: "small" (N_H=8, M=4, 2 MLP hidden layers) and "large" (N_H=32,
M=4, 5 MLP hidden layers) with F_x=3 (velocity), F_e=7 (relative velocity
+ distance vector + magnitude).  ``n_levels > 1`` adds the consistent
multilevel V-cycle (``core/consistent_mp.py::multilevel_vcycle``) between
the M fine layers and the decoder, on a graph built from
``core/coarsen.py``'s hierarchy.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn
from repro_torch.core.consistent_mp import (
    init_nmp_layer, multilevel_vcycle, nmp_layer)
from repro_torch.core.graph_state import NMPPlan, as_graph
from repro_torch.graph import segment


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    hidden: int = 8              # N_H
    n_mp_layers: int = 4         # M
    mlp_hidden_layers: int = 2
    node_in: int = 3             # F_x (velocity)
    edge_in: int = 7             # F_e
    node_out: int = 3            # F_y
    name: str = "small"
    # --- multilevel (coarse-grid) message passing (core/coarsen.py) ---
    n_levels: int = 1            # 1 = flat NMP; >1 adds a consistent V-cycle
    coarse_mp_layers: int = 2    # NMP layers smoothing each coarse level
    coarse_edge_in: int = 4      # coarse static edge feats (dist vec + mag)

    @staticmethod
    def small() -> "GNNConfig":
        return GNNConfig(hidden=8, n_mp_layers=4, mlp_hidden_layers=2, name="small")

    @staticmethod
    def large() -> "GNNConfig":
        return GNNConfig(hidden=32, n_mp_layers=4, mlp_hidden_layers=5, name="large")


def init_gnn(gen: torch.Generator, cfg: GNNConfig, device="cuda") -> nn.Params:
    """Random parameters in the reference's tree layout (with a
    ``"coarse"`` list when ``cfg.n_levels > 1``), drawn from ``gen`` (a CPU
    ``torch.Generator``) and placed on ``device``."""
    h, L = cfg.hidden, cfg.mlp_hidden_layers
    params = {
        "node_enc": nn.init_mlp(gen, cfg.node_in, [h] * L, h, device),
        "edge_enc": nn.init_mlp(gen, cfg.edge_in, [h] * L, h, device),
        "mp": [init_nmp_layer(gen, h, L, device) for _ in range(cfg.n_mp_layers)],
        "node_dec": nn.init_mlp(gen, h, [h] * L, cfg.node_out, device,
                                final_layernorm=False),
    }
    if cfg.n_levels > 1:
        params["coarse"] = init_coarse_levels(
            gen, h, L, cfg.n_levels, cfg.coarse_mp_layers, cfg.coarse_edge_in,
            device)
    return params


def init_coarse_levels(gen: torch.Generator, hidden: int, mlp_hidden_layers: int,
                       n_levels: int, coarse_mp_layers: int, coarse_edge_in: int,
                       device="cuda") -> list:
    """Per-coarse-level params of the V-cycle: an edge encoder lifting the
    level's static geometric edge features to the hidden width, and
    ``coarse_mp_layers`` NMP layers smoothing that level."""
    L = mlp_hidden_layers
    return [{"edge_enc": nn.init_mlp(gen, coarse_edge_in, [hidden] * L, hidden,
                                     device),
             "mp": [init_nmp_layer(gen, hidden, L, device)
                    for _ in range(coarse_mp_layers)]}
            for _ in range(1, n_levels)]


def build_edge_inputs(x: torch.Tensor, graph) -> torch.Tensor:
    """Paper's 7-dim edge init: relative node features ++ distance vec ++ |dist|."""
    rel = segment.gather(x, graph["edge_dst"]) - segment.gather(x, graph["edge_src"])
    return torch.cat([rel, graph["static_edge_feats"]], dim=-1)


def gnn_forward(params: nn.Params, x: torch.Tensor, graph,
                plan: NMPPlan, sync_fns=None) -> torch.Tensor:
    """Encode-process-decode forward on one rank.

    ``x``: [N_pad, F_x], or [B, N_pad, F_x], which runs one sample at a time
    so every matmul sees the same row count at any batch size (cuBLAS may
    pick another algorithm, with other last bits, for another shape).
    ``sync_fns`` holds each level's halo exchange of the local aggregate,
    fine first (``core/distributed.py::halo_fns``: ``core/halo.py::
    halo_sync`` on this rank's graph of that level and the mesh); a halo
    mode other than none without one raises.  Params with a ``"coarse"``
    list run the multilevel V-cycle after the M fine layers; ``graph`` must
    then carry the coarse chain (``ShardedGraph.build(..., hierarchy=)``).
    Returns [..., N_pad, F_y].
    """
    graph = as_graph(graph)
    if x.dim() == 3:
        return torch.stack([gnn_forward(params, xb, graph, plan, sync_fns) for xb in x])
    syncs = sync_fns or (None,) * graph.n_levels
    mask = graph["node_mask"][:, None]
    h = nn.mlp(params["node_enc"], x) * mask
    e = nn.mlp(params["edge_enc"], build_edge_inputs(x, graph)) \
        * graph["edge_mask"][:, None]
    for lp in params["mp"]:
        h, e = nmp_layer(lp, h, e, graph, plan, sync_fn=syncs[0])
    if "coarse" in params:
        h = multilevel_vcycle(params["coarse"], h, graph, plan, syncs)
    return nn.mlp(params["node_dec"], h) * mask
