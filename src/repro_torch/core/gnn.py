"""The paper's encode-process-decode consistent GNN (Sec. III, Table I),
port of ``repro.core.gnn``.

  1) node & edge encoders: local MLPs lifting F_x / F_e -> N_H;
  2) M consistent NMP layers (Sec. II-B);
  3) node decoder: local MLP N_H -> F_y (edge features discarded).

Configs: "small" (N_H=8, M=4, 2 MLP hidden layers) and "large" (N_H=32,
M=4, 5 MLP hidden layers) with F_x=3 (velocity), F_e=7 (relative velocity
+ distance vector + magnitude).  The multilevel V-cycle
(``n_levels > 1``) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn
from repro_torch.core.consistent_mp import init_nmp_layer, nmp_layer
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
    n_levels: int = 1            # 1 = flat NMP (the only depth ported)

    @staticmethod
    def small() -> "GNNConfig":
        return GNNConfig(hidden=8, n_mp_layers=4, mlp_hidden_layers=2, name="small")

    @staticmethod
    def large() -> "GNNConfig":
        return GNNConfig(hidden=32, n_mp_layers=4, mlp_hidden_layers=5, name="large")


def init_gnn(gen: torch.Generator, cfg: GNNConfig, device="cuda") -> nn.Params:
    """Random parameters in the reference's tree layout, drawn from ``gen``
    (a CPU ``torch.Generator``) and placed on ``device``."""
    if cfg.n_levels > 1:
        raise NotImplementedError("multilevel GNNs (n_levels > 1) are not "
                                  "ported to repro_torch yet")
    h, L = cfg.hidden, cfg.mlp_hidden_layers
    return {
        "node_enc": nn.init_mlp(gen, cfg.node_in, [h] * L, h, device),
        "edge_enc": nn.init_mlp(gen, cfg.edge_in, [h] * L, h, device),
        "mp": [init_nmp_layer(gen, h, L, device) for _ in range(cfg.n_mp_layers)],
        "node_dec": nn.init_mlp(gen, h, [h] * L, cfg.node_out, device,
                                final_layernorm=False),
    }


def build_edge_inputs(x: torch.Tensor, graph) -> torch.Tensor:
    """Paper's 7-dim edge init: relative node features ++ distance vec ++ |dist|."""
    rel = segment.gather(x, graph["edge_dst"]) - segment.gather(x, graph["edge_src"])
    return torch.cat([rel, graph["static_edge_feats"]], dim=-1)


def gnn_forward(params: nn.Params, x: torch.Tensor, graph,
                plan: NMPPlan, sync_fn=None) -> torch.Tensor:
    """Encode-process-decode forward on one rank.

    ``x``: [N_pad, F_x], or [B, N_pad, F_x], which runs one sample at a time
    so every matmul sees the same row count at any batch size (cuBLAS may
    pick another algorithm, with other last bits, for another shape).
    ``sync_fn`` is each layer's halo exchange of the local aggregate
    (``core/halo.py::halo_sync`` on this rank's graph and mesh); a halo
    mode other than none without one raises.  Returns [..., N_pad, F_y].
    """
    graph = as_graph(graph)
    if x.dim() == 3:
        return torch.stack([gnn_forward(params, xb, graph, plan, sync_fn) for xb in x])
    mask = graph["node_mask"][:, None]
    h = nn.mlp(params["node_enc"], x) * mask
    e = nn.mlp(params["edge_enc"], build_edge_inputs(x, graph)) \
        * graph["edge_mask"][:, None]
    for lp in params["mp"]:
        h, e = nmp_layer(lp, h, e, graph, plan, sync_fn=sync_fn)
    return nn.mlp(params["node_dec"], h) * mask
