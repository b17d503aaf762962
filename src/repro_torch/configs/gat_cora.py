"""GAT-Cora [arXiv:1710.10903]: 2L, hidden 8, 8 heads, attention
aggregation (port of ``repro.configs.gat_cora``): the reference's cell
functions, through ``configs/gnn_common.py``'s step builder on one rank or
over a process mesh's graph group."""
from __future__ import annotations

import torch

from repro_torch.configs import gnn_common as G
from repro_torch.models.gnn_zoo.gat import GATConfig, gat_forward, init_gat

ARCH_ID = "gat-cora"
FAMILY = "gnn"


def config(shape: dict | None = None) -> GATConfig:
    shape = shape or G.GNN_SHAPES["full_graph_sm"]
    if shape["kind"] == "molecule":
        return GATConfig(in_dim=8, hidden=8, heads=8, n_classes=1, n_layers=2)
    return GATConfig(in_dim=shape["d_feat"], hidden=8, heads=8,
                     n_classes=shape["n_classes"], n_layers=2)


def smoke_config() -> GATConfig:
    return GATConfig(in_dim=16, hidden=4, heads=2, n_classes=3, n_layers=2)


def _inputs_factory(shape, R, n_pad, e_pad, graph_axis=G.GRAPH, edge_parallel=False):
    """The cell's stacked inputs as meta tensors, and their specs."""
    d = shape.get("d_feat", 8)
    inputs = {"x": G._meta((R, n_pad, d), torch.float32),
              "labels": G._meta((R, n_pad), torch.int32)}
    specs = {"x": (graph_axis, None, None), "labels": (graph_axis, None)}
    return inputs, specs


def _loss_local_factory(shape, halo, graph_axis=G.GRAPH, mesh=None, overrides=None,
                        cfg: GATConfig | None = None):
    """``loss_local(params, inputs, graph)`` of this process: GAT on its
    rank-local graph, exchanging through ``halo`` over ``mesh``'s graph
    group, then the consistent cross entropy (``full``, ``minibatch``) or
    squared error (``molecule``) summed over that group.  ``cfg``:
    ``config(shape)`` by default."""
    del graph_axis, overrides  # the graph axis is the mesh's graph group
    cfg = config(shape) if cfg is None else cfg
    regression = shape["kind"] == "molecule"
    group = None if mesh is None else mesh.graph_group

    def loss_local(params, inputs, graph):
        out = gat_forward(params, inputs["x"][0], graph, cfg,
                          sync_fn=G.sync_fn_of(graph, halo, mesh))
        if regression:
            tgt = inputs["labels"][0].float()[:, None]
            return G.consistent_mse_loss(out, tgt, graph["node_inv_mult"], group)
        return G.consistent_ce_loss(out, inputs["labels"][0], graph["node_inv_mult"], group)
    return loss_local


def _param_factory(shape):
    """The cell's parameters as meta tensors (shapes only)."""
    with torch.device("meta"):
        return init_gat(None, config(shape), device="meta")


def build_dryrun_cell(shape_id, mesh, overrides=None):
    return G.build_gnn_dryrun_cell(
        shape_id, mesh,
        loss_local_factory=_loss_local_factory,
        inputs_factory=_inputs_factory,
        param_factory=_param_factory,
        overrides=overrides)
