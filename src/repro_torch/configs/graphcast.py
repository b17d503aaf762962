"""GraphCast [arXiv:2212.12794]: 16L d512 encoder-processor-decoder (port
of ``repro.configs.graphcast``).

The assigned generic-graph shapes (``configs/gnn_common.py::GNN_SHAPES``)
exercise the processor at scale through the reference's cell functions:
``_inputs_factory``, ``_loss_local_factory`` (cross entropy on the
``full`` kind, squared error on ``molecule``, with the reference's
overrides ``edge_parallel``, ``remat``, ``act_bf16``, ``remat_segment``
and ``params_bf16``), ``_param_factory`` and ``build_dryrun_cell``; a
training step runs them through ``gnn_common.make_gnn_train_step`` on one
rank or over a ``(data, graph, model)`` process mesh.  The weather
configuration (``weather_config``: 227 variables, icosahedral multimesh)
runs through ``repro_torch.examples.graphcast_weather`` and
``chip_smoke.py``'s GraphCast phases.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn
from repro_torch.configs import gnn_common as G
from repro_torch.core.distributed import halo_fns
from repro_torch.core.graph_state import NMPPlan
from repro_torch.models.gnn_zoo.graphcast import (
    GraphCastConfig, graphcast_forward, init_graphcast)

ARCH_ID = "graphcast"
FAMILY = "gnn"
EDGE_IN = 4
# the reference's default shape (gnn_common.GNN_SHAPES["full_graph_sm"])
FULL_GRAPH_SM = G.GNN_SHAPES["full_graph_sm"]


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


def _inputs_factory(shape, R, n_pad, e_pad, graph_axis=G.GRAPH, edge_parallel=False):
    """The cell's stacked inputs as meta tensors, and their specs."""
    d = shape.get("d_feat", 8)
    inputs = {"x": G._meta((R, n_pad, d), torch.float32),
              "edge_feats": G._meta((R, e_pad, EDGE_IN), torch.float32),
              "labels": G._meta((R, n_pad), torch.int32)}
    specs = {"x": (graph_axis, None, None),
             "edge_feats": (graph_axis, G.MODEL if edge_parallel else None, None),
             "labels": (graph_axis, None)}
    return inputs, specs


def _loss_local_factory(shape, halo, graph_axis=G.GRAPH, mesh=None, overrides=None,
                        plan: NMPPlan | None = None, cfg: GraphCastConfig | None = None):
    """``loss_local(params, inputs, graph)`` of this process: GraphCast's
    forward on its rank-local graph (its model shard's edges under
    ``edge_parallel``; ``inputs`` its blocks, a leading axis of 1), then
    the consistent cross entropy (``full``) or squared error
    (``molecule``) summed over the mesh's graph group.  ``halo`` is the
    exchange's spec; ``plan`` the NMP policy (the reference's default,
    ``NMPPlan(halo=halo)``: the plain backend, blocking), whose halo is
    replaced by ``halo``; ``cfg`` the model (``config(shape)`` by
    default), which the overrides modify.  ``params_bf16`` rounds every fp32 weight to
    bf16 and computes on it in fp32, as JAX promotes bf16 weights with
    fp32 activations (the fp32 kernels take the rounded values); autograd
    through the two casts rounds each weight's cotangent to bf16, as
    JAX's VJP of ``astype`` does."""
    del graph_axis  # the graph axis is the mesh's graph group
    cfg = config(shape) if cfg is None else cfg
    ov = overrides or {}
    if ov.get("edge_parallel"):
        cfg = dataclasses.replace(cfg, edge_parallel_axes=(G.MODEL,))
    if ov.get("remat"):
        cfg = dataclasses.replace(cfg, remat=True)
    if ov.get("act_bf16"):
        cfg = dataclasses.replace(cfg, act_dtype=torch.bfloat16)
    if ov.get("remat_segment"):
        cfg = dataclasses.replace(cfg, remat_segment=int(ov["remat_segment"]))
    params_bf16 = bool(ov.get("params_bf16"))
    regression = shape["kind"] == "molecule"
    plan = NMPPlan(halo=halo) if plan is None else plan.replace(halo=halo)
    group = None if mesh is None else mesh.graph_group

    def loss_local(params, inputs, graph):
        if params_bf16:
            params = nn.tree_map(
                lambda t: t.to(torch.bfloat16).float() if t.dtype == torch.float32 else t,
                params)
        sync = None if mesh is None else halo_fns(plan, graph, mesh)
        out = graphcast_forward(params, inputs["x"][0], inputs["edge_feats"][0], graph,
                                plan, cfg, sync_fns=sync, mesh=mesh)
        if regression:
            tgt = inputs["labels"][0].float()[:, None]
            return G.consistent_mse_loss(out, tgt, graph["node_inv_mult"], group)
        return G.consistent_ce_loss(out, inputs["labels"][0], graph["node_inv_mult"], group)
    return loss_local


def _param_factory(shape):
    """The cell's parameters as meta tensors (shapes only)."""
    cfg = config(shape)
    with torch.device("meta"):
        # no generator: meta tensors draw nothing
        return init_graphcast(None, cfg, device="meta")


def build_dryrun_cell(shape_id, mesh, overrides=None):
    return G.build_gnn_dryrun_cell(
        shape_id, mesh,
        loss_local_factory=_loss_local_factory,
        inputs_factory=_inputs_factory,
        param_factory=_param_factory,
        overrides=overrides)
