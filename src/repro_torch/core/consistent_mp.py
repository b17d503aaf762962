"""Consistent neural message passing layer (Sec. II-B, Eq. 4a-e), port of
``repro.core.consistent_mp``.

Operates on one rank's padded arrays (``[N_pad, H]`` nodes, ``[E_pad, H]``
edges); the halo exchange injects the cross-rank synchronization.

  4a  e_ij' = MLP_e(x_i, x_j, e_ij)            (residual MLP, LayerNorm, ELU)
  4b  a_i   = sum_{j in N(i)} e_ij' / d_ij     (segment sum with 1/d_ij)
  4c  halo swap of local aggregates
  4d  a_i*  = sum over coincident copies       (fused scatter-add)
  4e  x_i'  = MLP_n(a_i*, x_i)                 (residual on node features)

Backends for the 4a+4b hot loop (``plan.backend``):

* ``"xla"``   — plain PyTorch: gather + concat, edge MLP, deterministic
  sorted segment sum (``repro_torch.graph.segment``).
* ``"fused"`` — the hand-written CUDA kernels, forward and backward
  (``repro_torch.kernels.segment_agg``); needs the compact layout and its
  src-sorted companion on the graph (``ShardedGraph.build`` attaches both
  for a fused plan).

Both compute the same arithmetic up to summation order.  This slice
registers the blocking schedule.  The caller threads the exchange in as
``sync_fn``: ``core/halo.py::halo_sync`` on one process's rank-local graph
and its mesh (``core/distributed.py`` builds it), or a stacked emulator
over every rank on one device (``core/reference.py``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch import nn
from repro_torch.core.graph_state import (
    BLOCKING, FUSED, XLA, NMPPlan, ShardedGraph, as_graph, nmp_impl,
    register_nmp_impl,
)
from repro_torch.core.halo import NONE, HaloSpec
from repro_torch.graph import segment
from repro_torch.kernels.segment_agg.ops import fused_nmp_edge_agg


def init_nmp_layer(gen: torch.Generator, hidden: int, mlp_hidden_layers: int,
                   device="cuda") -> nn.Params:
    return {
        # edge MLP consumes [x_i, x_j, e_ij] -> hidden
        "edge": nn.init_mlp(gen, 3 * hidden, [hidden] * mlp_hidden_layers,
                            hidden, device),
        # node MLP consumes [a_i*, x_i] -> hidden
        "node": nn.init_mlp(gen, 2 * hidden, [hidden] * mlp_hidden_layers,
                            hidden, device),
    }


def _agg_xla(params, x, e, graph: ShardedGraph, plan: NMPPlan):
    src, dst = graph["edge_src"], graph["edge_dst"]
    # --- Eq. 4a: edge update (residual) ---
    feats = torch.cat([segment.gather(x, src), segment.gather(x, dst), e], dim=-1)
    e_new = (e + nn.mlp(params["edge"], feats)) * graph["edge_mask"][:, None]
    # --- Eq. 4b: local aggregation with inverse edge multiplicity ---
    weighted = e_new * graph["edge_inv_mult"][:, None]
    return e_new, segment.segment_sum(weighted, dst, x.shape[0])


def _agg_fused(params, x, e, graph: ShardedGraph, plan: NMPPlan):
    if "seg_perm" not in graph:
        raise ValueError(
            "backend='fused' needs the cached compact layout (seg_perm/"
            "seg_src/seg_rowptr/seg_src_slots/seg_src_rowptr) on the graph "
            "— build it with the fused plan: ShardedGraph.build(pg, coords, "
            "plan)")
    return fused_nmp_edge_agg(
        x, e, params["edge"], graph["seg_perm"], graph["seg_src"],
        graph["seg_rowptr"], graph["edge_mask"], graph["edge_inv_mult"],
        seg_src_slots=graph["seg_src_slots"],
        seg_src_rowptr=graph["seg_src_rowptr"])


_AGGS = {XLA: _agg_xla, FUSED: _agg_fused}


def edge_update_aggregate(params, x, e, graph, plan: NMPPlan):
    """Eq. 4a + 4b on one rank: returns (e', local aggregate a)."""
    graph = as_graph(graph)
    return _AGGS[plan.backend](params, x, e, graph, plan)


def node_update(params: nn.Params, x: torch.Tensor, agg: torch.Tensor,
                graph) -> torch.Tensor:
    """Eq. 4e: residual node MLP on [a_i*, x_i]."""
    x_new = x + nn.mlp(params["node"], torch.cat([agg, x], dim=-1))
    return x_new * graph["node_mask"][:, None]


def _blocking_layer(agg_fn, params, x, e, graph, plan, halo: HaloSpec,
                    sync_fn):
    """The paper's serial order: full Eq. 4a+4b, exchange, Eq. 4e."""
    e_new, agg = agg_fn(params, x, e, graph, plan)
    # --- Eq. 4c + 4d: halo swap + synchronization ---
    if sync_fn is not None:
        agg = sync_fn(agg)
    elif halo.mode != NONE:
        raise ValueError(
            f"halo mode {halo.mode!r} on one rank's arrays needs the exchange: "
            "no mesh was given (pass sync_fn=lambda a: halo_sync(a, graph, "
            "plan.halo, mesh) with a repro_torch.launch.mesh.make_mesh mesh), "
            "or run the stacked reference (repro_torch.core.reference)")
    # --- Eq. 4e: node update (residual) ---
    return node_update(params, x, agg, graph), e_new


for _backend, _agg in _AGGS.items():
    register_nmp_impl(_backend, BLOCKING)(
        functools.partial(_blocking_layer, _agg))


def nmp_layer(params: nn.Params, x: torch.Tensor, e: torch.Tensor, graph,
              plan: NMPPlan, halo: HaloSpec | None = None,
              sync_fn=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One consistent NMP layer on one rank. Returns (x', e').

    The implementation is resolved from the (backend, schedule) registry;
    ``halo`` defaults to ``plan.halo``; ``sync_fn`` performs the exchange
    of the local aggregate (identity when the halo mode is none).
    """
    graph = as_graph(graph)
    impl = nmp_impl(plan)
    halo = plan.halo if halo is None else halo
    return impl(params, x, e, graph, plan, halo, sync_fn)
