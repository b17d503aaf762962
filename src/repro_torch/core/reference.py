"""Single-device stacked-rank evaluation of the consistent GNN (port of
``repro.core.reference``, forward, blocking schedule).

Runs the R-rank partitioned model on ONE device by looping ranks in python
and emulating the halo exchange over the stacked aggregate
(``halo_sync_reference`` by default, or ``sync_fn`` such as
``halo_sync_stacked`` for the mode-faithful per-rank arithmetic, which runs
the packed pack/unpack kernels under ``HaloSpec(packed=True)``).  The NMP
hot loop goes through the same ``edge_update_aggregate`` as one rank's
forward, so a fused plan runs the CUDA kernel here too.  This is how the
1-rank == R-rank guarantee is checked on one card.
"""
from __future__ import annotations

import torch

from repro_torch import nn
from repro_torch.core.consistent_mp import edge_update_aggregate, node_update
from repro_torch.core.gnn import build_edge_inputs
from repro_torch.core.graph_state import BLOCKING, NMPPlan, ShardedGraph, as_graph
from repro_torch.core.halo import NONE, halo_sync_reference


def _smooth_stacked(lp, h, e, g: ShardedGraph, plan: NMPPlan, sync_fn=None):
    """One consistent NMP layer over the stacked ranks."""
    if plan.schedule != BLOCKING:
        raise NotImplementedError(
            f"schedule {plan.schedule!r} is not ported to repro_torch yet")
    sync = halo_sync_reference if sync_fn is None else sync_fn
    R = h.shape[0]
    ranks = [g.rank(r) for r in range(R)]
    outs = [edge_update_aggregate(lp, h[r], e[r], ranks[r], plan)
            for r in range(R)]
    agg = torch.stack([o[1] for o in outs])
    if plan.halo.mode != NONE:
        agg = sync(agg, g, plan.halo, combine="sum")
    e_new = torch.stack([o[0] for o in outs])
    h_new = torch.stack([node_update(lp, h[r], agg[r], ranks[r])
                         for r in range(R)])
    return h_new, e_new


def gnn_forward_stacked(params: nn.Params, x: torch.Tensor, graph,
                        plan: NMPPlan, sync_fn=None) -> torch.Tensor:
    """Paper GNN forward over all R ranks on one device.

    ``x``: [R, N_pad, F_x] -> [R, N_pad, F_y].
    """
    g0 = as_graph(graph)
    R = x.shape[0]
    hs, es = [], []
    for r in range(R):
        g_r = g0.rank(r)
        hs.append(nn.mlp(params["node_enc"], x[r]) * g_r["node_mask"][:, None])
        es.append(nn.mlp(params["edge_enc"], build_edge_inputs(x[r], g_r))
                  * g_r["edge_mask"][:, None])
    h, e = torch.stack(hs), torch.stack(es)
    for lp in params["mp"]:
        h, e = _smooth_stacked(lp, h, e, g0, plan, sync_fn)
    return torch.stack([nn.mlp(params["node_dec"], h[r])
                        * g0["node_mask"][r][:, None] for r in range(R)])
