"""Single-device stacked-rank evaluation of the consistent GNN (port of
``repro.core.reference``, blocking schedule): the stacked forward, the
Eq. 6 loss over the stacked ranks, its parameter gradients
(``torch.autograd.grad`` where the reference uses ``value_and_grad``) and
the K-step rollout oracle.

Runs the R-rank partitioned model on ONE device by looping ranks in python
and emulating the halo exchange over the stacked aggregate
(``halo_sync_reference`` by default, or ``sync_fn`` such as
``halo_sync_stacked`` for the mode-faithful per-rank arithmetic, which runs
the packed pack/unpack kernels under ``HaloSpec(packed=True)``).  The NMP
hot loop goes through the same ``edge_update_aggregate`` as one rank's
forward, so a fused plan runs the CUDA kernel here too.  This is how the
1-rank == R-rank guarantee is checked on one card, for values and for
gradients: the backward runs the fused backward kernel and, under the
packed exchange, the pack/unpack kernels as each other's adjoint.
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


def consistent_loss_stacked(y: torch.Tensor, y_hat: torch.Tensor, graph,
                            fy: int) -> torch.Tensor:
    """Eq. 6 with the cross-rank sum taken over the stacked ranks."""
    err2 = ((y - y_hat) ** 2).sum(dim=-1)              # [R, N_pad]
    inv = graph["node_inv_mult"]
    return (err2 * inv).sum() / (inv.sum() * fy)


def loss_and_grad_stacked(params: nn.Params, x: torch.Tensor,
                          y_hat: torch.Tensor, graph, plan: NMPPlan, fy: int,
                          sync_fn=None):
    """Eq. 6 loss of the stacked forward and its parameter gradients.

    ``x``/``y_hat``: [R, N_pad, F].  ``sync_fn`` as in
    :func:`gnn_forward_stacked`.  Returns (loss, y [R, N_pad, F_y], grads),
    all detached; ``grads`` has the params' tree.
    """
    graph = as_graph(graph)

    def f(p):
        y = gnn_forward_stacked(p, x, graph, plan, sync_fn=sync_fn)
        return consistent_loss_stacked(y, y_hat, graph, fy), y
    (loss, y), grads = nn.value_and_grad(f, params, has_aux=True)
    return loss, y, grads


def rollout_stacked(params: nn.Params, x0: torch.Tensor, targets: torch.Tensor,
                    graph, plan: NMPPlan, fy: int, noise=None, sync_fn=None):
    """Single-device oracle for the K-step autoregressive rollout
    (``repro_torch.train.rollout``): the model runs over its OWN
    predictions, each step's Eq. 6 loss is accumulated, and optional
    pushforward noise perturbs the step-1 input, detached.

    ``x0``: [R, N_pad, F]; ``targets``: [K, R, N_pad, F].  Differentiable
    in ``params``.  Returns (mean per-step loss, predictions [K, R, N_pad, F]).
    """
    graph = as_graph(graph)
    x = x0 if noise is None else x0 + noise.detach()
    losses, preds = [], []
    for tgt in targets:
        y = gnn_forward_stacked(params, x, graph, plan, sync_fn=sync_fn)
        losses.append(consistent_loss_stacked(y, tgt, graph, fy))
        preds.append(y)
        x = y                                   # run over own prediction
    return torch.stack(losses).mean(), torch.stack(preds)
