"""Single-device stacked-rank evaluation of the consistent GNN (port of
``repro.core.reference``, flat graphs): the stacked forward, the Eq. 6
loss over the stacked ranks, its parameter gradients
(``torch.autograd.grad`` where the reference uses ``value_and_grad``) and
the K-step rollout oracle, under the blocking or the overlap schedule.

Runs the R-rank partitioned model on ONE device by looping ranks in python
and emulating the halo exchange over the stacked aggregate
(``halo_sync_reference`` by default, or ``sync_fn`` such as
``halo_sync_stacked`` for the mode-faithful per-rank arithmetic, which runs
the packed pack/unpack kernels under ``HaloSpec(packed=True)``).  The NMP
hot loop goes through the same ``edge_update_aggregate`` (and, under the
overlap schedule, ``edge_update_aggregate_part`` once per side) as one
rank's forward, so a fused plan runs the CUDA kernel here too.  This is how
the 1-rank == R-rank guarantee is checked on one card, for values and for
gradients: the backward runs the fused backward kernel and, under the
packed exchange, the pack/unpack kernels as each other's adjoint.  The
plan's precision holds on every rank; on a bf16 plan each rank's layer
call rounds its own weight gradients to bf16, where the reference's
stacked xla path rounds once over every rank's edges.

Params with a ``"coarse"`` list run the multilevel V-cycle
(:func:`vcycle_stacked`) over a graph built from the hierarchy: every
level's exchange (the transfers' completions included) goes through the
same stacked ``sync_fn`` on that level's graph and halo spec.
"""
from __future__ import annotations

import torch

from repro_torch import nn
from repro_torch.core.consistent_mp import (
    check_coarse_halos, edge_update_aggregate, edge_update_aggregate_part,
    join_sides, node_update, prolong_aggregate, restrict_aggregate)
from repro_torch.core.gnn import build_edge_inputs
from repro_torch.core.graph_state import (
    BLOCKING, OVERLAP, NMPPlan, ShardedGraph, as_graph)
from repro_torch.core.halo import NONE, HaloSpec, halo_sync_reference


def _smooth_stacked(lp, h, e, g: ShardedGraph, plan: NMPPlan, sync_fn=None,
                    halo: HaloSpec | None = None):
    """One consistent NMP layer over the stacked ranks (``halo``: the
    level's spec, ``plan.halo`` by default).  Under the overlap schedule
    every rank's boundary side runs first, the exchange takes their
    aggregates, and the interior sides are added after it."""
    if plan.schedule not in (BLOCKING, OVERLAP):
        raise NotImplementedError(
            f"schedule {plan.schedule!r} is not ported to repro_torch yet")
    sync = _stacked_sync(sync_fn)
    halo = plan.halo if halo is None else halo
    R = h.shape[0]
    ranks = [g.rank(r) for r in range(R)]
    if plan.schedule == OVERLAP:
        outs_b = [edge_update_aggregate_part(lp, h[r], e[r], ranks[r], "bnd", plan)
                  for r in range(R)]
        agg = torch.stack([o[1] for o in outs_b])
        agg = sync(agg, g, halo)
        outs_i = [edge_update_aggregate_part(lp, h[r], e[r], ranks[r], "int", plan)
                  for r in range(R)]
        agg = agg + torch.stack([o[1] for o in outs_i])
        e_new = torch.stack([join_sides(b[0], i[0], ranks[r])
                             for r, (b, i) in enumerate(zip(outs_b, outs_i))])
    else:
        outs = [edge_update_aggregate(lp, h[r], e[r], ranks[r], plan)
                for r in range(R)]
        agg = torch.stack([o[1] for o in outs])
        agg = sync(agg, g, halo)
        e_new = torch.stack([o[0] for o in outs])
    h_new = torch.stack([node_update(lp, h[r], agg[r], ranks[r])
                         for r in range(R)])
    return h_new, e_new


def _stacked_sync(sync_fn):
    """The stacked exchange ``sync(a, graph, spec)`` of ``sync_fn`` (the
    canonical-order oracle by default); halo mode none is the identity."""
    sync_fn = halo_sync_reference if sync_fn is None else sync_fn

    def sync(a, g, spec):
        return a if spec.mode == NONE else sync_fn(a, g, spec, combine="sum")
    return sync


def vcycle_stacked(coarse_params, h: torch.Tensor, graph, plan: NMPPlan,
                   sync_fn=None) -> torch.Tensor:
    """Single-device emulator of ``consistent_mp.multilevel_vcycle`` over
    the stacked ranks: each rank's transfers and layers as one rank runs
    them, every exchange (the transfers' completions included) through
    ``sync_fn`` on the level's stacked graph and spec (``plan.halos``).
    ``h``: [R, N_pad, H] -> [R, N_pad, H]."""
    graph = as_graph(graph)
    n_levels = len(coarse_params) + 1
    graph.level(n_levels - 1)          # loud error if coarse levels missing
    levels = graph.levels
    check_coarse_halos(plan, n_levels)
    halos = plan.halos(n_levels)
    sync = _stacked_sync(sync_fn)
    R = h.shape[0]

    states = [h]
    for lvl in range(1, n_levels):
        g = levels[lvl]
        ranks = [g.rank(r) for r in range(R)]
        c = torch.stack([restrict_aggregate(states[-1][r], ranks[r])
                         for r in range(R)])
        c = sync(c, g, halos[lvl]) * g["node_mask"][..., None]
        p = coarse_params[lvl - 1]
        e = torch.stack([nn.mlp(p["edge_enc"], ranks[r]["static_edge_feats"])
                         * ranks[r]["edge_mask"][:, None] for r in range(R)])
        for lp in p["mp"]:
            c, e = _smooth_stacked(lp, c, e, g, plan, sync_fn, halos[lvl])
        states.append(c)
    for lvl in range(n_levels - 1, 0, -1):
        gt, gf = levels[lvl], levels[lvl - 1]
        up = torch.stack([prolong_aggregate(states[lvl][r], gt.rank(r))
                          for r in range(R)])
        up = sync(up, gf, halos[lvl - 1])
        states[lvl - 1] = (states[lvl - 1] + up) * gf["node_mask"][..., None]
    return states[0]


def gnn_forward_stacked(params: nn.Params, x: torch.Tensor, graph,
                        plan: NMPPlan, sync_fn=None) -> torch.Tensor:
    """Paper GNN forward over all R ranks on one device; params with a
    ``"coarse"`` list run :func:`vcycle_stacked` before the decoder.

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
    if "coarse" in params:
        h = vcycle_stacked(params["coarse"], h, g0, plan, sync_fn)
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
