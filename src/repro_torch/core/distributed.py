"""GNN step functions on one device (the one-rank, one-replica part of
``repro.core.distributed``).

``make_gnn_step_fns`` returns ``(eval_step, loss_step, grad_step,
train_step)`` over ``[B, 1, N_pad, F]`` inputs and a stacked one-rank
:class:`~repro_torch.core.graph_state.ShardedGraph`, with the reference's
contract: the loss is the Eq. 6 consistent MSE, averaged over the batch;
``grad_step`` returns (loss, d loss / d params); ``train_step`` is plain SGD
for consistency experiments (the training loop uses ``grad_step`` with
AdamW).  With one rank and one data replica the reference's ``pmean``s are
identities, and so is the halo exchange: a rank with no peers has nothing
to exchange, so any halo mode runs as ``none``.  A graph of R > 1 ranks
needs the ``torch.distributed`` halo exchange, a later slice, and raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn
from repro_torch.core.consistent_loss import consistent_mse
from repro_torch.core.gnn import GNNConfig, gnn_forward
from repro_torch.core.graph_state import NMPPlan, ShardedGraph, as_graph
from repro_torch.core.halo import NONE, HaloSpec


def one_rank(graph) -> ShardedGraph:
    """The rank-local graph of a stacked one-rank graph; R > 1 raises."""
    graph = as_graph(graph)
    n_ranks = int(graph["node_mask"].shape[0])
    if n_ranks != 1:
        raise NotImplementedError(
            f"a {n_ranks}-rank graph needs the torch.distributed halo "
            "exchange (ROADMAP queue: 'Real torch.distributed halo and "
            "core/distributed.py'), which is not ported yet; run the stacked "
            "reference (repro_torch.core.reference) or partition with ranks "
            "(1, 1, 1)")
    return graph.rank(0)


def one_rank_plan(plan: NMPPlan) -> NMPPlan:
    """``plan`` with its halo exchange dropped: one rank has no peers."""
    if plan.halo.mode == NONE:
        return plan
    return dataclasses.replace(plan, halo=HaloSpec(mode=NONE))


def make_gnn_step_fns(cfg: GNNConfig, plan: NMPPlan,
                      learning_rate: float = 1e-3):
    """(eval_step, loss_step, grad_step, train_step) on one device.

    ``eval_step(params, x, graph) -> y [B, 1, N_pad, F_y]``;
    ``loss_step(params, x, y_hat, graph) -> loss``;
    ``grad_step(params, x, y_hat, graph) -> (loss, grads)``;
    ``train_step(params, x, y_hat, graph) -> (loss, new params)`` (SGD).
    """
    del cfg  # the architecture is entirely encoded in the params tree
    local_plan = one_rank_plan(plan)

    def loss_local(params, x, y_hat, graph):
        g = one_rank(graph)
        y = gnn_forward(params, x[:, 0], g, local_plan)
        return consistent_mse(y, y_hat[:, 0], g["node_inv_mult"]), y

    @torch.no_grad()
    def eval_step(params, x, graph):
        return gnn_forward(params, x[:, 0], one_rank(graph), local_plan)[:, None]

    @torch.no_grad()
    def loss_step(params, x, y_hat, graph):
        return loss_local(params, x, y_hat, graph)[0]

    def grad_step(params, x, y_hat, graph):
        (loss, _), grads = nn.value_and_grad(loss_local, params, x, y_hat,
                                             graph, has_aux=True)
        return loss, grads

    def train_step(params, x, y_hat, graph):
        loss, grads = grad_step(params, x, y_hat, graph)
        with torch.no_grad():
            new = nn.tree_map(lambda p, g: p - learning_rate * g, params, grads)
        return loss, new

    return eval_step, loss_step, grad_step, train_step
