"""Multi-step autoregressive rollout (port of ``repro.train.rollout``:
``rollout_step`` and ``make_rollout_predict_fn``; the training step fns
come with training in a later slice).

``rollout_step`` runs the consistent GNN over its own predictions for K
steps in a python loop (the reference scans), accumulating each step's
Eq. 6 loss against ``targets[k]``.
"""
from __future__ import annotations

import torch

from repro_torch.core.consistent_loss import consistent_mse
from repro_torch.core.gnn import GNNConfig, gnn_forward
from repro_torch.core.graph_state import NMPPlan, as_graph


def rollout_step(params, x0, targets, graph, plan: NMPPlan, noise=None):
    """Rank-local K-step autoregressive rollout.

    ``x0``: [N_pad, F] or [B, N_pad, F]; ``targets``: [K, ...x0 shape...];
    ``noise`` (pushforward) perturbs only the step-1 input, detached.
    Returns (mean per-step loss, predictions [K, ..., N_pad, F]).
    """
    graph = as_graph(graph)
    x = x0 if noise is None else x0 + noise.detach()
    losses, preds = [], []
    for tgt in targets:
        y = gnn_forward(params, x, graph, plan)
        losses.append(consistent_mse(y, tgt, graph["node_inv_mult"]))
        preds.append(y)
        x = y
    return torch.stack(losses).mean(), torch.stack(preds)


def make_rollout_predict_fn(cfg: GNNConfig, plan: NMPPlan, rollout_steps: int):
    """Inference-only rollout: ``predict(params, x0, graph) -> preds``.

    ``x0``: [B, R, N_pad, F] (numpy or tensor) on a stacked one-rank graph;
    returns a tensor [B, K, R, N_pad, F] on the graph's device.  Zero
    targets make ``rollout_step`` an exact inference forward, so serving
    runs the same rollout the consistency tests pin.  Each batch slot runs
    on its own, so a prediction's bits do not depend on the slot count or
    on the other slots.  Multi-rank serving needs the ``torch.distributed``
    halo (a later slice) and raises.
    """
    del cfg  # the architecture is entirely encoded in the params tree
    zeros_cache: dict = {}

    @torch.no_grad()
    def predict(params, x0, graph):
        graph = as_graph(graph)
        xs = torch.as_tensor(x0, dtype=torch.float32).to(graph.device)
        b, r, n, f = xs.shape
        if r != 1:
            raise NotImplementedError(
                f"serving a {r}-rank partition needs the torch.distributed "
                "halo exchange, which is not ported yet")
        g = graph.rank(0)
        key = (n, f)
        if key not in zeros_cache:
            zeros_cache[key] = torch.zeros(rollout_steps, n, f,
                                           device=graph.device)
        targets = zeros_cache[key]
        preds = [rollout_step(params, xs[i, 0], targets, g, plan)[1]
                 for i in range(b)]
        return torch.stack(preds)[:, :, None]          # [B, K, 1, N, F]

    return predict
