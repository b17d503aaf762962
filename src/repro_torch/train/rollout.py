"""Multi-step autoregressive rollout (port of ``repro.train.rollout``).

``rollout_step`` runs the consistent GNN over its own predictions for K
steps in a python loop (the reference scans), accumulating each step's
Eq. 6 loss (consistent over the loss group) against ``targets[k]``;
pushforward noise perturbs the step-1 input, detached.  On top of it, for
one process of a ``(data, graph)`` mesh or, without one, one device:

* ``make_rollout_step_fns`` -> (``rollout_eval``, ``rollout_grad``) over
  ``[B, 1, N_pad, F]`` inputs and ``[B, K, 1, N_pad, F]`` targets;
* ``make_rollout_predict_fn`` — the inference rollout the serving engine
  runs (zero targets, one batch slot at a time; with a mesh, each process
  its own rank, through the posted exchange under the overlap schedule);
* ``curriculum_k`` and ``make_tgv_rollout_batch_fn``, both PURE in
  ``step`` (the deterministic-replay contract): snapshot times are
  ``(step*batch + b)*dt`` and noise is drawn from
  ``default_rng(seed + step*batch + b)`` on the GLOBAL node field, then
  gathered per rank, so coincident copies get the same perturbation.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.consistent_loss import consistent_mse
from repro_torch.core.distributed import (
    average_gradients, data_mean, halo_fns, local_graph, one_rank_plan)
from repro_torch.core.gnn import GNNConfig, gnn_forward
from repro_torch.core.graph_state import NMPPlan, as_graph
from repro_torch.core.mesh_gen import SEMMesh, taylor_green_velocity
from repro_torch.core.partition import PartitionedGraphs, gather_node_features


def curriculum_k(stages: Sequence[int], n_steps: int, step: int) -> int:
    """Rollout depth K for ``step`` under a staged curriculum: ``stages``
    (e.g. ``(1, 2, 4)``) split ``n_steps`` into even stages of increasing
    K.  Pure in ``step``."""
    stages = tuple(stages)
    if not stages:
        return 1
    stage_len = max(1, -(-n_steps // len(stages)))
    return stages[min(step // stage_len, len(stages) - 1)]


def rollout_step(params, x0, targets, graph, plan: NMPPlan, noise=None,
                 group=None, sync_fns=None):
    """Rank-local K-step autoregressive rollout.

    ``x0``: [N_pad, F] or [B, N_pad, F]; ``targets``: [K, ...x0 shape...];
    ``noise`` (pushforward) perturbs only the step-1 input, detached;
    ``group`` is the loss's graph group and ``sync_fns`` each level's halo
    exchange (``core/distributed.py::halo_fns``; both None on one rank).  Returns (mean per-step loss,
    predictions [K, ..., N_pad, F]).
    """
    graph = as_graph(graph)
    x = x0 if noise is None else x0 + noise.detach()
    losses, preds = [], []
    for tgt in targets:
        y = gnn_forward(params, x, graph, plan, sync_fns=sync_fns)
        losses.append(consistent_mse(y, tgt, graph["node_inv_mult"], group=group))
        preds.append(y)
        x = y
    return torch.stack(losses).mean(), torch.stack(preds)


def make_rollout_predict_fn(cfg: GNNConfig, plan: NMPPlan, rollout_steps: int,
                            mesh=None):
    """Inference-only rollout: ``predict(params, x0, graph) -> preds``.

    ``x0``: [B, 1, N_pad, F] (numpy or tensor): on a stacked one-rank graph
    without a mesh, or this process's rank slice on its rank-local graph
    with one; returns a tensor [B, K, 1, N_pad, F] on the graph's device,
    each rank its own predictions.  Zero targets make ``rollout_step`` an
    exact inference forward, so serving runs the same rollout the
    consistency tests pin.  Each batch slot runs on its own, so a
    prediction's bits do not depend on the slot count or on the other
    slots.
    """
    del cfg  # the architecture is entirely encoded in the params tree
    local_plan = one_rank_plan(plan) if mesh is None else plan
    zeros_cache: dict = {}

    @torch.no_grad()
    def predict(params, x0, graph):
        g = local_graph(graph, mesh)
        xs = torch.as_tensor(x0, dtype=torch.float32).to(g.device)
        b, r, n, f = xs.shape
        if r != 1:
            raise ValueError(f"x0 carries {r} ranks; pass this process's [B, 1, "
                             "N_pad, F] slice")
        key = (n, f)
        if key not in zeros_cache:
            zeros_cache[key] = torch.zeros(rollout_steps, n, f, device=g.device)
        targets = zeros_cache[key]
        sync = None if mesh is None else halo_fns(local_plan, g, mesh)
        preds = [rollout_step(params, xs[i, 0], targets, g, local_plan,
                              sync_fns=sync)[1]
                 for i in range(b)]
        return torch.stack(preds)[:, :, None]          # [B, K, 1, N, F]

    return predict


def make_rollout_step_fns(cfg: GNNConfig, plan: NMPPlan, rollout_steps: int,
                          mesh=None):
    """(rollout_eval, rollout_grad) of this process.

    ``rollout_eval(params, x0, targets, noise, graph) -> (loss, preds)``
    with x0/noise [B, 1, N_pad, F], targets [B, K, 1, N_pad, F] and preds
    [B, K, 1, N_pad, F]; ``rollout_grad`` returns (loss, d loss / d params)
    instead, averaged over every process of ``mesh``.  ``rollout_steps``
    must match the K dim of ``targets``.  Without a mesh a graph of R > 1
    ranks raises (see ``repro_torch.core.distributed``).
    """
    del cfg  # the architecture is entirely encoded in the params tree
    local_plan = one_rank_plan(plan) if mesh is None else plan

    def rollout_local(params, x0, targets, noise, graph):
        if targets.shape[1] != rollout_steps:
            raise ValueError(
                f"targets carry K={targets.shape[1]} steps but the step "
                f"fns were built for rollout_steps={rollout_steps}")
        g = local_graph(graph, mesh)
        tgt = targets[:, :, 0].movedim(1, 0)             # [K, B, N_pad, F]
        loss, preds = rollout_step(
            params, x0[:, 0], tgt, g, local_plan, noise=noise[:, 0],
            group=None if mesh is None else mesh.graph_group,
            sync_fns=None if mesh is None else halo_fns(local_plan, g, mesh))
        if mesh is not None:
            loss = data_mean(loss, mesh)
        return loss, preds.movedim(0, 1)[:, :, None]

    @torch.no_grad()
    def rollout_eval(params, x0, targets, noise, graph):
        return rollout_local(params, x0, targets, noise, graph)

    def rollout_grad(params, x0, targets, noise, graph):
        (loss, _), grads = nn.value_and_grad(rollout_local, params, x0,
                                             targets, noise, graph,
                                             has_aux=True)
        if mesh is not None:
            grads = average_gradients(grads, mesh)
        return loss, grads

    return rollout_eval, rollout_grad


def make_tgv_rollout_batch_fn(pg: PartitionedGraphs, mesh_sem: SEMMesh,
                              batch: int, rollout_steps: int,
                              dt: float = 0.05, noise_scale=0.0,
                              seed: int = 0, samples=None, rank=None):
    """Deterministic Taylor-Green rollout batches keyed by step.

    Returns ``batch_fn(step) -> (x0 [B, R, N_pad, F], targets
    [B, K, R, N_pad, F], noise [B, R, N_pad, F])`` as numpy, targets the
    next ``rollout_steps`` snapshots of the analytic TGV trajectory.
    ``noise_scale`` is a float or a ``step -> float`` callable.  One
    process's share: ``samples`` (indices into the batch of ``batch``) and
    ``rank`` (R = 1: that rank's rows), each sample the same as in the
    whole batch.
    """
    samples = range(batch) if samples is None else samples

    def batch_fn(step: int):
        scale = noise_scale(step) if callable(noise_scale) else noise_scale
        x0s, tgts, noises = [], [], []
        for b in samples:
            t = (step * batch + b) * dt % 2.0
            x0s.append(gather_node_features(
                pg, taylor_green_velocity(mesh_sem.coords, t=t), rank))
            tgts.append(np.stack([
                gather_node_features(
                    pg, taylor_green_velocity(mesh_sem.coords,
                                              t=t + (k + 1) * dt), rank)
                for k in range(rollout_steps)]))
            rng = np.random.default_rng(
                np.uint64(seed) + np.uint64(step * batch + b))
            nz = rng.normal(size=(mesh_sem.coords.shape[0],
                                  x0s[-1].shape[-1])).astype(np.float32)
            noises.append(scale * gather_node_features(pg, nz, rank))
        return (np.stack(x0s), np.stack(tgts),
                np.stack(noises).astype(np.float32))
    return batch_fn
