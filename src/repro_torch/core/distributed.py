"""GNN step functions over a ``(data, graph)`` process mesh (port of
``repro.core.distributed``).

``make_gnn_step_fns`` returns ``(eval_step, loss_step, grad_step,
train_step)`` with the reference's contract: the loss is the Eq. 6
consistent MSE over the graph group, averaged over the batch and over the
data group; ``grad_step`` returns (loss, d loss / d params), the same on
every process; ``train_step`` is plain SGD for consistency experiments (the
training loop uses ``grad_step`` with AdamW).

* With a mesh (``repro_torch.launch.mesh.make_mesh``), each process passes
  its own ``[B_local, 1, N_pad, F]`` block (:func:`shard_inputs`) and its
  rank-local graph (:func:`shard_graph`); each layer's halo exchange is
  ``core/halo.py::halo_sync`` over the graph group, and the gradients are
  averaged over every process in one flattened all-reduce
  (:func:`average_gradients`); a multilevel graph has one exchange per
  level (:func:`halo_fns`).  Under the overlap schedule the eval step
  (no gradient) posts each exchange and finishes it after queueing the
  interior side (:class:`HaloFn`); the gradient steps finish it at once,
  between the sides.
* Under a model axis (``make_mesh(..., model=M)``), each process holds
  a slice of its rank's edges (:func:`local_graph_of`) and sums its
  partial aggregates over the edge group
  (``core/consistent_mp.py::EdgeParallel``); the average over every
  process is still dL / d theta (``configs/gnn_common.py::
  gnn_loss_and_grads``).
* Without one, the inputs are ``[B, 1, N_pad, F]`` on a stacked one-rank
  graph: the reference's ``pmean``s are identities, and so is the halo
  exchange (a rank with no peers has nothing to exchange), so any halo
  mode runs as ``none``.  A graph of R > 1 ranks raises: it needs a mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.consistent_loss import all_reduce_sum, consistent_mse
from repro_torch.core.gnn import GNNConfig, gnn_forward
from repro_torch.core.graph_state import NMPPlan, ShardedGraph, as_graph, edge_shard
from repro_torch.core.halo import NONE, HaloSpec, halo_sync, halo_sync_post


def one_rank(graph) -> ShardedGraph:
    """The rank-local graph of a stacked one-rank graph; R > 1 raises."""
    graph = as_graph(graph)
    n_ranks = int(graph["node_mask"].shape[0])
    if n_ranks != 1:
        raise ValueError(
            f"a {n_ranks}-rank graph needs a mesh: run one process per rank "
            "(repro_torch.launch.mesh.spawn + make_mesh) and pass mesh= to the "
            "step functions, or run the stacked reference "
            "(repro_torch.core.reference)")
    return graph.rank(0)


def one_rank_plan(plan: NMPPlan) -> NMPPlan:
    """``plan`` with every level's halo exchange dropped: one rank has no
    peers."""
    if plan.halo.mode == NONE and not plan.coarse_halos:
        return plan
    return dataclasses.replace(plan, halo=HaloSpec(mode=NONE), coarse_halos=())


def shard_graph(mesh, graph) -> ShardedGraph:
    """This process's rank-local graph (every level) on its device, from a
    stacked graph (a rank-local one passes through)."""
    graph = as_graph(graph)
    if graph["node_mask"].dim() == 2:
        if graph["node_mask"].shape[0] != mesh.graph:
            raise ValueError(f"the graph has {graph['node_mask'].shape[0]} ranks, "
                             f"the mesh {mesh.graph}")
        graph = graph.rank(mesh.rank)
    return graph.to(mesh.device)


def shard_inputs(mesh, x, graph):
    """This process's block of a host batch ``x`` [B, R, N_pad, F] (numpy
    or tensor): its replica's ``B / D`` samples of its rank, as
    [B / D, 1, N_pad, F] on its device; with :func:`shard_graph` of
    ``graph``."""
    b = x.shape[0]
    if b % mesh.data:
        raise ValueError(f"batch {b} does not split over {mesh.data} data replicas")
    n = b // mesh.data
    block = x[mesh.replica * n:(mesh.replica + 1) * n, mesh.rank:mesh.rank + 1]
    xs = torch.as_tensor(np.ascontiguousarray(block) if isinstance(block, np.ndarray)
                         else block, dtype=torch.float32).to(mesh.device)
    return xs, shard_graph(mesh, graph)


def data_mean(loss: torch.Tensor, mesh) -> torch.Tensor:
    """The loss averaged over the data group (differentiable)."""
    return all_reduce_sum(loss, mesh.data_group) / mesh.data


def average_gradients(grads, mesh):
    """Each leaf averaged over every process of the mesh, in one flattened
    all-reduce (see ``core/consistent_loss.py::_AllReduceSum`` for why
    the average is dL / d theta)."""
    leaves = nn.tree_leaves(grads)
    flat = torch.cat([g.reshape(-1) for g in leaves])
    flat = mesh.world_group.all_reduce(flat) / mesh.world_group.size
    parts = flat.split([g.numel() for g in leaves])
    return nn.tree_unflatten(grads, [p.view_as(g) for p, g in zip(parts, leaves)])


class HaloFn:
    """Each layer's halo exchange on this process's rank-local graph:
    called, the exchange itself (``halo_sync``, differentiable); ``post``,
    the exchange posted (``halo_sync_post``), which the overlap schedule
    finishes after queueing the interior side when no gradient is needed."""
    __slots__ = ("graph", "spec", "mesh")

    def __init__(self, graph, spec: HaloSpec, mesh):
        self.graph, self.spec, self.mesh = graph, spec, mesh

    def __call__(self, agg: torch.Tensor) -> torch.Tensor:
        return halo_sync(agg, self.graph, self.spec, self.mesh)

    def post(self, agg: torch.Tensor):
        self.mesh.graph_group.transport.overlapped += 1
        return halo_sync_post(agg, self.graph, self.spec, self.mesh)


def halo_fns(plan: NMPPlan, graph, mesh) -> tuple:
    """The ``sync_fns`` of ``gnn_forward`` for this process's graph: one
    :class:`HaloFn` per level of ``graph`` (fine first) on that level's
    graph and spec (``plan.halos``), None where the mode is none."""
    levels = as_graph(graph).levels
    return tuple(None if spec.mode == NONE else HaloFn(g, spec, mesh)
                 for g, spec in zip(levels, plan.halos(len(levels))))


def local_graph(graph, mesh) -> ShardedGraph:
    """This process's rank-local graph: :func:`one_rank` without a mesh."""
    return one_rank(graph) if mesh is None else shard_graph(mesh, graph)


def local_partition(pg, mesh=None):
    """This process's share of a partition ``pg``: under a model axis
    (``mesh.model > 1``) every rank's nodes whole and its model shard's
    slice of their edges (``core/graph_state.py::edge_shard``; ``e_pad``
    must split evenly, ``pad_edges``); ``pg`` itself otherwise."""
    if mesh is None or mesh.model == 1:
        return pg
    return edge_shard(pg, mesh.shard, mesh.model)


def local_graph_of(pg, coords, plan: NMPPlan, mesh=None, device=None) -> ShardedGraph:
    """This process's rank-local graph of partition ``pg``, built with
    ``plan`` (its layouts, split and wires) on the mesh's device: rank
    ``mesh.rank``'s arrays over its model shard's edges
    (:func:`local_partition`), so a fused plan's compact layout and an
    overlap plan's interior/boundary split are those of the slice.  Without
    a mesh, the one rank of ``pg`` on ``device``."""
    if mesh is None:
        if pg.R != 1:
            raise ValueError(f"a {pg.R}-rank partition needs a mesh (make_mesh)")
        return ShardedGraph.build(pg, coords, plan, device=device or "cuda", rank=0)
    if pg.R != mesh.graph:
        raise ValueError(f"the partition has {pg.R} ranks, the mesh {mesh.graph}")
    return ShardedGraph.build(local_partition(pg, mesh), coords, plan, device=mesh.device,
                              rank=mesh.rank)


def make_gnn_step_fns(cfg: GNNConfig, plan: NMPPlan,
                      learning_rate: float = 1e-3, mesh=None):
    """(eval_step, loss_step, grad_step, train_step) of this process.

    ``eval_step(params, x, graph) -> y [B, 1, N_pad, F_y]``;
    ``loss_step(params, x, y_hat, graph) -> loss``;
    ``grad_step(params, x, y_hat, graph) -> (loss, grads)``;
    ``train_step(params, x, y_hat, graph) -> (loss, new params)`` (SGD).
    ``mesh``: this process's ``(data, graph)`` mesh, or None for one rank
    and one replica (module docstring).
    """
    del cfg  # the architecture is entirely encoded in the params tree
    local_plan = one_rank_plan(plan) if mesh is None else plan

    def forward(params, x, graph):
        g = local_graph(graph, mesh)
        sync = None if mesh is None else halo_fns(local_plan, g, mesh)
        return gnn_forward(params, x[:, 0], g, local_plan, sync_fns=sync), g

    def loss_local(params, x, y_hat, graph):
        y, g = forward(params, x, graph)
        if mesh is None:
            return consistent_mse(y, y_hat[:, 0], g["node_inv_mult"]), y
        loss = consistent_mse(y, y_hat[:, 0], g["node_inv_mult"],
                              group=mesh.graph_group)
        return data_mean(loss, mesh), y

    @torch.no_grad()
    def eval_step(params, x, graph):
        return forward(params, x, graph)[0][:, None]

    @torch.no_grad()
    def loss_step(params, x, y_hat, graph):
        return loss_local(params, x, y_hat, graph)[0]

    def grad_step(params, x, y_hat, graph):
        (loss, _), grads = nn.value_and_grad(loss_local, params, x, y_hat,
                                             graph, has_aux=True)
        if mesh is not None:
            grads = average_gradients(grads, mesh)
        return loss, grads

    def train_step(params, x, y_hat, graph):
        loss, grads = grad_step(params, x, y_hat, graph)
        with torch.no_grad():
            new = nn.tree_map(lambda p, g: p - learning_rate * g, params, grads)
        return loss, new

    return eval_step, loss_step, grad_step, train_step
