"""GNN-family shapes, consistent losses, the step builder and the dry-run
cell machinery (port of ``repro.configs.gnn_common``).

Mesh layout.  The reference's GNN cells name their mesh axes ``data``
(the paper's spatial graph decomposition, R sub-graphs), ``model``
(edge-parallel sharding of each sub-graph's edges) and ``pod`` (data
parallelism).  The port's process mesh (``launch/mesh.py::make_mesh``)
names the same axes ``graph``, ``model`` and ``data``; the specs here use
the port's names, so the reference's ``P("data", "model", None)`` is the
port's ``("graph", "model", None)``.  A spec is one entry per dimension of
a stacked array: the mesh axis that splits it, or None.  Where the
reference's ``shard_map`` hands each device its block, a process here
takes its own with :func:`shard_by_specs` and builds its rank-local graph
with ``core/distributed.py::local_graph_of``.

The step builder (:func:`make_gnn_train_step`) is this process's step on
its rank-local graph: ``nn.value_and_grad`` of the caller's
``loss_local`` (which sums over the graph group itself, as the
reference's does over its graph axis), the gradients and the loss
averaged over every process of the mesh, as the reference's ``pmean``
over all axes is, then ``train/optimizer.py::adamw_update_``.

The dry-run cells (:func:`build_gnn_dryrun_cell`) describe a cell at its
full size without data: the shape-only structures of the reference's
``jax.ShapeDtypeStruct`` are ``device="meta"`` tensors here, and the
metadata is spec-only (``synthetic_partitioned_meta``: shapes and
XOR-pairing rounds, no host-side partitioning of 61M-edge graphs); the
``minibatch`` kind's block is ``graph/sampler.py``'s padded to 128.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.consistent_loss import all_reduce_sum
from repro_torch.core.distributed import HaloFn, average_gradients
from repro_torch.core.graph_state import EDGE_KEYS
from repro_torch.core.halo import NEIGHBOR, NONE, HaloSpec
from repro_torch.train.optimizer import AdamWConfig, adamw_update_, init_adamw

#: the port's names of the reference's GNN mesh axes (module docstring)
GRAPH, MODEL, DATA = "graph", "model", "data"

GNN_SHAPES: Dict[str, dict] = {
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556, d_feat=1433,
                          n_classes=7),
    "minibatch_lg": dict(kind="minibatch", n_nodes=232965, n_edges=114615892,
                         batch_nodes=1024, fanouts=(15, 10), d_feat=602,
                         n_classes=41),
    "ogb_products": dict(kind="full", n_nodes=2449029, n_edges=61859140,
                         d_feat=100, n_classes=47),
    "molecule": dict(kind="molecule", n_nodes=30, n_edges=64, batch=128),
}


def _round_up(x, m=128):
    # multiple of 128 so the edge dim can also shard over the model axis
    # (edge-parallel mode; core/graph_state.py::EDGE_MULTIPLE)
    return ((int(x) + m - 1) // m) * m


def xor_rounds(R: int, k: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """k neighbor rounds from XOR pairings (valid perfect matchings for R=2^j)."""
    rounds = []
    for c in range(1, k + 1):
        perm = []
        for r in range(R):
            s = r ^ c
            if s < R:
                perm.append((r, s))
        rounds.append(tuple(perm))
    return tuple(rounds)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def synthetic_partitioned_meta(R: int, n_nodes: int, n_edges_directed: int,
                               halo_frac: float = 0.12, k_rounds: int = 8,
                               imbalance: float = 1.10):
    """Meta tensors of ``PartitionedGraphs.device_arrays()`` for a graph of
    this size partitioned R ways (dry-run only: no data).  Returns (meta,
    n_pad, e_pad)."""
    n_pad = _round_up(n_nodes * imbalance / R + 1)
    e_pad = _round_up(n_edges_directed * imbalance / R + 1)
    buf = _round_up(max(n_pad * halo_frac / 4, 8))
    f32, i32 = torch.float32, torch.int32
    meta = dict(
        node_mask=_meta((R, n_pad), f32), node_inv_mult=_meta((R, n_pad), f32),
        edge_src=_meta((R, e_pad), i32), edge_dst=_meta((R, e_pad), i32),
        edge_mask=_meta((R, e_pad), f32), edge_inv_mult=_meta((R, e_pad), f32),
        a2a_send_idx=_meta((R, R, buf), i32), a2a_send_mask=_meta((R, R, buf), f32),
        a2a_recv_idx=_meta((R, R, buf), i32), a2a_recv_mask=_meta((R, R, buf), f32),
        nbr_send_idx=_meta((R, k_rounds, buf), i32),
        nbr_send_mask=_meta((R, k_rounds, buf), f32),
        nbr_recv_idx=_meta((R, k_rounds, buf), i32),
        nbr_recv_mask=_meta((R, k_rounds, buf), f32),
    )
    return meta, n_pad, e_pad


def meta_specs(meta, graph_axis: str = GRAPH, edge_parallel: bool = False):
    """Each key's spec: its rank dimension over ``graph_axis``; with
    ``edge_parallel`` the ``EDGE_KEYS``' edge dimension over ``model``."""
    out = {}
    for k, v in meta.items():
        if edge_parallel and k in EDGE_KEYS:
            out[k] = (graph_axis, MODEL) + (None,) * (v.dim() - 2)
        else:
            out[k] = (graph_axis,) + (None,) * (v.dim() - 1)
    return out


def _axis_block(mesh, axis: str) -> Tuple[int, int]:
    """(this process's index, the axis's size) of a mesh axis."""
    if axis == GRAPH:
        return mesh.rank, mesh.graph
    if axis == MODEL:
        return mesh.shard, mesh.model
    if axis == DATA:
        return mesh.replica, mesh.data
    raise ValueError(f"unknown mesh axis {axis!r}; expected {GRAPH!r}, {MODEL!r} "
                     f"or {DATA!r}")


def local_block(a, spec, mesh):
    """This process's block of a stacked array (numpy or tensor) under
    ``spec``: each dimension a spec names is cut to the process's equal
    share along that mesh axis, the rest kept whole, as ``shard_map``
    hands each device its block (a dimension of size R over the graph axis
    keeps a leading axis of 1).  Without a mesh, ``a`` itself."""
    if mesh is None:
        return a
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        i, n = _axis_block(mesh, axis)
        if a.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {a.shape[dim]} does not split "
                             f"over the {n} processes of axis {axis!r}")
        w = a.shape[dim] // n
        index.append(slice(i * w, (i + 1) * w))
    return a[tuple(index)]


def shard_by_specs(tree: dict, specs: dict, mesh=None, device=None) -> dict:
    """Every array of ``tree`` as this process's block (:func:`local_block`)
    of ``specs[key]``, a tensor on ``device`` (the mesh's device by
    default)."""
    device = device if device is not None else (mesh.device if mesh is not None else "cpu")
    out = {}
    for k, v in tree.items():
        block = local_block(v, specs[k], mesh)
        if isinstance(block, np.ndarray):
            block = torch.from_numpy(np.ascontiguousarray(block))
        out[k] = block.to(device)
    return out


# ---------------------------------------------------------------------------
# the distributed GNN train and eval steps
# ---------------------------------------------------------------------------

def world_mean(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """``t`` averaged over every process of the mesh (the reference's
    ``pmean`` over all axes); ``t`` itself without one."""
    if mesh is None or mesh.world_group.size == 1:
        return t
    return mesh.world_group.all_reduce(t) / mesh.world_group.size


def gnn_loss_and_grads(loss_local, params, inputs, graph, mesh=None):
    """(loss, grads) of this process: ``nn.value_and_grad`` of
    ``loss_local(params, inputs, graph)``, both averaged over every process
    of ``mesh``.  With each loss replicated over the graph and model groups
    (its sums are all-reduced, their backward too), process p's gradient
    is d(sum of every copy's loss) / d(its own parameters), and the mean of
    those over the world is dL / d theta (``core/consistent_loss.py::
    _AllReduceSum``): a model shard's copy reaches the other shards'
    edge-MLP parameters through the edge group's sum, as a rank's reaches
    the other ranks' through the halo exchange."""
    loss, grads = nn.value_and_grad(loss_local, params, inputs, graph)
    if mesh is not None:
        grads = average_gradients(grads, mesh)
    return world_mean(loss, mesh), grads


def sync_fn_of(graph, halo: HaloSpec, mesh=None):
    """The one-level halo exchange of a zoo model (GAT, NequIP, MACE) on
    this process's rank-local graph (``core/distributed.py::HaloFn``);
    None on one rank or under mode none."""
    return None if mesh is None or halo.mode == NONE else HaloFn(graph, halo, mesh)


def make_gnn_train_step(loss_local, opt: AdamWConfig, mesh=None):
    """``loss_local(params, inputs, graph) -> scalar`` (may use the mesh's
    collectives) -> ``step(state, inputs, graph) -> (state', loss)``, with
    ``state = {"params", "opt"}`` (``init_adamw``): this process's
    ``inputs`` block and rank-local ``graph``; the loss is the mean over
    the mesh.  The update is in place (``adamw_update_``): ``state'`` holds
    the same tensors.  Without a mesh, the one-rank step."""

    def step(state, inputs, graph):
        loss, grads = gnn_loss_and_grads(loss_local, state["params"], inputs, graph, mesh)
        params, opt_state, _ = adamw_update_(grads, state["opt"], state["params"], opt)
        return {"params": params, "opt": opt_state}, loss

    return step


def make_gnn_eval_step(fwd_local):
    """``fwd_local(params, inputs, graph)`` -> ``eval_step(params, inputs,
    graph)``, without gradients: each process's own output (its rank's
    rows), as the reference's ``out_specs`` leave them; the collectives
    are ``fwd_local``'s own."""

    @torch.no_grad()
    def eval_step(params, inputs, graph):
        return fwd_local(params, inputs, graph)

    return eval_step


def consistent_ce_loss(logits, labels, node_inv_mult, group=None):
    """Partition-consistent node-classification cross entropy (Eq. 6
    analog): each node's term weighted by its inverse multiplicity, the
    sum and the effective count summed over ``group`` (the graph group;
    None on one rank)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    s = torch.sum(-ll * node_inv_mult)
    n = torch.sum(node_inv_mult)
    return all_reduce_sum(s, group) / torch.clamp(all_reduce_sum(n, group), min=1e-9)


def consistent_mse_loss(pred, target, node_inv_mult, group=None):
    """Partition-consistent squared error, summed over the features of a
    node (averaged over nodes by their inverse multiplicities)."""
    err = torch.sum((pred - target) ** 2, dim=-1) if pred.dim() > 1 else (pred - target) ** 2
    s = torch.sum(err * node_inv_mult)
    n = torch.sum(node_inv_mult)
    return all_reduce_sum(s, group) / torch.clamp(all_reduce_sum(n, group), min=1e-9)


# ---------------------------------------------------------------------------
# dry-run cell builder shared by the GNN archs
# ---------------------------------------------------------------------------

def _mesh_size(mesh, axis: str) -> int:
    """An axis's size in a process mesh or a dict of axis sizes."""
    if isinstance(mesh, dict):
        return int(mesh.get(axis, 1))
    return _axis_block(mesh, axis)[1]


def build_gnn_dryrun_cell(shape_id: str, mesh, *, loss_local_factory, inputs_factory,
                          param_factory, halo_mode: str = NEIGHBOR, overrides=None):
    """Wire one (gnn arch x shape) cell.

    ``mesh`` is a process mesh (``launch/mesh.py``) or a dict of axis
    sizes (``{"graph": 16, "model": 16}``: a shape-only cell).
    ``loss_local_factory(shape, halo, graph_axis, mesh, overrides=) ->
    loss_local(params, inputs, graph)``; ``inputs_factory(shape, R, n_pad,
    e_pad, graph_axis, edge_parallel=) -> (inputs, input_specs)``;
    ``param_factory(shape)`` -> a params tree of meta tensors.

    Returns (step, args, in_specs, out_specs, cell_meta): ``step(state,
    inputs, graph)`` of :func:`make_gnn_train_step` (on a process mesh, over
    it), ``args = (state, inputs, meta)`` as meta tensors at the cell's full
    size, the specs of the three and ``cell_meta``.
    """
    overrides = overrides or {}
    edge_parallel = bool(overrides.get("edge_parallel"))
    shape = dict(GNN_SHAPES[shape_id])
    graph_axis = GRAPH
    R = _mesh_size(mesh, graph_axis)
    kind = shape["kind"]

    if kind == "full":
        meta, n_pad, e_pad = synthetic_partitioned_meta(
            R, shape["n_nodes"], shape["n_edges"] * 2)
        halo = HaloSpec(mode=halo_mode, perms=xor_rounds(R, 8))
    elif kind == "minibatch":
        n_pad, e_pad = _minibatch_pads(shape)
        meta = _block_meta_sds(R, n_pad, e_pad)
        halo = HaloSpec(mode=NONE)
    else:  # molecule: per-device block-diagonal batch
        per_dev = max(shape["batch"] // R, 1)
        n_pad = per_dev * shape["n_nodes"]
        e_pad = per_dev * shape["n_edges"]
        meta = _block_meta_sds(R, n_pad, e_pad)
        halo = HaloSpec(mode=NONE)

    process_mesh = None if isinstance(mesh, dict) else mesh
    inputs, input_specs = inputs_factory(shape, R, n_pad, e_pad, graph_axis,
                                         edge_parallel=edge_parallel)
    loss_local = loss_local_factory(shape, halo, graph_axis, process_mesh,
                                    overrides=overrides)
    params = param_factory(shape)
    opt = AdamWConfig()
    state = {"params": params, "opt": init_adamw(params, opt)}
    step = make_gnn_train_step(loss_local, opt, mesh=process_mesh)

    args = (state, inputs, meta)
    in_specs = (None, input_specs, meta_specs(meta, graph_axis, edge_parallel))
    out_specs = (None, None)
    cell_meta = dict(kind=kind, n_pad=n_pad, e_pad=e_pad, halo_mode=halo.mode,
                     graph_axis=graph_axis, donate=(0,))
    return step, args, in_specs, out_specs, cell_meta


def _minibatch_pads(shape):
    from repro_torch.graph.sampler import SampledBlock
    seeds_per_dev = max(shape["batch_nodes"] // 16, 1)
    n_pad, e_pad = SampledBlock.pad_sizes(seeds_per_dev, shape["fanouts"])
    return _round_up(n_pad), _round_up(e_pad)


def _block_meta_sds(R, n_pad, e_pad):
    f32, i32 = torch.float32, torch.int32
    # no-halo meta still carries (tiny) halo arrays so device_arrays keys match
    return dict(
        node_mask=_meta((R, n_pad), f32), node_inv_mult=_meta((R, n_pad), f32),
        edge_src=_meta((R, e_pad), i32), edge_dst=_meta((R, e_pad), i32),
        edge_mask=_meta((R, e_pad), f32), edge_inv_mult=_meta((R, e_pad), f32),
        a2a_send_idx=_meta((R, R, 8), i32), a2a_send_mask=_meta((R, R, 8), f32),
        a2a_recv_idx=_meta((R, R, 8), i32), a2a_recv_mask=_meta((R, R, 8), f32),
        nbr_send_idx=_meta((R, 1, 8), i32), nbr_send_mask=_meta((R, 1, 8), f32),
        nbr_recv_idx=_meta((R, 1, 8), i32), nbr_recv_mask=_meta((R, 1, 8), f32),
    )
