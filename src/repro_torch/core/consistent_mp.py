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

Both compute the same arithmetic up to summation order, under either
precision (``plan.precision``): ``fp32``, or ``bf16``, where every dense
product of the edge MLP takes bf16-rounded operands and accumulates in
fp32 (``nn.dense(precision=)`` on the plain backend, the kernels' bf16
entries on the fused one).  The node MLP (Eq. 4e) stays fp32, as in the
reference.

Schedules (``plan.schedule``):

* ``"blocking"`` — Eq. 4a+4b, the exchange, Eq. 4e, serially (paper order).
* ``"overlap"``  — the interior/boundary split
  (``PartitionedGraphs.interior_split``): Eq. 4a+4b first on the edges
  whose destination is a boundary node, the exchange of that partial
  aggregate alone, and the interior edges, whose rows the exchange never
  touches, while it is in flight.  Each side runs the backend once on its
  own edges (the fused backend on the side's own compact layout).  Equal
  to blocking up to the summation order inside the kernel:
  ``halo_sync(agg_bnd) + agg_int == halo_sync(agg_bnd + agg_int)``; the
  edge outputs join by adding the boundary side's rows into the interior
  side's (:func:`join_sides`).

The caller threads the exchange in as ``sync_fn``:
``core/distributed.py::halo_fns`` on one process's rank-local graph and its
mesh (one per level), or a stacked emulator over every rank on one device
(``core/reference.py``).  Where ``sync_fn`` also has ``post`` (the
distributed one) and the aggregate needs no gradient, the overlap layer
posts the exchange before the interior side and finishes it after, so the
interior kernel is queued on the stream while the transfer is in flight;
under autograd it runs the exchange, finished at once, between the two
sides (the reference's dataflow, the same values).

Multilevel message passing (:func:`multilevel_vcycle`, ``GNNConfig.
n_levels > 1``): after the M fine layers, a V-cycle over the coarse levels
of ``core/coarsen.py``'s hierarchy.  Each restriction / prolongation is a
rank-local partial sum (:func:`restrict_aggregate`,
:func:`prolong_aggregate`: a gather and a segment sum over the level's
transfer map, sorted once in ``ShardedGraph.build``; no atomics),
completed by the halo sum of the level it lands on, and every coarse
level's NMP layers run through the same (backend, schedule) registry cell
as the fine ones, on the level's own layouts, split and exchange.

Measured plan autotuning (``NMPPlan.autotune``, :func:`autotune_plan`):
``schedule="auto"`` and halo mode ``"auto"`` resolve to the fastest
(schedule x halo mode x wire) candidate of one stacked NMP layer timed on
the partition at the model's width (:func:`measure_plan_candidates`),
cached per (graph, rank count, policy); over processes the lead measures
on the stacked proxy and broadcasts its pick.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import torch

from repro_torch import nn
from repro_torch.core.consistent_loss import all_reduce_sum
from repro_torch.core.graph_state import (
    AUTO, BLOCKING, FUSED, OVERLAP, XLA, NMPPlan, ShardedGraph, as_graph, nmp_impl,
    register_nmp_impl,
)
from repro_torch.core.halo import (
    NEIGHBOR, NONE, HaloSpec, wire_dtype_of, wire_name)
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
    e_new = (e + nn.mlp(params["edge"], feats, precision=plan.precision)) \
        * graph["edge_mask"][:, None]
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
        seg_src_rowptr=graph["seg_src_rowptr"], precision=plan.precision)


def _agg_xla_part(params, x, e, graph: ShardedGraph, part: str, plan: NMPPlan):
    if f"edge_{part}_idx" not in graph:
        raise ValueError(
            "schedule='overlap' needs the interior/boundary edge split "
            f"(edge_{part}_idx) on the graph — build it with the overlap "
            "plan: ShardedGraph.build(pg, coords, plan)")
    idx = graph[f"edge_{part}_idx"]          # [EP] the side's edge ids (0 pad)
    valid = graph[f"edge_{part}_valid"]      # [EP]
    src, dst = graph["edge_src"][idx], graph["edge_dst"][idx]
    mask = (graph["edge_mask"][idx] * valid)[:, None]
    inv = (graph["edge_inv_mult"][idx] * valid)[:, None]
    e_sub = e.index_select(0, idx)
    feats = torch.cat([segment.gather(x, src), segment.gather(x, dst), e_sub], dim=-1)
    e_sub = (e_sub + nn.mlp(params["edge"], feats, precision=plan.precision)) * mask
    agg = segment.segment_sum(e_sub * inv, dst, x.shape[0])
    # padding entries add zero rows at edge 0
    e_full = torch.zeros(e.shape[0], e_sub.shape[1], dtype=e_sub.dtype,
                         device=e_sub.device).index_add(0, idx, e_sub * valid[:, None])
    return e_full, agg


def _agg_fused_part(params, x, e, graph: ShardedGraph, part: str, plan: NMPPlan):
    if f"seg_perm_{part}" not in graph:
        raise ValueError(
            "schedule='overlap' with backend='fused' needs the interior/boundary "
            f"split's per-side compact layout (seg_perm_{part}, ...) on the graph "
            "— build it with the fused overlap plan: ShardedGraph.build(pg, "
            "coords, plan)")
    # the side's layout holds only its own edges, so the full mask and
    # inverse multiplicities select exactly the side's contributions
    return fused_nmp_edge_agg(
        x, e, params["edge"], graph[f"seg_perm_{part}"], graph[f"seg_src_{part}"],
        graph[f"seg_rowptr_{part}"], graph["edge_mask"], graph["edge_inv_mult"],
        seg_src_slots=graph[f"seg_src_slots_{part}"],
        seg_src_rowptr=graph[f"seg_src_rowptr_{part}"], precision=plan.precision)


_AGGS = {XLA: _agg_xla, FUSED: _agg_fused}
_AGGS_PART = {XLA: _agg_xla_part, FUSED: _agg_fused_part}


def edge_update_aggregate(params, x, e, graph, plan: NMPPlan):
    """Eq. 4a + 4b on one rank: returns (e', local aggregate a)."""
    graph = as_graph(graph)
    return _AGGS[plan.backend](params, x, e, graph, plan)


def edge_update_aggregate_part(params, x, e, graph, part: str, plan: NMPPlan):
    """Eq. 4a + 4b on one side of the interior/boundary split (``"bnd"`` |
    ``"int"``): returns (e_part, agg_part), full-size but zero outside the
    side's edges and destination rows, so ``e_bnd + e_int`` and
    ``agg_bnd + agg_int`` are the unsplit outputs."""
    graph = as_graph(graph)
    if part not in ("bnd", "int"):
        raise ValueError(f"unknown edge split part {part!r}; expected 'bnd' or 'int'")
    return _AGGS_PART[plan.backend](params, x, e, graph, part, plan)


def join_sides(e_bnd: torch.Tensor, e_int: torch.Tensor, graph) -> torch.Tensor:
    """``e_bnd + e_int``, the two sides' edge outputs, each zero outside its
    own edges: the boundary side's few rows (``edge_bnd_idx``) added into
    the interior side's output in place, in place of a full-size add."""
    graph = as_graph(graph)
    idx, valid = graph["edge_bnd_idx"], graph["edge_bnd_valid"]
    return e_int.index_add_(0, idx, e_bnd.index_select(0, idx) * valid[:, None])


def node_update(params: nn.Params, x: torch.Tensor, agg: torch.Tensor,
                graph) -> torch.Tensor:
    """Eq. 4e: residual node MLP on [a_i*, x_i]."""
    x_new = x + nn.mlp(params["node"], torch.cat([agg, x], dim=-1))
    return x_new * graph["node_mask"][:, None]


def _no_exchange(halo: HaloSpec):
    if halo.mode != NONE:
        raise ValueError(
            f"halo mode {halo.mode!r} on one rank's arrays needs the exchange: "
            "no mesh was given (pass gnn_forward sync_fns="
            "core.distributed.halo_fns(plan, graph, mesh) with a "
            "repro_torch.launch.mesh.make_mesh mesh), or run the stacked "
            "reference (repro_torch.core.reference)")


class EdgeParallel:
    """Second-level edge sharding of one layer (the reference's
    ``edge_parallel_axes``, resolved): this process holds a slice of its
    rank's edges and all of its nodes, and the partial aggregate of its
    slice is summed over ``group`` (the mesh's edge group: the model
    shards of this rank; None for one shard, which holds every edge) in
    ``dtype`` (the activations', as the reference sums in ``e``'s dtype:
    a bf16 carry halves the wire), differentiably (its backward is the
    same sum, ``core/consistent_loss.py::_AllReduceSum``), before the halo
    exchange."""
    __slots__ = ("group", "dtype")

    def __init__(self, group=None, dtype: torch.dtype = torch.float32):
        self.group, self.dtype = group, dtype

    def __call__(self, agg: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(agg.to(self.dtype), self.group).to(agg.dtype)


def _edge_sum(agg: torch.Tensor, edge_parallel) -> torch.Tensor:
    return edge_parallel(agg) if edge_parallel else agg


def _blocking_layer(agg_fn, params, x, e, graph, plan, halo: HaloSpec,
                    sync_fn, edge_parallel=None):
    """The paper's serial order: full Eq. 4a+4b, exchange, Eq. 4e."""
    e_new, agg = agg_fn(params, x, e, graph, plan)
    # the model shards' partial aggregates, summed before the exchange
    agg = _edge_sum(agg, edge_parallel)
    # --- Eq. 4c + 4d: halo swap + synchronization ---
    if sync_fn is not None:
        agg = sync_fn(agg)
    else:
        _no_exchange(halo)
    # --- Eq. 4e: node update (residual) ---
    return node_update(params, x, agg, graph), e_new


def _overlap_layer(agg_part_fn, params, x, e, graph, plan, halo: HaloSpec,
                   sync_fn, edge_parallel=None):
    """Interior/boundary split: the exchange takes only the boundary
    partial aggregate; the interior side runs while it is in flight (posted
    where ``sync_fn`` can post and no gradient is needed).  Under edge
    sharding each side's partial aggregate is summed over the model shards
    (the boundary side's before the exchange)."""
    e_bnd, agg_bnd = agg_part_fn(params, x, e, graph, "bnd", plan)
    agg_bnd = _edge_sum(agg_bnd, edge_parallel)
    pending, post = None, getattr(sync_fn, "post", None)
    # --- Eq. 4c + 4d on the boundary rows only ---
    if sync_fn is None:
        _no_exchange(halo)
        agg_sync = agg_bnd
    elif post is not None and not agg_bnd.requires_grad:
        pending = post(agg_bnd)
    else:
        agg_sync = sync_fn(agg_bnd)
    # the interior side: no data dependence on the exchange
    e_int, agg_int = agg_part_fn(params, x, e, graph, "int", plan)
    agg_int = _edge_sum(agg_int, edge_parallel)
    if pending is not None:
        agg_sync = pending.finish()
    # disjoint row support: the sum is the blocking schedule's aggregate
    return (node_update(params, x, agg_sync + agg_int, graph),
            join_sides(e_bnd, e_int, graph))


for _backend, _agg in _AGGS.items():
    register_nmp_impl(_backend, BLOCKING)(
        functools.partial(_blocking_layer, _agg))
for _backend, _agg_part in _AGGS_PART.items():
    register_nmp_impl(_backend, OVERLAP)(
        functools.partial(_overlap_layer, _agg_part))


def nmp_layer(params: nn.Params, x: torch.Tensor, e: torch.Tensor, graph,
              plan: NMPPlan, halo: HaloSpec | None = None,
              sync_fn=None, edge_parallel_axes=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One consistent NMP layer on one rank. Returns (x', e').

    The implementation is resolved from the (backend, schedule) registry;
    ``halo`` defaults to ``plan.halo``; ``sync_fn`` performs the exchange
    of the local aggregate (identity when the halo mode is none).
    ``edge_parallel_axes``: second-level edge parallelism, an
    :class:`EdgeParallel` (the reference's mesh axes resolved to this
    process's edge group, ``models/gnn_zoo/graphcast.py``), or None /
    ``()``: ``graph`` holds a slice of the rank's edges (and every node;
    ``e`` that slice's rows) and the local aggregate is summed over the
    group before the halo sync, which splits the aggregation sum one level
    more and leaves the layer's arithmetic the paper's.
    """
    graph = as_graph(graph)
    impl = nmp_impl(plan)
    halo = plan.halo if halo is None else halo
    return impl(params, x, e, graph, plan, halo, sync_fn, edge_parallel_axes or None)


# ---------------------------------------------------------------------------
# multilevel (coarse-grid) message passing
# ---------------------------------------------------------------------------

def restrict_aggregate(x_fine: torch.Tensor, coarse_graph) -> torch.Tensor:
    """Rank-local restriction partial sum (fine -> coarse, weight
    1/|children|) over ``coarse_graph``'s transfer map: [N_f, H] ->
    [N_c, H].  Each restriction edge lives on exactly one rank (the fine
    endpoint's primary), so the caller completes it with the coarse level's
    halo sum, as the Eq. 4b aggregate is; without it, coarse replica
    copies would hold partial sums and R ranks would not equal 1."""
    g = coarse_graph
    return segment.sorted_segment_sum(
        x_fine, (g["tc_src"], g["tc_rw"], g["tc_len"]),
        (g["tf_src"], g["tf_rw"], g["tf_len"]))


def prolong_aggregate(x_coarse: torch.Tensor, coarse_graph) -> torch.Tensor:
    """Rank-local prolongation partial sum (coarse -> fine, weight
    1/|parents|): [N_c, H] -> [N_f, H]; completed by the FINE level's halo
    sum."""
    g = coarse_graph
    return segment.sorted_segment_sum(
        x_coarse, (g["tf_src"], g["tf_pw"], g["tf_len"]),
        (g["tc_src"], g["tc_pw"], g["tc_len"]))


def check_coarse_halos(plan: NMPPlan, n_levels: int):
    """A NEIGHBOR-mode hierarchy needs one HaloSpec per coarse level: the
    level-0 rounds encode the FINE rank adjacency and cannot be reused."""
    if plan.halo.mode != NEIGHBOR or len(plan.coarse_halos) >= n_levels - 1:
        return
    raise ValueError(
        "NEIGHBOR-mode multilevel exchange needs one HaloSpec per coarse "
        f"level (got {len(plan.coarse_halos)} coarse_halos for "
        f"{n_levels - 1} coarse levels): the level-0 perms encode the FINE "
        "rank adjacency and cannot be reused — build the plan via "
        "NMPPlan.build(hierarchy, mode, ...)")


def multilevel_vcycle(coarse_params, h: torch.Tensor, graph, plan: NMPPlan,
                      sync_fns=None) -> torch.Tensor:
    """One consistent V-cycle over the coarsening hierarchy on one rank.
    Returns h' [N_pad, H].

    Down sweep, level l-1 -> l: restrict (:func:`restrict_aggregate`),
    complete the partial sums by level l's exchange and mask its padding,
    then ``coarse_params[l-1]["mp"]`` NMP layers on level l (the plan's
    registry cell, the level's own layouts, split and halo spec; the edge
    state from the level's static features through its edge encoder).  Up
    sweep: prolong each level's state, complete it by the finer level's
    exchange, add it to the finer state and mask.

    ``sync_fns[l]`` is level l's exchange (``core/distributed.py::
    halo_fns``); None where the level's halo mode is none (one rank).
    Halo specs come from ``plan.halos``; a NEIGHBOR plan without its
    coarse specs raises (:func:`check_coarse_halos`).
    """
    graph = as_graph(graph)
    n_levels = len(coarse_params) + 1
    graph.level(n_levels - 1)          # loud error if coarse levels missing
    levels = graph.levels
    check_coarse_halos(plan, n_levels)
    halos = plan.halos(n_levels)
    syncs = sync_fns or (None,) * n_levels

    def sync(a, lvl):
        if syncs[lvl] is None:
            _no_exchange(halos[lvl])
            return a
        return syncs[lvl](a)

    states = [h]
    for lvl in range(1, n_levels):
        g = levels[lvl]
        c = sync(restrict_aggregate(states[-1], g), lvl) * g["node_mask"][:, None]
        p = coarse_params[lvl - 1]
        e = nn.mlp(p["edge_enc"], g["static_edge_feats"]) * g["edge_mask"][:, None]
        for lp in p["mp"]:
            c, e = nmp_layer(lp, c, e, g, plan, halo=halos[lvl], sync_fn=syncs[lvl])
        states.append(c)
    for lvl in range(n_levels - 1, 0, -1):
        gf = levels[lvl - 1]
        up = sync(prolong_aggregate(states[lvl], levels[lvl]), lvl - 1)
        states[lvl - 1] = (states[lvl - 1] + up) * gf["node_mask"][:, None]
    return states[0]


# ---------------------------------------------------------------------------
# measured plan autotuning (NMPPlan.autotune: schedule="auto", halo="auto")
# ---------------------------------------------------------------------------

# (graph hash, R, policy) -> resolved pick (a schedule string on the
# schedule-only path; a (schedule, halo-mode label, wire name) triple on the
# cross-product path), for the process lifetime: one measurement per
# distinct (graph, rank count, policy).  Over processes every process
# caches the pick its lead broadcast, keyed by its own rank-local graph.
_SCHEDULE_CACHE: dict = {}

# (graph hash, R, policy, candidate grid) -> {(schedule, mode label, wire
# name): seconds}: the measured table the cross-product pick argmins over.
_TUNE_TABLE_CACHE: dict = {}

#: halo-mode labels the cross-product tuner sweeps; "neighbor-packed" is the
#: bucketed wire format (NEIGHBOR exchange over the narrow pk{k}_* arrays)
MODE_LABELS = ("a2a", "neighbor", "neighbor-packed")


def _graph_schedule_key(g0) -> tuple:
    """A hash of one level's edges and node mask (stacked or rank-local)."""
    import hashlib
    h = hashlib.sha1()
    for k in ("edge_src", "edge_dst", "node_mask"):
        a = g0[k].detach().cpu().numpy()
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return (h.hexdigest(),)


def _probe_inputs(g0, hidden: int):
    """The tuner's probe: one NMP layer's params (2 MLP hidden layers) at
    the model's width and seeded node / edge features, on the graph's
    device, as the reference draws them (its own seeds)."""
    import numpy as np
    R, n_pad = g0["node_mask"].shape
    e_pad = g0["edge_mask"].shape[-1]
    dev = g0.device
    params = init_nmp_layer(torch.Generator().manual_seed(0), hidden, 2, device=dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(R, n_pad, hidden)).astype(np.float32)).to(dev)
    e = torch.from_numpy(rng.normal(size=(R, e_pad, hidden)).astype(np.float32)).to(dev)
    return params, x, e


def _min_seconds(fn, iters: int, device) -> float:
    """Min over ``iters`` calls of ``fn``'s wall time, after one warm-up
    call (which builds the kernels at their first use); on a card each call
    is fenced by ``torch.cuda.synchronize``."""
    import time

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    with torch.no_grad():
        fn()
        sync()
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
    return best


def _measure_best_schedule(plan: NMPPlan, g0, hidden: int, iters: int) -> str:
    """Time one stacked NMP layer per schedule (``reference._smooth_stacked``,
    the canonical-order exchange) at the model's width; return the
    winner."""
    from repro_torch.core.reference import _smooth_stacked
    params, x, e = _probe_inputs(g0, hidden)
    best, best_t = BLOCKING, float("inf")
    for sched in (BLOCKING, OVERLAP):
        cand = plan.replace(schedule=sched)
        t = _min_seconds(lambda c=cand: _smooth_stacked(params, x, e, g0, c),
                         iters, g0.device)
        if t < best_t:
            best, best_t = sched, t
    return best


def interior_frac(g0) -> float:
    """Fraction of real edges in the interior side of the split (edges whose
    aggregate rows the halo exchange never touches)."""
    if "edge_int_valid" not in g0:
        raise ValueError("graph has no interior/boundary split — build it "
                         "with a plan whose schedule is 'overlap' or 'auto'")
    n_int = float(g0["edge_int_valid"].sum())
    n_bnd = float(g0["edge_bnd_valid"].sum())
    return n_int / max(n_int + n_bnd, 1.0)


def _mode_label(spec: HaloSpec) -> str:
    return f"{spec.mode}-packed" if spec.packed else spec.mode


def _spec_for(spec: HaloSpec, label: str, wire: str | None) -> HaloSpec:
    """The fixed HaloSpec a (mode label, wire name) candidate denotes; its
    perms, rounds2d and grid are kept from ``spec``."""
    if label == "neighbor-packed":
        mode, packed = NEIGHBOR, True
    elif label in ("a2a", "neighbor", "none"):
        mode, packed = label, False
    else:
        raise ValueError(f"unknown halo-mode label {label!r}; expected one of "
                         f"{MODE_LABELS}")
    return dataclasses.replace(spec, mode=mode, packed=packed,
                               wire_dtype=wire_dtype_of(wire))


def _resolve_plan(plan: NMPPlan, schedule: str, label: str,
                  wire: str | None) -> NMPPlan:
    """Apply a resolved (schedule, mode label, wire name) triple: the fine
    halo and every still-auto coarse halo (each keeps its own perms)."""
    halo = _spec_for(plan.halo, label, wire)
    coarse = tuple(_spec_for(h, label, wire) if h.mode == AUTO else h
                   for h in plan.coarse_halos)
    return plan.replace(schedule=schedule, halo=halo, coarse_halos=coarse)


def _packed_supported(graph) -> bool:
    """Whether the packed candidate runs its fused kernels: the pack and
    unpack-add kernels are in use on a card.  On the CPU the tuner sweeps
    ("a2a", "neighbor"), as the reference does without its interpreter."""
    return graph.device.type == "cuda"


def _grid(plan: NMPPlan, graph):
    """The (schedules, mode labels, wire names) a cross-product plan
    sweeps: the tuner may drop a requested wire, never introduce one."""
    schedules = (BLOCKING, OVERLAP) if plan.schedule == AUTO else (plan.schedule,)
    modes = MODE_LABELS if _packed_supported(graph) else ("a2a", "neighbor")
    wires = (None,) if plan.halo.wire_dtype is None \
        else (None, wire_name(plan.halo.wire_dtype))
    return schedules, modes, wires


def measure_plan_candidates(plan: NMPPlan, graph, hidden: int = 8,
                            iters: int = 20, schedules=None, modes=None,
                            wires=None) -> dict:
    """Time the (schedule x halo-mode x wire) candidate grid on the stacked
    ``graph``, memoized for the process lifetime.

    Each candidate times one stacked NMP layer (``reference._smooth_stacked``)
    with the exchange through the mode-faithful emulator
    (``halo.halo_sync_stacked``): the per-rank arithmetic, wire masking and
    compression, and the pack / unpack-add kernels the multi-process
    exchange runs for that candidate.  Min of ``iters`` calls after a
    warm-up, each fenced by ``torch.cuda.synchronize`` on a card.  Returns
    {(schedule, mode label, wire name): seconds}; ``NMPPlan.autotune``
    argmins over it."""
    import itertools
    from repro_torch.core.halo import halo_sync_stacked
    from repro_torch.core.reference import _smooth_stacked

    graph = as_graph(graph)
    g0 = graph.levels[0]
    R = g0["node_mask"].shape[0]
    d_sched, d_modes, d_wires = _grid(plan, graph)
    schedules = d_sched if schedules is None else schedules
    if modes is None:
        modes = d_modes if plan.halo.mode == AUTO else (_mode_label(plan.halo),)
    wires = tuple(wire_name(w) for w in (d_wires if wires is None else wires))
    key = (_graph_schedule_key(g0), R, plan.backend, plan.precision,
           graph.device.type, tuple(schedules), tuple(modes), wires, hidden)
    cached = _TUNE_TABLE_CACHE.get(key)
    if cached is not None:
        return dict(cached)
    params, x, e = _probe_inputs(g0, hidden)
    table = {}
    for sched, label, wire in itertools.product(schedules, modes, wires):
        cand = plan.replace(schedule=sched, halo=_spec_for(plan.halo, label, wire))
        table[(sched, label, wire)] = _min_seconds(
            lambda c=cand: _smooth_stacked(params, x, e, g0, c, halo_sync_stacked),
            iters, g0.device)
    _TUNE_TABLE_CACHE[key] = dict(table)
    return table


def autotune_plan(plan: NMPPlan, graph, measure: bool | None = None,
                  hidden: int = 8, iters: int = 20, mesh=None,
                  stacked=None) -> NMPPlan:
    """Resolve every ``"auto"`` field of the plan (``schedule`` and/or the
    halo ``mode``) against a stacked graph (see :meth:`NMPPlan.autotune`).

    A fixed halo mode resolves the schedule alone (:func:`_measure_best_schedule`);
    a halo mode ``"auto"`` takes the (schedule x halo-mode x wire) table of
    :func:`measure_plan_candidates`.  Wire candidates are ``{None,
    plan.halo.wire_dtype}``.  ``measure=False`` (or
    ``REPRO_SCHEDULE_AUTOTUNE=0``) takes the reference's structural
    fallback: overlap where ``interior_frac`` < 0.5, and packed neighbor
    (neighbor on the CPU) for the halo mode.

    ``graph`` rank-local (one process of a mesh): every process must
    resolve the same plan, or the ranks post different exchanges and hang.
    So the lead (world rank 0) resolves it on the stacked proxy
    ``stacked()`` (a callable building the stacked graph, called on the
    lead alone), broadcasts the pick to every process of ``mesh``, and
    every process caches it."""
    graph = as_graph(graph)
    if plan.schedule != AUTO and plan.halo.mode != AUTO:
        return plan
    g0 = graph.levels[0]
    nm = g0["node_mask"]
    if nm.dim() == 1 and mesh is not None:
        return _autotune_over(plan, g0, mesh, stacked, measure, hidden, iters)
    if nm.dim() != 2:
        raise ValueError("autotune needs the stacked graph (leading rank axis), or "
                         "a rank-local one with mesh= and stacked=; got node_mask "
                         f"of ndim {nm.dim()}")
    R = nm.shape[0]
    if R <= 1 or plan.halo.mode == NONE:
        return _one_rank_pick(plan)
    if measure is None:
        measure = os.environ.get("REPRO_SCHEDULE_AUTOTUNE", "1") != "0"
    policy = (_graph_schedule_key(g0), R, plan.backend, plan.precision,
              graph.device.type)
    if plan.halo.mode != AUTO:
        key = policy + (plan.halo.mode, bool(measure), hidden)
        sched = _SCHEDULE_CACHE.get(key)
        if sched is None:
            if measure:
                sched = _measure_best_schedule(plan, g0, hidden, iters)
            else:
                # structural fallback: once the exchange-independent share
                # of the edge work drops under half, there is not enough
                # interior compute to pay blocking's serialization
                sched = OVERLAP if interior_frac(g0) < 0.5 else BLOCKING
            _SCHEDULE_CACHE[key] = sched
        return plan.replace(schedule=sched)

    schedules, modes, wires = _grid(plan, graph)
    key = policy + ("cross", schedules, modes, wires, bool(measure), hidden)
    triple = _SCHEDULE_CACHE.get(key)
    if triple is None:
        if measure:
            table = measure_plan_candidates(plan, graph, hidden=hidden, iters=iters,
                                            schedules=schedules, modes=modes,
                                            wires=wires)
            triple = min(table, key=table.get)
        else:
            if plan.schedule == AUTO:
                sched = OVERLAP if interior_frac(g0) < 0.5 else BLOCKING
            else:
                sched = plan.schedule
            label = "neighbor-packed" if _packed_supported(graph) else "neighbor"
            triple = (sched, label, wire_name(plan.halo.wire_dtype))
        _SCHEDULE_CACHE[key] = triple
    return _resolve_plan(plan, *triple)


def _one_rank_pick(plan: NMPPlan) -> NMPPlan:
    # no exchange to hide: blocking is trivially optimal, and one rank
    # needs no exchange at all
    out = plan.replace(schedule=BLOCKING) if plan.schedule == AUTO else plan
    if out.halo.mode == AUTO:
        out = _resolve_plan(out, out.schedule, "none", None)
    return out


def _pick_of(plan: NMPPlan) -> tuple:
    """A resolved plan's (schedule, mode label, wire name)."""
    return (plan.schedule, _mode_label(plan.halo), wire_name(plan.halo.wire_dtype))


def _autotune_over(plan: NMPPlan, g0, mesh, stacked, measure, hidden, iters):
    """:func:`autotune_plan` on one process of ``mesh`` (its docstring)."""
    import torch.distributed as dist
    if mesh.graph <= 1 or plan.halo.mode == NONE:
        return _one_rank_pick(plan)
    key = ("mesh", _graph_schedule_key(g0), mesh.rank, mesh.graph, plan.schedule,
           _mode_label(plan.halo), wire_name(plan.halo.wire_dtype), plan.backend,
           plan.precision, g0.device.type, measure, hidden)
    pick = _SCHEDULE_CACHE.get(key)
    if pick is None:
        box = [None]
        if mesh.lead:
            if stacked is None:
                raise ValueError("autotune of a rank-local graph needs stacked=, a "
                                 "callable building the stacked graph (the lead "
                                 "measures on it)")
            box[0] = _pick_of(autotune_plan(plan, stacked(), measure=measure,
                                            hidden=hidden, iters=iters))
        group = mesh.world_group
        dist.broadcast_object_list(box, src=group.ranks[0], group=group.pg)
        pick = _SCHEDULE_CACHE[key] = tuple(box[0])
    if plan.halo.mode != AUTO:
        return plan.replace(schedule=pick[0])
    return _resolve_plan(plan, *pick)


def autotune_schedule(plan: NMPPlan, graph, measure: bool | None = None,
                      hidden: int = 8, iters: int = 20, **kw) -> NMPPlan:
    """Alias of :func:`autotune_plan` (the reference's name from before the
    tuner also resolved halo mode ``"auto"``)."""
    return autotune_plan(plan, graph, measure=measure, hidden=hidden,
                         iters=iters, **kw)
