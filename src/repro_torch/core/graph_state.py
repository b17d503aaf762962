"""Execution state for the consistent GNN: ShardedGraph + NMPPlan (port of
``repro.core.graph_state``).

* :class:`ShardedGraph` — the per-rank static arrays of one partition as a
  dict of tensors on one device, each with a leading rank axis (node/edge
  indices, masks, inverse multiplicities, halo buffers, static geometric
  edge features, the fused kernel's compact layout) and the packed halo
  rounds' wires; each coarser level of a multilevel hierarchy is nested as
  a child ``ShardedGraph`` (``coarse``) carrying its restriction /
  prolongation transfer maps; :meth:`rank` slices one rank out of every
  level.
* :class:`NMPPlan` — a frozen execution policy: NMP backend (``xla`` |
  ``fused``), schedule, the edge MLP's precision (``fp32`` | ``bf16``),
  fused-layout block sizes and the fine and per-coarse-level
  :class:`~repro_torch.core.halo.HaloSpec` objects.  Layer implementations
  register per ``(backend, schedule)`` cell via :func:`register_nmp_impl`
  (``core/consistent_mp.py`` registers the blocking and the overlap
  schedule for both backends).  ``schedule="auto"`` and halo mode
  ``"auto"`` are resolved by :meth:`NMPPlan.autotune` (the measured tuner
  of ``core/consistent_mp.py``); :meth:`NMPPlan.autotune_blocks` takes the
  block sizes from ``kernels/segment_agg/ops.py::pick_block_sizes``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.halo import AUTO, HaloSpec, halo_spec_from_plan, wire_name
from repro_torch.kernels.halo_pack.ops import HaloWire, halo_wire
# the edge MLP's precisions (the fused kernels' entries): fp32, bf16
from repro_torch.nn import BF16, FP32, PRECISIONS  # noqa: F401

XLA = "xla"          # plain PyTorch ops (the name mirrors the reference)
FUSED = "fused"      # the hand-written CUDA kernel
BACKENDS = (XLA, FUSED)
BLOCKING = "blocking"
OVERLAP = "overlap"
SCHEDULES = (BLOCKING, OVERLAP, AUTO)


@dataclasses.dataclass(frozen=True)
class NMPPlan:
    """Static execution policy for every consistent-NMP forward path.

    ``precision`` is the edge MLP's (Eq. 4a) product policy on either
    backend: ``bf16`` rounds both operands of every dense product to bf16
    and accumulates in fp32; everything else (biases, ELU, LayerNorm, the
    residual, the aggregate, the node MLP, encoders and decoder) stays fp32.
    ``block_n`` / ``block_e`` key the cached compact layout (``block_e`` is
    its tile depth); the CUDA kernel itself walks the layout node by node,
    so they do not change its arithmetic.  ``halo`` is the fine (level-0)
    exchange spec and ``coarse_halos[l-1]`` level l's: each coarse level
    has its own rank adjacency and rounds.
    """
    halo: HaloSpec = HaloSpec(mode="none")
    coarse_halos: Tuple[HaloSpec, ...] = ()
    backend: str = XLA
    schedule: str = BLOCKING
    precision: str = FP32
    block_n: int = 128
    block_e: int = 128

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}; "
                             f"expected one of {PRECISIONS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown NMP backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"expected one of {SCHEDULES}")

    @property
    def seg_layout(self) -> Tuple[int, int] | None:
        """The (block_n, block_e) layout key the fused backend needs."""
        return (self.block_n, self.block_e) if self.backend == FUSED else None

    @property
    def wants_split(self) -> bool:
        """Whether the graph needs the interior/boundary split."""
        return self.schedule in (OVERLAP, AUTO)

    @property
    def wants_packed(self) -> bool:
        """Whether any level's graph needs the packed halo arrays."""
        return any(h.packed or h.mode == AUTO
                   for h in (self.halo, *self.coarse_halos))

    def halos(self, n_levels: int) -> Tuple[HaloSpec, ...]:
        """Per-level exchange specs of an ``n_levels``-deep hierarchy.

        A missing coarse entry falls back to the fine spec, which is right
        only for the A2A / NONE modes (a NEIGHBOR fine spec without its
        coarse entries is refused by ``multilevel_vcycle``)."""
        return (self.halo,) + tuple(
            self.coarse_halos[i] if i < len(self.coarse_halos) else self.halo
            for i in range(n_levels - 1))

    def replace(self, **kw) -> "NMPPlan":
        return dataclasses.replace(self, **kw)

    @classmethod
    def build(cls, pg_or_hierarchy, mode: str, packed: bool = False,
              wire_dtype=None, **policy) -> "NMPPlan":
        """Plan with its halo specs derived from the partition's halo plans:
        ``pg_or_hierarchy`` is a ``PartitionedGraphs`` (flat) or a
        ``MultiLevelGraphs`` (``core/coarsen.py``; every level its own
        spec); ``mode`` is ``none`` | ``a2a`` | ``neighbor`` | ``auto`` (the
        last resolved by :meth:`autotune` over the (schedule x halo-mode x
        wire) candidates); ``wire_dtype`` (e.g. ``torch.bfloat16`` or
        ``"bfloat16"``) compresses the exchanges' wire."""
        levels = getattr(pg_or_hierarchy, "levels", [pg_or_hierarchy])
        specs = tuple(halo_spec_from_plan(lvl.halo, mode, packed=packed,
                                          wire_dtype=wire_dtype)
                      for lvl in levels)
        return cls(halo=specs[0], coarse_halos=specs[1:], **policy)

    def autotune_blocks(self, hidden: int, dtype=torch.float32,
                        backend: str | None = None) -> "NMPPlan":
        """``block_n`` / ``block_e`` from the static table of
        ``kernels/segment_agg/ops.py::pick_block_sizes`` for this width
        (``REPRO_SEG_BLOCKS`` overrides it)."""
        from repro_torch.kernels.segment_agg.ops import pick_block_sizes
        bn, be = pick_block_sizes(hidden, dtype, backend)
        return self.replace(block_n=bn, block_e=be)

    def autotune(self, graph=None, measure: bool | None = None, hidden: int = 8,
                 iters: int = 20, mesh=None, stacked=None) -> "NMPPlan":
        """Resolve ``schedule="auto"`` and/or halo mode ``"auto"``.

        Times one stacked NMP layer per candidate (the (schedule x
        halo-mode x wire) cross-product when the halo mode is ``"auto"``,
        schedules only otherwise) on ``graph`` (a stacked
        :class:`ShardedGraph`) at width ``hidden``, and returns a plan with
        the fastest, cached per (graph, rank count, policy) for the process
        lifetime.  ``measure=False`` (or ``REPRO_SCHEDULE_AUTOTUNE=0``)
        takes the reference's structural fallback.  A rank-local ``graph``
        (one process of ``mesh``) takes the pick its lead measured on
        ``stacked()`` and broadcast.  Plans with nothing ``auto`` are
        returned unchanged (``core/consistent_mp.py::autotune_plan``)."""
        if self.schedule != AUTO and self.halo.mode != AUTO:
            return self
        from repro_torch.core.consistent_mp import autotune_plan
        return autotune_plan(self, graph, measure=measure, hidden=hidden,
                             iters=iters, mesh=mesh, stacked=stacked)

    def policy(self) -> dict:
        """JSON-able policy fields (the plan's checkpoint-fingerprint entry;
        one written before ``precision`` existed reads as fp32, one before
        ``halo_wire`` as None: ``policy.get("halo_wire")``)."""
        return {"backend": self.backend, "schedule": self.schedule,
                "precision": self.precision,
                "block_n": self.block_n, "block_e": self.block_e,
                "halo_mode": self.halo.mode, "halo_packed": self.halo.packed,
                "halo_wire": wire_name(self.halo.wire_dtype)}


_NMP_IMPLS: Dict[Tuple[str, str], Callable] = {}


def register_nmp_impl(backend: str, schedule: str):
    """Register one layer implementation for a (backend, schedule) cell:
    ``impl(params, x, e, graph, plan, halo, sync_fn, edge_parallel) ->
    (x', e')``."""
    def deco(fn):
        _NMP_IMPLS[(backend, schedule)] = fn
        return fn
    return deco


def nmp_impl(plan: NMPPlan) -> Callable:
    """Resolve the layer implementation registered for ``plan``."""
    try:
        return _NMP_IMPLS[(plan.backend, plan.schedule)]
    except KeyError:
        if plan.schedule == AUTO:
            raise ValueError(
                "schedule='auto' must be resolved before layer dispatch: call "
                "plan.autotune(graph) after ShardedGraph.build (the training "
                "loop and the engine do this)") from None
        raise ValueError(
            f"no NMP implementation registered for backend={plan.backend!r}, "
            f"schedule={plan.schedule!r}; registered cells: "
            f"{sorted(_NMP_IMPLS)}") from None


def registered_nmp_impls() -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(_NMP_IMPLS))


class ShardedGraph:
    """Stacked per-rank static arrays of one partition level, as tensors on
    one device.  ``graph[name]`` has a leading rank axis; ``graph.rank(r)``
    returns rank r's slice of every level (a rank-local graph, which one
    process of a multi-process run holds).  ``graph.wire(name)`` is a
    packed halo round's :class:`HaloWire` (``pk{k}_send`` / ``pk{k}_recv``:
    ids, mask and their inverse) or an exchange wire (``pk_send`` /
    ``pk_recv``: the rounds' wires concatenated in round order, the rows of
    round k from the sum of the earlier rounds' widths on), made once by
    :meth:`build`.  ``coarse`` chains the next coarser level of a
    multilevel hierarchy (its arrays also carry the transfer maps from the
    finer level, sorted once by coarse and by fine node:
    :func:`_transfer_arrays`)."""

    __slots__ = ("arrays", "wires", "coarse")

    def __init__(self, arrays: Dict[str, torch.Tensor],
                 wires: Dict[str, HaloWire] | None = None,
                 coarse: "ShardedGraph | None" = None):
        if not isinstance(arrays, dict):
            raise TypeError(f"arrays must be a dict, got {type(arrays)}")
        if coarse is not None and not isinstance(coarse, ShardedGraph):
            raise TypeError("coarse must be a ShardedGraph (or None), got "
                            f"{type(coarse)}")
        self.arrays = dict(arrays)
        self.wires = dict(wires or {})
        self.coarse = coarse

    def __getitem__(self, key: str) -> torch.Tensor:
        try:
            return self.arrays[key]
        except KeyError:
            raise KeyError(
                f"ShardedGraph has no array {key!r} at this level; present: "
                f"{sorted(self.arrays)} — was the graph built with the plan "
                "that needs it (ShardedGraph.build(pg, coords, plan))?"
            ) from None

    def __contains__(self, key: str) -> bool:
        return key in self.arrays

    def __repr__(self) -> str:
        lv = ", ".join(f"L{i}:{len(l.arrays)} arrays"
                       for i, l in enumerate(self.levels))
        return f"ShardedGraph({lv})"

    @property
    def device(self) -> torch.device:
        return next(iter(self.arrays.values())).device

    @property
    def levels(self) -> Tuple["ShardedGraph", ...]:
        """Fine-to-coarse chain of levels (``levels[0] is self``)."""
        out, g = [], self
        while g is not None:
            out.append(g)
            g = g.coarse
        return tuple(out)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level(self, lvl: int) -> "ShardedGraph":
        levels = self.levels
        if lvl >= len(levels):
            raise ValueError(
                f"multilevel graph for level {lvl} missing (graph has "
                f"{len(levels)} levels) — build the graph from the "
                "hierarchy: ShardedGraph.build(pg, coords, plan, "
                "hierarchy=...)")
        return levels[lvl]

    def wire(self, name: str) -> HaloWire:
        try:
            return self.wires[name]
        except KeyError:
            raise KeyError(
                f"ShardedGraph has no halo wire {name!r}; present: "
                f"{sorted(self.wires)} — was the graph built with a packed "
                "plan (ShardedGraph.build(pg, coords, plan))?") from None

    def rank(self, r: int) -> "ShardedGraph":
        """Slice every array's (and wire's) leading rank axis, every level."""
        return ShardedGraph({k: v[r] for k, v in self.arrays.items()},
                            {k: w.rank(r) for k, w in self.wires.items()},
                            None if self.coarse is None else self.coarse.rank(r))

    def to(self, device) -> "ShardedGraph":
        """Every array and wire of every level on ``device``."""
        return ShardedGraph({k: v.to(device) for k, v in self.arrays.items()},
                            {k: w.to(device) for k, w in self.wires.items()},
                            None if self.coarse is None else self.coarse.to(device))

    @classmethod
    def build(cls, pg, coords: np.ndarray, plan: NMPPlan | None = None,
              device="cuda", rank: int | None = None,
              hierarchy=None) -> "ShardedGraph":
        """Collect ``pg``'s static arrays plus the static geometric edge
        features from ``coords`` onto ``device``; ``plan`` decides what else
        rides along (the fused backend's compact layout, the overlap
        schedule's interior/boundary split with each side's layout, the
        packed halo arrays and their wires).  With ``rank``, only that
        rank's arrays are built (its compact layouts alone, padded as in the
        stack) and its slice (:meth:`rank`) is returned: equal to the
        stacked graph's ``.rank(rank)``, at every level.

        ``hierarchy`` (a ``core.coarsen.MultiLevelGraphs`` whose level 0 is
        ``pg``) nests each coarse level, built the same way from its own
        partition and coordinates, with its transfer maps; ``coords`` must
        then agree with the hierarchy's, which define every level's edge
        features."""
        plan = plan or NMPPlan()
        if hierarchy is None:
            return cls._one_level(pg, coords, plan, device, rank)
        if hierarchy.levels[0] is not pg:
            raise ValueError("hierarchy.levels[0] must be the pg passed in "
                             "(the fine partition the step fns shard over)")
        if coords is not None and coords is not hierarchy.coords[0] \
                and not np.array_equal(coords, hierarchy.coords[0]):
            raise ValueError(
                "coords disagrees with hierarchy.coords[0]: the hierarchy's "
                "build-time coordinates define every level's static edge "
                "features — rebuild the hierarchy from the transformed mesh "
                "instead of passing different coords here")
        graph = None
        for lvl in range(hierarchy.n_levels - 1, -1, -1):
            level = cls._one_level(hierarchy.levels[lvl], hierarchy.coords[lvl],
                                   plan, device, rank)
            if lvl >= 1:
                level.arrays.update(_to_device(_transfer_arrays(
                    hierarchy.transfers[lvl - 1], hierarchy.levels[lvl - 1].n_pad,
                    hierarchy.levels[lvl].n_pad, rank), device, rank))
            level.coarse = graph
            graph = level
        return graph

    @classmethod
    def _one_level(cls, pg, coords, plan: NMPPlan, device, rank) -> "ShardedGraph":
        """One level's graph (every rank's, or ``rank``'s slice)."""
        arrays = _to_device(_level_arrays(pg, coords, plan.seg_layout,
                                          plan.wants_split, plan.wants_packed,
                                          rank), device)
        rounds = [k for k in range(len(pg.halo.perms)) if f"pk{k}_send_idx" in arrays]
        wires = {f"pk{k}_{side}": halo_wire(arrays[f"pk{k}_{side}_idx"],
                                            arrays[f"pk{k}_{side}_mask"], pg.n_pad)
                 for k in rounds for side in ("send", "recv")}
        if rounds:
            # the exchange wires: every round's wire, concatenated in round
            # order (a row may be sent in several rounds, so no inverse)
            for side in ("send", "recv"):
                wires[f"pk_{side}"] = HaloWire(*(
                    torch.cat([arrays[f"pk{k}_{side}_{part}"] for k in rounds], -1)
                    for part in ("idx", "mask")))
        graph = cls(arrays, wires)
        return graph if rank is None else graph.rank(0)


def _to_device(arrays: Dict[str, np.ndarray], device, rank=None):
    """numpy arrays -> tensors on ``device``; with ``rank``, each is the
    rank's slice (a leading axis of 1 stripped)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in arrays.items()}
    return out if rank is None else {k: v[0] for k, v in out.items()}


def _transfer_arrays(t, n_fine: int, n_coarse: int,
                     rank: int | None = None) -> Dict[str, np.ndarray]:
    """A coarse level's transfer maps from the finer level (every rank's, or
    ``rank``'s alone with a leading axis of 1): the slots of
    ``core/coarsen.py::TransferPlan`` ([R, M_pad]; the reference's
    ``t_fine``, ``t_coarse``, ``t_rw``, ``t_pw``) sorted once (stably) by
    coarse and by fine node, which the transfers' segment sums take in
    place of sorting the ids on every call
    (``graph/segment.py::sorted_segment_sum``):

      tc_src [R, M_pad]  the fine node of each slot, sorted by coarse node;
      tc_rw / tc_pw      its restriction / prolongation weight;
      tc_len [R, N_c]    slots per coarse node;
      tf_src, tf_rw, tf_pw, tf_len [R, N_f]   the same sorted by fine node.

    Restriction sums ``x[tc_src] * tc_rw`` per coarse node (its gradient
    ``g[tf_src] * tf_rw`` per fine node); prolongation ``c[tf_src] * tf_pw``
    per fine node (its gradient ``g[tc_src] * tc_pw`` per coarse node).
    Padding slots (index 0, weight 0) are kept where the reference's
    segment sum has them."""
    ranks = range(t.fine_idx.shape[0]) if rank is None else (rank,)
    out = {}
    for key, ids, other, n in (("tc", t.coarse_idx, t.fine_idx, n_coarse),
                               ("tf", t.fine_idx, t.coarse_idx, n_fine)):
        order = [np.argsort(ids[r], kind="stable") for r in ranks]
        out[f"{key}_src"] = np.stack([other[r][o] for r, o in zip(ranks, order)])
        out[f"{key}_rw"] = np.stack([t.r_w[r][o] for r, o in zip(ranks, order)])
        out[f"{key}_pw"] = np.stack([t.p_w[r][o] for r, o in zip(ranks, order)])
        out[f"{key}_len"] = np.stack([np.bincount(ids[r], minlength=n)
                                      for r in ranks]).astype(np.int64)
    return out


def _level_arrays(pg, coords, seg_layout, split: bool, packed: bool,
                  rank: int | None = None) -> Dict[str, np.ndarray]:
    """Stacked static arrays: halo/edge metadata + edge geometry (numpy;
    none where ``coords`` is None); with ``rank``, that rank's alone (a
    leading axis of 1)."""
    from repro_torch.core.mesh_gen import edge_features
    from repro_torch.core.partition import gather_node_features

    arrays = dict(pg.device_arrays(seg_layout=seg_layout, split=split,
                                   packed=packed, rank=rank))
    if coords is None:
        # a graph without geometry (Cora, say): no static edge features
        return arrays
    coords_r = gather_node_features(pg, coords, rank)
    ef = []
    for i, r in enumerate(range(pg.R) if rank is None else (rank,)):
        e = np.stack([pg.edge_src[r], pg.edge_dst[r]], axis=-1)
        ef.append(edge_features(coords_r[i], e) * pg.edge_mask[r][:, None])
    arrays["static_edge_feats"] = np.stack(ef).astype(np.float32)
    return arrays


#: the multiple the edge axis is padded to so that it splits evenly over
#: the model axis (the reference's ``configs/gnn_common.py::_round_up``)
EDGE_MULTIPLE = 128
#: the arrays with an edge axis that edge sharding slices
EDGE_KEYS = ("edge_src", "edge_dst", "edge_mask", "edge_inv_mult")


def _with_edges(pg, **edges):
    """``pg`` with new edge arrays, its nodes and halo plan kept and its
    cached layouts, split and packed arrays dropped (they follow the
    edges)."""
    return dataclasses.replace(pg, **edges, _seg_layouts={}, _int_split=None,
                               _packed_halos={})


def pad_edges(pg, multiple: int = EDGE_MULTIPLE):
    """``pg`` with every rank's edge axis padded to a multiple of
    ``multiple`` (padding edges 0 -> 0, mask and inverse multiplicity 0),
    as the reference sizes ``e_pad`` so that it also splits over the model
    axis; ``pg`` itself when it already is."""
    e_pad = pg.e_pad
    grow = -e_pad % int(multiple)
    if not grow:
        return pg
    return _with_edges(pg, **{k: np.pad(getattr(pg, k), ((0, 0), (0, grow)))
                              for k in EDGE_KEYS})


def edge_shard(pg, index: int, count: int):
    """Model shard ``index`` of ``count`` of a partition (edge-parallel
    sharding, ``repro/configs/gnn_common.py::meta_specs``): every rank keeps
    its nodes and halo plan whole and slice ``index`` of ``count`` equal
    slices of its edges along ``e_pad`` (the ``EDGE_KEYS`` rows).  A graph
    built from it (``ShardedGraph.build``) carries that slice's static edge
    features, compact layout and interior/boundary split; a slice may hold
    no real edge.  ``e_pad`` must split evenly (:func:`pad_edges`)."""
    if not 0 <= index < count:
        raise ValueError(f"model shard {index} of {count}")
    if count == 1:
        return pg
    if pg.e_pad % count:
        raise ValueError(f"e_pad {pg.e_pad} does not split over {count} model shards: "
                         "pad it first (core.graph_state.pad_edges)")
    width = pg.e_pad // count
    cut = slice(index * width, (index + 1) * width)
    return _with_edges(pg, **{k: np.ascontiguousarray(getattr(pg, k)[:, cut])
                              for k in EDGE_KEYS})


def as_graph(graph) -> ShardedGraph:
    """Validate a ShardedGraph argument."""
    if isinstance(graph, ShardedGraph):
        return graph
    raise TypeError(f"expected a ShardedGraph, got {type(graph).__name__}")
