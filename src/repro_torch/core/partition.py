"""Distributed mesh-based graph partitioning with halo metadata (Sec. II-A).

Port of ``repro.core.partition``.  Two partitioners produce the same
``PartitionedGraphs`` structure:

* the block partitioner (:func:`partition_elements` +
  :func:`from_element_partition`): elements of an ``SEMMesh`` are assigned
  to ranks by blocks of the element grid (NekRS-style slab/pencil/block
  decompositions); nodes on shared element faces become *coincident
  copies* on every touching rank and face-lattice edges are duplicated
  across ranks (edge multiplicity d_ij > 1, undone by 1/d_ij scaling
  during aggregation — Eq. 4b);
* the vertex cut (:func:`from_edge_partition`) of an arbitrary directed
  edge list (d_ij == 1), with forced replica copies: the spectral
  partitioner (``partition_mesh(method="spectral")``, node -> part from
  ``core/partition_quality.py``), :func:`partition_graph`, and the coarse
  levels of the multilevel hierarchy (``core/coarsen.py``).

The halo plan carries both exchange layouts of the reference:
  * A2A       — equal-size buffers to *all* ranks;
  * NEIGHBOR  — the rank adjacency graph greedily edge-colored into rounds
    of disjoint rank pairs (plus the bucketed per-round packed arrays), or,
    on a (Ga, Gb) rank grid, the two-level rounds of
    :func:`build_2d_halo_rounds` (:func:`partition_mesh_2d`): one round per
    grid shift, routed as chained one-way hops along the grid's axes.

The overlap schedule's interior/boundary split
(:meth:`PartitionedGraphs.interior_split`) and each side's compact layout
(``segment_layout(part=)``) are array-equal to the reference's too
(``tests/test_torch_overlap.py``); a process of a mesh builds only its own
rank's layouts (``rank=``).

Everything here is host-side numpy and produces arrays equal to the
reference's (``tests/test_torch_host.py``,
``tests/test_torch_partition_quality.py``).  The per-edge python loops of
the reference are vectorized (``np.unique`` over int64 pair keys,
``np.searchsorted`` for global->local ids), which keeps the host build of
the ~0.7M-node p=7 serving mesh to seconds; the arithmetic and the order of
every output array are unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.mesh_gen import (
    SEMMesh, element_lattice_edges, undirected_to_directed)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RankGraph:
    """One rank's local sub-graph (host-side, un-padded)."""
    global_ids: np.ndarray       # [N_r] sorted unique global node ids
    edges: np.ndarray            # [E_r, 2] directed edges, local node indices
    edge_inv_mult: np.ndarray    # [E_r] 1/d_ij
    node_inv_mult: np.ndarray    # [N_r] 1/d_i

    @property
    def n_nodes(self) -> int:
        return int(self.global_ids.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])


@dataclasses.dataclass
class HaloPlan:
    """Padded, stacked halo-exchange metadata for R ranks.

    A2A arrays are [R, R, B_a2a]; NEIGHBOR arrays are [R, K, B_nbr] with
    ``perms`` holding one list of (src, dst) rank pairs per round.
    """
    a2a_send_idx: np.ndarray     # int32 [R, R, B] local node idx to send to rank s
    a2a_send_mask: np.ndarray    # float32 [R, R, B]
    a2a_recv_idx: np.ndarray     # int32 [R, R, B] local idx receiving from rank s
    a2a_recv_mask: np.ndarray    # float32 [R, R, B]
    perms: List[List[Tuple[int, int]]]            # per round: [(src, dst), ...]
    nbr_send_idx: np.ndarray     # int32 [R, K, B2]
    nbr_send_mask: np.ndarray    # float32 [R, K, B2]
    nbr_recv_idx: np.ndarray     # int32 [R, K, B2]
    nbr_recv_mask: np.ndarray    # float32 [R, K, B2]


@dataclasses.dataclass
class HaloPlan2d(HaloPlan):
    """A two-level halo plan (:func:`partition_mesh_2d`): the ``nbr_*``
    arrays of :func:`build_2d_halo_rounds`, ``rounds2d`` (each round's
    chain of per-axis hops), ``grid2d`` (the two grid axes as ((name,
    size), (name, size)), rank ``a * Gb + b``) and as ``perms`` the rounds'
    flat (src, dst) pairs (:func:`flat_rounds2d_perms`)."""
    rounds2d: tuple = ()         # per round: ((axis, ((s, d), ...)), ...)
    grid2d: tuple = ()           # ((axis a, Ga), (axis b, Gb))


@dataclasses.dataclass
class PartitionedGraphs:
    """Stacked padded per-rank arrays (leading rank axis)."""
    R: int
    n_global: int                # unique global nodes (N of Eq. 5)
    global_ids: np.ndarray       # int32 [R, N_pad], -1 padding
    node_mask: np.ndarray        # float32 [R, N_pad]
    node_inv_mult: np.ndarray    # float32 [R, N_pad] (0 on padding)
    edge_src: np.ndarray         # int32 [R, E_pad] (0 on padding)
    edge_dst: np.ndarray         # int32 [R, E_pad]
    edge_mask: np.ndarray        # float32 [R, E_pad]
    edge_inv_mult: np.ndarray    # float32 [R, E_pad] (0 on padding)
    halo: HaloPlan
    # compact gather layouts for the fused NMP kernel, memoized per
    # (block_n, block_e): the host-side sort runs once per partition
    _seg_layouts: Dict[Tuple[int, int, str], dict] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # interior/boundary edge classification for the overlap schedule,
    # memoized (host-side, one pass per partition)
    _int_split: dict | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # bucketed per-round packed halo arrays, memoized per bucket size
    _packed_halos: Dict[int, dict] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_pad(self) -> int:
        return int(self.global_ids.shape[1])

    @property
    def e_pad(self) -> int:
        return int(self.edge_src.shape[1])

    def interior_split(self) -> dict:
        """Cached interior/boundary classification (the overlap schedule's).

        A node is *boundary* when a coincident copy lives on another rank
        (it appears in some halo send buffer); an edge is *boundary* when its
        destination is a boundary node, so its aggregate feeds the exchange.
        Interior edges land only on rows the exchange never reads or writes:
        ``halo_sync(agg_bnd) + agg_int == halo_sync(agg_bnd + agg_int)``.

        Returns stacked arrays, equal to the reference's:
          node_bnd_mask  [R, N_pad]  1.0 on boundary nodes;
          edge_bnd_mask / edge_int_mask [R, E_pad], a disjoint split of
            edge_mask;
          edge_bnd_idx / edge_int_idx [R, EB] / [R, EI] int32, each side's
            edge ids (0 on padding), with edge_bnd_valid / edge_int_valid;
          interior_frac, the share of real edges that are interior.
        """
        if self._int_split is not None:
            return self._int_split
        h = self.halo
        node_bnd = np.zeros((self.R, self.n_pad), dtype=np.float32)
        for r in range(self.R):
            node_bnd[r, h.a2a_send_idx[r][h.a2a_send_mask[r] > 0]] = 1.0
        node_bnd *= self.node_mask
        edge_bnd = np.take_along_axis(node_bnd, self.edge_dst, axis=1) * self.edge_mask
        edge_int = self.edge_mask - edge_bnd

        def compact(mask):
            ids = [np.nonzero(mask[r] > 0)[0] for r in range(self.R)]
            width = _round_up(max((i.size for i in ids), default=1), 8)
            idx = np.zeros((self.R, width), dtype=np.int32)
            valid = np.zeros((self.R, width), dtype=np.float32)
            for r, i in enumerate(ids):
                idx[r, :i.size] = i
                valid[r, :i.size] = 1.0
            return idx, valid

        bnd_idx, bnd_valid = compact(edge_bnd)
        int_idx, int_valid = compact(edge_int)
        n_real = float(self.edge_mask.sum())
        self._int_split = dict(
            node_bnd_mask=node_bnd, edge_bnd_mask=edge_bnd, edge_int_mask=edge_int,
            edge_bnd_idx=bnd_idx, edge_bnd_valid=bnd_valid,
            edge_int_idx=int_idx, edge_int_valid=int_valid,
            interior_frac=float(edge_int.sum()) / n_real if n_real else 0.0)
        return self._int_split

    def segment_layout(self, block_n: int, block_e: int, part: str = "all",
                       rank: int | None = None) -> dict:
        """Cached compact gather layout for the fused NMP kernel.

        Runs ``compact_gather_layout`` once per rank (edges outside the
        layout are routed to the ``n_pad`` sentinel so they are dropped) and
        pads the per-rank tile counts to a common maximum (pad tiles:
        ``perm == -1``, src/dst 0).  ``part`` restricts the layout to one
        side of :meth:`interior_split` (``"int"`` | ``"bnd"``): the overlap
        schedule runs the kernel once per side.  A side with no edge on a
        rank (every side ``"bnd"`` at R=1) is one tile of ``perm == -1`` and
        an all-zero ``rowptr``.  ``block_n`` does not shape the layout; it
        stays in the cache key as in the reference.  With ``rank``, only
        that rank's layout is built (a leading axis of 1), padded to the
        same tile count: equal to the stacked layout's slice.

        Returns {perm [R, T, BE] int32 (-1 = empty slot), src [R, T, BE],
                 dst [R, T, BE], rowptr [R, N_pad + 1] int32,
                 src_slots [R, T * BE] int32, src_rowptr [R, N_pad + 1]
                 int32, n_tiles, block_n, block_e}.  The port-only keys:
        ``rowptr`` delimits each node's run of dst-sorted slots — the CUDA
        kernels reduce every run in slot order, which is what makes the
        aggregate deterministic; ``src_slots[src_rowptr[n] ..
        src_rowptr[n + 1]]`` are node n's outgoing slots (flat slot ids),
        over which the backward kernel reduces the source-row gradients.
        """
        key = (int(block_n), int(block_e), part, rank)
        cached = self._seg_layouts.get(key)
        if cached is not None:
            return cached
        from repro_torch.kernels.segment_agg.ops import compact_gather_layout
        if part == "all":
            keep = self.edge_mask
        elif part in ("int", "bnd"):
            keep = self.interior_split()[f"edge_{part}_mask"]
        else:
            raise ValueError(f"unknown layout part {part!r}; expected 'all', "
                             "'int' or 'bnd'")
        ranks = range(self.R) if rank is None else (rank,)
        per_rank = []
        for r in ranks:
            # excluded edges get dst = n_pad -> dropped by the layout pass
            dst = np.where(keep[r] > 0, self.edge_dst[r], self.n_pad)
            per_rank.append(compact_gather_layout(
                self.edge_src[r], dst, self.n_pad, block_e))
        # every rank's tile count, from its edge count alone
        nt = max(1, math.ceil(int((keep > 0).sum(axis=1).max()) / block_e))
        n = len(per_rank)
        perm = np.full((n, nt, block_e), -1, dtype=np.int32)
        src = np.zeros((n, nt, block_e), dtype=np.int32)
        dst_t = np.zeros((n, nt, block_e), dtype=np.int32)
        for r, l in enumerate(per_rank):
            perm[r, :l["n_tiles"]] = l["perm"]
            src[r, :l["n_tiles"]] = l["src"]
            dst_t[r, :l["n_tiles"]] = l["dst"]
        rowptr = np.stack([l["rowptr"] for l in per_rank])
        # src-sorted slot ids, zero-padded past each rank's real slots
        src_slots = np.zeros((n, nt * block_e), dtype=np.int32)
        for r, l in enumerate(per_rank):
            src_slots[r, :l["n_edges"]] = l["src_slots"]
        src_rowptr = np.stack([l["src_rowptr"] for l in per_rank])
        layout = dict(perm=perm, src=src, dst=dst_t, rowptr=rowptr,
                      src_slots=src_slots, src_rowptr=src_rowptr,
                      n_tiles=nt, block_n=int(block_n), block_e=int(block_e))
        self._seg_layouts[key] = layout
        return layout

    def packed_halo(self, bucket: int = 8) -> Dict[str, np.ndarray]:
        """Cached bucketed per-round packed halo arrays (see
        :func:`packed_halo_arrays`)."""
        key = int(bucket)
        cached = self._packed_halos.get(key)
        if cached is None:
            h = self.halo
            cached = packed_halo_arrays(dict(
                nbr_send_idx=h.nbr_send_idx, nbr_send_mask=h.nbr_send_mask,
                nbr_recv_idx=h.nbr_recv_idx, nbr_recv_mask=h.nbr_recv_mask,
            ), bucket=bucket)
            self._packed_halos[key] = cached
        return cached

    def wire_bytes(self, mode: str, packed: bool = False, feat_dim: int = 1,
                   wire_dtype=None, bucket: int = 8) -> dict:
        """Per-rank on-wire halo payload for ONE exchange of a
        ``[N, feat_dim]`` aggregate (the reference's metric):

        * ``mode="a2a"``: every rank ships its full dense buffer to each of
          the other R-1 ranks — ``(R-1) * B * feat_dim`` elements;
        * ``mode="neighbor"``: one ``B``-wide buffer per round a rank
          takes part in;
        * ``packed=True`` (neighbor only): round ``k``'s bucketed width
          ``w_k`` in place of ``B``.

        ``wire_dtype`` (a torch dtype or its name; None is float32) sets
        the element size.  Returns ``{mode, packed, itemsize, per_rank,
        max, mean, total}`` (bytes; ``per_rank`` a plain list)."""
        if mode not in ("a2a", "neighbor"):
            raise ValueError(f"wire_bytes: unknown halo mode {mode!r}")
        if packed and mode == "a2a":
            raise ValueError("wire_bytes: packed buffers are neighbor-only — "
                             "all-to-all needs uniform per-rank buffers")
        from repro_torch.core.halo import wire_dtype_of
        itemsize = 4 if wire_dtype is None else wire_dtype_of(wire_dtype).itemsize
        h = self.halo
        per_rank = np.zeros(self.R, dtype=np.int64)
        if mode == "a2a":
            B = h.a2a_send_idx.shape[-1]
            per_rank[:] = (self.R - 1) * B * feat_dim * itemsize
        else:
            K, B = h.nbr_send_idx.shape[1], h.nbr_send_idx.shape[2]
            pk = self.packed_halo(bucket) if packed else None
            for k in range(K):
                width = pk[f"pk{k}_send_idx"].shape[-1] if packed else B
                participates = (h.nbr_send_mask[:, k].sum(axis=-1) > 0) \
                    | (h.nbr_recv_mask[:, k].sum(axis=-1) > 0)
                per_rank += participates * width * feat_dim * itemsize
        return dict(mode=mode, packed=bool(packed), itemsize=itemsize,
                    per_rank=[int(v) for v in per_rank],
                    max=int(per_rank.max()) if self.R else 0,
                    mean=float(per_rank.mean()) if self.R else 0.0,
                    total=int(per_rank.sum()))

    def device_arrays(self, seg_layout: Tuple[int, int] | None = None,
                      split: bool = False, packed: bool = False,
                      rank: int | None = None) -> Dict[str, np.ndarray]:
        """The dict of arrays a serve/train step consumes (leading rank axis).

        ``seg_layout=(block_n, block_e)`` adds the cached compact layout
        (``seg_perm``/``seg_src``/``seg_dst`` and the port's ``seg_rowptr``,
        ``seg_src_slots``, ``seg_src_rowptr``); ``split=True`` adds the
        interior/boundary split of the overlap schedule
        (``edge_{bnd,int}_idx`` / ``_valid``, and with ``seg_layout`` each
        side's layout under the same names suffixed ``_bnd`` / ``_int``);
        ``packed=True`` adds the bucketed per-round packed halo arrays.
        With ``rank``, every array is that rank's slice (a leading axis of
        1) and only its layouts are built.
        """
        h = self.halo
        out = dict(
            node_mask=self.node_mask, node_inv_mult=self.node_inv_mult,
            edge_src=self.edge_src, edge_dst=self.edge_dst,
            edge_mask=self.edge_mask, edge_inv_mult=self.edge_inv_mult,
            a2a_send_idx=h.a2a_send_idx, a2a_send_mask=h.a2a_send_mask,
            a2a_recv_idx=h.a2a_recv_idx, a2a_recv_mask=h.a2a_recv_mask,
            nbr_send_idx=h.nbr_send_idx, nbr_send_mask=h.nbr_send_mask,
            nbr_recv_idx=h.nbr_recv_idx, nbr_recv_mask=h.nbr_recv_mask,
        )
        if split:
            sp = self.interior_split()
            for k in ("edge_bnd_idx", "edge_bnd_valid", "edge_int_idx", "edge_int_valid"):
                out[k] = sp[k]
        if packed:
            out.update(self.packed_halo())
        if rank is not None:
            out = {k: v[rank:rank + 1] for k, v in out.items()}
        layout_keys = ("perm", "src", "dst", "rowptr", "src_slots", "src_rowptr")
        parts = (("all", ""),) + ((("bnd", "_bnd"), ("int", "_int")) if split else ())
        if seg_layout is not None:
            for part, suffix in parts:
                layout = self.segment_layout(*seg_layout, part=part, rank=rank)
                out.update((f"seg_{k}{suffix}", layout[k]) for k in layout_keys)
        return out


# ---------------------------------------------------------------------------
# element partitioning (NekRS-style decompositions)
# ---------------------------------------------------------------------------

def partition_elements(mesh: SEMMesh, rank_grid: Sequence[int]) -> np.ndarray:
    """Assign elements to ranks by blocks of the element grid.

    ``rank_grid`` has one entry per axis; (R,1,1) = slabs, (a,b,1) = pencils,
    (a,b,c) = sub-cubes.
    """
    if len(rank_grid) != mesh.dim:
        raise ValueError("rank_grid must match mesh dim")
    for n, r in zip(mesh.nelem_axes, rank_grid):
        if n % r != 0:
            raise ValueError(f"elements per axis {n} not divisible by ranks {r}")
    blocks = [n // r for n, r in zip(mesh.nelem_axes, rank_grid)]
    # element grid index, x fastest (SEMMesh.element_grid_index, vectorized)
    e = np.arange(mesh.n_elem, dtype=np.int64)
    gidx = []
    for n in mesh.nelem_axes:
        gidx.append(e % n)
        e = e // n
    rank = np.zeros(mesh.n_elem, dtype=np.int64)
    for ax in range(mesh.dim - 1, -1, -1):
        rank = rank * rank_grid[ax] + gidx[ax] // blocks[ax]
    return rank


def from_element_partition(mesh: SEMMesh, elem2rank: np.ndarray,
                           R: int) -> List[RankGraph]:
    """Build per-rank reduced local graphs (Fig. 3c) from an element partition."""
    le = element_lattice_edges(mesh.p, mesh.dim)
    n = np.int64(mesh.n_nodes)

    node_mult = np.zeros(mesh.n_nodes, dtype=np.int64)
    rank_nodes: List[np.ndarray] = []
    rank_keys: List[np.ndarray] = []     # undirected pairs as lo * n + hi
    for r in range(R):
        elems = np.nonzero(elem2rank == r)[0]
        if elems.size == 0:
            rank_nodes.append(np.zeros(0, dtype=np.int64))
            rank_keys.append(np.zeros(0, dtype=np.int64))
            continue
        en = mesh.elem_nodes[elems]                  # [ne, npts]
        gids = np.unique(en)                         # local collapse of coincident nodes
        src = en[:, le[:, 0]].reshape(-1)
        dst = en[:, le[:, 1]].reshape(-1)
        # sorted unique keys == lexicographically sorted unique (lo, hi)
        keys = np.unique(np.minimum(src, dst) * n + np.maximum(src, dst))
        rank_nodes.append(gids)
        rank_keys.append(keys)
        node_mult[gids] += 1

    # edge multiplicity d_ij: number of ranks owning each undirected edge
    all_keys, counts = np.unique(np.concatenate(rank_keys), return_counts=True)

    graphs: List[RankGraph] = []
    for r in range(R):
        gids, keys = rank_nodes[r], rank_keys[r]
        pairs = np.stack([keys // n, keys % n], axis=-1)
        dir_r = undirected_to_directed(pairs)
        loc = np.searchsorted(gids, dir_r).astype(np.int64).reshape(-1, 2)
        mult = counts[np.searchsorted(all_keys, keys)]
        inv_und = (1.0 / mult).astype(np.float32)
        graphs.append(RankGraph(
            global_ids=gids,
            edges=loc,
            edge_inv_mult=np.concatenate([inv_und, inv_und]),
            node_inv_mult=(1.0 / node_mult[gids]).astype(np.float32),
        ))
    return graphs


def from_edge_partition(
    n_nodes: int,
    directed_edges: np.ndarray,
    R: int,
    node2part: np.ndarray | None = None,
    assign: str = "dst",
    extra_nodes: Sequence[np.ndarray] | None = None,
) -> List[RankGraph]:
    """Vertex-cut partition of an arbitrary directed edge list.

    Every node's *primary* copy lives on ``node2part[node]`` (contiguous
    blocks by default); each directed edge is assigned to one rank
    (``assign`` = 'dst' | 'src'); endpoint copies are replicated wherever
    used.  d_ij == 1 always; d_i = number of ranks holding a copy of i.

    ``extra_nodes`` (one array of global ids per rank) forces additional
    replica copies beyond the edge-endpoint closure: the multilevel
    hierarchy (``core/coarsen.py``) places a coarse-node copy on every rank
    that owns restriction / prolongation edges into it, so the transfer
    aggregates are completed by the same halo sum as the edge aggregates.
    """
    if node2part is None:
        node2part = (np.arange(n_nodes) * R) // max(n_nodes, 1)
    node2part = node2part.astype(np.int64)
    e_owner = node2part[directed_edges[:, 1 if assign == "dst" else 0]]

    node_mult = np.zeros(n_nodes, dtype=np.int64)
    rank_nodes: List[np.ndarray] = []
    rank_edges: List[np.ndarray] = []
    for r in range(R):
        er = directed_edges[e_owner == r]
        parts = [er.reshape(-1), np.nonzero(node2part == r)[0]]
        if extra_nodes is not None and len(extra_nodes[r]):
            parts.append(np.asarray(extra_nodes[r], dtype=np.int64))
        gids = np.unique(np.concatenate(parts))
        rank_nodes.append(gids)
        rank_edges.append(er)
        node_mult[gids] += 1

    graphs: List[RankGraph] = []
    for r in range(R):
        gids, er = rank_nodes[r], rank_edges[r]
        lookup = np.full(n_nodes, -1, dtype=np.int64)
        lookup[gids] = np.arange(gids.size)
        loc = lookup[er].reshape(-1, 2) if er.size else np.zeros((0, 2), dtype=np.int64)
        graphs.append(RankGraph(
            global_ids=gids,
            edges=loc,
            edge_inv_mult=np.ones(loc.shape[0], dtype=np.float32),
            node_inv_mult=(1.0 / node_mult[gids]).astype(np.float32),
        ))
    return graphs


# ---------------------------------------------------------------------------
# halo plan construction
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def greedy_edge_coloring(pairs: List[Tuple[int, int]]) -> List[List[Tuple[int, int]]]:
    """Color rank-pair edges so same-color pairs are disjoint (<= Δ+1 colors).

    Pairs are processed largest-degree-endpoints first for tighter colorings.
    Returns rounds: list of lists of (r, s) with r < s.
    """
    deg: Dict[int, int] = {}
    for a, b in pairs:
        deg[a] = deg.get(a, 0) + 1
        deg[b] = deg.get(b, 0) + 1
    order = sorted(pairs, key=lambda p: -(deg[p[0]] + deg[p[1]]))
    used: Dict[int, set] = {}
    rounds: List[List[Tuple[int, int]]] = []
    for a, b in order:
        c = 0
        while c in used.get(a, set()) or c in used.get(b, set()):
            c += 1
        while len(rounds) <= c:
            rounds.append([])
        rounds[c].append((a, b))
        used.setdefault(a, set()).add(c)
        used.setdefault(b, set()).add(c)
    return rounds


def build_halo_plan(graphs: List[RankGraph], pad_to: int = 8) -> HaloPlan:
    """Shared-node send/recv masks for both exchange modes.

    For each rank pair (r, s) with shared global ids, both directions exchange
    the local aggregates at those ids, sorted by global id (fixing summation
    order => deterministic results).
    """
    R = len(graphs)
    shared: Dict[Tuple[int, int], np.ndarray] = {}
    for r in range(R):
        for s in range(r + 1, R):
            common = np.intersect1d(graphs[r].global_ids, graphs[s].global_ids,
                                    assume_unique=True)
            if common.size:
                shared[(r, s)] = common  # sorted

    def local(r, common):
        return np.searchsorted(graphs[r].global_ids, common).astype(np.int32)

    # ---- A2A equal buffers ----
    B = _round_up(max((v.size for v in shared.values()), default=1), pad_to)
    a2a_send_idx = np.zeros((R, R, B), dtype=np.int32)
    a2a_send_mask = np.zeros((R, R, B), dtype=np.float32)
    a2a_recv_idx = np.zeros((R, R, B), dtype=np.int32)
    a2a_recv_mask = np.zeros((R, R, B), dtype=np.float32)
    for (r, s), common in shared.items():
        n = common.size
        lr, ls = local(r, common), local(s, common)
        a2a_send_idx[r, s, :n] = lr
        a2a_send_mask[r, s, :n] = 1.0
        a2a_recv_idx[s, r, :n] = ls
        a2a_recv_mask[s, r, :n] = 1.0
        a2a_send_idx[s, r, :n] = ls
        a2a_send_mask[s, r, :n] = 1.0
        a2a_recv_idx[r, s, :n] = lr
        a2a_recv_mask[r, s, :n] = 1.0

    # ---- NEIGHBOR rounds ----
    rounds = greedy_edge_coloring(list(shared.keys())) if shared else []
    K = max(len(rounds), 1)
    nbr_send_idx = np.zeros((R, K, B), dtype=np.int32)
    nbr_send_mask = np.zeros((R, K, B), dtype=np.float32)
    nbr_recv_idx = np.zeros((R, K, B), dtype=np.int32)
    nbr_recv_mask = np.zeros((R, K, B), dtype=np.float32)
    perms: List[List[Tuple[int, int]]] = []
    for k, rnd in enumerate(rounds or [[]]):
        perm: List[Tuple[int, int]] = []
        for (r, s) in rnd:
            common = shared[(r, s)]
            n = common.size
            lr, ls = local(r, common), local(s, common)
            for q, lq in ((r, lr), (s, ls)):
                nbr_send_idx[q, k, :n] = lq
                nbr_send_mask[q, k, :n] = 1.0
                nbr_recv_idx[q, k, :n] = lq
                nbr_recv_mask[q, k, :n] = 1.0
            perm.append((r, s))
            perm.append((s, r))
        perms.append(perm)
    return HaloPlan(
        a2a_send_idx=a2a_send_idx, a2a_send_mask=a2a_send_mask,
        a2a_recv_idx=a2a_recv_idx, a2a_recv_mask=a2a_recv_mask,
        perms=perms,
        nbr_send_idx=nbr_send_idx, nbr_send_mask=nbr_send_mask,
        nbr_recv_idx=nbr_recv_idx, nbr_recv_mask=nbr_recv_mask,
    )


def packed_halo_arrays(nbr: Dict[str, np.ndarray],
                       bucket: int = 8) -> Dict[str, np.ndarray]:
    """Bucketed per-round truncation of dense NEIGHBOR halo arrays.

    Real entries are prefix-packed (mask is a 1.0-prefix), so truncating
    round ``k`` to ``w_k = round_up(max real entries over ranks, bucket)``
    keeps every real entry: the packed arrays are slices of the dense ones.
    Returns ``pk{k}_{send_idx,send_mask,recv_idx,recv_mask}`` ([R, w_k]).
    """
    send_mask, recv_mask = nbr["nbr_send_mask"], nbr["nbr_recv_mask"]
    R, K, B = send_mask.shape
    out: Dict[str, np.ndarray] = {}
    for k in range(K):
        occ = max(int((send_mask[:, k] > 0).sum(axis=-1).max(initial=0)),
                  int((recv_mask[:, k] > 0).sum(axis=-1).max(initial=0)))
        w = min(_round_up(occ, bucket), B)
        if float(send_mask[:, k, w:].sum()) or float(recv_mask[:, k, w:].sum()):
            raise ValueError(
                f"packed_halo_arrays: round {k} has real entries beyond "
                f"width {w} — halo arrays are not prefix-packed")
        for name in ("send_idx", "send_mask", "recv_idx", "recv_mask"):
            out[f"pk{k}_{name}"] = np.ascontiguousarray(
                nbr[f"nbr_{name}"][:, k, :w])
    return out


def pack(graphs: List[RankGraph], n_global: int, pad_to: int = 8) -> PartitionedGraphs:
    """Pad per-rank graphs to common shapes and stack along axis 0."""
    R = len(graphs)
    n_pad = _round_up(max(g.n_nodes for g in graphs), pad_to)
    e_pad = _round_up(max(g.n_edges for g in graphs), pad_to)
    gid = np.full((R, n_pad), -1, dtype=np.int32)
    nmask = np.zeros((R, n_pad), dtype=np.float32)
    ninv = np.zeros((R, n_pad), dtype=np.float32)
    esrc = np.zeros((R, e_pad), dtype=np.int32)
    edst = np.zeros((R, e_pad), dtype=np.int32)
    emask = np.zeros((R, e_pad), dtype=np.float32)
    einv = np.zeros((R, e_pad), dtype=np.float32)
    for r, g in enumerate(graphs):
        gid[r, :g.n_nodes] = g.global_ids
        nmask[r, :g.n_nodes] = 1.0
        ninv[r, :g.n_nodes] = g.node_inv_mult
        esrc[r, :g.n_edges] = g.edges[:, 0]
        edst[r, :g.n_edges] = g.edges[:, 1]
        emask[r, :g.n_edges] = 1.0
        einv[r, :g.n_edges] = g.edge_inv_mult
    return PartitionedGraphs(
        R=R, n_global=n_global,
        global_ids=gid, node_mask=nmask, node_inv_mult=ninv,
        edge_src=esrc, edge_dst=edst, edge_mask=emask, edge_inv_mult=einv,
        halo=build_halo_plan(graphs, pad_to=pad_to),
    )


def _shifts():
    return [(da, db) for da in (-1, 0, 1) for db in (-1, 0, 1)
            if not (da == 0 and db == 0)]


def flat_rounds2d_perms(grid: Tuple[int, int]) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Flat per-round (src, dst) rank pairs of :func:`build_2d_halo_rounds`.

    Each round routes one uniform (da, db) grid shift as <= 2 chained
    per-axis hops; their composition delivers rank ``a*Gb + b``'s buffer to
    ``(a+da)*Gb + (b+db)`` exactly when that rank exists.  The stacked
    emulator exchanges along these pairs; the shift order is
    :func:`build_2d_halo_rounds`'s."""
    Ga, Gb = grid
    rounds = []
    for da, db in _shifts():
        perm = []
        for a in range(Ga):
            for b in range(Gb):
                a2, b2 = a + da, b + db
                if 0 <= a2 < Ga and 0 <= b2 < Gb:
                    perm.append((a * Gb + b, a2 * Gb + b2))
        rounds.append(tuple(perm))
    return tuple(rounds)


def build_2d_halo_rounds(graphs: List[RankGraph], grid: Tuple[int, int],
                         axes: Tuple[str, str] = ("data", "model"),
                         pad_to: int = 8):
    """Two-level halo plan: sub-graphs laid out on a (Ga, Gb) grid (rank
    ``a * Gb + b``, a along ``axes[0]``, b along ``axes[1]``); every
    neighbor shift (da, db) becomes one exchange round routed as <= 2
    chained one-way hops, first along ``axes[1]`` then along ``axes[0]``
    (a uniform translation: no relay conflicts).

    Returns (rounds2d, nbr arrays [R, K, B]); rounds2d holds per round its
    hops ``(axis, ((i, i + d), ...))``, indexed along the named axis."""
    Ga, Gb = grid
    R = len(graphs)
    if R != Ga * Gb:
        raise ValueError(f"{R} rank graphs do not fill a {Ga}x{Gb} grid")
    shifts = _shifts()
    shared: Dict[Tuple[int, int], np.ndarray] = {}
    maxb = 1
    for r in range(R):
        a, b = divmod(r, Gb)
        for si, (da, db) in enumerate(shifts):
            a2, b2 = a + da, b + db
            if not (0 <= a2 < Ga and 0 <= b2 < Gb):
                continue
            s = a2 * Gb + b2
            common = np.intersect1d(graphs[r].global_ids, graphs[s].global_ids,
                                    assume_unique=True)
            if common.size:
                shared[(r, si)] = common
                maxb = max(maxb, common.size)

    B = _round_up(maxb, pad_to)
    K = len(shifts)
    send_idx = np.zeros((R, K, B), dtype=np.int32)
    send_mask = np.zeros((R, K, B), dtype=np.float32)
    recv_idx = np.zeros((R, K, B), dtype=np.int32)
    recv_mask = np.zeros((R, K, B), dtype=np.float32)
    rounds2d = []
    for si, (da, db) in enumerate(shifts):
        hops = []
        if db:
            hops.append((axes[1], tuple((b, b + db) for b in range(Gb)
                                        if 0 <= b + db < Gb)))
        if da:
            hops.append((axes[0], tuple((a, a + da) for a in range(Ga)
                                        if 0 <= a + da < Ga)))
        rounds2d.append(tuple(hops))
        for r in range(R):
            common = shared.get((r, si))
            if common is None:
                continue
            a, b = divmod(r, Gb)
            s = (a + da) * Gb + (b + db)
            n = common.size
            # global -> local ids (sorted unique global ids, as the
            # reference's dict lookup)
            send_idx[r, si, :n] = np.searchsorted(graphs[r].global_ids, common)
            send_mask[r, si, :n] = 1.0
            recv_idx[s, si, :n] = np.searchsorted(graphs[s].global_ids, common)
            recv_mask[s, si, :n] = 1.0
    arrays = dict(nbr_send_idx=send_idx, nbr_send_mask=send_mask,
                  nbr_recv_idx=recv_idx, nbr_recv_mask=recv_mask)
    return tuple(rounds2d), arrays


def partition_mesh_2d(mesh: SEMMesh, grid: Tuple[int, int],
                      axes: Tuple[str, str] = ("data", "model"),
                      pad_to: int = 8) -> PartitionedGraphs:
    """The block partition of ``mesh`` on a (Ga, Gb) rank grid (rank
    ``a * Gb + b``: element blocks (Gb, Ga, 1), y-major, as the reference's
    two-level driver lays them out) with the two-level halo plan of
    :func:`build_2d_halo_rounds` in place of the edge-colored rounds: its
    ``nbr_*`` arrays, ``rounds2d`` and ``grid2d``, and the rounds' flat
    pairs as ``perms``.  ``NMPPlan.build(pg, "neighbor")`` then gives the
    rounds2d spec, and ``ShardedGraph.build`` its dense and packed arrays."""
    Ga, Gb = grid
    graphs = from_element_partition(mesh, partition_elements(mesh, (Gb, Ga, 1)),
                                     Ga * Gb)
    pg = pack(graphs, mesh.n_nodes, pad_to=pad_to)
    rounds2d, nbr = build_2d_halo_rounds(graphs, grid, axes, pad_to=pad_to)
    a2a = {f.name: getattr(pg.halo, f.name) for f in dataclasses.fields(HaloPlan)
           if f.name.startswith("a2a_")}
    pg.halo = HaloPlan2d(**a2a, **nbr, perms=[list(p) for p in flat_rounds2d_perms(grid)],
                         rounds2d=rounds2d, grid2d=((axes[0], Ga), (axes[1], Gb)))
    return pg


# ---------------------------------------------------------------------------
# front doors
# ---------------------------------------------------------------------------

def partition_mesh(mesh: SEMMesh, rank_grid: Sequence[int], pad_to: int = 8,
                   method: str = "block") -> PartitionedGraphs:
    """Partition an SEM mesh onto ``prod(rank_grid)`` ranks.

    ``method="block"`` is the NekRS-style element-block decomposition along
    the rank grid (d_ij > 1 coincident GLL copies); ``method="spectral"``
    runs recursive spectral bisection + KL refinement on the mesh graph
    (``core/partition_quality.py``) and builds a vertex-cut edge partition
    (d_ij == 1).  Consistency (Eqs. 2, 3) holds either way: the choice only
    moves halo volume and balance."""
    R = int(math.prod(rank_grid))
    if method == "block":
        e2r = partition_elements(mesh, rank_grid)
        return pack(from_element_partition(mesh, e2r, R), mesh.n_nodes,
                    pad_to=pad_to)
    if method == "spectral":
        from repro_torch.core.mesh_gen import mesh_graph_edges
        from repro_torch.core.partition_quality import mesh_node2part
        node2part = mesh_node2part(mesh, R)
        directed = undirected_to_directed(mesh_graph_edges(mesh))
        return pack(from_edge_partition(mesh.n_nodes, directed, R,
                                        node2part=node2part),
                    mesh.n_nodes, pad_to=pad_to)
    raise ValueError(f"unknown partition method {method!r} "
                     "(expected 'block' or 'spectral')")


def partition_graph(n_nodes: int, directed_edges: np.ndarray, R: int,
                    pad_to: int = 8, assign: str = "dst",
                    method: str = "block",
                    node2part: np.ndarray = None) -> PartitionedGraphs:
    """Partition an arbitrary directed graph onto R ranks.

    ``node2part`` (any [N] int array; ranks may even be empty) wins over
    ``method``; otherwise ``method="block"`` keeps the contiguous index
    split and ``method="spectral"`` computes one with
    ``core/partition_quality.py::spectral_node2part``."""
    if node2part is None and method == "spectral":
        from repro_torch.core.partition_quality import spectral_node2part
        node2part = spectral_node2part(n_nodes, directed_edges, R)
    elif node2part is None and method != "block":
        raise ValueError(f"unknown partition method {method!r} "
                         "(expected 'block' or 'spectral')")
    return pack(from_edge_partition(n_nodes, directed_edges, R,
                                    node2part=node2part, assign=assign),
                n_nodes, pad_to=pad_to)


def gather_node_features(pg: PartitionedGraphs, global_x: np.ndarray,
                         rank: int | None = None) -> np.ndarray:
    """[n_global, F] -> [R, N_pad, F]; coincident copies get identical rows.
    With ``rank``, that rank's rows alone: [1, N_pad, F]."""
    ids, mask = pg.global_ids, pg.node_mask
    if rank is not None:
        ids, mask = ids[rank:rank + 1], mask[rank:rank + 1]
    safe = np.clip(ids, 0, None)
    out = global_x[safe.reshape(-1)].reshape(ids.shape[0], pg.n_pad, -1)
    return out * mask[..., None]


def scatter_node_outputs(pg: PartitionedGraphs, per_rank_y: np.ndarray) -> np.ndarray:
    """Inverse of gather (Eq. 2's "cat" by global index): [R, N_pad, F] -> [n_global, F].

    Coincident copies are asserted consistent by taking any owner's row.
    """
    F = per_rank_y.shape[-1]
    out = np.zeros((pg.n_global, F), dtype=per_rank_y.dtype)
    for r in range(pg.R):
        m = pg.node_mask[r] > 0
        out[pg.global_ids[r, m]] = per_rank_y[r, m]
    return out
