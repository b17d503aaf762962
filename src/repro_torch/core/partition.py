"""Distributed mesh-based graph partitioning with halo metadata (Sec. II-A).

Port of ``repro.core.partition``, block partitioner only: elements of an
``SEMMesh`` are assigned to ranks by blocks of the element grid
(NekRS-style slab/pencil/block decompositions); nodes on shared element
faces become *coincident copies* on every touching rank and face-lattice
edges are duplicated across ranks (edge multiplicity d_ij > 1, undone by
1/d_ij scaling during aggregation — Eq. 4b).

The halo plan carries both exchange layouts of the reference:
  * A2A       — equal-size buffers to *all* ranks;
  * NEIGHBOR  — the rank adjacency graph greedily edge-colored into rounds
    of disjoint rank pairs (plus the bucketed per-round packed arrays).

Everything here is host-side numpy and produces arrays equal to the
reference's (``tests/test_torch_host.py``).  The per-edge python loops of
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
    _seg_layouts: Dict[Tuple[int, int], dict] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # bucketed per-round packed halo arrays, memoized per bucket size
    _packed_halos: Dict[int, dict] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_pad(self) -> int:
        return int(self.global_ids.shape[1])

    @property
    def e_pad(self) -> int:
        return int(self.edge_src.shape[1])

    def segment_layout(self, block_n: int, block_e: int) -> dict:
        """Cached compact gather layout for the fused NMP kernel.

        Runs ``compact_gather_layout`` once per rank (padding edges are
        routed to an out-of-range sentinel so they are dropped) and pads the
        per-rank tile counts to a common maximum (pad tiles: ``perm == -1``,
        src/dst 0).  ``block_n`` does not shape the layout; it stays in the
        cache key as in the reference.

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
        key = (int(block_n), int(block_e))
        cached = self._seg_layouts.get(key)
        if cached is not None:
            return cached
        from repro_torch.kernels.segment_agg.ops import compact_gather_layout
        per_rank = []
        for r in range(self.R):
            # masked-out edges get dst = n_pad -> dropped by the layout pass
            dst = np.where(self.edge_mask[r] > 0, self.edge_dst[r], self.n_pad)
            per_rank.append(compact_gather_layout(
                self.edge_src[r], dst, self.n_pad, block_e))
        nt = max(l["n_tiles"] for l in per_rank)
        perm = np.full((self.R, nt, block_e), -1, dtype=np.int32)
        src = np.zeros((self.R, nt, block_e), dtype=np.int32)
        dst_t = np.zeros((self.R, nt, block_e), dtype=np.int32)
        for r, l in enumerate(per_rank):
            perm[r, :l["n_tiles"]] = l["perm"]
            src[r, :l["n_tiles"]] = l["src"]
            dst_t[r, :l["n_tiles"]] = l["dst"]
        rowptr = np.stack([l["rowptr"] for l in per_rank])
        # src-sorted slot ids, zero-padded past each rank's real slots
        src_slots = np.zeros((self.R, nt * block_e), dtype=np.int32)
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

    def device_arrays(self, seg_layout: Tuple[int, int] | None = None,
                      packed: bool = False) -> Dict[str, np.ndarray]:
        """The dict of arrays a serve/train step consumes (leading rank axis).

        ``seg_layout=(block_n, block_e)`` adds the cached compact layout
        (``seg_perm``/``seg_src``/``seg_dst`` and the port's ``seg_rowptr``,
        ``seg_src_slots``, ``seg_src_rowptr``);
        ``packed=True`` adds the bucketed per-round packed halo arrays.
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
        if seg_layout is not None:
            layout = self.segment_layout(*seg_layout)
            out["seg_perm"] = layout["perm"]
            out["seg_src"] = layout["src"]
            out["seg_dst"] = layout["dst"]
            out["seg_rowptr"] = layout["rowptr"]
            out["seg_src_slots"] = layout["src_slots"]
            out["seg_src_rowptr"] = layout["src_rowptr"]
        if packed:
            out.update(self.packed_halo())
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


# ---------------------------------------------------------------------------
# front doors
# ---------------------------------------------------------------------------

def partition_mesh(mesh: SEMMesh, rank_grid: Sequence[int], pad_to: int = 8,
                   method: str = "block") -> PartitionedGraphs:
    """Partition an SEM mesh onto ``prod(rank_grid)`` ranks by element
    blocks.  ``method="spectral"`` (the reference's spectral bisection) is
    not ported yet and raises."""
    if method != "block":
        raise NotImplementedError(
            f"partition method {method!r} is not ported to repro_torch yet "
            "(only 'block'); see ROADMAP.md")
    R = int(math.prod(rank_grid))
    e2r = partition_elements(mesh, rank_grid)
    return pack(from_element_partition(mesh, e2r, R), mesh.n_nodes,
                pad_to=pad_to)


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
