"""Consistent multilevel (coarse-grid) hierarchy over the SEM mesh (port of
``repro.core.coarsen``).

Flat message passing moves information one graph hop per layer; a coarse
hierarchy carries it across the domain: restrict the node state to a much
smaller graph, message-pass there (one coarse hop spans many fine hops),
and prolong the result back.  The hierarchy is built so that the R-rank
V-cycle is arithmetically the 1-rank one, level by level.

Levels
  0   the GLL-node graph (``SEMMesh``);
  1   element centroids: one node per spectral element, edges between
      elements sharing at least one GLL node;
  l>1 element-block clustering: the element grid is coarsened by
      ``cluster`` per axis, nodes are block centroids, edges connect blocks
      holding adjacent members (the level below's edges, projected).

Every level is a ``PartitionedGraphs`` over the SAME R ranks, built with
``from_edge_partition`` on a ``node2rank`` derived from the element
partition; each restriction / prolongation edge (fine f -> coarse c) is
owned by ONE rank, the primary rank of f, which holds f and is given a
replica copy of c (``extra_nodes``).  The restriction aggregate is then a
partial sum over rank-local children, completed by the coarse level's halo
sum exactly as the Eq. 4b aggregate is; prolongation is the transpose,
completed by the fine level's halo sum.

Host numpy, computed once per partition, array-equal to the reference's
(``tests/test_torch_multilevel.py``); :func:`_project_edges` gets the
reference's sorted unique pairs without forming the cross product of every
fine edge's parent lists (64 pairs per edge in 3D), which keeps the build
of the 727,833-node p=7 mesh to seconds.  ``ShardedGraph.build(...,
hierarchy=)`` (``core/graph_state.py``) nests each coarse level as a child
graph carrying its transfer maps.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.mesh_gen import (
    SEMMesh, mesh_graph_edges, undirected_to_directed)
from repro_torch.core.partition import (
    PartitionedGraphs, RankGraph, _round_up, from_edge_partition,
    from_element_partition, pack, partition_elements)


@dataclasses.dataclass
class TransferPlan:
    """Padded per-rank restriction / prolongation maps between two levels.

    Row r holds the transfer edges owned by rank r (the fine endpoint's
    primary rank); ``fine_idx`` / ``coarse_idx`` are LOCAL node indices on
    that rank at the fine / coarse level.  ``r_w`` (restriction,
    1/|children(c)|) and ``p_w`` (prolongation, 1/|parents(f)|) make both
    transfers means over the membership relation; padding slots weigh 0.
    """
    fine_idx: np.ndarray     # int32 [R, M_pad]
    coarse_idx: np.ndarray   # int32 [R, M_pad]
    r_w: np.ndarray          # float32 [R, M_pad]
    p_w: np.ndarray          # float32 [R, M_pad]

    @property
    def m_pad(self) -> int:
        return int(self.fine_idx.shape[1])


@dataclasses.dataclass
class MultiLevelGraphs:
    """The hierarchy: per-level partitions and the transfers between them.

    ``levels[0]`` is the fine (GLL-node) partition; ``transfers[l-1]``
    connects level l-1 to level l; ``coords[l]`` are level l's global node
    coordinates (centroids for l >= 1), the source of its static edge
    features.
    """
    levels: List[PartitionedGraphs]
    coords: List[np.ndarray]
    transfers: List[TransferPlan]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level_sizes(self) -> List[int]:
        return [pg.n_global for pg in self.levels]


def _primary_ranks(graphs: List[RankGraph], n_nodes: int) -> np.ndarray:
    """Lowest rank holding a copy of each global node (-1 if unowned)."""
    primary = np.full(n_nodes, -1, dtype=np.int64)
    for r in range(len(graphs) - 1, -1, -1):
        primary[graphs[r].global_ids] = r
    return primary


def _parents_table(pairs: np.ndarray, n_fine: int) -> np.ndarray:
    """Ragged membership as a padded table: parents[f] -> [P] coarse ids,
    -1 padding (P = most parents of one fine node, <= 2^dim here)."""
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    f_sorted = pairs[order, 0]
    counts = np.bincount(f_sorted, minlength=n_fine)
    P = int(counts.max()) if counts.size else 1
    table = np.full((n_fine, max(P, 1)), -1, dtype=np.int64)
    slot = np.arange(pairs.shape[0]) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]])[f_sorted]
    table[f_sorted, slot] = pairs[order, 1]
    return table


def _project_edges(fine_edges: np.ndarray, parents: np.ndarray) -> np.ndarray:
    """Coarse directed edges: every (parent of u, parent of v) pair of a fine
    edge (u, v), self-loops dropped, sorted and deduplicated — the
    reference's cross product of the padded parent lists, uniqued.  Formed
    in two steps, each deduplicated: the (u, parent of v) pairs, then their
    (parent of u, parent of v) pairs."""
    if fine_edges.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    n_c = np.int64(max(int(parents.max()) + 1, 1))
    P = parents.shape[1]
    u = np.repeat(fine_edges[:, 0].astype(np.int64), P)
    cv = parents[fine_edges[:, 1]].reshape(-1)
    keep = cv >= 0
    ucv = np.unique(u[keep] * n_c + cv[keep])
    u, cv = ucv // n_c, ucv % n_c
    cu = parents[u].reshape(-1)
    cv = np.repeat(cv, P)
    keep = (cu >= 0) & (cu != cv)
    if not keep.any():
        return np.zeros((0, 2), dtype=np.int64)
    keys = np.unique(cu[keep] * n_c + cv[keep])
    return np.stack([keys // n_c, keys % n_c], axis=-1)


def _local_lookup(graphs: List[RankGraph], n_nodes: int) -> np.ndarray:
    """[R, n_nodes] global -> local node index per rank (-1 if absent)."""
    lut = np.full((len(graphs), n_nodes), -1, dtype=np.int64)
    for r, g in enumerate(graphs):
        lut[r, g.global_ids] = np.arange(g.global_ids.size)
    return lut


def _pack_transfer(pairs: np.ndarray, owner: np.ndarray,
                   fine_graphs: List[RankGraph],
                   coarse_graphs: List[RankGraph],
                   R: int, pad_to: int = 8,
                   n_fine: int = 0, n_coarse: int = 0) -> TransferPlan:
    """Give each (fine, coarse) transfer edge to ``owner`` (the fine
    endpoint's primary rank) and pack local-index maps padded per rank."""
    f_g, c_g = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    n_children = np.bincount(c_g, minlength=n_coarse)
    n_parents = np.bincount(f_g, minlength=n_fine)
    lut_f = _local_lookup(fine_graphs, n_fine)
    lut_c = _local_lookup(coarse_graphs, n_coarse)

    counts = np.bincount(owner, minlength=R)
    m_pad = _round_up(int(counts.max()) if counts.size else 1, pad_to)
    fi = np.zeros((R, m_pad), dtype=np.int32)
    ci = np.zeros((R, m_pad), dtype=np.int32)
    rw = np.zeros((R, m_pad), dtype=np.float32)
    pw = np.zeros((R, m_pad), dtype=np.float32)
    order = np.argsort(owner, kind="stable")
    slot = np.arange(pairs.shape[0]) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]])[owner[order]]
    r_o, f_o, c_o = owner[order], f_g[order], c_g[order]
    lf, lc = lut_f[r_o, f_o], lut_c[r_o, c_o]
    if not ((lf >= 0).all() and (lc >= 0).all()):
        raise AssertionError("transfer edge references a node missing from "
                             "its owner rank")
    fi[r_o, slot] = lf
    ci[r_o, slot] = lc
    rw[r_o, slot] = 1.0 / n_children[c_o]
    pw[r_o, slot] = 1.0 / n_parents[f_o]
    return TransferPlan(fine_idx=fi, coarse_idx=ci, r_w=rw, p_w=pw)


def build_hierarchy(mesh: SEMMesh, rank_grid: Sequence[int], n_levels: int,
                    cluster: int = 2, pad_to: int = 8,
                    node2part: np.ndarray = None) -> MultiLevelGraphs:
    """The consistent multilevel hierarchy of an element partition.

    Level 0 is the block element partition; level 1 collapses each element
    to its centroid (``node2rank = elem2rank``: coarse nodes live with their
    fine children); deeper levels cluster the element grid by ``cluster``
    per axis, a block's primary rank being that of its first member, so a
    rank grid that does not align with the blocks splits a block's
    children across ranks (the case the halo-summed restriction is for).

    ``node2part`` overrides the block element decomposition: level 0 is
    then the vertex-cut edge partition of the mesh graph, and each element
    centroid lives on the majority rank of its GLL nodes.
    """
    if n_levels < 1:
        raise ValueError("n_levels must be >= 1")
    R = int(np.prod(rank_grid))
    fine_edges = undirected_to_directed(mesh_graph_edges(mesh))
    if node2part is None:
        e2r = partition_elements(mesh, rank_grid)
        graphs0 = from_element_partition(mesh, e2r, R)
    else:
        node2part = np.asarray(node2part, dtype=np.int64)
        graphs0 = from_edge_partition(mesh.n_nodes, fine_edges, R,
                                      node2part=node2part)
        # centroid rank = majority rank over the element's GLL nodes
        e2r = np.array([
            np.bincount(node2part[mesh.elem_nodes[el]], minlength=R).argmax()
            for el in range(mesh.n_elem)], dtype=np.int64)
    pg0 = pack(graphs0, mesh.n_nodes, pad_to=pad_to)

    levels = [pg0]
    coords = [mesh.coords]
    transfers: List[TransferPlan] = []

    prev_graphs = graphs0
    prev_coords = mesh.coords
    prev_primary = _primary_ranks(graphs0, mesh.n_nodes)
    prev_edges = fine_edges
    # element-grid position per level-(l-1) node, for block clustering
    prev_grid = None
    prev_grid_dims = None

    for level in range(1, n_levels):
        if level == 1:
            # element centroids: membership = the element-node incidence
            n_coarse = mesh.n_elem
            t_fine = mesh.elem_nodes.reshape(-1)
            t_coarse = np.repeat(np.arange(mesh.n_elem), mesh.nodes_per_elem)
            pairs = np.stack([t_fine, t_coarse], axis=-1)
            coarse_coords = np.stack([
                prev_coords[mesh.elem_nodes[e]].mean(axis=0)
                for e in range(mesh.n_elem)])
            node2rank = e2r.copy()
            grid = np.array([mesh.element_grid_index(e)
                             for e in range(mesh.n_elem)], dtype=np.int64)
            grid_dims = np.array(mesh.nelem_axes, dtype=np.int64)
        else:
            # cluster the element grid by `cluster` per axis
            block = prev_grid // cluster
            grid_dims = (prev_grid_dims + cluster - 1) // cluster
            strides = np.ones_like(grid_dims)
            for ax in range(1, len(grid_dims)):
                strides[ax] = strides[ax - 1] * grid_dims[ax - 1]
            flat = (block * strides[None, :]).sum(axis=1)
            n_coarse = int(np.prod(grid_dims))
            pairs = np.stack([np.arange(flat.size, dtype=np.int64), flat],
                             axis=-1)
            coarse_coords = np.zeros((n_coarse, prev_coords.shape[1]))
            counts = np.bincount(flat, minlength=n_coarse).astype(np.float64)
            for d in range(prev_coords.shape[1]):
                coarse_coords[:, d] = np.bincount(
                    flat, weights=prev_coords[:, d], minlength=n_coarse)
            coarse_coords /= np.maximum(counts, 1.0)[:, None]
            # a block lives with its first member's children
            first = np.full(n_coarse, flat.size, dtype=np.int64)
            np.minimum.at(first, flat, np.arange(flat.size))
            node2rank = prev_primary[first]
            grid = np.zeros((n_coarse, len(grid_dims)), dtype=np.int64)
            rem = np.arange(n_coarse)
            for ax in range(len(grid_dims)):
                grid[:, ax] = rem % grid_dims[ax]
                rem = rem // grid_dims[ax]

        if n_coarse < 1:
            raise ValueError(f"level {level} has no nodes")

        # a face GLL node appears once per touching element: each (f, c)
        # counts once in the transfer
        pairs = np.unique(pairs, axis=0)
        parents = _parents_table(pairs, len(prev_coords))
        coarse_edges = _project_edges(prev_edges, parents)

        # transfer edges are owned by the fine endpoint's primary rank,
        # which is given a coarse replica so both endpoints are rank-local
        owner = prev_primary[pairs[:, 0]]
        extra = [np.unique(pairs[owner == r, 1]) for r in range(R)]

        coarse_graphs = from_edge_partition(
            n_coarse, coarse_edges, R, node2part=node2rank, extra_nodes=extra)
        levels.append(pack(coarse_graphs, n_coarse, pad_to=pad_to))
        transfers.append(_pack_transfer(
            pairs, owner, prev_graphs, coarse_graphs, R, pad_to=pad_to,
            n_fine=len(prev_coords), n_coarse=n_coarse))
        coords.append(coarse_coords)

        prev_graphs = coarse_graphs
        prev_coords = coarse_coords
        prev_primary = node2rank.copy()
        prev_edges = coarse_edges
        prev_grid = grid
        prev_grid_dims = grid_dims

    return MultiLevelGraphs(levels=levels, coords=coords, transfers=transfers)
