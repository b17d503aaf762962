"""Fanout neighbor sampling (GraphSAGE-style) for the minibatch_lg cells
(port of ``repro.graph.sampler``; numpy, array-equal to the reference for
the same ``np.random.Generator`` state; the CSR's stable sort is a radix
sort, the same permutation in linear time).

Host-side CSR sampler producing fixed-size padded blocks: for seeds S and
fanouts [f1, f2, ...], hop h uniformly samples up to f_h in-neighbors of
the frontier.  The returned block is a *local* graph with edges
(src_local -> dst_local) oriented toward the seeds, padded to static
shapes (the data pipeline of sampled training: each data-parallel process
consumes its own stream of blocks).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray    # [N+1]
    indices: np.ndarray   # [E] in-neighbors
    n_nodes: int

    @staticmethod
    def from_edges(n_nodes: int, edges: np.ndarray) -> "CSRGraph":
        """edges [E,2] directed (src, dst): CSR over *incoming* edges per dst."""
        order = _stable_order(edges[:, 1], n_nodes)
        counts = np.bincount(edges[:, 1], minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return CSRGraph(indptr=indptr.astype(np.int64),
                        indices=edges[order, 0].astype(np.int64),
                        n_nodes=n_nodes)


def _stable_order(keys: np.ndarray, n: int) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for keys in ``[0, n)``, as a
    least-significant-digit radix sort over 16-bit digits: numpy sorts a
    16-bit array stably in linear time, and a stable sort is unique, so
    the permutation is the reference's (its argsort of 114.6 M ids, the
    minibatch_lg graph, is a timsort of ~40 s)."""
    order = None
    for shift in range(0, max(int(n - 1).bit_length(), 1), 16):
        digits = ((keys if order is None else keys[order]) >> shift) & 0xFFFF
        step = np.argsort(digits.astype(np.uint16), kind="stable")
        order = step if order is None else order[step]
    return order


@dataclasses.dataclass
class SampledBlock:
    """Fixed-shape sampled subgraph (padded)."""
    node_ids: np.ndarray      # [N_pad] global ids (-1 pad)
    node_mask: np.ndarray     # [N_pad] float
    edge_src: np.ndarray      # [E_pad] local idx
    edge_dst: np.ndarray      # [E_pad]
    edge_mask: np.ndarray     # [E_pad]
    seed_mask: np.ndarray     # [N_pad] 1.0 on seed rows (loss rows)

    @staticmethod
    def pad_sizes(n_seeds: int, fanouts: Sequence[int]):
        n = n_seeds
        total_n = n_seeds
        total_e = 0
        for f in fanouts:
            e = n * f
            total_e += e
            n = e
            total_n += n
        return total_n, total_e


def sample_block(g: CSRGraph, seeds: np.ndarray, fanouts: Sequence[int],
                 rng: np.random.Generator) -> SampledBlock:
    n_pad, e_pad = SampledBlock.pad_sizes(len(seeds), fanouts)
    nodes: List[int] = list(seeds)
    local = {int(s): i for i, s in enumerate(seeds)}
    esrc, edst = [], []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            k = min(f, deg)
            picks = g.indices[lo + rng.choice(deg, size=k, replace=False)]
            for u in picks:
                u = int(u)
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                esrc.append(local[u])
                edst.append(local[int(v)])
                nxt.append(u)
        frontier = nxt
    node_ids = np.full(n_pad, -1, np.int64)
    node_ids[:len(nodes)] = nodes
    nm = np.zeros(n_pad, np.float32)
    nm[:len(nodes)] = 1
    es = np.zeros(e_pad, np.int32)
    ed = np.zeros(e_pad, np.int32)
    em = np.zeros(e_pad, np.float32)
    es[:len(esrc)] = esrc
    ed[:len(edst)] = edst
    em[:len(esrc)] = 1
    sm = np.zeros(n_pad, np.float32)
    sm[:len(seeds)] = 1
    return SampledBlock(node_ids, nm, es, ed, em, sm)


def block_meta(block: SampledBlock) -> dict:
    """meta dict compatible with the message-passing layers (no halo)."""
    return dict(
        node_mask=block.node_mask,
        node_inv_mult=block.seed_mask,       # loss over seeds only
        edge_src=block.edge_src, edge_dst=block.edge_dst,
        edge_mask=block.edge_mask,
        edge_inv_mult=block.edge_mask,       # d_ij = 1
    )
