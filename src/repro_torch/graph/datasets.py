"""Synthetic datasets (port of ``repro.graph.datasets``; no downloads):
Cora's dimensions (``cora_like``), ogbn-products / Reddit-like power-law
graphs for sampled training (``powerlaw_graph``), random molecular
configurations with radius-graph edges (``molecules``, batched
block-diagonally by ``batch_molecules``) and Criteo-like click streams
(``criteo_like``).  numpy, array-equal to the reference for the same seed
and sizes."""
from __future__ import annotations

import numpy as np


def cora_like(seed: int = 0, n: int = 2708, m_und: int = 5278, d: int = 1433,
              n_classes: int = 7):
    """Random graph with Cora's exact dimensions. Returns (edges[E,2] directed,
    features [n,d], labels [n])."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m_und)
    dst = rng.integers(0, n, m_und)
    keep = src != dst
    und = np.stack([src[keep], dst[keep]], -1)
    edges = np.concatenate([und, und[:, ::-1]], axis=0)
    feats = (rng.random((n, d)) < 0.012).astype(np.float32)  # sparse bag-of-words
    labels = rng.integers(0, n_classes, n)
    return edges, feats, labels.astype(np.int32)


def powerlaw_graph(n: int, avg_deg: int, seed: int = 0) -> np.ndarray:
    """Directed edges [E,2] with power-law-ish in-degrees (preferential-style)."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    # Zipf-weighted destination choice via inverse-CDF on sorted weights
    w = 1.0 / np.arange(1, n + 1) ** 0.8
    w /= w.sum()
    dst = rng.choice(n, size=m, p=w)
    src = rng.integers(0, n, m)
    keep = src != dst
    return np.stack([src[keep], dst[keep]], axis=-1).astype(np.int64)


def molecules(batch: int, n_atoms: int = 30, n_species: int = 8,
              cutoff: float = 3.0, seed: int = 0):
    """Random 3D configurations + radius-graph edges per molecule.

    Returns (species [B,n], pos [B,n,3], edges list of [E_i,2])."""
    rng = np.random.default_rng(seed)
    species = rng.integers(0, n_species, (batch, n_atoms)).astype(np.int32)
    pos = rng.normal(scale=2.0, size=(batch, n_atoms, 3)).astype(np.float32)
    edge_lists = []
    for b in range(batch):
        d = np.linalg.norm(pos[b][:, None] - pos[b][None], axis=-1)
        src, dst = np.nonzero((d < cutoff) & (d > 1e-6))
        edge_lists.append(np.stack([src, dst], -1).astype(np.int64))
    return species, pos, edge_lists


def batch_molecules(species, pos, edge_lists, e_pad_per: int = 64):
    """Block-diagonal batch of small graphs with static padding."""
    B, n = species.shape
    n_total = B * n
    e_pad = B * e_pad_per
    esrc = np.zeros(e_pad, np.int32)
    edst = np.zeros(e_pad, np.int32)
    emask = np.zeros(e_pad, np.float32)
    off = 0
    for b, el in enumerate(edge_lists):
        k = min(len(el), e_pad_per)
        esrc[off:off + k] = el[:k, 0] + b * n
        edst[off:off + k] = el[:k, 1] + b * n
        emask[off:off + k] = 1
        off += e_pad_per
    meta = dict(
        node_mask=np.ones(n_total, np.float32),
        node_inv_mult=np.ones(n_total, np.float32),
        edge_src=esrc, edge_dst=edst, edge_mask=emask, edge_inv_mult=emask,
    )
    return species.reshape(-1), pos.reshape(-1, 3), meta


def criteo_like(batch: int, cfg, seed: int = 0):
    """(dense [B,13], sparse_idx [B,F,H] with field offsets applied, labels)."""
    rng = np.random.default_rng(seed)
    dense = rng.lognormal(0, 1, (batch, cfg.n_dense)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(cfg.vocab_sizes)[:-1]])
    idx = np.stack([
        offs[f] + rng.integers(0, cfg.vocab_sizes[f], (batch, cfg.multi_hot))
        for f in range(cfg.n_sparse)
    ], axis=1).astype(np.int32)
    labels = rng.integers(0, 2, (batch, 1)).astype(np.float32)
    return dense, idx, labels
