"""Synthetic datasets (port of ``cora_like`` and ``criteo_like`` from
``repro.graph.datasets``): numpy, array-equal to the reference for the
same seed and sizes."""
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
