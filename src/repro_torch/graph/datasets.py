"""Synthetic recsys data (port of ``criteo_like`` from
``repro.graph.datasets``): numpy, array-equal to the reference for the
same seed."""
from __future__ import annotations

import numpy as np


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
