"""Plain PyTorch oracle for the dst-aligned edge-MLP + aggregation op (port
of ``repro.kernels.segment_agg.ref``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.graph.segment import segment_sum


def edge_mlp_agg_ref(feats, w1, b1, w2, b2, dst, weights, n_nodes: int):
    """feats [E, F_in] (pre-gathered [x_i ++ x_j ++ e_ij]); 2-layer ELU MLP;
    weighted (1/d_ij) segment sum to dst in the original edge order.  Edges
    with ``dst`` outside ``[0, n_nodes)`` add to no node, as
    ``jax.ops.segment_sum`` drops them.  The sum is the port's sorted,
    deterministic ``segment_sum`` (``index_add_`` is atomic on CUDA).

    Returns (e_new [E, H], agg [n_nodes, H])."""
    h = F.elu(feats @ w1 + b1)
    e_new = h @ w2 + b2
    dst = dst.long()
    keep = (dst >= 0) & (dst < n_nodes)
    agg = segment_sum((e_new * weights[:, None])[keep], dst[keep], n_nodes)
    return e_new, agg
