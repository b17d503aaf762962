"""Consistent loss (Sec. II-C, Eq. 6), port of ``repro.core.consistent_loss``.

Squared errors are weighted by inverse node multiplicity 1/d_i (padding
rows carry weight 0) and normalised by N_eff = sum_i 1/d_i, which makes the
partitioned MSE equal the un-partitioned Eq. 5 value.  This single-process
slice has no cross-rank reduction: a stacked [R, ...] input is summed over
every rank directly.
"""
from __future__ import annotations

import torch


def consistent_mse(y: torch.Tensor, y_hat: torch.Tensor,
                   node_inv_mult: torch.Tensor) -> torch.Tensor:
    """Eq. 6 on [N_pad, Fy] or [B, N_pad, Fy] (batch mean). Returns a scalar."""
    fy = y.shape[-1]
    err2 = ((y - y_hat) ** 2).sum(dim=-1)             # [..., N_pad]
    s = (err2 * node_inv_mult).sum(dim=-1)            # Eq. 6b
    if s.dim():
        s = s.mean()
    return s / (node_inv_mult.sum() * fy)
