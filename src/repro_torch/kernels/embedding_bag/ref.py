"""Plain PyTorch version of the embedding-bag kernel (port of
``repro.kernels.embedding_bag.ref``)."""
from __future__ import annotations

import torch


def embedding_bag_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [V, D]; idx [B, H] int -> sum-pooled bags [B, D] in
    ``table.dtype``.

    Sums the rows h = 0..H-1 in order, in fp32 from zero, and casts once at
    the end: the order in which the TPU kernel carries its VMEM accumulator
    over its sequential h grid axis, and the order of ``csrc/embedding_bag.cu``,
    which is bitwise equal to this function."""
    B, H = idx.shape
    rows = table.index_select(0, idx.reshape(-1)).reshape(B, H, table.shape[1])
    acc = torch.zeros(B, table.shape[1], dtype=torch.float32, device=table.device)
    for h in range(H):
        acc = acc + rows[:, h].float()
    return acc.to(table.dtype)
