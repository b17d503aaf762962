"""Segment ops for message passing (port of ``repro.graph.segment``).

``segment_sum`` is deterministic on every device: rows are stably sorted by
segment id and each segment is reduced in that order by
``torch.segment_reduce`` (one sequential sum per output element), so a
repeated call gives bitwise the same result.  ``index_add_`` would use
float atomics on CUDA, whose order changes from run to run.
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum(data[i] for i with segment_ids[i] == s)``; ids must
    lie in ``[0, num_segments)``.  data: [E, ...] -> [num_segments, ...]."""
    ids = segment_ids.long()
    order = torch.sort(ids, stable=True).indices
    lengths = torch.bincount(ids, minlength=num_segments)
    return torch.segment_reduce(data.index_select(0, order), "sum",
                                lengths=lengths, axis=0)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather along the node axis (dim -2)."""
    return x.index_select(-2, idx)
