"""Segment ops for message passing (port of ``repro.graph.segment``).

Both are deterministic on every device, forward and backward:

* ``segment_sum`` stably sorts rows by segment id and reduces each segment
  in that order with ``torch.segment_reduce`` (one sequential sum per
  output element), so a repeated call gives bitwise the same result.
  ``index_add_`` would use float atomics on CUDA, whose order changes from
  run to run.
* ``gather``'s backward (the scatter-add of the row gradients) goes through
  ``segment_sum`` instead of ``index_select``'s own backward, which is an
  atomic ``index_add_`` on CUDA.  Training's bitwise repeatability rests on
  this.
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


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = x.shape[-2]
        return x.index_select(-2, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        gx = segment_sum(g.movedim(-2, 0), idx, ctx.n_rows)
        return gx.movedim(0, -2), None


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather along the node axis (dim -2), with the deterministic
    scatter-add backward."""
    return _Gather.apply(x, idx)
