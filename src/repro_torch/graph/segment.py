"""Segment ops for message passing (port of ``repro.graph.segment``).

Both are deterministic on every device, forward and backward:

* ``segment_sum`` stably sorts rows by segment id and reduces each segment
  in that order with ``torch.segment_reduce`` (one sequential sum per
  output element), so a repeated call gives bitwise the same result.
  ``index_add_`` would use float atomics on CUDA, whose order changes from
  run to run.  ``segment_max`` reduces the same sorted rows by ``"max"``
  (an empty segment gives ``-inf``, as ``jax.ops.segment_max``);
  ``segment_mean`` and ``segment_softmax`` are built from the two, as the
  reference builds them.
* ``gather``'s (and ``gather_rows``') backward (the scatter-add of the row gradients) goes through
  ``segment_sum`` instead of ``index_select``'s own backward, which is an
  atomic ``index_add_`` on CUDA.  Training's bitwise repeatability rests on
  this.
* ``sorted_segment_sum`` is a weighted gather and segment sum over ids
  sorted once ahead of time (a static map: the multilevel transfers),
  differentiable in the gathered rows through the transposed map, also
  sorted ahead of time; bitwise ``segment_sum(gather(x, src) * w, dst)``,
  without the sort on every call.
"""
from __future__ import annotations

import torch

#: the masked-logit fill of the reference's ``segment_softmax``
NEG_INF = -1e30


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum(data[i] for i with segment_ids[i] == s)``; ids must
    lie in ``[0, num_segments)``.  data: [E, ...] -> [num_segments, ...]."""
    return _sorted_reduce(data, segment_ids, num_segments, "sum")


def _sorted_reduce(data, segment_ids, num_segments, reduce):
    ids = segment_ids.long()
    order = torch.sort(ids, stable=True).indices
    lengths = torch.bincount(ids, minlength=num_segments)
    return torch.segment_reduce(data.index_select(0, order), reduce,
                                lengths=lengths, axis=0)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = max(data[i] for i with segment_ids[i] == s)``, ``-inf``
    for an empty segment.  data: [E, ...] -> [num_segments, ...]."""
    return _sorted_reduce(data, segment_ids, num_segments, "max")


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 eps: float = 1e-9) -> torch.Tensor:
    """The segment sum over the segment's row count (at least ``eps``)."""
    s = segment_sum(data, segment_ids, num_segments)
    c = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype, device=data.device),
                    segment_ids, num_segments)
    return s / torch.clamp(c, min=eps).reshape((-1,) + (1,) * (data.dim() - 1))


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Numerically stable softmax over segments (e.g. GAT's edge softmax).

    ``logits``: [E, ...]; ``mask``: [E] 1/0, masked entries get weight 0.
    The shift (each segment's max) is detached: the softmax does not change
    when a segment's logits all move by one amount, so its derivative in
    the shift is 0."""
    bcast = (-1,) + (1,) * (logits.dim() - 1)
    if mask is not None:
        logits = torch.where(mask.reshape(bcast) > 0, logits, NEG_INF)
    seg_max = segment_max(logits.detach(), segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    expv = torch.exp(logits - gather_rows(seg_max, segment_ids))
    if mask is not None:
        expv = expv * mask.reshape(bcast)
    denom = segment_sum(expv, segment_ids, num_segments)
    return expv / torch.clamp(gather_rows(denom, segment_ids), min=1e-20)


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


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 for any trailing shape, with :func:`gather`'s
    deterministic backward."""
    return gather(x.reshape(x.shape[0], -1), idx).reshape((-1,) + x.shape[1:])


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _sorted_sum(x, *fwd)

    @staticmethod
    def backward(ctx, g):
        return _sorted_sum(g.contiguous(), *ctx.bwd), None, None


def _sorted_sum(x, idx, w, lengths):
    return torch.segment_reduce(x.index_select(0, idx) * w[:, None], "sum",
                                lengths=lengths, axis=0)


def sorted_segment_sum(x: torch.Tensor, fwd, bwd) -> torch.Tensor:
    """``out[s] = sum_i w[i] * x[src[i]]`` over the slots i of segment s,
    in the order of a stable sort by segment, from the map sorted ahead of
    time: ``fwd = (src sorted by segment, w sorted alike, slots per
    segment)``; ``bwd`` is the transposed map in the same form (the
    segment of each slot sorted by ``src``, its weight, slots per row of
    ``x``), whose sum is the gradient in ``x``.  x: [N, F] -> [S, F]."""
    return _SortedSegmentSum.apply(x, tuple(fwd), tuple(bwd))
