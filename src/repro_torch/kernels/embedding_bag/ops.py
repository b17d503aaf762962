"""Embedding bag: the CUDA kernel's wrapper (port of
``repro.kernels.embedding_bag.ops``).

``embedding_bag(table, idx)`` -> ``out[b] = sum_h table[idx[b, h]]``, fp32
accumulation, output in ``table.dtype`` (fp32 or bf16).  On a CUDA tensor
it launches ``csrc/embedding_bag.cu`` (or raises); on a CPU tensor it runs
:func:`embedding_bag_plain`, to which the kernel is bitwise equal.

Differentiable in ``table``.  The gradient is the table gradient of the
reference's autodiff through ``take`` + ``segment_sum``: the bag gradients,
repeated H times, summed into ``[V, D]`` by the sorted, deterministic
``graph.segment.segment_sum``.  The reference has no backward kernel for
the embedding bag, so neither does the port; ``index_add_``,
``index_select``'s own backward and ``F.embedding_bag``'s backward are not
used because all of them sum with atomics on CUDA.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.graph.segment import segment_sum
from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag.ref import embedding_bag_plain

KERNEL = "embedding_bag"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# table, idx, out, n_bags, bag_len, D, V, stream: V * D passes 2^31 at RM2
_SIG = (_P, _P, _P, _I64, _I64, _I64, _I64, _P)
_SIGNATURES = {"embedding_bag_f32": _SIG, "embedding_bag_bf16": _SIG}
_ENTRY = {torch.float32: "embedding_bag_f32", torch.bfloat16: "embedding_bag_bf16"}

__all__ = ["KERNEL", "embedding_bag", "embedding_bag_plain"]


def _forward(table, idx):
    if table.device.type == "cpu":
        return embedding_bag_plain(table, idx)
    entry = _ENTRY.get(table.dtype)
    if entry is None:
        raise TypeError(f"{KERNEL}: table dtype {table.dtype} is not float32 "
                        "or bfloat16")
    build.require_cuda(KERNEL, table, idx, dtypes=(table.dtype, torch.int32))
    (V, D), (B, H) = table.shape, idx.shape
    out = torch.empty(B, D, dtype=table.dtype, device=table.device)
    lib = build.load(KERNEL, _SIGNATURES)
    code = getattr(lib, entry)(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                               B, H, D, V, build.stream_of(table))
    build.check(lib, code, entry)
    build.count_launch(KERNEL)
    return out


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return _forward(table, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        rows = g.repeat_interleave(idx.shape[1], dim=0)
        return segment_sum(rows, idx.reshape(-1), ctx.n_rows), None


def embedding_bag(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sum-pooled bags: table [V, D] float32/bfloat16; idx [B, H] int32 row
    ids in [0, V) -> [B, D] in ``table.dtype``."""
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"{KERNEL}: expected table [V, D] and idx [B, H]; got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    if table.device.type not in ("cpu", "cuda") or idx.device != table.device:
        raise ValueError(f"{KERNEL}: table on {table.device}, idx on {idx.device}")
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingBag.apply(table, idx)
    return _forward(table, idx)
