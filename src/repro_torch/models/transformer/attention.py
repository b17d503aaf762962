"""Attention: blocked (flash) prefill/forward and one-device decode (port of
``repro.models.transformer.attention``).

``blocked_attention`` is the attention of every prefill, forward and
training step; the reference computes it with a nested ``lax.scan`` of
online-softmax tiles, whose TPU twin is the Pallas flash kernel, and
differentiates it under ``jax.checkpoint``.  The port runs it through that
kernel's CUDA counterpart (``kernels/flash_attention``): one launch per
layer, and under autograd one backward call (kernel 6b, which recomputes
the tiles from the saved row log-sum-exp).  Decode attends one new token per sequence over the KV cache in
plain PyTorch (the reference has no kernel there either).  The
sequence-sharded decode and its ``psum`` combine come with the multi-card
slice; on one device the combine reduces to dividing by ``l``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention


def blocked_attention(q, k, v, *, scale: float):
    """Causal attention, q [B, S, Hq, D], k, v [B, S, Hkv, D] ->
    [B, S, Hq, D] in q's dtype; differentiable (see the module docstring)."""
    return flash_attention(q, k, v, scale=scale, causal=True)


def _bmm_f32(a, b):
    """``a @ b`` for 3-d operands with an fp32 result accumulated in fp32.
    On the card bf16 operands go to cuBLAS as they are (``out_dtype``), so
    the cache is never copied to fp32; aten has ``out_dtype`` only on CUDA,
    so elsewhere the operands are upcast (a bf16 product is exact in fp32:
    the same result up to the order of the sums)."""
    if a.is_cuda and a.dtype == b.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _local_decode_scores(q, kc, vc, *, scale: float):
    """q [B, Hq, D]; kc, vc [B, n, Hkv, D], every position valid ->
    (unnormalised out [B, Hkv, G, D] fp32, sum of exps l [B, Hkv, G]).

    fp32 scores of the cache's values (the reference's
    ``preferred_element_type=float32``), p rounded to the cache's type for
    the PV product, as the reference rounds it.  One batched product per KV
    head reads that head's [B, n, D] slice of the cache through its
    strides."""
    B, n, Hkv, D = kc.shape
    qg = q.reshape(B, Hkv, q.shape[1] // Hkv, D)
    outs, sums = [], []
    for h in range(Hkv):
        s = _bmm_f32(qg[:, h], kc[:, :, h].transpose(1, 2)).mul_(scale)    # [B, G, n]
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        outs.append(_bmm_f32(p.to(vc.dtype), vc[:, :, h]))
        sums.append(p.sum(dim=-1))
    return torch.stack(outs, 1), torch.stack(sums, 1)


def decode_attention(q, k_cache, v_cache, k_new, v_new, cache_len: int, *, scale: float):
    """One new token per sequence: writes ``k_new``/``v_new`` [B, Hkv, D]
    at position ``cache_len`` of the caches [B, capacity, Hkv, D] in place
    (the reference donates its cache), then attends q [B, Hq, D] over the
    ``cache_len + 1`` filled positions.  Returns [B, Hq, D] in the cache's
    dtype."""
    k_cache[:, cache_len] = k_new
    v_cache[:, cache_len] = v_new
    n = cache_len + 1
    o, l = _local_decode_scores(q, k_cache[:, :n], v_cache[:, :n], scale=scale)
    out = o / l.clamp_min(1e-20)[..., None]
    return out.reshape(q.shape[0], q.shape[1], -1).to(v_cache.dtype)
