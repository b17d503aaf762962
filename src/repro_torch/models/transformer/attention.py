"""Attention: blocked (flash) prefill/forward, its context-parallel form, and
the sequence-sharded decode (port of ``repro.models.transformer.attention``).

``blocked_attention`` is the attention of every prefill, forward and
training step; the reference computes it with a nested ``lax.scan`` of
online-softmax tiles, whose TPU twin is the Pallas flash kernel, and
differentiates it under ``jax.checkpoint``.  The port runs it through that
kernel's CUDA counterpart (``kernels/flash_attention``): one launch per
layer, and under autograd one backward call (kernel 6b, which recomputes
the tiles from the saved row log-sum-exp).

Context parallelism (``attn_parallel="seq"`` over a ``model`` group of
processes, ``ctx.model > 1``): each process holds its own ``S / n`` query
rows; ``attention_seq_parallel`` all-gathers the shard's K and V over the
group (one tiled gather of both a layer, ``launch/mesh.py::Group.all_gather``)
and calls ``blocked_attention`` on its rows at ``q_offset = shard * S / n``
against all ``S`` keys: kernel 6 at ``Sq != Skv``.  A sliding ``window``
and a tanh ``softcap`` (Gemma-2) pass through to the kernel, which masks by
the rows' global positions.

Decode attends one new token per sequence over a KV cache whose sequence
is split over the group (``seq_shard_decode``): each process scores its
slice of the cache in plain PyTorch (the reference has no kernel there
either), with the layer's window and softcap, and the partial softmaxes
``(o, m, l)`` are merged by ``_combine_partials``.  The reference merges them with a ``pmax`` and two
``psum``s; the port gathers every shard's partials and merges them in shard
order on each process, so every process ends with bitwise the same output
(and so the same greedy token).  On one device the merge reduces to
dividing by ``l``.  ``ctx`` is a ``model.ParallelCtx`` (None: one device);
its ``host_s`` collects the host seconds spent in the gathers.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.transformer.layers import softcap as cap_scores

NEG = -1e30


def blocked_attention(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
                      softcap: float | None = None, q_offset: int = 0):
    """q [B, Sq, Hq, D], k, v [B, Skv, Hkv, D] -> [B, Sq, Hq, D] in q's
    dtype, query row ``r`` at position ``q_offset + r``; differentiable at
    ``Sq == Skv`` (see the module docstring)."""
    return flash_attention(q, k, v, scale=scale, causal=causal, window=window,
                           softcap=softcap, q_offset=q_offset)


def host_timed(ctx, key, fn):
    """``fn()``, its host seconds added to ``ctx.host_s[key]``."""
    t0 = time.perf_counter()
    out = fn()
    ctx.host_s[key] = ctx.host_s.get(key, 0.0) + time.perf_counter() - t0
    return out


def attention_seq_parallel(q, k, v, ctx, *, scale: float, window: int = 0,
                           softcap: float | None = None, return_kv: bool = False):
    """Context-parallel causal blocked attention: q, k, v [B, S_loc, H, D]
    are this shard's rows (positions ``shard * S_loc`` on); K and V are
    all-gathered over the model group, in shard order, and the shard's rows
    attend to all of them, within ``window`` of their global positions and
    under ``softcap`` -> [B, S_loc, Hq, D] (with ``return_kv`` also the gathered K and
    V, [B, n * S_loc, Hkv, D], from which the prefill fills its cache
    shard).  One tiled gather of K and V side by side; kernel 6 reads the
    two halves of the gathered buffer in place, as strided views."""
    Hkv = k.shape[2]
    kv = host_timed(ctx, "all_gather",
                    lambda: ctx.group.all_gather(torch.cat((k, v), dim=2), dim=1))
    k_all, v_all = kv[:, :, :Hkv], kv[:, :, Hkv:]
    out = blocked_attention(q, k_all, v_all, scale=scale, window=window, softcap=softcap,
                            q_offset=ctx.shard * q.shape[1])
    return (out, k_all, v_all) if return_kv else out


def _bmm_f32(a, b):
    """``a @ b`` for 3-d operands with an fp32 result accumulated in fp32.
    On the card bf16 operands go to cuBLAS as they are (``out_dtype``), so
    the cache is never copied to fp32.  On the CPU the operands are upcast
    (a bf16 product is exact in fp32: the same result up to the order of
    the sums) and multiplied elementwise, then summed over the contraction,
    without the CPU BLAS: on an H100 host's Xeon (MKL 2024.2 under torch
    2.11) its batched product returned some batch items about 5e-5 off in
    a few percent of fresh processes, on a process's first products, in
    fp32 and float64 alike (``tools/decode_fp32_check.py --first``), and
    this plain decode is what the card's is held to."""
    if a.is_cuda:
        if a.dtype == b.dtype != torch.float32:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())
    return (a.float()[:, :, None, :] * b.float().transpose(1, 2)[:, None]).sum(-1)


def _local_decode_scores(q, kc, vc, start: int, cache_len: int, *, scale: float,
                         window: int = 0, softcap: float | None = None):
    """q [B, Hq, D]; kc, vc [B, S_loc, Hkv, D], this shard's slice of the
    cache, at global positions ``kpos = start + j`` -> the shard's partial
    softmax (unnormalised out o [B, Hkv, G, D], row max m [B, Hkv, G],
    sum of exps l [B, Hkv, G], fp32).

    The reference's validity mask, ``kpos < cache_len`` and, with a
    ``window`` > 0, ``kpos >= cache_len - window`` (the query sits at
    ``cache_len - 1``), keeps one run of the shard's positions: only those
    are scored (a masked key's ``exp(-1e30 - m)`` adds exact zeros).  A
    shard with no valid position gives ``o = 0, m = -1e30, l = 0``, which
    the merge weighs by ``exp(-1e30 - m_max) = 0``, as the reference's
    masked shard.  fp32 scores of the cache's values (the reference's
    ``preferred_element_type=float32``), scaled, then capped by
    ``softcap`` (``cap * tanh(s / cap)``), p rounded to the cache's type
    for the PV product, as the reference rounds it.  One batched product
    per KV head reads that head's [B, n, D] slice of the cache through its
    strides."""
    B, S_loc, Hkv, D = kc.shape
    G = q.shape[1] // Hkv
    a = max(cache_len - window - start, 0) if window > 0 else 0
    b = min(cache_len - start, S_loc)
    if b <= a:
        zeros = torch.zeros(B, Hkv, G, dtype=torch.float32, device=q.device)
        return (torch.zeros(B, Hkv, G, vc.shape[-1], dtype=torch.float32, device=q.device),
                zeros.fill_(NEG), torch.zeros_like(zeros))
    qg = q.reshape(B, Hkv, G, D)
    outs, maxes, sums = [], [], []
    for h in range(Hkv):
        s = _bmm_f32(qg[:, h], kc[:, a:b, h].transpose(1, 2)).mul_(scale)    # [B, G, n]
        s = cap_scores(s, softcap)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        outs.append(_bmm_f32(p.to(vc.dtype), vc[:, a:b, h]))
        maxes.append(m[..., 0])
        sums.append(p.sum(dim=-1))
    return torch.stack(outs, 1), torch.stack(maxes, 1), torch.stack(sums, 1)


def _combine_partials(o, m, l, ctx):
    """Merge the model group's partial softmaxes: ``exp(m - max m)``-weighted
    sums of ``l`` and ``o`` over the shards -> o_tot / max(l_tot, 1e-20).
    The reference's ``pmax`` and ``psum``s; here one all-gather of the
    packed partials and the merge in shard order on every process, so the
    result is bitwise the same on each.  One device (``ctx`` None):
    ``o / max(l, 1e-20)``."""
    if ctx is None:
        return o / l.clamp_min(1e-20)[..., None]
    packed = torch.cat((o, m[..., None], l[..., None]), dim=-1)[None]
    parts = host_timed(ctx, "combine", lambda: ctx.group.all_gather(packed, dim=0))
    D = o.shape[-1]
    m_max = parts[..., D].amax(dim=0)
    o_tot = l_tot = None
    for part in parts:
        corr = torch.exp(part[..., D] - m_max)
        lw, ow = part[..., D + 1] * corr, part[..., :D] * corr[..., None]
        l_tot, o_tot = (lw, ow) if o_tot is None else (l_tot + lw, o_tot + ow)
    return o_tot / l_tot.clamp_min(1e-20)[..., None]


def decode_attention_sharded(q, k_cache, v_cache, k_new, v_new, cache_len: int, ctx, *,
                             scale: float, window: int = 0, softcap: float | None = None):
    """One new token per sequence over a sequence-sharded cache: this
    process's slice ``k_cache``, ``v_cache`` [B, S_loc, Hkv, D] holds
    positions ``[shard * S_loc, (shard + 1) * S_loc)``.  The shard that owns
    position ``cache_len`` writes ``k_new`` / ``v_new`` [B, Hkv, D] there in
    place (the reference donates its cache); every shard scores its slice
    over the ``cache_len + 1`` filled positions, the last ``window`` of
    them if ``window`` > 0, under ``softcap``, and the partials are merged
    over the group.  q [B, Hq, D] -> [B, Hq, D] in the cache's dtype."""
    S_loc = k_cache.shape[1]
    start = 0 if ctx is None else ctx.shard * S_loc
    if start <= cache_len < start + S_loc:
        k_cache[:, cache_len - start] = k_new
        v_cache[:, cache_len - start] = v_new
    o, m, l = _local_decode_scores(q, k_cache, v_cache, start, cache_len + 1, scale=scale,
                                   window=window, softcap=softcap)
    out = _combine_partials(o, m, l, ctx)
    return out.reshape(q.shape[0], q.shape[1], -1).to(v_cache.dtype)


def decode_attention(q, k_cache, v_cache, k_new, v_new, cache_len: int, *, scale: float,
                     window: int = 0, softcap: float | None = None):
    """:func:`decode_attention_sharded` on one device: the caches [B,
    capacity, Hkv, D] whole."""
    return decode_attention_sharded(q, k_cache, v_cache, k_new, v_new, cache_len, None,
                                    scale=scale, window=window, softcap=softcap)
