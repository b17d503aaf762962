"""Transformer LM on one device: init, forward, the training loss, prefill
and decode (port of ``repro.models.transformer.model`` for the dense
GQA/MQA decoder).

Parameters keep the reference's tree and its stacked ``[L, ...]`` layer
leaves, so ``repro_torch.convert`` maps one to the other; ``lax.scan`` over
the layers becomes a Python loop over the layers.  ``forward`` and
``lm_loss`` also take a tree whose ``layers`` is a list of per-layer trees
(the train step's leaves: one autograd leaf per layer, so no layer's
gradient is built as a whole ``[L, ...]`` stack); a stacked tree is
unbound once per call, never sliced per layer.  ``cfg.remat == "full"``
recomputes each layer in the backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` of the scan body).  The functions take no
``ParallelCtx``: one device, no mesh.  The KV cache is preallocated at its
capacity and written in place: by ``prefill_step`` for the prompt and by
``decode_step`` at ``cache_len`` (the reference donates it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.transformer.attention import blocked_attention, decode_attention
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.layers import (
    apply_rope, ffn, init_ffn, init_rmsnorm, init_stacked, rmsnorm)
from repro_torch.nn import tree_leaves, tree_unflatten


def init_transformer(gen: torch.Generator, cfg: TransformerConfig, device="cuda"):
    """Parameter tree drawn on ``device`` (the generator's), ``param_dtype``
    weights with the reference's scales, fp32 norm gains at 0."""
    L, d, hq, hkv, hd = cfg.n_layers, cfg.d_model, cfg.n_q, cfg.n_kv, cfg.head_dim
    dt = cfg.param_dtype
    s = d ** -0.5
    layers = {
        "attn": {
            "wq": init_stacked(gen, (L, d, hq, hd), s, dt, device),
            "wk": init_stacked(gen, (L, d, hkv, hd), s, dt, device),
            "wv": init_stacked(gen, (L, d, hkv, hd), s, dt, device),
            "wo": init_stacked(gen, (L, hq, hd, d), (hq * hd) ** -0.5, dt, device),
        },
        "ln_attn_pre": init_rmsnorm((L, d), device),
        "ln_mlp_pre": init_rmsnorm((L, d), device),
        "ffn": init_ffn(gen, L, d, cfg.d_ff, dt, device),
    }
    embed = torch.empty(cfg.vocab, d, dtype=dt, device=device)
    embed.normal_(generator=gen).mul_(s)
    return {"embed": embed, "layers": layers, "final_norm": init_rmsnorm((d,), device)}


def layer_list(params) -> list:
    """The per-layer trees of ``params["layers"]``: the list itself, or each
    stacked leaf unbound once (a slice ``t[i]`` per layer would make each
    slice's backward build a whole ``[L, ...]`` gradient)."""
    layers = params["layers"]
    if isinstance(layers, list):
        return layers
    parts = [t.unbind(0) for t in tree_leaves(layers)]
    return [tree_unflatten(layers, [u[i] for u in parts]) for i in range(len(parts[0]))]


def _embed(params, tokens):
    # F.embedding: a gather whose backward on the card sums rows in a fixed
    # order (a repeated training step is bitwise the same)
    return F.embedding(tokens, params["embed"])


def _qkv_gqa(p, x, cfg: TransformerConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def attn_block(p, x, cfg: TransformerConfig, attention):
    """-> (attention output [B, S, d], k, v [B, S, Hkv, D] for the cache)."""
    positions = torch.arange(x.shape[1], device=x.device)[None]
    q, k, v = _qkv_gqa(p, x, cfg, positions)
    out = attention(q, k, v, scale=cfg.head_dim ** -0.5)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k, v


def layer_fn(p_l, x, cfg: TransformerConfig, attention):
    """One pre-norm block -> (x', k, v)."""
    h = rmsnorm(p_l["ln_attn_pre"], x, cfg.norm_eps)
    a, k, v = attn_block(p_l["attn"], h, cfg, attention)
    x = x + a
    h = rmsnorm(p_l["ln_mlp_pre"], x, cfg.norm_eps)
    return x + ffn(p_l["ffn"], h), k, v


def _logits(params, x, cfg: TransformerConfig):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x @ params["embed"].T                    # tied embeddings


def _remat(fn, cfg: TransformerConfig):
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return lambda x, p_l: checkpoint(fn, x, p_l, use_reentrant=False)


def forward(params, tokens, cfg: TransformerConfig, attention=blocked_attention):
    """tokens [B, S] -> logits [B, S, V].  ``attention(q, k, v, scale=)`` is
    the flash kernel's path unless the caller gives another (a check at
    full width runs the plain attention through it)."""
    body = _remat(lambda x, p_l: layer_fn(p_l, x, cfg, attention)[0], cfg)
    x = _embed(params, tokens)
    for p_l in layer_list(params)[:cfg.n_layers]:
        x = body(x, p_l)
    return _logits(params, x, cfg)


def lm_loss(params, tokens, targets, cfg: TransformerConfig, z_coef: float = 1e-4,
            attention=blocked_attention):
    """Next-token cross entropy on fp32 logits plus ``z_coef * mean(z^2)``
    (z the logsumexp) -> (loss, {"ce", "z"}), as the reference's
    ``lm_loss`` (no MoE term: the dense decoder has none)."""
    logits = forward(params, tokens, cfg, attention).float()
    z = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets[..., None])[..., 0]
    ce = (z - ll).mean()
    zloss = z_coef * z.square().mean()
    return ce + zloss, {"ce": ce, "z": zloss}


def init_cache(cfg: TransformerConfig, batch: int, capacity: int, device="cuda"):
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cache_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cache_dtype, device=device)}


def prefill_step(params, tokens, cfg: TransformerConfig, capacity: int):
    """tokens [B, S] -> (last-position logits [B, V], cache of ``capacity``
    holding the prompt's K/V at positions [0, S))."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, capacity, tokens.device)
    x = _embed(params, tokens)
    for i, p_l in enumerate(layer_list(params)[:cfg.n_layers]):
        x, k, v = layer_fn(p_l, x, cfg, blocked_attention)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return _logits(params, x[:, -1:], cfg)[:, 0], cache


def _decode_layer(p_l, x, cache_l, cache_len: int, cfg: TransformerConfig):
    """x [B, 1, d]; cache_l = (k, v) [B, capacity, Hkv, D] of this layer,
    written in place at ``cache_len``."""
    h = rmsnorm(p_l["ln_attn_pre"], x, cfg.norm_eps)
    positions = torch.full((x.shape[0], 1), cache_len, device=x.device)
    q, k, v = _qkv_gqa(p_l["attn"], h, cfg, positions)
    k_cache, v_cache = cache_l
    out = decode_attention(q[:, 0], k_cache, v_cache, k[:, 0].to(k_cache.dtype),
                           v[:, 0].to(v_cache.dtype), cache_len,
                           scale=cfg.head_dim ** -0.5)
    x = x + torch.einsum("bhk,hkd->bd", out, p_l["attn"]["wo"])[:, None]
    h = rmsnorm(p_l["ln_mlp_pre"], x, cfg.norm_eps)
    return x + ffn(p_l["ffn"], h)


def decode_step(params, cache, tokens, cache_len: int, cfg: TransformerConfig):
    """One token per sequence: tokens [B, 1], ``cache_len`` tokens already
    cached -> (logits [B, 1, V], the cache, updated in place)."""
    x = _embed(params, tokens)
    for i, p_l in enumerate(layer_list(params)[:cfg.n_layers]):
        x = _decode_layer(p_l, x, (cache["k"][i], cache["v"][i]), cache_len, cfg)
    return _logits(params, x, cfg), cache
