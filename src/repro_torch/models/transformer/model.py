"""Transformer LM: init, forward, the training loss, prefill and decode
(port of ``repro.models.transformer.model`` for the dense GQA/MQA decoder),
on one device or, for serving, over a ``model`` group of processes.
Gemma-2's pieces are the reference's too: each layer's own window
(``cfg.layer_windows``) and the score softcap in its attention, the
post-norms ``ln_attn_post`` / ``ln_mlp_post`` on the attention's and the
MLP's outputs, the embedding scaled by sqrt(d_model) (rounded to the
activations' dtype first) under ``gemma_norm``, and the final logits'
softcap.

Parameters keep the reference's tree and its stacked ``[L, ...]`` layer
leaves, so ``repro_torch.convert`` maps one to the other; ``lax.scan`` over
the layers becomes a Python loop over the layers.  ``forward`` and
``lm_loss`` also take a tree whose ``layers`` is a list of per-layer trees
(the train step's leaves: one autograd leaf per layer, so no layer's
gradient is built as a whole ``[L, ...]`` stack); a stacked tree is
unbound once per call, never sliced per layer.  ``cfg.remat == "full"``
recomputes each layer in the backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` of the scan body; the train step refuses
the reference's "dots" policy, ``steps.make_train_step``).  The KV cache is
preallocated at its capacity and written in place: by ``prefill_step`` for
the prompt and by ``decode_step`` at ``cache_len`` (the reference donates
it).

``prefill_step`` and ``decode_step`` take a :class:`ParallelCtx` (None: one
device).  Over a ``model`` group of n > 1 processes (``attn_parallel=
"seq"``, the reference's context parallelism) every process is given the
whole prompt and keeps its own ``S / n`` rows through each layer (norms,
QKV, RoPE at their global positions, attention through
``attention_seq_parallel``, MLP); it fills its own shard of the cache,
positions ``[shard * C / n, (shard + 1) * C / n)`` of capacity C, from the
K/V the attention gathered; the last position's hidden state comes from the
last shard, gathered to every process, which computes the logits from it.
Decode runs ``decode_attention_sharded`` over the cache shards.  Every
process of a group ends each step with bitwise the same logits.  ``forward``
and ``lm_loss`` run on one device.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.transformer.attention import (
    attention_seq_parallel, blocked_attention, decode_attention_sharded, host_timed)
from repro_torch.models.transformer.config import ITEM, TransformerConfig
from repro_torch.models.transformer.layers import (
    apply_rope, ffn, init_ffn, init_rmsnorm, init_stacked, rmsnorm, softcap)
from repro_torch.nn import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True, eq=False)
class ParallelCtx:
    """This process's place in the LM's mesh: ``mesh`` a
    ``launch/mesh.py::Mesh`` with ``graph == 1`` (data replicas serve their
    own sequences; the model group, the mesh's edge group, splits each
    sequence).  One device takes no context (``ctx=None``).  ``host_s``
    sums the host seconds of the model group's gathers by kind:
    "all_gather" (the prefill's K/V and last hidden state), "combine" (the
    decode's partial softmaxes)."""
    mesh: object
    host_s: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.mesh.graph != 1:
            raise ValueError(f"the LM's mesh has no graph axis; got graph={self.mesh.graph}")

    @property
    def model(self) -> int:
        return self.mesh.model

    @property
    def shard(self) -> int:
        return self.mesh.shard

    @property
    def group(self):
        return self.mesh.edge_group


def _sharded(cfg: TransformerConfig, ctx) -> bool:
    """Whether ``ctx`` splits the sequence (a model group of more than one
    process); only the "seq" layout runs there."""
    if ctx is None or ctx.model == 1:
        return False
    if cfg.attn_parallel != "seq":
        raise NotImplementedError(f"{cfg.name}: the {cfg.attn_parallel!r} layout at model "
                                  f"{ctx.model} > 1 is not ported ({ITEM})")
    return True


def init_transformer(gen: torch.Generator, cfg: TransformerConfig, device="cuda"):
    """Parameter tree drawn on ``device`` (the generator's), ``param_dtype``
    weights with the reference's scales, fp32 norm gains at 0 (the
    post-norms' too, under ``post_norms``)."""
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
        "ffn": init_ffn(gen, L, d, cfg.d_ff, dt, device, cfg.mlp_variant),
    }
    if cfg.post_norms:
        layers["ln_attn_post"] = init_rmsnorm((L, d), device)
        layers["ln_mlp_post"] = init_rmsnorm((L, d), device)
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


def _embed(params, tokens, cfg: TransformerConfig):
    # F.embedding: a gather whose backward on the card sums rows in a fixed
    # order (a repeated training step is bitwise the same)
    x = F.embedding(tokens, params["embed"])
    if cfg.gemma_norm:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _qkv_gqa(p, x, cfg: TransformerConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def attn_block(p, x, cfg: TransformerConfig, attention, ctx=None, start: int = 0,
               window: int = 0):
    """x [B, S, d], rows at positions ``start`` on, under this layer's
    ``window`` (0: global) and ``cfg.attn_softcap`` -> (attention output
    [B, S, d], k, v for the cache: [B, S, Hkv, D] of these rows under the
    "heads" layout; every shard's, [B, n * S, Hkv, D], under "seq" over a
    model group, where ``attention`` is not used).  ``attention(q, k, v,
    scale=, window=, softcap=)`` computes the attention on one device."""
    positions = torch.arange(start, start + x.shape[1], device=x.device)[None]
    q, k, v = _qkv_gqa(p, x, cfg, positions)
    scale = cfg.head_dim ** -0.5
    masks = dict(window=window, softcap=cfg.attn_softcap)
    if _sharded(cfg, ctx):
        out, k, v = attention_seq_parallel(q, k, v, ctx, scale=scale, return_kv=True, **masks)
    else:
        out = attention(q, k, v, scale=scale, **masks)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k, v


def _post_norm(p_l, name, x, cfg: TransformerConfig):
    return rmsnorm(p_l[name], x, cfg.norm_eps) if cfg.post_norms else x


def layer_fn(p_l, x, cfg: TransformerConfig, attention, ctx=None, start: int = 0,
             window: int = 0):
    """One pre-norm block (and post-norm, under ``post_norms``) -> (x', k,
    v) (:func:`attn_block`)."""
    h = rmsnorm(p_l["ln_attn_pre"], x, cfg.norm_eps)
    a, k, v = attn_block(p_l["attn"], h, cfg, attention, ctx, start, window)
    x = x + _post_norm(p_l, "ln_attn_post", a, cfg)
    h = rmsnorm(p_l["ln_mlp_pre"], x, cfg.norm_eps)
    return x + _post_norm(p_l, "ln_mlp_post", ffn(p_l["ffn"], h, cfg.mlp_variant), cfg), k, v


def _logits(params, x, cfg: TransformerConfig):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return softcap(x @ params["embed"].T, cfg.final_softcap)      # tied embeddings


def _remat(fn, cfg: TransformerConfig):
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return lambda x, p_l: checkpoint(fn, x, p_l, use_reentrant=False)


def forward(params, tokens, cfg: TransformerConfig, attention=blocked_attention):
    """tokens [B, S] -> logits [B, S, V].  ``attention(q, k, v, scale=)`` is
    the flash kernel's path unless the caller gives another (a check at
    full width runs the plain attention through it; see :func:`attn_block`
    for a window and a softcap)."""
    x = _embed(params, tokens, cfg)
    for p_l, w in zip(layer_list(params)[:cfg.n_layers], cfg.layer_windows):
        body = _remat(lambda x, p_l, w=w: layer_fn(p_l, x, cfg, attention, window=w)[0], cfg)
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


def _split(n: int, what: str, size: int) -> int:
    if size % n:
        raise ValueError(f"{what} {size} does not split over the {n} shards of the "
                         "model group")
    return size // n


def prefill_step(params, tokens, cfg: TransformerConfig, capacity: int, ctx=None):
    """tokens [B, S] -> (last-position logits [B, V], cache of ``capacity``
    holding the prompt's K/V at positions [0, S)); over a model group (module
    docstring) the cache is this process's shard, [L, B, capacity / n, Hkv,
    D], and S and the capacity must split evenly."""
    B, S = tokens.shape
    n = ctx.model if _sharded(cfg, ctx) else 1
    S_loc, cap_loc = _split(n, "prompt length", S), _split(n, "capacity", capacity)
    start, c0 = (ctx.shard * S_loc, ctx.shard * cap_loc) if n > 1 else (0, 0)
    cache = init_cache(cfg, B, cap_loc, tokens.device)
    filled = min(cap_loc, S - c0)           # this shard's cached prompt positions
    x = _embed(params, tokens[:, start:start + S_loc], cfg)
    for i, (p_l, w) in enumerate(zip(layer_list(params)[:cfg.n_layers], cfg.layer_windows)):
        x, k, v = layer_fn(p_l, x, cfg, blocked_attention, ctx, start, w)
        if filled > 0:
            cache["k"][i, :, :filled] = k[:, c0:c0 + filled]
            cache["v"][i, :, :filled] = v[:, c0:c0 + filled]
    x = x[:, -1:]
    if n > 1:                                               # the last shard's row
        x = host_timed(ctx, "all_gather", lambda: ctx.group.all_gather(x, dim=1))[:, -1:]
    return _logits(params, x, cfg)[:, 0], cache


def _decode_layer(p_l, x, cache_l, cache_len: int, cfg: TransformerConfig, ctx,
                  window: int = 0):
    """x [B, 1, d]; cache_l = (k, v) [B, capacity / n, Hkv, D] of this
    layer (this process's shard), written in place at ``cache_len`` by the
    shard that holds it; the layer's ``window`` (0: global)."""
    h = rmsnorm(p_l["ln_attn_pre"], x, cfg.norm_eps)
    positions = torch.full((x.shape[0], 1), cache_len, device=x.device)
    q, k, v = _qkv_gqa(p_l["attn"], h, cfg, positions)
    k_cache, v_cache = cache_l
    out = decode_attention_sharded(q[:, 0], k_cache, v_cache, k[:, 0].to(k_cache.dtype),
                                   v[:, 0].to(v_cache.dtype), cache_len, ctx,
                                   scale=cfg.head_dim ** -0.5, window=window,
                                   softcap=cfg.attn_softcap)
    a = torch.einsum("bhk,hkd->bd", out, p_l["attn"]["wo"])[:, None]
    x = x + _post_norm(p_l, "ln_attn_post", a, cfg)
    h = rmsnorm(p_l["ln_mlp_pre"], x, cfg.norm_eps)
    return x + _post_norm(p_l, "ln_mlp_post", ffn(p_l["ffn"], h, cfg.mlp_variant), cfg)


def decode_step(params, cache, tokens, cache_len: int, cfg: TransformerConfig, ctx=None):
    """One token per sequence: tokens [B, 1], ``cache_len`` tokens already
    cached -> (logits [B, 1, V], the cache, updated in place); over a model
    group ``cache`` is this process's shard (:func:`prefill_step`)."""
    ctx = ctx if _sharded(cfg, ctx) else None
    n = 1 if ctx is None else ctx.model
    if not 0 <= cache_len < n * cache["k"].shape[2]:
        raise ValueError(f"cache_len {cache_len} outside the cache's capacity "
                         f"{n * cache['k'].shape[2]}")
    x = _embed(params, tokens, cfg)
    for i, (p_l, w) in enumerate(zip(layer_list(params)[:cfg.n_layers], cfg.layer_windows)):
        x = _decode_layer(p_l, x, (cache["k"][i], cache["v"][i]), cache_len, cfg, ctx, w)
    return _logits(params, x, cfg), cache
