"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B]: 28L d3072, GQA 24 query heads
over 8 KV heads of dim 128, SwiGLU 8192, vocab 128,256, RoPE theta 500,000,
tied embeddings (port of ``repro.configs.llama3_2_3b``).

The reference serves it context-parallel (``attn_parallel="seq"``: 24
heads do not divide a 16-way ``model`` axis) and trains it under the
"dots" remat policy; the port serves it on one device or over a ``model``
group of processes (``model.ParallelCtx``), and its train step refuses
"dots" (ROADMAP queue 1 item 2).

``build_cell(shape_id)`` is the counterpart of the reference's
``launch/dryrun.py::build_lm_cell`` for the two serving cells: it returns
``(step, args, meta)`` with weights drawn on ``device`` from ``seed``, so
``step(*args)`` runs the cell.  Weights are 3.21 B parameters, 6.43 GB in
bf16; a sequence's KV cache at 32,768 positions is 3.76 GB (28 layers x K
and V x 32,768 x 8 heads x 128 x 2 B).  Cut to one H100 (80 GB), each cut
only where memory forces it, all 28 layers kept:

- prefill_32k: batch 32 -> 8 (a 30.1 GB cache and the prompt's
  activations; 32 sequences' cache alone would be 120 GB).
- decode_32k: batch 128 -> 16 (a 60.1 GB cache filled to 32,767
  positions; 128 sequences' would be 481 GB).

``batch`` cuts the batch further (``meta["reduced"]`` records it): processes
of a model group that share one card hold a sequence each.  Over a model
group (``ctx``) every process draws the same weights and tokens, and the
decode cell's cache is the process's shard of the one-device cell's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.model import init_cache, init_transformer
from repro_torch.models.transformer.steps import make_decode_step, make_prefill_step

ARCH_ID = "llama3.2-3b"
N_LAYERS_ONE_CARD = {"prefill_32k": 28, "decode_32k": 28}
BATCH_ONE_CARD = {"prefill_32k": 8, "decode_32k": 16}


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        vocab=128256, d_model=3072, n_layers=28,
        n_q=24, n_kv=8, head_dim=128,
        d_ff=8192, mlp_variant="swiglu",
        rope_theta=500000.0,
        tied_embeddings=True,
        train_microbatches=4,
        attn_parallel="seq",                      # 24 heads don't divide 16
        remat="dots")


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        vocab=256, d_model=32, n_layers=2,
        n_q=4, n_kv=2, head_dim=16,
        d_ff=64, mlp_variant="swiglu",
        tied_embeddings=True,
        attn_parallel="seq",
        remat="dots")


def build_cell(shape_id: str, device="cuda", seed: int = 0, cfg: TransformerConfig = None,
               ctx=None, batch: int = None):
    """(step, args, meta) for prefill_32k or decode_32k at Llama's full width
    and the cell's depth in ``N_LAYERS_ONE_CARD`` unless ``cfg`` is given,
    ``batch`` sequences (default ``BATCH_ONE_CARD``), over ``ctx``'s model
    group if given.

    prefill: args (params, tokens [B, S]); decode: args (params, cache,
    tokens [B, 1], S - 1) with the cache of capacity S filled to S - 1 by
    random K/V from the generator, drawn a layer at a time; over a model
    group each process draws the whole cache and keeps its shard's slice,
    positions ``[shard * S / n, (shard + 1) * S / n)``, so the shards are
    slices of one cache.  ``meta["cfg"]`` is the configuration the step runs, ``meta["reduced"]``
    each cut as (reference, here), ``meta["model_flops"]`` the reference's
    2 * params * tokens."""
    if shape_id not in BATCH_ONE_CARD:
        raise ValueError(f"{ARCH_ID}: cells {sorted(BATCH_ONE_CARD)} are ported; "
                         f"{shape_id!r} is not ported (ROADMAP queue 1 item 2)")
    cfg = cfg or config().with_(n_layers=N_LAYERS_ONE_CARD[shape_id])
    shape = LM_SHAPES[shape_id]
    B, S = batch or BATCH_ONE_CARD[shape_id], shape["seq_len"]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    reduced = {}
    if cfg.n_layers < config().n_layers:
        reduced["n_layers"] = (config().n_layers, cfg.n_layers)
    if B < shape["global_batch"]:
        reduced["batch"] = (shape["global_batch"], B)
    meta = dict(kind=shape["kind"], seq=S, batch=B, n_layers=cfg.n_layers, cfg=cfg,
                n_params=cfg.n_params(), reduced=reduced)
    params = init_transformer(gen, cfg, device)
    if shape["kind"] == "prefill":
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
        meta["model_flops"] = 2 * cfg.n_params() * B * S
        return make_prefill_step(cfg, capacity=S, ctx=ctx), (params, tokens), meta

    n, shard = (1, 0) if ctx is None else (ctx.model, ctx.shard)
    if S % n:
        raise ValueError(f"{shape_id}: {S} positions do not split over {n} shards")
    loc = S // n
    lo, hi = shard * loc, min((shard + 1) * loc, S - 1)     # this shard's filled positions
    cache = init_cache(cfg, B, loc, device)
    for leaf in cache.values():
        for layer in leaf:          # a layer of the whole cache, then this shard's slice
            layer[:, :hi - lo] = torch.empty(
                B, S - 1, *leaf.shape[3:], dtype=leaf.dtype,
                device=device).normal_(generator=gen)[:, lo:hi]
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=device)
    meta["model_flops"] = 2 * cfg.n_params() * B
    return make_decode_step(cfg, ctx), (params, cache, tokens, S - 1), meta
