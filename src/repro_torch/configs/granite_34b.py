"""Granite-34B-code [arXiv:2405.04324]: 88L d6144, MQA (48 query heads
over one KV head of dim 128), gelu MLP 24576, vocab 49152, tied
embeddings (port of ``repro.configs.granite_34b``).

``repro``'s granite-34b, which the port follows, uses RoPE and RMSNorm with
no biases; the published GPTBigCode-style model has learned positions,
LayerNorm and biases.

``build_cell(shape_id)`` is the one-card counterpart of the reference's
``launch/dryrun.py::build_lm_cell`` for ``prefill_32k`` and ``decode_32k``:
it returns ``(step, args, meta)`` with weights drawn on ``device`` from
``seed``, so ``step(*args)`` runs the cell.  Cut to one H100 (80 GB), each
cut only where memory forces it:

- prefill_32k keeps all 88 layers (67.3 GB of bf16 weights; a B=1 prefill
  of 32,768 tokens peaks at 76.9 GB on an H100); its batch is cut 32 -> 1.
- decode_32k: depth 88 -> 44 layers, one of two pipeline stages (the
  layers are all alike; 16.98 B parameters, 33.96 GB), and batch
  128 -> 32.  Its cache at capacity 32,768 is 23.6 GB at 44 layers and
  B=32: at 88 layers the weights and that cache would need 114 GB, and at
  B=128 the cache alone 94 GB.

``train_4k`` comes with the LM train step and ``long_500k`` with the
sequence-sharded decode across cards.
"""
from __future__ import annotations

import torch

from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.model import init_cache, init_transformer
from repro_torch.models.transformer.steps import make_decode_step, make_prefill_step

ARCH_ID = "granite-34b"
N_LAYERS_ONE_CARD = {"prefill_32k": 88, "decode_32k": 44}
BATCH_ONE_CARD = {"prefill_32k": 1, "decode_32k": 32}


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        vocab=49152, d_model=6144, n_layers=88,
        n_q=48, n_kv=1, head_dim=128,
        d_ff=24576, rope_theta=10000.0)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        vocab=256, d_model=32, n_layers=2,
        n_q=4, n_kv=1, head_dim=16, d_ff=96)


def build_cell(shape_id: str, device="cuda", seed: int = 0, cfg: TransformerConfig = None):
    """(step, args, meta) for ``prefill_32k`` or ``decode_32k`` on one
    device, at Granite's full width and the cell's depth in
    ``N_LAYERS_ONE_CARD`` unless ``cfg`` is given.

    prefill: args (params, tokens [B, S]); decode: args (params, cache,
    tokens [B, 1], S - 1) with the cache of capacity S filled to S - 1 by
    random K/V from the generator.  ``meta["cfg"]`` is the configuration
    the step runs, ``meta["reduced"]`` each cut as (reference, here), and
    ``meta["model_flops"]`` the reference's (2 * params * tokens)."""
    if shape_id not in BATCH_ONE_CARD:
        raise ValueError(f"{ARCH_ID}: cells {sorted(BATCH_ONE_CARD)} run on one card; "
                         f"{shape_id!r} is not ported")
    cfg = cfg or config().with_(n_layers=N_LAYERS_ONE_CARD[shape_id])
    shape = LM_SHAPES[shape_id]
    B, S = BATCH_ONE_CARD[shape_id], shape["seq_len"]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_transformer(gen, cfg, device)
    reduced = dict(batch=(shape["global_batch"], B))
    if cfg.n_layers < config().n_layers:
        reduced["n_layers"] = (config().n_layers, cfg.n_layers)
    meta = dict(kind=shape["kind"], seq=S, batch=B, n_layers=cfg.n_layers, cfg=cfg,
                n_params=cfg.n_params(), reduced=reduced)
    if shape["kind"] == "prefill":
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
        meta["model_flops"] = 2 * cfg.n_params() * B * S
        return make_prefill_step(cfg, capacity=S), (params, tokens), meta

    cache = init_cache(cfg, B, S, device)
    for leaf in cache.values():
        for layer in leaf:
            layer[:, :S - 1].normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=device)
    meta["model_flops"] = 2 * cfg.n_params() * B
    return make_decode_step(cfg), (params, cache, tokens, S - 1), meta
