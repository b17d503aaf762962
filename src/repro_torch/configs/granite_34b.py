"""Granite-34B-code [arXiv:2405.04324]: 88L d6144, MQA (48 query heads
over one KV head of dim 128), gelu MLP 24576, vocab 49152, tied
embeddings (port of ``repro.configs.granite_34b``).

``repro``'s granite-34b, which the port follows, uses RoPE and RMSNorm with
no biases; the published GPTBigCode-style model has learned positions,
LayerNorm and biases.

``build_cell(shape_id)`` is the one-card counterpart of the reference's
``launch/dryrun.py::build_lm_cell`` for all four cells: it returns
``(step, args, meta)`` with weights drawn on ``device`` from ``seed``, so
``step(*args)`` runs the cell.  Cut to one H100 (80 GB), each cut only
where memory forces it:

- prefill_32k keeps all 88 layers (67.3 GB of bf16 weights; a B=1 prefill
  of 32,768 tokens peaks at 76.9 GB on an H100); its batch is cut 32 -> 1.
- decode_32k: depth 88 -> 44 layers, one of two pipeline stages (the
  layers are all alike; 16.98 B parameters, 33.96 GB), and batch
  128 -> 32.  Its cache at capacity 32,768 is 23.6 GB at 44 layers and
  B=32: at 88 layers the weights and that cache would need 114 GB, and at
  B=128 the cache alone 94 GB.
- train_4k: the reference's step (bf16 moments, ``train_microbatches`` =
  16 micro-batches, fp32 master weights and accumulators, remat "full").
  Its state is 16 bytes a parameter (fp32 master, bf16 m and v, fp32
  accumulators, the bf16 compute copy and one micro-batch's bf16
  gradients), 6.07 GB a layer (379.06 M parameters) and 4.83 GB for the
  tied embedding (301.99 M).  At 8 layers a step peaked at 55.1 GB on an
  H100 80GB HBM3 at 700 W (53.3 GB of state and one micro-batch's
  activations), and each layer adds about 6.07 GB: depth 88 -> 11 (about
  73 GB; 12 layers would be about 79 GB, too near the card's 80 GB to
  leave the allocator room) and batch 256 -> 16: 16 micro-batches of 1
  sequence.
- long_500k: B = 1 over a cache of capacity 524,288 filled to 524,287,
  1.03 GB a layer (0.76 GB of weights and a 0.27 GB cache) and 0.60 GB
  of embedding: depth 88 -> 72, about 74.5 GB (80 layers would be 82.7 GB,
  88 layers 91.5 GB).  The reference spreads this cache over 256 shards
  (``seq_shard_decode``); on one card it is one sequence of one device, and
  its decode attention is plain PyTorch as every decode step's is.
"""
from __future__ import annotations

import torch

from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.model import init_cache, init_transformer
from repro_torch.models.transformer.steps import (
    lm_init_train_state, make_decode_step, make_prefill_step, make_train_step)
from repro_torch.train.optimizer import AdamWConfig

ARCH_ID = "granite-34b"
N_LAYERS_ONE_CARD = {"prefill_32k": 88, "decode_32k": 44, "train_4k": 11, "long_500k": 72}
BATCH_ONE_CARD = {"prefill_32k": 1, "decode_32k": 32, "train_4k": 16, "long_500k": 1}


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        vocab=49152, d_model=6144, n_layers=88,
        n_q=48, n_kv=1, head_dim=128,
        d_ff=24576, mlp_variant="gelu_mlp", rope_theta=10000.0,
        train_microbatches=16, remat="full")


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        vocab=256, d_model=32, n_layers=2,
        n_q=4, n_kv=1, head_dim=16, d_ff=96, mlp_variant="gelu_mlp")


def build_cell(shape_id: str, device="cuda", seed: int = 0, cfg: TransformerConfig = None):
    """(step, args, meta) for one of the four cells on one device, at
    Granite's full width and the cell's depth in ``N_LAYERS_ONE_CARD``
    unless ``cfg`` is given.

    prefill: args (params, tokens [B, S]); decode (decode_32k, long_500k):
    args (params, cache, tokens [B, 1], S - 1) with the cache of capacity S
    filled to S - 1 by random K/V from the generator; train: args (state,
    tokens [B, S], targets [B, S]), ``state`` the fp32 master weights and
    the AdamW state, updated in place by each step.  ``meta["cfg"]`` is the
    configuration the step runs, ``meta["reduced"]`` each cut as
    (reference, here), and ``meta["model_flops"]`` the reference's (2 *
    params * tokens; 6 * params * tokens for the train step, whose
    ``meta["n_micro"]`` is its micro-batch count)."""
    if shape_id not in BATCH_ONE_CARD:
        raise ValueError(f"{ARCH_ID}: cells {sorted(BATCH_ONE_CARD)} run on one card; "
                         f"{shape_id!r} is not ported")
    cfg = cfg or config().with_(n_layers=N_LAYERS_ONE_CARD[shape_id])
    shape = LM_SHAPES[shape_id]
    B, S = BATCH_ONE_CARD[shape_id], shape["seq_len"]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    reduced = {}
    if cfg.n_layers < config().n_layers:
        reduced["n_layers"] = (config().n_layers, cfg.n_layers)
    if B < shape["global_batch"]:
        reduced["batch"] = (shape["global_batch"], B)
    meta = dict(kind=shape["kind"], seq=S, batch=B, n_layers=cfg.n_layers, cfg=cfg,
                n_params=cfg.n_params(), reduced=reduced)
    if shape["kind"] == "train":
        opt = AdamWConfig(moment_dtype=torch.bfloat16)
        state = lm_init_train_state(gen, cfg, opt, device)
        tokens, targets = (torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
                           for _ in range(2))
        n_micro = max(1, min(cfg.train_microbatches, B))
        meta.update(model_flops=6 * cfg.n_params() * B * S, n_micro=n_micro, opt=opt)
        return make_train_step(cfg, opt, n_micro=n_micro), (state, tokens, targets), meta

    params = init_transformer(gen, cfg, device)
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
