"""LM input-shape cells; a copy of ``repro.configs.lm_common.LM_SHAPES``,
and ``serve_cell``, the serving cells' builder of the configurations that
are served (Llama-3.2-3B, Gemma-2-2B).

``lm_rules`` and ``batch_axes_for`` are the reference's sharding rules for
``jax.sharding`` meshes; the port's processes hold their shards themselves
(``models/transformer/model.py::ParallelCtx``), so it has no copy of them."""
from __future__ import annotations

import torch

from repro_torch.models.transformer.model import init_cache, init_transformer
from repro_torch.models.transformer.steps import make_decode_step, make_prefill_step

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def serve_cell(arch_id: str, full, n_layers_one_card: dict, batch_one_card: dict,
               shape_id: str, device="cuda", seed: int = 0, cfg=None, ctx=None,
               batch: int = None):
    """(step, args, meta) of a served LM's prefill_32k or decode_32k cell
    (the cells in ``batch_one_card``; any other raises, naming ROADMAP
    queue 1 item 2): the arch's configuration ``full`` at the cell's depth
    in ``n_layers_one_card`` unless ``cfg`` is given, ``batch`` sequences
    (default ``batch_one_card``), over ``ctx``'s model group if given.

    prefill: args (params, tokens [B, S]); decode: args (params, cache,
    tokens [B, 1], S - 1) with the cache of capacity S filled to S - 1 by
    random K/V from the generator, drawn a layer at a time; over a model
    group each process draws the whole cache and keeps its shard's slice,
    positions ``[shard * S / n, (shard + 1) * S / n)``, so the shards are
    slices of one cache.  ``meta["cfg"]`` is the configuration the step runs, ``meta["reduced"]``
    each cut as (reference, here), ``meta["model_flops"]`` the reference's
    2 * params * tokens."""
    if shape_id not in batch_one_card:
        raise ValueError(f"{arch_id}: cells {sorted(batch_one_card)} are ported; "
                         f"{shape_id!r} is not ported (ROADMAP queue 1 item 2)")
    cfg = cfg or full.with_(n_layers=n_layers_one_card[shape_id])
    shape = LM_SHAPES[shape_id]
    B, S = batch or batch_one_card[shape_id], shape["seq_len"]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    reduced = {}
    if cfg.n_layers < full.n_layers:
        reduced["n_layers"] = (full.n_layers, cfg.n_layers)
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
