"""LM serving steps (port of ``repro.models.transformer.steps``'s prefill
and decode steps) and the greedy serving loop of ``examples/serve_lm.py``.

The steps run under ``torch.no_grad()``; the decode step writes its cache
in place.  The train step comes with the LM training slice.

Precision on the card: the reference's bf16 products accumulate in fp32.
The attention's do here too (the flash kernel and the decode attention's
fp32-result products), but torch's default
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
True`` lets cuBLAS reduce split-K partial sums of the dense bf16 GEMMs in
bf16.  A caller who wants the reference's arithmetic sets it to ``False``
before serving, as ``chip_smoke.py`` does; the steps leave the process's
settings alone.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.model import decode_step, prefill_step


def make_prefill_step(cfg: TransformerConfig, capacity: int):
    """step(params, tokens [B, S]) -> (last logits [B, V], cache)."""
    @torch.no_grad()
    def step(params, tokens):
        return prefill_step(params, tokens, cfg, capacity)
    return step


def make_decode_step(cfg: TransformerConfig):
    """step(params, cache, tokens [B, 1], cache_len) -> (logits [B, 1, V],
    cache)."""
    @torch.no_grad()
    def step(params, cache, tokens, cache_len: int):
        return decode_step(params, cache, tokens, cache_len, cfg)
    return step


def greedy_generate(params, prompts, cfg: TransformerConfig, gen_len: int):
    """Serve a batch: prefill ``prompts`` [B, S] into a cache of capacity
    S + gen_len, then decode greedily.  Returns the ``gen_len`` tokens of
    each sequence, [B, gen_len]."""
    S = prompts.shape[1]
    prefill = make_prefill_step(cfg, capacity=S + gen_len)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, prompts)
    tok = logits.argmax(dim=-1, keepdim=True)
    out = [tok]
    for i in range(gen_len - 1):
        logits, cache = decode(params, cache, tok, S + i)
        tok = logits[:, 0].argmax(dim=-1, keepdim=True)
        out.append(tok)
    return torch.cat(out, dim=1)
