"""LM steps (port of ``repro.models.transformer.steps``): the train step
(fp32 master weights, micro-batch gradient accumulation, AdamW), the
prefill and decode steps, and the greedy serving loop of
``examples/serve_lm.py``.

The serving steps run under ``torch.no_grad()``; the decode step writes its
cache in place.  They take a ``model.ParallelCtx`` (``ctx``, None: one
device): over a model group each process calls them with the same prompts
and tokens, holds its shard of the cache and gets the same logits.  The
train step updates its state in place (the reference's cell donates it):
at Granite's width a second copy of the master weights and moments does
not fit one card.

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

from repro_torch.models.transformer.config import ITEM, TransformerConfig
from repro_torch.models.transformer.model import (
    decode_step, init_transformer, layer_list, lm_loss, prefill_step)
from repro_torch.nn import tree_leaves, tree_map, tree_unflatten
from repro_torch.train.optimizer import (
    AdamWConfig, accumulate_gradients, adamw_update_, init_adamw)


def lm_init_train_state(gen: torch.Generator, cfg: TransformerConfig, opt: AdamWConfig,
                        device="cuda") -> dict:
    """{"params": fp32 master weights, "opt": AdamW state}: the weights
    drawn as ``init_transformer`` draws them, then upcast."""
    master = tree_map(lambda t: t.float(), init_transformer(gen, cfg, device))
    return {"params": master, "opt": init_adamw(master, opt)}


def _by_layer(tree):
    """The model's tree with ``layers`` the list of per-layer trees
    (:func:`layer_list`: views of the stacked leaves)."""
    return {**tree, "layers": layer_list(tree)}


def make_train_step(cfg: TransformerConfig, opt: AdamWConfig, n_micro: int = 1,
                    cast_per_micro: bool = False, accum_dtype=torch.float32):
    """step(state, tokens [B, S], targets [B, S]) -> (state, {"loss", "lr",
    "grad_norm"}), the state updated in place.

    The reference's step: the loss of the master weights cast to
    ``cfg.param_dtype`` (every floating leaf, the norm gains too); with
    ``n_micro > 1`` the batch is split into ``n_micro`` micro-batches whose
    gradients are added into ``accum_dtype`` accumulators and divided by
    ``n_micro``, the bf16 compute copy cast once per step unless
    ``cast_per_micro`` (then each micro-batch casts the master and its
    gradient is the master's, fp32).  Each micro-batch's gradient comes
    from ``torch.autograd.grad`` on leaves of its own, one per layer slice,
    and ``accumulate_gradients`` adds it into the stacked accumulators'
    per-layer views: ``.backward()`` into bf16 leaves would sum the
    micro-batches in bf16, which the reference does not.  Then AdamW
    (``adamw_update_``) on the master weights.  Raises on ``cfg.remat ==
    "dots"``, which the port's gradient does not have (a configuration that
    sets it is served, never trained)."""
    if cfg.remat == "dots":
        raise ValueError(f"{cfg.name}: remat 'dots' is not ported to the gradient (the port "
                         f"recomputes 'full' layers or 'none'; the reference's policy comes "
                         f"with training a configuration that sets it, {ITEM})")

    def cast(tree):
        return tree_map(lambda t: t.to(cfg.param_dtype), tree)

    def leaf(t):
        return t.detach().requires_grad_(True)

    def micro_grad(tree, batch, cast_inside):
        """(loss, gradients of ``tree``'s leaves in its structure)."""
        tokens, targets = batch
        with torch.enable_grad():
            leaves = tree_leaves(tree)
            loss, _ = lm_loss(cast(tree) if cast_inside else tree, tokens, targets, cfg)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(tree, list(grads))

    def step(state, tokens, targets):
        master = state["params"]
        B = tokens.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} is not a multiple of n_micro {n_micro}")
        # n_micro == 1: the gradient of the master itself, as the reference
        # takes it (fp32; accum_dtype applies to micro-batches only)
        dtype = accum_dtype if n_micro > 1 else torch.float32
        from_master = n_micro == 1 or cast_per_micro
        src = tree_map(leaf, _by_layer(master if from_master else cast(master)))
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device), master)
        batch = tuple(t.view(n_micro, B // n_micro, -1) for t in (tokens, targets))
        loss, _ = accumulate_gradients(
            lambda p, mb: micro_grad(p, mb, cast_inside=from_master), n_micro,
            into=lambda _: _by_layer(grads))(src, batch)
        del src
        _, opt_state, info = adamw_update_(grads, state["opt"], master, opt)
        state["opt"] = opt_state
        return state, {"loss": loss, **info}
    return step


def make_prefill_step(cfg: TransformerConfig, capacity: int, ctx=None):
    """step(params, tokens [B, S]) -> (last logits [B, V], cache)."""
    @torch.no_grad()
    def step(params, tokens):
        return prefill_step(params, tokens, cfg, capacity, ctx)
    return step


def make_decode_step(cfg: TransformerConfig, ctx=None):
    """step(params, cache, tokens [B, 1], cache_len) -> (logits [B, 1, V],
    cache)."""
    @torch.no_grad()
    def step(params, cache, tokens, cache_len: int):
        return decode_step(params, cache, tokens, cache_len, cfg, ctx)
    return step


def greedy_generate(params, prompts, cfg: TransformerConfig, gen_len: int, ctx=None):
    """Serve a batch: prefill ``prompts`` [B, S] into a cache of capacity
    S + gen_len, then decode greedily.  Returns the ``gen_len`` tokens of
    each sequence, [B, gen_len] (over a model group the same on every
    process; S and S + gen_len must split over it)."""
    S = prompts.shape[1]
    prefill = make_prefill_step(cfg, capacity=S + gen_len, ctx=ctx)
    decode = make_decode_step(cfg, ctx)
    logits, cache = prefill(params, prompts)
    tok = logits.argmax(dim=-1, keepdim=True)
    out = [tok]
    for i in range(gen_len - 1):
        logits, cache = decode(params, cache, tok, S + i)
        tok = logits[:, 0].argmax(dim=-1, keepdim=True)
        out.append(tok)
    return torch.cat(out, dim=1)
