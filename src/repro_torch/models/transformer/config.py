"""Transformer configuration (port of ``repro.models.transformer.config``).

The port holds the fields its ported models read: a dense decoder with
grouped-query attention (MQA when ``n_kv == 1``), RoPE, pre-norm RMSNorm,
tied embeddings and an MLP variant, ``gelu_mlp`` (tanh GELU, Granite-34B-code)
or ``swiglu`` (Llama-3.2-3B); the training knobs ``train_microbatches``
(the train cell's micro-batch count) and ``remat`` ("full": every layer
recomputed in the backward, "none": activations kept, "dots": the
reference's policy, which Llama's config sets and which only a train step
refuses: the port has no gradient through it yet); and the parallel
layout: ``attn_parallel`` ("heads", or "seq": context parallelism over the
``model`` axis of a ``ParallelCtx``) and ``seq_shard_decode`` (the axes the
decode cache's sequence is split over, ``("model",)``).  The reference's
other knobs (MoE, MLA, sliding windows, softcaps, post-norms, the other MLP
variants, untied embeddings, ring attention) come with the configurations
and the sharding that use them; a value the port does not run raises
here, naming ROADMAP queue 1 item 2.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.models.transformer.layers import MLP_VARIANTS

REMAT_POLICIES = ("none", "full", "dots")
ATTN_PARALLEL = ("heads", "seq")
ITEM = "ROADMAP queue 1 item 2"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_q: int
    n_kv: int
    head_dim: int
    d_ff: int
    mlp_variant: str = "swiglu"
    rope_theta: float = 10000.0
    tied_embeddings: bool = True
    norm_eps: float = 1e-6
    param_dtype: torch.dtype = torch.bfloat16
    cache_dtype: torch.dtype = torch.bfloat16
    train_microbatches: int = 1
    attn_parallel: str = "heads"
    remat: str = "none"
    seq_shard_decode: Tuple[str, ...] = ("model",)

    def __post_init__(self):
        for field, value, ported in (("remat", self.remat, REMAT_POLICIES),
                                     ("mlp_variant", self.mlp_variant, MLP_VARIANTS),
                                     ("attn_parallel", self.attn_parallel, ATTN_PARALLEL)):
            if value not in ported:
                raise ValueError(f"{self.name}: {field} {value!r} is not ported (the port "
                                 f"has {ported}; the rest come with the configurations "
                                 f"that use them, {ITEM})")
        if not self.tied_embeddings:
            raise ValueError(f"{self.name}: untied embeddings are not ported ({ITEM})")
        if tuple(self.seq_shard_decode) != ("model",):
            raise ValueError(f"{self.name}: seq_shard_decode {self.seq_shard_decode!r} is "
                             f"not ported (the port shards the decode cache over "
                             f"('model',); the wider split of long_500k is {ITEM})")

    def with_(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count, as the reference counts it (tied
        embedding, attention and MLP matrices; the norms left out)."""
        d = self.d_model
        attn = d * self.n_q * self.head_dim * 2 + d * self.n_kv * self.head_dim * 2
        mats = 3 if self.mlp_variant == "swiglu" else 2
        return self.vocab * d + self.n_layers * (attn + mats * d * self.d_ff)
