"""Transformer configuration (port of ``repro.models.transformer.config``).

The port holds the fields its ported models read: a dense decoder with
grouped-query attention (MQA when ``n_kv == 1``), RoPE, pre-norm RMSNorm,
tied embeddings and an MLP variant, ``gelu_mlp`` (tanh GELU, Granite-34B-code),
``swiglu`` (Llama-3.2-3B) or ``geglu`` (Gemma-2-2B); Gemma-2's knobs: a
sliding ``window`` on the layers ``window_pattern`` names ("alternate": the
even layers, :attr:`TransformerConfig.layer_windows`), the tanh softcaps
of the attention scores (``attn_softcap``) and of the final logits
(``final_softcap``), RMSNorms after the attention and the MLP as well
(``post_norms``) and the embedding scaled by sqrt(d_model)
(``gemma_norm``); the training knobs ``train_microbatches``
(the train cell's micro-batch count) and ``remat`` ("full": every layer
recomputed in the backward, "none": activations kept, "dots": the
reference's policy, which Llama's config sets and which only a train step
refuses: the port has no gradient through it yet); and the parallel
layout: ``attn_parallel`` ("heads", or "seq": context parallelism over the
``model`` axis of a ``ParallelCtx``) and ``seq_shard_decode`` (the axes the
decode cache's sequence is split over, ``("model",)``).  The reference's
other knobs (MoE, MLA, QK norms, untied embeddings, ring attention) come
with the configurations and the sharding that use them; a value the port
does not run raises here, naming ROADMAP queue 1 item 2.  Gemma-2's
training (a gradient through the softcap, kernel 6b at head dim 256) is
that item too: the train step refuses it (``kernels/flash_attention``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.models.transformer.layers import MLP_VARIANTS

REMAT_POLICIES = ("none", "full", "dots")
ATTN_PARALLEL = ("heads", "seq")
WINDOW_PATTERNS = ("none", "alternate")
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
    window: Optional[int] = None            # sliding-window size (local layers)
    window_pattern: str = "none"            # none | alternate (even layers local)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_norms: bool = False                # RMSNorm after the attention and the MLP
    gemma_norm: bool = False                # embedding scaled by sqrt(d_model)
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
                                     ("attn_parallel", self.attn_parallel, ATTN_PARALLEL),
                                     ("window_pattern", self.window_pattern,
                                      WINDOW_PATTERNS)):
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

    @property
    def layer_windows(self) -> Tuple[int, ...]:
        """Each layer's attention window (0: global), as the reference's:
        under "alternate" the even layers are local, the odd global."""
        if self.window is None or self.window_pattern == "none":
            return tuple(0 for _ in range(self.n_layers))
        return tuple(self.window if i % 2 == 0 else 0 for i in range(self.n_layers))

    def n_params(self) -> int:
        """Analytic parameter count, as the reference counts it (tied
        embedding, attention and MLP matrices; the norms left out)."""
        d = self.d_model
        attn = d * self.n_q * self.head_dim * 2 + d * self.n_kv * self.head_dim * 2
        mats = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        return self.vocab * d + self.n_layers * (attn + mats * d * self.d_ff)
