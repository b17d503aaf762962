"""Transformer configuration (port of ``repro.models.transformer.config``).

The port holds the fields its ported model reads: a dense decoder with
grouped-query attention (MQA when ``n_kv == 1``), RoPE, pre-norm RMSNorm,
a tanh-GELU MLP (``gelu_mlp``) and tied embeddings, as Granite-34B-code
sets them, and the two training knobs Granite sets: ``train_microbatches``
(the train cell's micro-batch count) and ``remat`` ("full": every layer
recomputed in the backward, "none": activations kept; the reference's
"dots" policy has no caller in the port and is refused).  The reference's
other knobs (MoE, MLA, sliding windows, softcaps, post-norms, the other
MLP variants, untied embeddings and the parallel layouts) each have one
value on this path; they come with the configurations and the sharding
that use them.
"""
from __future__ import annotations

import dataclasses

import torch

REMAT_POLICIES = ("none", "full")


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
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    param_dtype: torch.dtype = torch.bfloat16
    cache_dtype: torch.dtype = torch.bfloat16
    train_microbatches: int = 1
    remat: str = "none"

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"{self.name}: remat {self.remat!r} is not ported (the port "
                             f"has {REMAT_POLICIES}; the reference's 'dots' policy comes "
                             "with a configuration that uses it, ROADMAP queue 1 item 2)")

    def with_(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count, as the reference counts it (tied
        embedding, attention and MLP matrices; the norms left out)."""
        d = self.d_model
        attn = d * self.n_q * self.head_dim * 2 + d * self.n_kv * self.head_dim * 2
        return self.vocab * d + self.n_layers * (attn + 2 * d * self.d_ff)
