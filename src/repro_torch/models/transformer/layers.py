"""Transformer building blocks: RMSNorm, RoPE and the GELU MLP (port of
``repro.models.transformer.layers``).

Parameters are stacked over layers (leading axis ``L``), as the reference
stacks them for ``lax.scan``; the model indexes layer ``i`` of each leaf.
"""
from __future__ import annotations

import math

import torch


def init_stacked(gen: torch.Generator, shape, scale: float, dtype, device):
    """``normal(0, 1) * scale`` in ``dtype``, as the reference draws its
    weights, written in place one layer (index of the leading axis) at a
    time: no temporary of the whole leaf."""
    t = torch.empty(shape, dtype=dtype, device=device)
    for layer in t:
        layer.normal_(generator=gen).mul_(scale)
    return t


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(shape, device):
    return {"g": torch.zeros(shape, dtype=torch.float32, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 RMSNorm scaled by ``(1 + g)``, cast back to ``x.dtype``."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + p["g"].float())).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D] (D even); positions: [B, S] or [1, S].  Split-halves
    rotation in fp32, cast back to ``x.dtype``."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs                 # [B, S, D/2]
    cos, sin = ang.cos()[:, :, None], ang.sin()[:, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (the reference's ``gelu_mlp`` variant)
# ---------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, n_layers: int, d: int, ff: int, dtype, device):
    return {"wi": init_stacked(gen, (n_layers, d, ff), d ** -0.5, dtype, device),
            "wo": init_stacked(gen, (n_layers, ff, d), ff ** -0.5, dtype, device)}


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` as the reference evaluates it:
    op by op in ``x.dtype`` (each product and sum rounded, as XLA rounds
    them), with the constants rounded to ``x.dtype``
    (``np.sqrt(2 / np.pi).astype(x.dtype)`` and the weakly typed 0.044715).
    ``F.gelu`` rounds once and keeps exact constants: in bf16 its result
    differs from the reference's by an ulp in many elements."""
    c1 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype).item()
    c2 = torch.tensor(0.044715, dtype=x.dtype).item()
    inner = (x + x * x * x * c2) * c1
    return x * ((torch.tanh(inner) + 1.0) * 0.5)


def ffn(p, x: torch.Tensor) -> torch.Tensor:
    return gelu_tanh(x @ p["wi"]) @ p["wo"]
