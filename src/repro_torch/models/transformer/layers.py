"""Transformer building blocks: RMSNorm, RoPE, the dense MLPs (the
tanh-GELU ``gelu_mlp``, ``swiglu`` and ``geglu``) and the tanh softcap
(port of ``repro.models.transformer.layers``).

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
# MLPs (the reference's ``gelu_mlp``, ``swiglu`` and ``geglu`` variants)
# ---------------------------------------------------------------------------

MLP_VARIANTS = ("gelu_mlp", "swiglu", "geglu")


def init_ffn(gen: torch.Generator, n_layers: int, d: int, ff: int, dtype, device,
             variant: str = "gelu_mlp"):
    """The reference's leaves: ``wi`` [L, d, ff] and ``wo`` [L, ff, d], and
    for ``swiglu`` and ``geglu`` the gate ``wg`` [L, d, ff] (drawn between
    them)."""
    p = {"wi": init_stacked(gen, (n_layers, d, ff), d ** -0.5, dtype, device)}
    if variant in ("swiglu", "geglu"):
        p["wg"] = init_stacked(gen, (n_layers, d, ff), d ** -0.5, dtype, device)
    p["wo"] = init_stacked(gen, (n_layers, ff, d), ff ** -0.5, dtype, device)
    return p


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


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu(x)`` as the reference evaluates it: ``x * (1 / (1 +
    exp(-x)))`` op by op in ``x.dtype``.  ``F.silu`` rounds once: in bf16
    its result differs from the reference's by an ulp in about a third of
    the elements."""
    return x * (1.0 / (torch.exp(-x) + 1.0))


def ffn(p, x: torch.Tensor, variant: str = "gelu_mlp") -> torch.Tensor:
    if variant == "swiglu":
        return (silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    if variant == "geglu":
        return (gelu_tanh(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    return gelu_tanh(x @ p["wi"]) @ p["wo"]


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """``cap * tanh(x / cap)`` computed in fp32 and cast back to
    ``x.dtype`` (None: ``x``), as the reference's."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
