"""Dense / ELU / LayerNorm / MLP building blocks (port of ``repro.nn``).

Parameters keep the reference's layout so that checkpoint key paths carry
over 1:1: a dense layer is ``{"w": [d_in, d_out], "b": [d_out]}``, an MLP
is ``{"layers": [dense, ...], "ln": {"g", "b"}}``.  Modules are plain
functions over those nested dicts of tensors; initializers draw from a
``torch.Generator`` on the CPU (so a seed gives the same weights on every
device) and then move to ``device``.  fp32 only in this slice.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

Params = dict


def glorot(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return u * (2.0 * lim) - lim


def init_dense(gen: torch.Generator, d_in: int, d_out: int, device="cuda",
               bias: bool = True) -> Params:
    p = {"w": glorot(gen, (d_in, d_out)).to(device)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_layernorm(d: int, device="cuda") -> Params:
    return {"g": torch.ones(d, device=device), "b": torch.zeros(d, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the BIASED variance, as ``jnp.var``."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    xhat = (x - mu) * torch.rsqrt(var + eps)
    return xhat * p["g"] + p["b"]


def init_mlp(gen: torch.Generator, d_in: int, hidden: Sequence[int], d_out: int,
             device="cuda", final_layernorm: bool = True) -> Params:
    """Paper-style MLP: hidden layers with ELU, optional output LayerNorm."""
    dims = [d_in, *hidden, d_out]
    p: Params = {"layers": [init_dense(gen, a, b, device)
                            for a, b in zip(dims[:-1], dims[1:])]}
    if final_layernorm:
        p["ln"] = init_layernorm(d_out, device)
    return p


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        x = dense(lp, x)
        if i < n - 1:
            x = F.elu(x)
    if "ln" in p:
        x = layernorm(p["ln"], x)
    return x
