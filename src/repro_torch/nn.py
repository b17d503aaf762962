"""Dense / ELU / LayerNorm / MLP building blocks (port of ``repro.nn``).

Parameters keep the reference's layout so that checkpoint key paths carry
over 1:1: a dense layer is ``{"w": [d_in, d_out], "b": [d_out]}``, an MLP
is ``{"layers": [dense, ...], "ln": {"g", "b"}}``.  Modules are plain
functions over those nested dicts of tensors; initializers draw from a
``torch.Generator`` on the CPU (so a seed gives the same weights on every
device) and then move to ``device``.  fp32 only in this slice.  Parameter
trees are handled by ``tree_leaves`` (JAX's flatten order), ``tree_map`` and
``tree_unflatten``; ``value_and_grad`` is the counterpart of
``jax.value_and_grad`` over them.
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


# ---------------------------------------------------------------------------
# parameter trees (nested dicts / lists of tensors)
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """Leaves in JAX's flatten order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure filled with ``leaves`` (in :func:`tree_leaves`
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (fp32), summed leaf by leaf
    in :func:`tree_leaves` order as ``repro.nn.global_norm``."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def value_and_grad(fn, params, *args, has_aux: bool = False):
    """``jax.value_and_grad`` for a function of a parameter tree: returns
    (fn(params, *args), d out / d params) with the value detached.  With
    ``has_aux`` the function returns (scalar, aux) and only the scalar is
    differentiated.  Gradients of leaves the value does not reach are
    zeros."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(p)
        out = fn(p, *args)
        value = out[0] if has_aux else out
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for g, l in zip(grads, leaves)]
    out = tree_map(lambda t: t.detach(), list(out)) if has_aux else out.detach()
    return out, tree_unflatten(p, grads)
