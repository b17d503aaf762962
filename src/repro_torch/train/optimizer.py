"""AdamW with the reference's production features (port of the AdamW part
of ``repro.train.optimizer``): LR schedules (constant, warmup + cosine),
global gradient-norm clipping, decoupled weight decay with a parameter
mask, fp32 moments (the reference's bf16-moment option is not ported).

Plain tensor code, not ``torch.optim.AdamW``: the reference's b2 = 0.95,
its global-norm clip and its decay mask differ from that class.  The
optimizer state keeps the reference's tree ``{"m", "v", "step"}`` (moments
congruent with the params, ``step`` an int32 scalar on the CPU), so a
checkpoint of it restores in ``repro`` and back.  Every step is computed
in fp32 with the reference's expression order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.nn import global_norm, tree_map

F32 = torch.float32


# ---------------------------------------------------------------------------
# LR schedules: step (int32 tensor or int) -> fp32 scalar tensor
# ---------------------------------------------------------------------------

def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    def f(step):
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = base_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def constant_lr(base_lr: float) -> Callable:
    return lambda step: torch.full((), base_lr, dtype=F32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    schedule: Callable = dataclasses.field(default_factory=lambda: constant_lr(1e-3))
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    # params whose path matches any of these substrings are excluded from
    # weight decay (norms, biases)
    no_decay_substrings: tuple = ("ln", "norm", "bias", "b",)


def init_adamw(params, cfg: AdamWConfig) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def _paths(tree, prefix=()):
    """Key paths ("mp/0/edge/layers/0/w") in the tree's own structure."""
    if isinstance(tree, dict):
        return {k: _paths(v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_paths(v, prefix + (str(i),)) for i, v in enumerate(tree)]
    return "/".join(prefix)


def _decay_mask(params, cfg: AdamWConfig):
    """1.0 for the leaves weight decay applies to, 0.0 for the excluded."""
    def flag(keystr):
        last = keystr.split("/")[-1]
        exclude = any(s == last or (len(s) > 1 and s in keystr)
                      for s in cfg.no_decay_substrings)
        return 0.0 if exclude else 1.0
    return tree_map(flag, _paths(params))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step.  Returns (new params, new state, {"lr", "grad_norm"});
    ``params`` and ``state`` are not modified."""
    step = state["step"] + 1
    lr = cfg.schedule(step)
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    mask = _decay_mask(params, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(F32)
    bc2 = 1 - b2 ** step.to(F32)

    def upd(p, g, m, v, dmask):
        g32 = g.to(F32)
        m32 = m.to(F32) * b1 + (1 - b1) * g32
        v32 = v.to(F32) * b2 + (1 - b2) * torch.square(g32)
        mhat = m32 / bc1
        vhat = v32 / bc2
        step_vec = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.to(F32)
        p32 = p32 - lr * (step_vec + cfg.weight_decay * dmask * p32)
        return p32.to(p.dtype), m32, v32

    out = tree_map(upd, params, grads, state["m"], state["v"], mask)
    new_params = _select(out, 0)
    new_state = {"m": _select(out, 1), "v": _select(out, 2), "step": step}
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}


def _select(tree_of_tuples, i):
    """Pick element ``i`` of every tuple leaf."""
    if isinstance(tree_of_tuples, dict):
        return {k: _select(v, i) for k, v in tree_of_tuples.items()}
    if isinstance(tree_of_tuples, list):
        return [_select(v, i) for v in tree_of_tuples]
    return tree_of_tuples[i]


__all__ = ["AdamWConfig", "adamw_update", "clip_by_global_norm",
           "constant_lr", "init_adamw", "warmup_cosine"]
