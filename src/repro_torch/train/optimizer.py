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
# rows of a leaf that adamw_update_ updates at a time: its temporaries are
# a few [CHUNK_ROWS, D] tensors (256 MB each for DLRM RM2's D=64 table)
CHUNK_ROWS = 1 << 20


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


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def _step_scalars(state, cfg: AdamWConfig):
    step = state["step"] + 1
    return step, cfg.schedule(step), 1 - cfg.b1 ** step.to(F32), 1 - cfg.b2 ** step.to(F32)


def _leaf_update_(p, g, m, v, dmask, lr, bc1, bc2, cfg: AdamWConfig):
    """AdamW for one fp32 leaf (or rows of one), written into p, m and v,
    in the reference's expression order."""
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
    step_vec = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
    p.sub_(lr * step_vec.add_(cfg.weight_decay * dmask * p))


@torch.no_grad()
def adamw_update_(grads, state, params, cfg: AdamWConfig):
    """One AdamW step in place: writes the new params and moments into
    ``params``, ``state["m"]`` and ``state["v"]`` and the new step into
    ``state``; returns (params, state, {"lr", "grad_norm"}).  Params, grads
    and moments are fp32.

    The counterpart of the reference's donated train state: a functional
    update holds a clipped copy of the grads and new params, m and v beside
    the old ones, which at DLRM RM2's 3.2 B parameters (12.8 GB per copy)
    does not fit an 80 GB card.  The norm and the clip scale are computed
    once; the update runs over ``CHUNK_ROWS`` rows of a leaf at a time, so
    its temporaries stay chunk-sized."""
    step, lr, bc1, bc2 = _step_scalars(state, cfg)
    gnorm = global_norm(grads)
    scale = None if cfg.clip_norm is None else _clip_scale(gnorm, cfg.clip_norm)

    def upd_(p, g, m, v, dmask):
        p, g, m, v = (t if t.dim() else t.view(1) for t in (p, g, m, v))
        for lo in range(0, p.shape[0], CHUNK_ROWS):
            rows = slice(lo, lo + CHUNK_ROWS)
            gc = g[rows] if scale is None else g[rows] * scale
            _leaf_update_(p[rows], gc, m[rows], v[rows], dmask, lr, bc1, bc2, cfg)

    tree_map(upd_, params, grads, state["m"], state["v"], _decay_mask(params, cfg))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def adamw_update(grads, state, params, cfg: AdamWConfig):
    """:func:`adamw_update_` on copies: returns (new params, new state,
    {"lr", "grad_norm"}) and leaves ``params`` and ``state`` as they were."""
    copy = lambda tree: tree_map(torch.clone, tree)  # noqa: E731
    return adamw_update_(grads, {"m": copy(state["m"]), "v": copy(state["v"]),
                                 "step": state["step"]}, copy(params), cfg)


__all__ = ["AdamWConfig", "adamw_update", "adamw_update_", "constant_lr",
           "init_adamw", "warmup_cosine"]
