"""AdamW with the reference's production features (port of the AdamW part
of ``repro.train.optimizer``, and its ``accumulate_gradients``): LR
schedules (constant, warmup + cosine), global gradient-norm clipping,
decoupled weight decay with a parameter mask, and moments in
``moment_dtype`` (fp32, or bf16 to halve their memory: upcast, updated in
fp32 and rounded on store, as the reference's ``upd`` does).

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
# elements of a leaf that adamw_update_ updates at a time: its temporaries
# are a few fp32 chunks of this size (256 MB each), whatever the leaf's
# shape (a stacked [L, 6144, 24576] leaf is 4.8 GB in fp32 at L = 8)
CHUNK_ELEMS = 1 << 26


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
    moment_dtype: torch.dtype = F32       # bf16 halves the moments' memory
    # params whose path matches any of these substrings are excluded from
    # weight decay (norms, biases)
    no_decay_substrings: tuple = ("ln", "norm", "bias", "b",)


def init_adamw(params, cfg: AdamWConfig) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
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
    """AdamW for one fp32 leaf (or a chunk of one) and its fp32 gradient,
    written into p, m and v, in the reference's expression order: moments
    of another dtype are upcast, updated in fp32 and rounded on store."""
    m32, v32 = m.float(), v.float()         # m and v themselves when fp32
    m32.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v32.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
    step_vec = (m32 / bc1).div_(torch.sqrt(v32 / bc2).add_(cfg.eps))
    p.sub_(lr * step_vec.add_(cfg.weight_decay * dmask * p))
    if m32.data_ptr() != m.data_ptr():
        m.copy_(m32)
        v.copy_(v32)


@torch.no_grad()
def adamw_update_(grads, state, params, cfg: AdamWConfig):
    """One AdamW step in place: writes the new params and moments into
    ``params``, ``state["m"]`` and ``state["v"]`` and the new step into
    ``state``; returns (params, state, {"lr", "grad_norm"}).  Params are
    fp32 and contiguous, moments fp32 or ``cfg.moment_dtype``; grads of any
    floating dtype (clipped in their own dtype, then upcast, as the
    reference clips them).

    The counterpart of the reference's donated train state: a functional
    update holds a clipped copy of the grads and new params, m and v beside
    the old ones, which at DLRM RM2's 3.2 B parameters (12.8 GB per copy)
    does not fit an 80 GB card.  The norm and the clip scale are computed
    once; the update runs over ``CHUNK_ELEMS`` elements of a leaf's flat
    view at a time (it is elementwise, so the chunking changes no bit), so
    its temporaries stay chunk-sized."""
    step, lr, bc1, bc2 = _step_scalars(state, cfg)
    gnorm = global_norm(grads)
    scale = None if cfg.clip_norm is None else _clip_scale(gnorm, cfg.clip_norm)

    def upd_(p, g, m, v, dmask):
        p, g, m, v = (t.view(-1) for t in (p, g.contiguous(), m, v))
        for lo in range(0, p.numel(), CHUNK_ELEMS):
            part = slice(lo, lo + CHUNK_ELEMS)
            gc = g[part] if scale is None else g[part] * scale.to(g.dtype)
            _leaf_update_(p[part], gc.float(), m[part], v[part], dmask, lr, bc1, bc2, cfg)

    tree_map(upd_, params, grads, state["m"], state["v"], _decay_mask(params, cfg))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def adamw_update(grads, state, params, cfg: AdamWConfig):
    """:func:`adamw_update_` on copies: returns (new params, new state,
    {"lr", "grad_norm"}) and leaves ``params`` and ``state`` as they were."""
    copy = lambda tree: tree_map(torch.clone, tree)  # noqa: E731
    return adamw_update_(grads, {"m": copy(state["m"]), "v": copy(state["v"]),
                                 "step": state["step"]}, copy(params), cfg)


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

def add_gradient_(acc, g):
    """``acc += g`` in place as the reference adds ``g.astype(acc.dtype)``:
    g is rounded to a narrower accumulator first (an fp32 accumulator holds
    a bf16 g exactly, so it is added as it is)."""
    acc.add_(g if g.dtype == acc.dtype or acc.dtype == F32 else g.to(acc.dtype))


def accumulate_gradients(grad_fn, n_micro: int, into: Optional[Callable] = None):
    """Wrap ``grad_fn(params, batch) -> (loss, grads)`` to average over
    micro-batches: ``batch`` leaves have a leading [n_micro, ...] axis; the
    loop keeps peak activation memory at one micro-batch.  Each
    micro-batch's grads are added in place, in micro-batch order, into the
    accumulators ``into(params)`` (a tree congruent with the grads; its
    leaves may be views of larger tensors, and a narrower dtype rounds each
    gradient first, :func:`add_gradient_`) or into zeros like ``params``.
    Returns (mean loss, the accumulators divided by n_micro in place), as
    the reference's scan."""
    def wrapped(params, batch):
        acc = (into or (lambda p: tree_map(torch.zeros_like, p)))(params)
        loss = 0.0
        for i in range(n_micro):
            l_i, g = grad_fn(params, tree_map(lambda t: t[i], batch))
            tree_map(add_gradient_, acc, g)
            del g
            loss = loss + l_i
        return loss / n_micro, tree_map(lambda a: a.div_(n_micro), acc)
    return wrapped


__all__ = ["AdamWConfig", "accumulate_gradients", "add_gradient_", "adamw_update",
           "adamw_update_", "constant_lr", "init_adamw", "warmup_cosine"]
