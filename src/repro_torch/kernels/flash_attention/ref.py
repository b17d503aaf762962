"""Plain PyTorch version of the flash-attention kernel (the counterpart of
``repro.kernels.flash_attention.ref.attention_ref``)."""
from __future__ import annotations

import torch

NEG = -1e30


def attention_plain(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
                    softcap: float | None = None, chunk: int | None = None):
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] with Hq % Hkv == 0 ->
    [B, Sq, Hq, D] in ``v.dtype``.

    ``attention_ref``'s semantics on ``repro``'s public layout, in the
    kernel's arithmetic: scores, max and sum of exps in fp32; scale, then
    the tanh softcap, then the mask (causal, and ``0 <= qpos - kpos <
    window`` when ``window > 0``) with the finite ``-1e30``, so a row whose
    keys are all masked gets the mean of V; the unnormalised
    ``p = exp(s - max)`` rounded to ``v.dtype`` for the PV product (a no-op
    in fp32; in bf16 the precision of the model's ``blocked_attention``,
    ``p.astype(v.dtype)``), then divided by ``max(sum p, 1e-20)``.
    Query head ``h`` reads KV head ``h // (Hq // Hkv)``, by broadcasting,
    not by repeating K and V.  ``chunk`` bounds the query rows scored at
    once (the whole score matrix of a 32k prefill is 206 GB in fp32)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kt = k.float().permute(0, 2, 3, 1)                      # [B, Hkv, D, Skv]
    vf = v.float().permute(0, 2, 1, 3)                      # [B, Hkv, Skv, D]
    kpos = torch.arange(Skv, device=q.device)
    out = torch.empty(B, Sq, Hq, v.shape[-1], dtype=v.dtype, device=q.device)
    step = chunk or Sq
    for r0 in range(0, Sq, step):
        n = min(step, Sq - r0)
        qc = q[:, r0:r0 + n].float().reshape(B, n, Hkv, G, D).permute(0, 2, 3, 1, 4)
        s = (qc.reshape(B, Hkv, G * n, D) @ kt).mul_(scale).view(B, Hkv, G, n, Skv)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        qpos = torch.arange(r0, r0 + n, device=q.device)[:, None]
        mask = torch.ones(n, Skv, dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window and window > 0:
            mask &= (qpos - kpos) < window
        s = s.masked_fill(~mask, NEG)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        den = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
        p = p.to(v.dtype).float().view(B, Hkv, G * n, Skv)
        o = (p @ vf).view(B, Hkv, G, n, -1) / den
        out[:, r0:r0 + n] = o.permute(0, 3, 1, 2, 4).reshape(B, n, Hq, -1).to(v.dtype)
    return out
