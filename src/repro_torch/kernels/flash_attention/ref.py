"""Plain PyTorch versions of the flash-attention kernels: the forward (the
counterpart of ``repro.kernels.flash_attention.ref.attention_ref``) and its
gradient (kernel 6b's, which has no TPU twin); and the mirror of the bf16
kernel's softcap at head dim 256, for the tests."""
from __future__ import annotations

import numpy as np
import torch

NEG = -1e30
LOG2E = 1.4426950408889634


def _mask(r0, n, Skv, causal, window, device, q_offset=0):
    """[n, Skv] keys that query rows [r0, r0 + n), at positions
    ``q_offset + r0`` on, keep."""
    qpos = torch.arange(q_offset + r0, q_offset + r0 + n, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)
    mask = torch.ones(n, Skv, dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window and window > 0:
        mask &= (qpos - kpos) < window
    return mask


def _heads(x, r0, n, Hkv, dtype=torch.float32):
    """Rows [r0, r0 + n) of x [B, S, Hq, D] as ``dtype`` [B, Hkv, G * n, D]
    (query head h = hk * G + g at row g * n + i)."""
    B, _, Hq, D = x.shape
    G = Hq // Hkv
    xc = x[:, r0:r0 + n].to(dtype).reshape(B, n, Hkv, G, D).permute(0, 2, 3, 1, 4)
    return xc.reshape(B, Hkv, G * n, D)


def softcap_ex2(s, cap: float, scale: float = 1.0):
    """``cap * tanh(scale * s / cap)`` of raw fp32 scores ``s`` in the steps
    of the bf16 kernel's softcap at head dim 256
    (``csrc/flash_attention.cu::cap_score_ex2``), used by the tests:
    ``kin = 2 log2(e) scale / cap`` once in fp32, ``e = 2^min(s kin, 64)``,
    then ``(e - 1) * (1 / (e + 1)) * cap``.  The kernel takes the power and
    the reciprocal by ``ex2.approx`` and ``rcp.approx`` (within 2 and 1 ulp)
    and multiplies by ``cap log2(e)`` in place of ``cap`` (its softmax is in
    base 2), so this is its arithmetic with correctly rounded steps, not
    its bits."""
    f32 = np.float32
    kin = f32(f32(f32(2.0) * f32(LOG2E)) * f32(scale)) / f32(cap)
    e = torch.exp2(torch.clamp(s.float() * float(kin), max=64.0))
    return (e - 1) * (1 / (e + 1)) * float(f32(cap))


def attention_plain(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
                    softcap: float | None = None, chunk: int | None = None,
                    return_lse: bool = False, q_offset: int = 0):
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] with Hq % Hkv == 0 ->
    [B, Sq, Hq, D] in ``v.dtype``; query row ``r`` sits at position
    ``q_offset + r`` and key ``j`` at ``j`` (the reference's
    ``blocked_attention(q_offset=)``, as a context-parallel shard calls it).

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
    once (the whole score matrix of a 32k prefill is 206 GB in fp32).
    ``return_lse`` also returns each row's log-sum-exp
    ``max + log(max(sum p, 1e-20))``, fp32 [B, Hq, Sq], as the kernel
    writes it for the backward."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kt = k.float().permute(0, 2, 3, 1)                      # [B, Hkv, D, Skv]
    vf = v.float().permute(0, 2, 1, 3)                      # [B, Hkv, Skv, D]
    out = torch.empty(B, Sq, Hq, v.shape[-1], dtype=v.dtype, device=q.device)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device) if return_lse else None
    step = chunk or Sq
    for r0 in range(0, Sq, step):
        n = min(step, Sq - r0)
        s = (_heads(q, r0, n, Hkv) @ kt).mul_(scale).view(B, Hkv, G, n, Skv)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(~_mask(r0, n, Skv, causal, window, q.device, q_offset), NEG)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        den = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
        if return_lse:
            lse[:, :, r0:r0 + n] = (m + torch.log(den)).reshape(B, Hq, n)
        p = p.to(v.dtype).float().view(B, Hkv, G * n, Skv)
        o = (p @ vf).view(B, Hkv, G, n, -1) / den
        out[:, r0:r0 + n] = o.permute(0, 3, 1, 2, 4).reshape(B, n, Hq, -1).to(v.dtype)
    return (out, lse) if return_lse else out


def attention_plain_bwd(q, k, v, out, lse, dout, *, scale: float, causal: bool = True,
                        window: int = 0, softcap: float | None = None,
                        chunk: int | None = None):
    """(dq, dk, dv) of :func:`attention_plain` (self-attention, Sq = Skv)
    in kernel 6b's arithmetic: P recomputed as ``exp(s - lse)`` from the
    forward's row log-sum-exp ``lse`` [B, Hq, S], ``D = rowsum(dout * out)``,
    ``dS = P (dP - D)``; in bf16 P and dS are rounded to the inputs' type as
    the products' operands (no-ops in fp32), every sum is fp32; dk and dv
    summed over the query heads that share a KV head; float64 inputs are
    computed in float64 throughout (a reference for the fp32 sums).
    ``chunk`` bounds the query rows scored at once.  No softcap (the kernel
    has none)."""
    if softcap:
        raise NotImplementedError("attention_plain_bwd: no softcap")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    acc = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(acc).permute(0, 2, 1, 3)                      # [B, Hkv, S, D]
    vf = v.to(acc).permute(0, 2, 1, 3)
    dk = torch.zeros(B, Hkv, S, D, dtype=acc, device=q.device)
    dv = torch.zeros_like(dk)
    dq = torch.empty_like(q)
    delta = (dout.to(acc) * out.to(acc)).sum(-1)            # [B, S, Hq]
    step = chunk or S
    for r0 in range(0, S, step):
        n = min(step, S - r0)
        qc, gc = _heads(q, r0, n, Hkv, acc), _heads(dout, r0, n, Hkv, acc)
        s = (qc @ kf.transpose(-1, -2)).mul_(scale).view(B, Hkv, G, n, S)
        s = s.masked_fill(~_mask(r0, n, S, causal, window, q.device), NEG)
        p = torch.exp(s - lse[:, :, r0:r0 + n].to(acc).reshape(B, Hkv, G, n, 1))
        dp = (gc @ vf.transpose(-1, -2)).view(B, Hkv, G, n, S)
        dl = delta[:, r0:r0 + n].reshape(B, n, Hkv, G).permute(0, 2, 3, 1)[..., None]
        ds = (p * (dp - dl)).to(q.dtype).to(acc).view(B, Hkv, G * n, S)
        p = p.to(q.dtype).to(acc).view(B, Hkv, G * n, S)
        dv += p.transpose(-1, -2) @ gc
        dk += ds.transpose(-1, -2) @ qc
        dqc = (ds @ kf).mul_(scale).view(B, Hkv, G, n, D)
        dq[:, r0:r0 + n] = dqc.permute(0, 3, 1, 2, 4).reshape(B, n, Hq, D).to(q.dtype)
    dk = dk.mul_(scale).permute(0, 2, 1, 3).to(k.dtype)
    return dq, dk, dv.permute(0, 2, 1, 3).to(v.dtype)
