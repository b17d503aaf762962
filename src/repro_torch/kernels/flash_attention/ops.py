"""Flash-attention forward: the CUDA kernel's wrapper (port of
``repro.kernels.flash_attention.ops``).

``flash_attention(q, k, v, ...)`` takes ``repro``'s public layout, q
``[B, S, Hq, D]`` and k, v ``[B, S, Hkv, D]`` with ``Hq % Hkv == 0``, and
returns ``[B, S, Hq, D]`` in q's dtype.  On a CUDA tensor it launches
``csrc/flash_attention.cu`` (or raises); on a CPU tensor it runs
:func:`attention_plain`.  The reference wrapper repeats K and V head-wise
for GQA; the kernel reads KV head ``h // (Hq // Hkv)`` by index through
the tensors' strides, so neither a repeat nor a transposed copy is made
and q, k, v may be strided views (last dimension contiguous).

Self-attention only (one sequence length S for queries and keys: every
row then keeps its diagonal key, so the kernel may skip the key tiles that
the mask leaves empty).  Forward-only, as the TPU kernel is: no
``autograd.Function``; a call that would need a gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_plain

KERNEL = "flash_attention"
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# q, k, v, out, B, S, Hq, Hkv, D, 3 strides (batch, seq, head) for each of
# q, k, v, scale, causal, window, softcap, stream
_SIG = (_P, _P, _P, _P, _I, _I, _I, _I, _I, *([_I64] * 9), _F, _I, _I, _F, _P)
_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_SIGNATURES = {name: _SIG for name in _ENTRY.values()}
HEAD_DIMS = (16, 32, 64, 128)

__all__ = ["KERNEL", "HEAD_DIMS", "flash_attention", "attention_plain"]


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{KERNEL}: expected q [B, S, Hq, D] and k, v [B, S, Hkv, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    (B, S, Hq, D), Hkv = q.shape, k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"{KERNEL}: q {tuple(q.shape)} and k/v {tuple(k.shape)} need "
                         "the same B, S and D, and Hq a multiple of Hkv")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{KERNEL}: q on {q.device}, k on {k.device}, v on {v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{KERNEL}: dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{KERNEL} is forward-only: call it under torch.no_grad()")


def _launch(q, k, v, scale, causal, window, softcap):
    entry = _ENTRY.get(q.dtype)
    if entry is None:
        raise TypeError(f"{KERNEL}: dtype {q.dtype} is not float32 or bfloat16")
    (B, S, Hq, D), Hkv = q.shape, k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head dim {D} not in {HEAD_DIMS}")
    # TMA tensor maps (bf16) and 16-byte loads (fp32): last dim contiguous,
    # strides and base addresses 16-byte aligned
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{KERNEL}: {name} strides {t.stride()} are not 16-byte "
                             "rows with a contiguous last dimension")
    out = torch.empty(B, S, Hq, D, dtype=q.dtype, device=q.device)
    lib = build.load(KERNEL, _SIGNATURES)
    code = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(causal), int(window), float(softcap or 0.0), build.stream_of(q))
    build.check(lib, code, entry)
    build.count_launch(KERNEL)
    return out


def flash_attention(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
                    softcap: float | None = None) -> torch.Tensor:
    """Online-softmax attention: scale, tanh ``softcap`` (None: off), the
    causal mask and a sliding ``window`` (``0 <= qpos - kpos < window``
    when ``window > 0``).  See the module docstring for the layout."""
    _check(q, k, v)
    if softcap is not None and softcap < 0:
        raise ValueError(f"{KERNEL}: softcap {softcap} must be positive (or None)")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, causal=causal, window=window,
                               softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: tensors on {q.device}, expected cpu or cuda")
    return _launch(q, k, v, scale, causal, max(int(window), 0), softcap)
