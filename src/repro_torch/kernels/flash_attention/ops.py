"""Flash attention: the CUDA kernels' wrapper (port of
``repro.kernels.flash_attention.ops``) and its gradient.

``flash_attention(q, k, v, ...)`` takes ``repro``'s public layout, q
``[B, Sq, Hq, D]`` and k, v ``[B, Skv, Hkv, D]`` with ``Hq % Hkv == 0``, and
returns ``[B, Sq, Hq, D]`` in q's dtype.  On a CUDA tensor it launches
``csrc/flash_attention.cu`` (or raises); on a CPU tensor it runs
:func:`attention_plain`.  The reference wrapper repeats K and V head-wise
for GQA; the kernel reads KV head ``h // (Hq // Hkv)`` by index through
the tensors' strides, so neither a repeat nor a transposed copy is made
and q, k, v may be strided views (last dimension contiguous).

Queries and keys may differ in length, and ``q_offset`` places query row
``r`` at position ``q_offset + r`` against keys at ``0 .. Skv - 1``: the
shape of the TPU kernel's ``seq_kv`` and of the reference's
``blocked_attention(q_offset=)`` under context parallelism
(``models/transformer/attention.py::attention_seq_parallel``: a shard's
``S / n`` rows at ``shard * S / n`` against all ``S`` keys).  Every query row
must keep a key (the kernel skips the key tiles the mask leaves empty, so
it never sees a row without one): a window that leaves the last row none
raises ``ValueError``.  No caller reaches that shape, and there the
reference's own two versions disagree (the Pallas kernel also averages its
zero padding).

When a gradient is needed, the call goes through an
``autograd.Function``: its forward launches the same kernel, which also
writes each row's log-sum-exp, and its backward launches
``csrc/flash_attention_bwd.cu`` (kernel 6b: four kernels, each counted
under ``KERNEL_BWD``), which recomputes P from that statistic.  On CPU
tensors the Function runs the plain versions, :func:`attention_plain` and
:func:`attention_plain_bwd`.  The TPU kernel is forward-only; the reference
differentiates its ``blocked_attention`` under ``jax.checkpoint``, which
is the gradient this backward computes.  The forward takes the head dims
``HEAD_DIMS``, 256 (Gemma-2-2B) among them; the backward takes
``BWD_HEAD_DIMS``, which lack 256, and no softcap: both are what training
Gemma-2 needs (``GEMMA_TRAIN``).  It is self-attention only (``Sq == Skv``,
``q_offset == 0``): context-parallel training, which would need it at a
shard's rows, is ROADMAP queue 1 item 2.
"""
from __future__ import annotations

import ctypes
import functools
import heapq

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_plain, attention_plain_bwd

KERNEL = "flash_attention"
KERNEL_BWD = "flash_attention_bwd"
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# q, k, v, out, lse, B, Sq, Skv, q_off, Hq, Hkv, D, 3 strides (batch, seq,
# head) for each of q, k, v, scale, causal, window, softcap, stream
_SIG = (_P, _P, _P, _P, _P, *([_I] * 7), *([_I64] * 9), _F, _I, _I, _F, _P)
_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_SIGNATURES = {name: _SIG for name in _ENTRY.values()}
# q, k, v, out, dout, lse, delta, dq, dk_part, dv_part, dk, dv, B, S, Hq,
# Hkv, D, groups, scale, causal, window, bf16_io, stream
_BWD_SIG = (*([_P] * 12), *([_I] * 6), _F, _I, _I, _I, _P)
#: the backward's kernels, one launch each per call, in order
BWD_ENTRIES = ("flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
               "flash_attention_bwd_dq", "flash_attention_bwd_reduce")
_BWD_SIGNATURES = {name: _BWD_SIG for name in BWD_ENTRIES}
HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = (16, 32, 64, 128)
#: what the gradient lacks for Gemma-2's training (head dim 256, a softcap)
GEMMA_TRAIN = "ROADMAP queue 1 item 2 (Gemma-2's training)"
# the backward's dK / dV kernel: keys per block and query rows per ring
# stage (its bf16 rows of D and lse are padded to the stage), and what a
# block costs beside its stages (loading K / V, writing its partials), in
# stages of one head
BWD_KEY_TILE, BWD_ROW_TILE, BWD_BLOCK_COST = 128, 64, 3

_SELF_ONLY = (f"{KERNEL}: the gradient is self-attention only (Sq == Skv, q_offset 0); "
              "context-parallel training, which needs it at a shard's rows, is ROADMAP "
              "queue 1 item 2")

__all__ = ["KERNEL", "KERNEL_BWD", "BWD_ENTRIES", "HEAD_DIMS", "BWD_HEAD_DIMS", "flash_attention",
           "flash_attention_bwd", "attention_plain", "attention_plain_bwd"]


def _check(q, k, v, window: int = 0, q_offset: int = 0):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{KERNEL}: expected q [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    (B, Sq, Hq, D), (Skv, Hkv) = q.shape, k.shape[1:3]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"{KERNEL}: q {tuple(q.shape)} and k/v {tuple(k.shape)} need "
                         "the same B and D, and Hq a multiple of Hkv")
    if q_offset < 0:
        raise ValueError(f"{KERNEL}: q_offset {q_offset} is negative")
    if window > 0 and q_offset + Sq - window >= Skv:
        raise ValueError(f"{KERNEL}: window {window} leaves query rows without a key "
                         f"(rows at {q_offset} .. {q_offset + Sq - 1}, keys 0 .. {Skv - 1})")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{KERNEL}: q on {q.device}, k on {k.device}, v on {v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{KERNEL}: dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")


def _entry(q):
    entry = _ENTRY.get(q.dtype)
    if entry is None:
        raise TypeError(f"{KERNEL}: dtype {q.dtype} is not float32 or bfloat16")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head dim {q.shape[3]} not in {HEAD_DIMS}")
    return entry


def _launch(q, k, v, scale, causal, window, softcap, with_lse=False, q_offset=0):
    """-> out, or (out, lse [B, Hq, Sq] fp32) if ``with_lse``."""
    entry = _entry(q)
    (B, Sq, Hq, D), (Skv, Hkv) = q.shape, k.shape[1:3]
    # TMA tensor maps (bf16) and 16-byte loads (fp32): last dim contiguous,
    # strides and base addresses 16-byte aligned
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{KERNEL}: {name} strides {t.stride()} are not 16-byte "
                             "rows with a contiguous last dimension")
    out = torch.empty(B, Sq, Hq, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device) if with_lse else None
    lib = build.load(KERNEL, _SIGNATURES)
    code = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B, Sq, Skv, int(q_offset), Hq, Hkv, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(causal), int(window), float(softcap or 0.0), build.stream_of(q))
    build.check(lib, code, entry)
    build.count_launch(KERNEL)
    return (out, lse) if with_lse else out


def _dkdv_stages(S: int, causal: bool, window: int) -> list:
    """Query-row stages that each key tile of the dK / dV kernel walks per
    head: the rows that the causal mask / window leave non-empty for its
    keys, as the kernel enumerates them."""
    out = []
    for k0 in range(0, S, BWD_KEY_TILE):
        lo = k0 if causal else 0
        hi = min(S, k0 + BWD_KEY_TILE - 1 + window) if window > 0 else S
        out.append(-(-hi // BWD_ROW_TILE) - lo // BWD_ROW_TILE)
    return out


def dkdv_schedule(B: int, S: int, Hq: int, Hkv: int, n_sm: int, causal: bool, window: int,
                  groups: int) -> tuple:
    """(end, work) of the dK / dV kernel's blocks at ``groups`` head groups
    in the cost model of :func:`bwd_groups`: when the greedy schedule over
    ``n_sm`` SMs (one block each, in grid order) ends, and the blocks' summed
    cost, both in stages of one head."""
    G = Hq // Hkv
    per = -(-G // groups)
    heads = [min(G, (j + 1) * per) - j * per for j in range(-(-G // per))]
    sms, work = [0] * n_sm, 0
    for n in _dkdv_stages(S, causal, window) * (B * Hkv):
        for h in heads:
            heapq.heapreplace(sms, sms[0] + h * n + BWD_BLOCK_COST)
            work += h * n + BWD_BLOCK_COST
    return max(sms), work


@functools.lru_cache(maxsize=256)
def bwd_groups(B: int, S: int, Hq: int, Hkv: int, n_sm: int, causal: bool = True,
               window: int = 0) -> int:
    """Groups of the query heads that share a KV head, one block of the dK /
    dV kernel each per key tile.  The blocks run one per SM and are
    dispatched in grid order (every group of key tile 0, then of tile 1,
    ...: the heaviest first under the causal mask); a block costs its heads
    times its query stages plus ``BWD_BLOCK_COST``.  Returns the group count
    whose greedy schedule of the blocks over ``n_sm`` SMs ends first
    (:func:`dkdv_schedule`; the fewest groups among equals); no group is
    empty."""
    if -(-S // BWD_KEY_TILE) * B * Hkv >= 8 * n_sm:     # eight waves unsplit: no split pays
        return 1
    G = Hq // Hkv
    return min(sorted({-(-G // per) for per in range(1, G + 1)}),
               key=lambda groups: dkdv_schedule(B, S, Hq, Hkv, n_sm, causal, window, groups)[0])


def _dense(t):
    """``t`` contiguous with a 16-byte aligned base (a copy if not)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_bwd_head_dim(D: int):
    if D not in BWD_HEAD_DIMS:
        raise NotImplementedError(f"{KERNEL_BWD}: head dim {D} not in {BWD_HEAD_DIMS}; kernel "
                                  f"6b at head dim 256 comes with {GEMMA_TRAIN}")


def _launch_bwd(q, k, v, out, lse, dout, scale, causal, window):
    _entry(q)
    _check_bwd_head_dim(q.shape[3])
    q, k, v, out, dout = (_dense(t) for t in (q, k, v, out, dout.to(q.dtype)))
    (B, S, Hq, D), Hkv = q.shape, k.shape[2]
    dev = q.device
    groups = bwd_groups(B, S, Hq, Hkv, torch.cuda.get_device_properties(dev)
                        .multi_processor_count, causal, window)
    # D per row [B, Hq, S]; bf16: D and lse * log2(e), [2, B, Hq, Sp] with
    # the rows padded to whole stages of the dK / dV kernel
    Sp = -(-S // BWD_ROW_TILE) * BWD_ROW_TILE
    delta = torch.empty(2, B, Hq, Sp, dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(k)
    dk_part = torch.empty(groups, B, S, Hkv, D, dtype=torch.float32, device=dev)
    dv_part = torch.empty_like(dk_part)
    lib = build.load(KERNEL_BWD, _BWD_SIGNATURES)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk_part.data_ptr(), dv_part.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, Hq, Hkv, D, groups, scale, int(causal), int(window),
            int(q.dtype == torch.bfloat16), build.stream_of(q))
    for entry in BWD_ENTRIES:
        build.check(lib, getattr(lib, entry)(*args), entry)
        build.count_launch(KERNEL_BWD)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, scale: float, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` from its inputs, its output,
    the row log-sum-exp ``lse`` [B, Hq, S] of its forward and the output's
    cotangent ``dout``: kernel 6b on CUDA tensors, :func:`attention_plain_bwd`
    on CPU tensors.  Self-attention only (module docstring)."""
    if k.shape[1] != q.shape[1]:
        raise NotImplementedError(_SELF_ONLY)
    if q.device.type == "cpu":
        return attention_plain_bwd(q, k, v, out, lse, dout, scale=scale, causal=causal,
                                   window=window)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL_BWD}: tensors on {q.device}, expected cpu or cuda")
    return _launch_bwd(q, k, v, out, lse, dout, scale, causal, max(int(window), 0))


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward, saving its row log-sum-exp, and kernel 6b."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        if q.device.type == "cpu":
            out, lse = attention_plain(q, k, v, scale=scale, causal=causal, window=window,
                                       return_lse=True)
        else:
            out, lse = _launch(q, k, v, scale, causal, window, None, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(scale=scale, causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
                    softcap: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention: scale, tanh ``softcap`` (None: off), the
    causal mask and a sliding ``window`` (``0 <= qpos - kpos < window``
    when ``window > 0``), query row ``r`` at ``qpos = q_offset + r``.  See
    the module docstring for the layout and the gradient."""
    window, q_offset = max(int(window), 0), int(q_offset)
    _check(q, k, v, window, q_offset)
    if softcap is not None and softcap < 0:
        raise ValueError(f"{KERNEL}: softcap {softcap} must be positive (or None)")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{KERNEL}: tensors on {q.device}, expected cpu or cuda")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if softcap is not None:
            raise NotImplementedError(f"{KERNEL}: no gradient through a softcap yet; it "
                                      f"comes with {GEMMA_TRAIN}")
        if k.shape[1] != q.shape[1] or q_offset:
            raise NotImplementedError(_SELF_ONLY)
        if q.device.type == "cuda":
            _check_bwd_head_dim(q.shape[3])
        return _FlashAttention.apply(q, k, v, scale, causal, window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)
    return _launch(q, k, v, scale, causal, window, softcap, q_offset=q_offset)
