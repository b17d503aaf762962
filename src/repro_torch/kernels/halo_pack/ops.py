"""Packed halo wire ops: the CUDA kernels' wrappers and their plain versions.

Port of ``repro.kernels.halo_pack.ops`` (``halo_pack`` /
``halo_unpack_add``), differentiable:

* ``halo_pack(x, idx, mask)``             -> ``buf = x[idx] * mask[:, None]``
* ``halo_unpack_add(a, buf, idx, mask)``  -> ``a.index_add(0, idx, buf * mask)``

On a CUDA tensor each wrapper launches its kernel in ``csrc/halo_pack.cu``
(or raises); on a CPU tensor it runs the plain version.  Both kernels are
pure data movement and bitwise equal to the plain versions, which are
bitwise equal to ``repro.kernels.halo_pack.ref`` (``tests/test_torch_kernels``).

Each op is the other's adjoint, as in the reference's custom VJPs
(``_pack_core`` / ``_unpack_core``): d pack / d x =
``halo_unpack_add(zeros, g, idx, mask)``, d unpack / d a = g and
d unpack / d buf = ``halo_pack(g, idx, mask)`` — so on CUDA tensors each
backward launches the other op's kernel (and counts that launch).  When no
gradient is needed the wrappers call the op directly: these launches are
host-bound, and the ``autograd.Function`` would add its own host cost.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KERNEL = "halo_pack"
PACK, UNPACK = "halo_pack", "halo_unpack_add"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "halo_pack_f32": (_P,) * 4 + (_I,) * 3 + (_P,),
    "halo_unpack_add_f32": (_P,) * 5 + (_I,) * 3 + (_P,),
}


def halo_pack_plain(x, idx, mask):
    """``buf[i] = x[idx[i]] * mask[i]`` — masked row gather, [W, F]."""
    return x.index_select(0, idx) * mask[:, None]


def halo_unpack_add_plain(a, buf, idx, mask):
    """``out = a.at[idx].add(buf * mask[:, None])`` — masked scatter-add."""
    return a.index_add(0, idx, buf * mask[:, None])


def _check_wire(name, rows, idx, mask):
    if rows.dim() != 2 or idx.dim() != 1 or mask.shape != idx.shape:
        raise ValueError(f"{name}: expected rows [N, F], idx [W], mask [W]; "
                         f"got {tuple(rows.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(mask.shape)}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {rows.device}")


def _pack(x, idx, mask):
    if x.device.type == "cpu":
        return halo_pack_plain(x, idx, mask)
    f32 = torch.float32
    build.require_cuda(PACK, x, idx, mask, dtypes=(f32, torch.int32, f32))
    n, f = x.shape
    w = idx.shape[0]
    buf = torch.empty(w, f, dtype=f32, device=x.device)
    lib = build.load(KERNEL, _SIGNATURES)
    code = lib.halo_pack_f32(x.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                             buf.data_ptr(), w, f, n, build.stream_of(x))
    build.check(lib, code, "halo_pack_f32")
    build.count_launch(PACK)
    return buf


def _unpack_add(a, buf, idx, mask):
    if a.device.type == "cpu":
        return halo_unpack_add_plain(a, buf, idx, mask)
    f32 = torch.float32
    build.require_cuda(UNPACK, a, buf, idx, mask,
                       dtypes=(f32, f32, torch.int32, f32))
    n, f = a.shape
    w = idx.shape[0]
    out = torch.empty_like(a)
    lib = build.load(KERNEL, _SIGNATURES)
    code = lib.halo_unpack_add_f32(a.data_ptr(), buf.data_ptr(), idx.data_ptr(),
                                   mask.data_ptr(), out.data_ptr(), w, f, n,
                                   build.stream_of(a))
    build.check(lib, code, "halo_unpack_add_f32")
    build.count_launch(UNPACK)
    return out


class _Pack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, mask):
        ctx.save_for_backward(idx, mask)
        ctx.n_rows = x.shape[0]
        return _pack(x, idx, mask)

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        g = g.contiguous()
        gx = _unpack_add(g.new_zeros(ctx.n_rows, g.shape[1]), g, idx, mask)
        return gx, None, None


class _UnpackAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, buf, idx, mask):
        ctx.save_for_backward(idx, mask)
        return _unpack_add(a, buf, idx, mask)

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        return g, _pack(g.contiguous(), idx, mask), None, None


def halo_pack(x: torch.Tensor, idx: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Fused masked row gather: ``buf = x[idx] * mask[:, None]``.

    x: [N, F] float32; idx: [W] int32 row ids, unique among slots with a
    non-zero mask (true of every halo round); mask: [W] 0/1 send mask
    (padding slots become zeros).  Returns [W, F]; differentiable in x."""
    _check_wire(PACK, x, idx, mask)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Pack.apply(x, idx, mask)
    return _pack(x, idx, mask)


def halo_unpack_add(a: torch.Tensor, buf: torch.Tensor, idx: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Fused masked scatter-add: ``out = a.at[idx].add(buf * mask[:, None])``.

    a: [N, F] float32 (the combine seed, not modified); buf: [W, F] recv
    buffer; idx: [W] int32 destination rows, unique among slots with a
    non-zero mask (true of every halo round); mask: [W] 0/1 recv mask.
    Returns [N, F]; differentiable in a and buf."""
    _check_wire(UNPACK, a, idx, mask)
    if buf.shape != (idx.shape[0], a.shape[1]):
        raise ValueError(f"{UNPACK}: buf {tuple(buf.shape)} does not match "
                         f"[W, F] = [{idx.shape[0]}, {a.shape[1]}]")
    if torch.is_grad_enabled() and (a.requires_grad or buf.requires_grad):
        return _UnpackAdd.apply(a, buf, idx, mask)
    return _unpack_add(a, buf, idx, mask)
