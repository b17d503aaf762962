"""Fused NMP edge-MLP + aggregation (Eq. 4a + 4b): host layout, the CUDA
kernels' wrappers, their plain PyTorch versions and the autograd op.

Port of ``repro.kernels.segment_agg.ops`` (``compact_gather_layout`` and the
differentiable ``fused_nmp_edge_agg``):

* ``compact_gather_layout`` — host numpy, equal to the reference's layout
  (edges sorted by destination, flat ``[n_tiles, block_e]`` tiles of the
  original edge id and the src/dst node ids) plus three port-only keys:
  ``rowptr`` (each node's run of dst-sorted slots, which the kernels reduce
  in slot order), and the src-sorted companion ``src_slots`` /
  ``src_rowptr`` (each node's outgoing slots), over which the backward
  kernel reduces the source-row gradients.
* ``fused_nmp_edge_agg`` — the differentiable op (a ``torch.autograd.
  Function``, counterpart of the reference's ``_nmp_core`` custom VJP): on
  CUDA tensors its forward launches ``csrc/nmp_fwd.cu`` and its backward
  ``csrc/nmp_bwd.cu`` (or raise); on CPU tensors both run the plain
  versions.  There is no other fallback.
* ``fused_nmp_edge_agg_plain`` / ``fused_nmp_edge_agg_bwd_plain`` — the
  same functions in plain PyTorch, used by the CPU tests and by
  ``chip_smoke.py`` to check the kernels on the card;
  ``fused_nmp_edge_agg_bwd`` is the backward's wrapper on its own.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.kernels import build

KERNEL = "nmp_fwd"
KERNEL_BWD = "nmp_bwd"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"nmp_edge_mlp_agg_fwd_f32": (_P,) * 15 + (_I,) * 4 + (_P,)}
_SIGNATURES_BWD = {
    "nmp_edge_mlp_agg_bwd_groups": (_I, _I, _I, ctypes.POINTER(ctypes.c_int)),
    "nmp_edge_mlp_agg_bwd_f32": (_P,) * 22 + (_I,) * 5 + (_P,),
}
SUPPORTED_HIDDEN = (8, 16, 32)


# ---------------------------------------------------------------------------
# layout pass (host)
# ---------------------------------------------------------------------------

def compact_gather_layout(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                          block_e: int) -> dict:
    """Compact per-tile gather/scatter index lists.

    Edges are sorted by destination (stable) and chopped into flat
    ``[n_tiles, block_e]`` tiles; edges with ``dst`` outside
    ``[0, n_nodes)`` (padding edges routed to a sentinel) are dropped.  Per
    slot: original edge id (``perm``, -1 on the tail padding) and src/dst
    node ids (0 on padding).  Port-only keys: ``rowptr[n] .. rowptr[n + 1]``
    are node n's slots; ``src_slots`` lists the real slots stably sorted by
    source node, and ``src_slots[src_rowptr[n] .. src_rowptr[n + 1]]`` are
    node n's outgoing slots.

    Returns {perm [T, BE] int32, src [T, BE] int32, dst [T, BE] int32,
             rowptr [n_nodes + 1] int32, src_slots [n_edges] int32,
             src_rowptr [n_nodes + 1] int32, n_tiles, block_e, n_edges}.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = np.nonzero((dst >= 0) & (dst < n_nodes))[0]
    order = keep[np.argsort(dst[keep], kind="stable")]
    n_real = int(order.size)
    nt = max(1, math.ceil(n_real / block_e))
    perm = np.full(nt * block_e, -1, dtype=np.int32)
    perm[:n_real] = order
    valid = perm >= 0
    safe = np.clip(perm, 0, None)
    src_t = np.where(valid, src[safe], 0).astype(np.int32)
    dst_t = np.where(valid, dst[safe], 0).astype(np.int32)
    rowptr = np.searchsorted(dst[order], np.arange(n_nodes + 1),
                             side="left").astype(np.int32)
    src_slots = np.argsort(src_t[:n_real], kind="stable")
    src_rowptr = np.searchsorted(src_t[:n_real][src_slots],
                                 np.arange(n_nodes + 1), side="left")
    return dict(perm=perm.reshape(nt, block_e),
                src=src_t.reshape(nt, block_e),
                dst=dst_t.reshape(nt, block_e),
                rowptr=rowptr, src_slots=src_slots.astype(np.int32),
                src_rowptr=src_rowptr.astype(np.int32), n_tiles=nt,
                block_e=int(block_e), n_edges=n_real)


# ---------------------------------------------------------------------------
# kernel operands
# ---------------------------------------------------------------------------

def _stack_edge_mlp(params) -> Tuple[torch.Tensor, ...]:
    """``nn.mlp`` params -> contiguous kernel operands (w0 [3H,H], b0 [H],
    wrest [max(Lp,1),H,H], brest [max(Lp,1),H], lng [H], lnb [H]) plus
    (n_hidden, has_ln).  A single-layer MLP gets a zero dummy hidden stack;
    an MLP without LayerNorm gets ones/zeros that the kernels skip.  The
    stacking is differentiable, so gradients of the stacked operands reach
    the leaves of ``params``."""
    layers = params["layers"]
    w0 = layers[0]["w"]
    hid = w0.shape[1]
    if len(layers) > 1:
        wrest = torch.stack([l["w"] for l in layers[1:]])
        brest = torch.stack([l["b"] for l in layers[1:]])
    else:
        wrest = w0.new_zeros((1, hid, hid))
        brest = w0.new_zeros((1, hid))
    ln = params.get("ln")
    lng = ln["g"] if ln is not None else w0.new_ones(hid)
    lnb = ln["b"] if ln is not None else w0.new_zeros(hid)
    ops = tuple(t.contiguous() for t in
                (w0, layers[0]["b"], wrest, brest, lng, lnb))
    return ops + (len(layers) - 1, ln is not None)


def _unstack_edge_mlp(w0, b0, wrest, brest, lng, lnb, n_hidden, has_ln):
    """Inverse of :func:`_stack_edge_mlp`: the ``nn.mlp`` params over views
    of the stacked operands."""
    layers = [{"w": w0, "b": b0}] + [{"w": wrest[l], "b": brest[l]}
                                     for l in range(n_hidden)]
    params = {"layers": layers}
    if has_ln:
        params["ln"] = {"g": lng, "b": lnb}
    return params


def _check_hidden(edge_params, hid):
    if edge_params["layers"][0]["w"].shape[0] != 3 * hid:
        raise ValueError(
            f"edge MLP consumes {edge_params['layers'][0]['w'].shape[0]} "
            f"features, expected 3*H = {3 * hid}")


def _check_cuda(name, x, hid, n, seg_rowptr):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if hid not in SUPPORTED_HIDDEN:
        raise ValueError(f"{name}: hidden {hid} not in {SUPPORTED_HIDDEN}")
    if seg_rowptr.shape[0] != n + 1:
        raise ValueError(f"seg_rowptr has {seg_rowptr.shape[0]} entries, "
                         f"expected N_pad + 1 = {n + 1}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_nmp_edge_agg_plain(x, e, edge_params, seg_perm, seg_src,
                             seg_rowptr, edge_mask, edge_inv_mult):
    """Plain PyTorch Eq. 4a + 4b over the compact layout, on the operands the
    kernel takes (each slot's destination node comes from ``seg_rowptr``).

    Returns (e_new [E, H] == (e + MLP([x_src, x_dst, e])) * mask on the
    layout's edges and 0 elsewhere, agg [N, H] == segment sum of
    e_new * 1/d_ij over dst)."""
    n_real = int(seg_rowptr[-1])
    p = seg_perm.reshape(-1)[:n_real].long()
    s = seg_src.reshape(-1)[:n_real].long()
    d = torch.repeat_interleave(torch.arange(x.shape[0], device=x.device),
                                seg_rowptr.diff().long())
    feats = torch.cat([x[s], x[d], e[p]], dim=-1)
    en = (e[p] + nn.mlp(edge_params, feats)) * edge_mask[p][:, None]
    e_new = torch.zeros(e.shape[0], x.shape[1], dtype=x.dtype, device=x.device)
    e_new[p] = en
    agg = torch.zeros_like(x).index_add_(0, d, en * edge_inv_mult[p][:, None])
    return e_new, agg


def _bwd_plain_stacked(x, e, ops, n_hidden, has_ln, seg_perm, seg_src,
                       seg_rowptr, edge_mask, edge_inv_mult, g_enew, g_agg):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, e) + tuple(ops)]
        params = _unstack_edge_mlp(*leaves[2:], n_hidden, has_ln)
        e_new, agg = fused_nmp_edge_agg_plain(
            leaves[0], leaves[1], params, seg_perm, seg_src, seg_rowptr,
            edge_mask, edge_inv_mult)
        grads = torch.autograd.grad((e_new, agg), leaves, (g_enew, g_agg),
                                    allow_unused=True)
    return tuple(torch.zeros_like(l) if g is None else g
                 for g, l in zip(grads, leaves))


def fused_nmp_edge_agg_bwd_plain(x, e, edge_params, seg_perm, seg_src,
                                 seg_rowptr, edge_mask, edge_inv_mult,
                                 g_enew, g_agg):
    """Plain VJP of :func:`fused_nmp_edge_agg_plain` (``torch.autograd.grad``
    through it) for the cotangents (g_enew [E, H], g_agg [N, H]).

    Returns (g_x [N, H], g_e [E, H], g_w0 [3H, H], g_b0 [H],
    g_wrest [max(Lp,1), H, H], g_brest [max(Lp,1), H], g_lng [H],
    g_lnb [H]) — gradients of the stacked operands of
    :func:`_stack_edge_mlp` (zeros for the dummy hidden stack and for an
    absent LayerNorm)."""
    *ops, n_hidden, has_ln = _stack_edge_mlp(edge_params)
    return _bwd_plain_stacked(x, e, ops, n_hidden, has_ln, seg_perm, seg_src,
                              seg_rowptr, edge_mask, edge_inv_mult, g_enew,
                              g_agg)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _fwd(x, e, ops, n_hidden, has_ln, seg_perm, seg_src, seg_rowptr,
         edge_mask, edge_inv_mult):
    """Forward on stacked operands: plain on CPU, ``nmp_fwd`` on CUDA."""
    n, hid = x.shape
    if x.device.type == "cpu":
        return fused_nmp_edge_agg_plain(
            x, e, _unstack_edge_mlp(*ops, n_hidden, has_ln), seg_perm,
            seg_src, seg_rowptr, edge_mask, edge_inv_mult)
    _check_cuda("fused_nmp_edge_agg", x, hid, n, seg_rowptr)
    f32, i32 = torch.float32, torch.int32
    args = (x, e, seg_perm.reshape(-1), seg_src.reshape(-1), seg_rowptr,
            edge_mask, edge_inv_mult, *ops)
    build.require_cuda("fused_nmp_edge_agg", *args,
                       dtypes=(f32, f32, i32, i32, i32) + (f32,) * 8)
    e_new = torch.zeros(e.shape[0], hid, dtype=f32, device=x.device)
    agg = torch.empty(n, hid, dtype=f32, device=x.device)
    lib = build.load(KERNEL, _SIGNATURES)
    code = lib.nmp_edge_mlp_agg_fwd_f32(
        *(t.data_ptr() for t in args), e_new.data_ptr(), agg.data_ptr(),
        n, hid, n_hidden, int(has_ln), build.stream_of(x))
    build.check(lib, code, "nmp_edge_mlp_agg_fwd_f32")
    build.count_launch(KERNEL)
    return e_new, agg


def _bwd(x, e, ops, n_hidden, has_ln, seg_perm, seg_src, seg_rowptr,
         seg_src_slots, seg_src_rowptr, edge_mask, edge_inv_mult, g_enew,
         g_agg):
    """Backward on stacked operands: plain on CPU, ``nmp_bwd`` on CUDA."""
    n, hid = x.shape
    if x.device.type == "cpu":
        return _bwd_plain_stacked(x, e, ops, n_hidden, has_ln, seg_perm,
                                  seg_src, seg_rowptr, edge_mask,
                                  edge_inv_mult, g_enew, g_agg)
    _check_cuda("fused_nmp_edge_agg_bwd", x, hid, n, seg_rowptr)
    if seg_src_slots is None or seg_src_rowptr is None:
        raise ValueError(
            "fused_nmp_edge_agg_bwd needs the src-sorted layout "
            "(seg_src_slots / seg_src_rowptr; ShardedGraph.build with a "
            "fused plan attaches it)")
    if seg_src_rowptr.shape[0] != n + 1:
        raise ValueError(f"seg_src_rowptr has {seg_src_rowptr.shape[0]} "
                         f"entries, expected N_pad + 1 = {n + 1}")
    if g_enew.shape != (e.shape[0], hid) or g_agg.shape != x.shape:
        raise ValueError(f"cotangents {tuple(g_enew.shape)}, {tuple(g_agg.shape)} "
                         f"do not match e_new [{e.shape[0]}, {hid}] and agg "
                         f"{tuple(x.shape)}")
    f32, i32 = torch.float32, torch.int32
    g_enew, g_agg = g_enew.contiguous(), g_agg.contiguous()
    perm = seg_perm.reshape(-1)
    args = (x, e, perm, seg_src.reshape(-1), seg_rowptr, seg_src_slots,
            seg_src_rowptr, edge_mask, edge_inv_mult, *ops, g_enew, g_agg)
    build.require_cuda("fused_nmp_edge_agg_bwd", *args,
                       dtypes=(f32, f32) + (i32,) * 5 + (f32,) * 10)
    lib = build.load(KERNEL_BWD, _SIGNATURES_BWD)
    groups = ctypes.c_int(0)
    code = lib.nmp_edge_mlp_agg_bwd_groups(hid, n_hidden, n, ctypes.byref(groups))
    build.check(lib, code, "nmp_edge_mlp_agg_bwd_groups")
    lp = ops[2].shape[0]
    sizes = (3 * hid * hid, hid, lp * hid * hid, lp * hid, hid, hid)
    wsize = sum(sizes)
    dev = x.device
    gx = torch.empty(n, hid, dtype=f32, device=dev)
    ge = torch.zeros(e.shape[0], hid, dtype=f32, device=dev)
    gw = torch.empty(wsize, dtype=f32, device=dev)
    gxi_slot = torch.empty(perm.shape[0], hid, dtype=f32, device=dev)
    partials = torch.empty(groups.value, wsize, dtype=f32, device=dev)
    code = lib.nmp_edge_mlp_agg_bwd_f32(
        *(t.data_ptr() for t in args), gx.data_ptr(), ge.data_ptr(),
        gw.data_ptr(), gxi_slot.data_ptr(), partials.data_ptr(),
        n, hid, n_hidden, int(has_ln), groups.value, build.stream_of(x))
    build.check(lib, code, "nmp_edge_mlp_agg_bwd_f32")
    build.count_launch(KERNEL_BWD)
    gw0, gb0, gwr, gbr, glng, glnb = torch.split(gw, sizes)
    return (gx, ge, gw0.view(3 * hid, hid), gb0, gwr.view(lp, hid, hid),
            gbr.view(lp, hid), glng, glnb)


class _FusedNMP(torch.autograd.Function):
    """Counterpart of the reference's ``_nmp_core`` custom VJP: the forward
    and backward kernels (plain versions on CPU tensors).  The backward
    returns None for the layout, the mask and the inverse multiplicities,
    as the reference's VJP returns zeros for them."""

    @staticmethod
    def forward(ctx, save, n_hidden, has_ln, x, e, w0, b0, wrest, brest, lng,
                lnb, perm, src, rowptr, src_slots, src_rowptr, emask, einv):
        ops = (w0, b0, wrest, brest, lng, lnb)
        out = _fwd(x, e, ops, n_hidden, has_ln, perm, src, rowptr, emask, einv)
        if save:
            ctx.save_for_backward(x, e, *ops, perm, src, rowptr, src_slots,
                                  src_rowptr, emask, einv)
        ctx.static = (n_hidden, has_ln)
        return out

    @staticmethod
    def backward(ctx, g_enew, g_agg):
        x, e, *rest = ctx.saved_tensors
        grads = _bwd(x, e, tuple(rest[:6]), *ctx.static, *rest[6:],
                     g_enew, g_agg)
        return (None, None, None) + tuple(grads) + (None,) * 7


def fused_nmp_edge_agg(x, e, edge_params, seg_perm, seg_src, seg_rowptr,
                       edge_mask, edge_inv_mult, *, seg_src_slots=None,
                       seg_src_rowptr=None):
    """Fused, differentiable Eq. 4a + 4b (edge MLP -> 1/d_ij-weighted
    aggregate).

    Args:
      x: [N_pad, H] node features; e: [E_pad, H] edge features (original
        edge order); edge_params: ``nn.mlp`` params of the edge MLP (3H in).
      seg_perm / seg_src: [T, BE] (or flat) compact layout
        (``compact_gather_layout``); seg_rowptr: [N_pad + 1] slot offsets,
        which fix each slot's destination node.
      edge_mask / edge_inv_mult: [E_pad].
      seg_src_slots / seg_src_rowptr: the src-sorted companion layout; the
        CUDA backward needs it (the forward does not).

    CPU tensors run the plain forward and backward; CUDA tensors launch
    ``csrc/nmp_fwd.cu`` and, in the backward, ``csrc/nmp_bwd.cu`` (fp32,
    H in {8, 16, 32}) or raise.  Tensors are saved for the backward only
    when grad is enabled and an input requires it.

    Returns (e_new [E_pad, H], agg [N_pad, H]).
    """
    _check_hidden(edge_params, x.shape[1])
    *ops, n_hidden, has_ln = _stack_edge_mlp(edge_params)
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, e, *ops))
    return _FusedNMP.apply(save, n_hidden, has_ln, x, e, *ops, seg_perm,
                           seg_src, seg_rowptr, seg_src_slots, seg_src_rowptr,
                           edge_mask, edge_inv_mult)


def fused_nmp_edge_agg_bwd(x, e, edge_params, seg_perm, seg_src, seg_rowptr,
                           seg_src_slots, seg_src_rowptr, edge_mask,
                           edge_inv_mult, g_enew, g_agg):
    """The backward on its own: VJP of :func:`fused_nmp_edge_agg` for the
    cotangents (g_enew [E_pad, H], g_agg [N_pad, H]).  CPU tensors run
    :func:`fused_nmp_edge_agg_bwd_plain`; CUDA tensors launch
    ``csrc/nmp_bwd.cu`` or raise.  Returns the tuple of
    :func:`fused_nmp_edge_agg_bwd_plain`."""
    _check_hidden(edge_params, x.shape[1])
    *ops, n_hidden, has_ln = _stack_edge_mlp(edge_params)
    return _bwd(x, e, tuple(ops), n_hidden, has_ln, seg_perm, seg_src,
                seg_rowptr, seg_src_slots, seg_src_rowptr, edge_mask,
                edge_inv_mult, g_enew, g_agg)


__all__ = ["compact_gather_layout", "fused_nmp_edge_agg",
           "fused_nmp_edge_agg_bwd", "fused_nmp_edge_agg_bwd_plain",
           "fused_nmp_edge_agg_plain"]
