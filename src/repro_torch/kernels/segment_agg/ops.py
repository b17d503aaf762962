"""Fused NMP edge-MLP + aggregation (Eq. 4a + 4b): host layout, the CUDA
kernel's wrapper, and its plain PyTorch version.

Port of ``repro.kernels.segment_agg.ops`` (``compact_gather_layout`` and
``fused_nmp_edge_agg``), forward only; the backward kernel comes with
training in a later slice.

* ``compact_gather_layout`` — host numpy, equal to the reference's layout
  (edges sorted by destination, flat ``[n_tiles, block_e]`` tiles of the
  original edge id and the src/dst node ids) plus ``rowptr``, each node's
  run of slots, which the CUDA kernel reduces in slot order.
* ``fused_nmp_edge_agg`` — the wrapper: on a CUDA tensor it launches the
  hand-written kernel ``csrc/nmp_fwd.cu`` (or raises); on a CPU tensor it
  runs :func:`fused_nmp_edge_agg_plain`.  There is no other fallback.
* ``fused_nmp_edge_agg_plain`` — the same function in plain PyTorch, used
  by the CPU tests and by ``chip_smoke.py`` to check the kernel on the card.
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
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"nmp_edge_mlp_agg_fwd_f32": (_P,) * 15 + (_I,) * 4 + (_P,)}
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
    node ids (0 on padding).  ``rowptr[n] .. rowptr[n + 1]`` are node n's
    slots (port-only key).

    Returns {perm [T, BE] int32, src [T, BE] int32, dst [T, BE] int32,
             rowptr [n_nodes + 1] int32, n_tiles, block_e, n_edges}.
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
    return dict(perm=perm.reshape(nt, block_e),
                src=src_t.reshape(nt, block_e),
                dst=dst_t.reshape(nt, block_e),
                rowptr=rowptr, n_tiles=nt, block_e=int(block_e),
                n_edges=n_real)


# ---------------------------------------------------------------------------
# kernel operands
# ---------------------------------------------------------------------------

def _stack_edge_mlp(params) -> Tuple[torch.Tensor, ...]:
    """``nn.mlp`` params -> contiguous kernel operands (w0 [3H,H], b0 [H],
    wrest [max(Lp,1),H,H], brest [max(Lp,1),H], lng [H], lnb [H]) plus
    (n_hidden, has_ln).  A single-layer MLP gets a zero dummy hidden stack;
    an MLP without LayerNorm gets ones/zeros that the kernel skips."""
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


# ---------------------------------------------------------------------------
# plain version and wrapper
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


def fused_nmp_edge_agg(x, e, edge_params, seg_perm, seg_src, seg_rowptr,
                       edge_mask, edge_inv_mult):
    """Fused Eq. 4a + 4b (edge MLP -> 1/d_ij-weighted aggregate), forward.

    Args:
      x: [N_pad, H] node features; e: [E_pad, H] edge features (original
        edge order); edge_params: ``nn.mlp`` params of the edge MLP (3H in).
      seg_perm / seg_src: [T, BE] (or flat) compact layout
        (``compact_gather_layout``); seg_rowptr: [N_pad + 1] slot offsets,
        which fix each slot's destination node.
      edge_mask / edge_inv_mult: [E_pad].

    CPU tensors run :func:`fused_nmp_edge_agg_plain`; CUDA tensors launch
    ``csrc/nmp_fwd.cu`` (fp32, H in {8, 16, 32}) or raise.

    Returns (e_new [E_pad, H], agg [N_pad, H]).
    """
    n, hid = x.shape
    if edge_params["layers"][0]["w"].shape[0] != 3 * hid:
        raise ValueError(
            f"edge MLP consumes {edge_params['layers'][0]['w'].shape[0]} "
            f"features, expected 3*H = {3 * hid}")
    if x.device.type == "cpu":
        return fused_nmp_edge_agg_plain(x, e, edge_params, seg_perm, seg_src,
                                        seg_rowptr, edge_mask, edge_inv_mult)
    if x.device.type != "cuda":
        raise ValueError(f"fused_nmp_edge_agg: unsupported device {x.device}")
    if hid not in SUPPORTED_HIDDEN:
        raise ValueError(f"fused_nmp_edge_agg: hidden {hid} not in "
                         f"{SUPPORTED_HIDDEN}")
    if seg_rowptr.shape[0] != n + 1:
        raise ValueError(f"seg_rowptr has {seg_rowptr.shape[0]} entries, "
                         f"expected N_pad + 1 = {n + 1}")
    w0, b0, wrest, brest, lng, lnb, n_hidden, has_ln = \
        _stack_edge_mlp(edge_params)
    f32, i32 = torch.float32, torch.int32
    args = (x, e, seg_perm.reshape(-1), seg_src.reshape(-1), seg_rowptr,
            edge_mask, edge_inv_mult, w0, b0, wrest, brest, lng, lnb)
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


__all__ = ["compact_gather_layout", "fused_nmp_edge_agg",
           "fused_nmp_edge_agg_plain"]
