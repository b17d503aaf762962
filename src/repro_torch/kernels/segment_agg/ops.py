"""Fused edge-MLP + aggregation: host layouts, the CUDA kernels' wrappers,
their plain PyTorch versions and the autograd op.

Port of ``repro.kernels.segment_agg.ops``.  The NMP pair (Eq. 4a + 4b,
``compact_gather_layout`` and the differentiable ``fused_nmp_edge_agg``):

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
  ``csrc/nmp_bwd.cu`` at the tuned widths H in {8, 16, 32} (the backward
  at most 5 hidden layers), and ``csrc/nmp_any.cu``'s entries at every
  other fp32 shape (any H >= 1, any depth; counted apart as
  ``nmp_fwd_any`` / ``nmp_bwd_any``; :func:`any_route` sends H >= 64
  with H % 4 == 0 to their tensor-core route, which launches the per-node
  pass ``node_dst_product`` first, counted as ``nmp_dst_any``), or raise;
  on CPU tensors both run the plain versions.  There is no other
  fallback.  ``precision`` is the reference's policy: ``"fp32"``, or
  ``"bf16"`` (every edge-MLP product on
  bf16-rounded operands, accumulated in fp32; ``csrc/nmp_bf16.cu``'s
  entries at the tuned widths, counted apart as ``nmp_fwd_bf16`` /
  ``nmp_bwd_bf16``, which raise at any other shape: ROADMAP queue 2);
  anything else raises.
* ``fused_nmp_edge_agg_plain`` / ``fused_nmp_edge_agg_bwd_plain`` — the
  same functions in plain PyTorch, used by the CPU tests and by
  ``chip_smoke.py`` to check the kernels on the card;
  ``fused_nmp_edge_agg_bwd`` is the backward's wrapper on its own.

The legacy forward-only op over pre-gathered ``[E, Fin]`` features
(``dst_aligned_layout`` and ``fused_edge_mlp_agg``):

* ``dst_aligned_layout`` — host numpy, array-equal to the reference's
  (per node block, the edges whose destination lies in it, padded to
  whole edge tiles).
* ``edge_mlp_agg`` — the tile-level wrapper: on CUDA tensors it launches
  ``csrc/edge_mlp_agg.cu`` (or raises), on CPU tensors it runs
  ``edge_mlp_agg_plain``, the same function in plain PyTorch.
* ``fused_edge_mlp_agg`` — gathers the tiles through the layout, runs
  ``edge_mlp_agg`` and puts ``e_new`` back in the original edge order.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.graph.segment import segment_sum
from repro_torch.kernels import build

KERNEL = "nmp_fwd"
KERNEL_BWD = "nmp_bwd"
#: the bf16 entries' launch counters, apart from the fp32 ones
KERNEL_BF16 = "nmp_fwd_bf16"
KERNEL_BWD_BF16 = "nmp_bwd_bf16"
#: the generic-width entries' launch counters (``csrc/nmp_any.cu``)
KERNEL_ANY = "nmp_fwd_any"
KERNEL_BWD_ANY = "nmp_bwd_any"
#: the tensor-core route's per-node pass x w0_dst (``csrc/nmp_any.cu``
#: ``nmp_node_dst_f32``), launched once before each of its forwards and
#: backwards
KERNEL_DST = "nmp_dst_any"
#: the generic pair's two routes: exact fp32 FMAs on the CUDA cores, and
#: 3xTF32 ``wgmma`` on the tensor cores (:func:`any_route` picks one)
FMA, TC = "fma", "tc"
ROUTES = (FMA, TC)
#: the library of the generic-width entries
LIB_ANY = "nmp_any"
FP32, BF16, PRECISIONS = nn.FP32, nn.BF16, nn.PRECISIONS
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "nmp_edge_mlp_agg_fwd_plan": (_I, _I, _L, ctypes.POINTER(ctypes.c_int)),
    # 13 operands, e_new, agg, scratch tile_lo / partials / covered; N,
    # slots, edges, H, Lp, has_ln, stream
    "nmp_edge_mlp_agg_fwd_f32": (_P,) * 18 + (_I, _L, _L) + (_I,) * 3 + (_P,),
}
_SIGNATURES_BWD = {
    "nmp_edge_mlp_agg_bwd_plan": (_I, _I, _L, ctypes.POINTER(ctypes.c_int)),
    # 17 operands, gx, ge, gw, scratch g_z0 / slot_dst / partials; N, slots,
    # H, Lp, has_ln, partial rows, stream
    "nmp_edge_mlp_agg_bwd_f32": (_P,) * 23 + (_I, _L) + (_I,) * 4 + (_P,),
}
#: the library of the bf16 entries (``csrc/nmp_bf16.cu``)
LIB_BF16 = "nmp_bf16"
_SIGNATURES_BF16 = {
    "nmp_edge_mlp_agg_fwd_bf16_plan": (_I, _I, _L, ctypes.POINTER(ctypes.c_int)),
    # as nmp_edge_mlp_agg_fwd_f32
    "nmp_edge_mlp_agg_fwd_bf16": (_P,) * 18 + (_I, _L, _L) + (_I,) * 3 + (_P,),
    "nmp_edge_mlp_agg_bwd_bf16_plan": (_I, _I, _L, ctypes.POINTER(ctypes.c_int)),
    # 17 operands, gx, ge, gw, scratch tile_lo / partials / the slots' x_src
    # gradients (bf16) / covered / weight-gradient partials; N, slots,
    # edges, H, Lp, has_ln, partial rows, stream
    "nmp_edge_mlp_agg_bwd_bf16": (_P,) * 25 + (_I, _L, _L) + (_I,) * 4 + (_P,),
}
_PLAN = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES_ANY = {
    "nmp_edge_mlp_agg_fwd_any_plan": (_I, _I, _L, _PLAN),
    # 13 operands, e_new, agg, scratch tile_lo / partials / work; N, slots,
    # edges, H, Lp, has_ln, stream
    "nmp_edge_mlp_agg_fwd_any_f32": (_P,) * 18 + (_I, _L, _L) + (_I,) * 3 + (_P,),
    "nmp_edge_mlp_agg_bwd_any_plan": (_I, _I, _L, _PLAN),
    # 17 operands, gx, ge, gw, scratch g_z0 / slot_dst / node sums /
    # partials / work; N, slots, H, Lp, has_ln, partial rows, stream
    "nmp_edge_mlp_agg_bwd_any_f32": (_P,) * 25 + (_I, _L) + (_I,) * 4 + (_P,),
    # the tensor-core route: kind (0 fwd, 1 bwd, 2 dst), H, Lp, slots, N, plan
    "nmp_any_tc_plan": (_I, _I, _I, _L, _I, _PLAN),
    # x, w0, out, scratch; N, H, stream
    "nmp_node_dst_f32": (_P,) * 4 + (_I, _I, _P),
    # 13 operands, x w0_dst, e_new, agg, scratch; N, slots, edges, H, Lp,
    # has_ln, stream
    "nmp_edge_mlp_agg_fwd_tc_f32": (_P,) * 17 + (_I, _L, _L) + (_I,) * 3 + (_P,),
    # 17 operands, x w0_dst, gx, ge, gw, scratch; N, slots, H, Lp, has_ln,
    # stream
    "nmp_edge_mlp_agg_bwd_tc_f32": (_P,) * 22 + (_I, _L) + (_I,) * 3 + (_P,),
}
#: the widths of the tuned kernels (``csrc/nmp_fwd.cu``, ``csrc/nmp_bwd.cu``
#: and the bf16 pair ``csrc/nmp_bf16.cu``); every other fp32 width runs
#: ``csrc/nmp_any.cu``
SUPPORTED_HIDDEN = (8, 16, 32)
#: hidden layers the tuned backward's register accumulators hold; deeper
#: fp32 MLPs run ``csrc/nmp_any.cu``
MAX_BWD_HIDDEN = 5
#: where the bf16 entries at other shapes are queued
BF16_ANY_ITEM = "ROADMAP.md queue 2 item 1 (bf16 NMP kernels at any width and depth)"
KERNEL_MLP_AGG = "edge_mlp_agg"
_MLP_AGG_ENTRY = {torch.float32: "edge_mlp_agg_f32", torch.bfloat16: "edge_mlp_agg_bf16"}
# feats, dstl, weights, w1, b1, w2, b2, e_new, agg, NB, slots per node
# block, Fin, Hh, H, block_n, stream
_SIGNATURES_MLP_AGG = {name: (_P,) * 9 + (_I,) * 6 + (_P,)
                       for name in _MLP_AGG_ENTRY.values()}
# Fin, block_n, feats' element size, NB, out[5]
_SIGNATURES_MLP_AGG["edge_mlp_agg_plan"] = (_I,) * 4 + (ctypes.POINTER(ctypes.c_int),)
#: what ``csrc/edge_mlp_agg.cu`` takes: Fin, Hh and H, block_n at most
MLP_AGG_MAX_FIN, MLP_AGG_MAX_HIDDEN, MLP_AGG_MAX_BLOCK_N = 128, 32, 256


#: env var overriding the block-size table: "block_n,block_e"
BLOCKS_ENV = "REPRO_SEG_BLOCKS"
#: (max hidden, block_n, block_e) rows by backend, first match wins.  The
#: CPU rows are the reference's.  On a card kernels 1 and 2 walk the
#: compact layout node by node, so the pair does not change their
#: arithmetic; the CUDA row is the pair the measurement of kernel 3 (the
#: dst-aligned op, block_n <= 256, H <= 32) picked at H = 32 among 64/128,
#: 128/256 and 256/256 (PERF.md §6; chip_smoke.py phase 2,
#: ``block_pairs_ms``), applied at every width.
BLOCK_TABLE = {"cpu": ((64, 16, 32), (256, 32, 64), (4096, 32, 32)),
               "cuda": ((4096, 64, 128),)}


def pick_block_sizes(hidden: int, dtype=torch.float32,
                     backend: str | None = None) -> Tuple[int, int]:
    """Static block-size table of the fused NMP kernels (port of
    ``repro.kernels.segment_agg.ops.pick_block_sizes``): ``(block_n,
    block_e)`` keyed on (hidden, dtype, backend), ``backend`` "cpu" or
    "cuda" (default: "cuda" where torch finds a card).  bf16 rows are half
    the bytes, so they go twice as deep.  ``REPRO_SEG_BLOCKS``
    ("block_n,block_e") overrides the table."""
    import os
    override = os.environ.get(BLOCKS_ENV)
    if override:
        bn, be = (int(v) for v in override.split(","))
        return bn, be
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    table = BLOCK_TABLE["cuda" if backend == "cuda" else "cpu"]
    for max_h, bn, be in table:
        if hidden <= max_h:
            break
    if torch.empty((), dtype=dtype).element_size() <= 2:
        be *= 2
    return bn, be


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


def _check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{PRECISIONS}")


#: (C entry, launch counter, C launch-plan entry, library, its signatures)
#: of each tuned NMP kernel at each precision
_ENTRIES = {
    ("fwd", FP32): ("nmp_edge_mlp_agg_fwd_f32", KERNEL, "nmp_edge_mlp_agg_fwd_plan",
                    KERNEL, _SIGNATURES),
    ("fwd", BF16): ("nmp_edge_mlp_agg_fwd_bf16", KERNEL_BF16,
                    "nmp_edge_mlp_agg_fwd_bf16_plan", LIB_BF16, _SIGNATURES_BF16),
    ("bwd", FP32): ("nmp_edge_mlp_agg_bwd_f32", KERNEL_BWD, "nmp_edge_mlp_agg_bwd_plan",
                    KERNEL_BWD, _SIGNATURES_BWD),
    ("bwd", BF16): ("nmp_edge_mlp_agg_bwd_bf16", KERNEL_BWD_BF16,
                    "nmp_edge_mlp_agg_bwd_bf16_plan", LIB_BF16, _SIGNATURES_BF16)}


def _entry(kind, precision):
    """(loaded library, C entry) of the tuned kernel ``kind`` at ``precision``."""
    entry, _, _, lib, sigs = _ENTRIES[kind, precision]
    return build.load(lib, sigs), entry


def entry_counter(kind: str, hidden: int, n_hidden: int, precision: str = FP32) -> str:
    """The launch counter of the kernel that ``kind`` ("fwd" / "bwd") runs
    at this shape and precision on a card: the tuned kernel's where H is in
    :data:`SUPPORTED_HIDDEN` (and, for the backward, at most
    :data:`MAX_BWD_HIDDEN` hidden layers), else the generic entry's; raises
    for bf16 where the tuned kernels do not take the shape."""
    _check_precision(precision)
    if hidden in SUPPORTED_HIDDEN and (kind == "fwd" or n_hidden <= MAX_BWD_HIDDEN):
        return _ENTRIES[kind, precision][1]
    if precision == BF16:
        raise ValueError(
            f"fused_nmp_edge_agg: precision='bf16' at H={hidden} with {n_hidden} hidden "
            f"layers; the bf16 kernels take H in {SUPPORTED_HIDDEN} (the backward at most "
            f"{MAX_BWD_HIDDEN} hidden layers); other shapes are {BF16_ANY_ITEM}")
    return KERNEL_ANY if kind == "fwd" else KERNEL_BWD_ANY


def _check_cuda(name, x, hid, n, seg_rowptr):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if seg_rowptr.shape[0] != n + 1:
        raise ValueError(f"seg_rowptr has {seg_rowptr.shape[0]} entries, "
                         f"expected N_pad + 1 = {n + 1}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_nmp_edge_agg_plain(x, e, edge_params, seg_perm, seg_src,
                             seg_rowptr, edge_mask, edge_inv_mult,
                             precision=FP32):
    """Plain PyTorch Eq. 4a + 4b over the compact layout, on the operands the
    kernel takes (each slot's destination node comes from ``seg_rowptr``),
    the edge MLP under ``precision`` (``nn.mlp``).

    Returns (e_new [E, H] == (e + MLP([x_src, x_dst, e])) * mask on the
    layout's edges and 0 elsewhere, agg [N, H] == segment sum of
    e_new * 1/d_ij over dst)."""
    n_real = int(seg_rowptr[-1])
    p = seg_perm.reshape(-1)[:n_real].long()
    s = seg_src.reshape(-1)[:n_real].long()
    d = torch.repeat_interleave(torch.arange(x.shape[0], device=x.device),
                                seg_rowptr.diff().long())
    feats = torch.cat([x[s], x[d], e[p]], dim=-1)
    en = (e[p] + nn.mlp(edge_params, feats, precision)) * edge_mask[p][:, None]
    e_new = torch.zeros(e.shape[0], x.shape[1], dtype=x.dtype, device=x.device)
    e_new[p] = en
    agg = torch.zeros_like(x).index_add_(0, d, en * edge_inv_mult[p][:, None])
    return e_new, agg


def _bwd_plain_stacked(x, e, ops, n_hidden, has_ln, seg_perm, seg_src,
                       seg_rowptr, edge_mask, edge_inv_mult, g_enew, g_agg,
                       precision=FP32):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, e) + tuple(ops)]
        params = _unstack_edge_mlp(*leaves[2:], n_hidden, has_ln)
        e_new, agg = fused_nmp_edge_agg_plain(
            leaves[0], leaves[1], params, seg_perm, seg_src, seg_rowptr,
            edge_mask, edge_inv_mult, precision)
        grads = torch.autograd.grad((e_new, agg), leaves, (g_enew, g_agg),
                                    allow_unused=True)
    return tuple(torch.zeros_like(l) if g is None else g
                 for g, l in zip(grads, leaves))


def fused_nmp_edge_agg_bwd_plain(x, e, edge_params, seg_perm, seg_src,
                                 seg_rowptr, edge_mask, edge_inv_mult,
                                 g_enew, g_agg, precision=FP32):
    """Plain VJP of :func:`fused_nmp_edge_agg_plain` (``torch.autograd.grad``
    through it) for the cotangents (g_enew [E, H], g_agg [N, H]).  Under
    ``precision="bf16"`` autograd through the operands' casts rounds each
    cast operand's cotangent to bf16, as JAX's VJP of the reference's
    policy does: per element for the inputs, once on each weight's
    gradient summed over every edge.

    Returns (g_x [N, H], g_e [E, H], g_w0 [3H, H], g_b0 [H],
    g_wrest [max(Lp,1), H, H], g_brest [max(Lp,1), H], g_lng [H],
    g_lnb [H]) — gradients of the stacked operands of
    :func:`_stack_edge_mlp` (zeros for the dummy hidden stack and for an
    absent LayerNorm)."""
    *ops, n_hidden, has_ln = _stack_edge_mlp(edge_params)
    return _bwd_plain_stacked(x, e, ops, n_hidden, has_ln, seg_perm, seg_src,
                              seg_rowptr, edge_mask, edge_inv_mult, g_enew,
                              g_agg, precision)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _fwd(x, e, ops, n_hidden, has_ln, seg_perm, seg_src, seg_rowptr,
         edge_mask, edge_inv_mult, precision, route=None):
    """Forward on stacked operands: plain on CPU; on CUDA ``nmp_fwd`` (in
    bf16 ``nmp_bf16``'s forward) at the tuned widths, ``nmp_any``'s forward
    at every other fp32 shape, on ``route`` (:func:`any_route` unless
    given)."""
    n, hid = x.shape
    if x.device.type == "cpu":
        return fused_nmp_edge_agg_plain(
            x, e, _unstack_edge_mlp(*ops, n_hidden, has_ln), seg_perm,
            seg_src, seg_rowptr, edge_mask, edge_inv_mult, precision)
    _check_cuda("fused_nmp_edge_agg", x, hid, n, seg_rowptr)
    counter = entry_counter("fwd", hid, n_hidden, precision)
    f32, i32 = torch.float32, torch.int32
    args = (x, e, seg_perm.reshape(-1), seg_src.reshape(-1), seg_rowptr,
            edge_mask, edge_inv_mult, *ops)
    build.require_cuda("fused_nmp_edge_agg", *args,
                       dtypes=(f32, f32, i32, i32, i32) + (f32,) * 8)
    n_slots = args[2].shape[0]
    dev, n_edges = x.device, e.shape[0]
    e_new = torch.empty(n_edges, hid, dtype=f32, device=dev)
    agg = torch.empty(n, hid, dtype=f32, device=dev)
    if counter == KERNEL_ANY and _route(hid, n_hidden, route) == TC:
        # x_dst w0_dst per node (its own launch), then the edge pass; one
        # scratch buffer that the entry carves
        pdst = node_dst_product(x, ops[0])
        args = (_aligned(x), _aligned(e)) + args[2:]
        plan = fwd_any_launch_plan(hid, n_hidden, n_slots, TC)
        scratch = torch.empty(max(1, plan["scratch_floats"]), dtype=f32, device=dev)
        lib, entry = build.load(LIB_ANY, _SIGNATURES_ANY), "nmp_edge_mlp_agg_fwd_tc_f32"
        code = getattr(lib, entry)(
            *(t.data_ptr() for t in args), pdst.data_ptr(), e_new.data_ptr(),
            agg.data_ptr(), scratch.data_ptr(), n, n_slots, n_edges, hid, n_hidden,
            int(has_ln), build.stream_of(x))
        build.check(lib, code, entry)
        build.count_launch(counter)
        return e_new, agg
    # scratch: each tile's first owned node and its two partial rows of the
    # nodes its edges cut (128-slot tiles in the tuned kernel, 64 in the
    # generic one); then a byte per edge that the layout holds (tuned), or
    # the activation slabs where shared memory cannot hold them (generic)
    if counter == KERNEL_ANY:
        plan = fwd_any_launch_plan(hid, n_hidden, n_slots, FMA)
        tiles = plan["tiles"]
        last = torch.empty(max(1, plan["grid"] * plan["work_floats"]), dtype=f32, device=dev)
        lib, entry = build.load(LIB_ANY, _SIGNATURES_ANY), "nmp_edge_mlp_agg_fwd_any_f32"
    else:
        tiles = fwd_launch_plan(hid, n_hidden, n_slots, precision)["tiles"]
        last = torch.empty(n_edges, dtype=torch.uint8, device=dev)
        lib, entry = _entry("fwd", precision)
    scratch = (torch.empty(tiles + 1, dtype=i32, device=dev),
               torch.empty(tiles, 2, hid, dtype=f32, device=dev), last)
    code = getattr(lib, entry)(
        *(t.data_ptr() for t in args), e_new.data_ptr(), agg.data_ptr(),
        *(t.data_ptr() for t in scratch), n, n_slots, n_edges, hid, n_hidden,
        int(has_ln), build.stream_of(x))
    build.check(lib, code, entry)
    build.count_launch(counter)
    return e_new, agg


def _plan(kind, hidden, n_hidden, n_slots, precision):
    _check_precision(precision)
    _, _, entry, lib, sigs = _ENTRIES[kind, precision]
    lib = build.load(lib, sigs)
    plan = (ctypes.c_int * 6)()
    code = getattr(lib, entry)(hidden, n_hidden, n_slots, plan)
    build.check(lib, code, entry)
    return plan


def fwd_launch_plan(hidden: int, n_hidden: int, n_slots: int,
                    precision: str = FP32) -> dict:
    """The forward edge pass's launch on the current card at ``precision``:
    ``grid``, ``smem_bytes`` of dynamic shared memory per block,
    ``blocks_per_sm`` resident (occupancy API), ``smem_layers`` (the hidden
    layers whose weights sit in shared memory; the rest are read from
    global memory) and ``tiles`` (128-slot tiles the scratch holds); in
    bf16 also ``stages``, the ring's staged tiles."""
    plan = _plan("fwd", hidden, n_hidden, n_slots, precision)
    out = dict(grid=plan[0], smem_bytes=plan[1], blocks_per_sm=plan[2],
               smem_layers=plan[3], tiles=plan[4])
    if precision == BF16:
        out["stages"] = plan[5]
    return out


def bwd_launch_plan(hidden: int, n_hidden: int, n_slots: int,
                    precision: str = FP32) -> dict:
    """The backward edge pass's launch on the current card at
    ``precision``: ``grid`` (the partial weight-gradient rows),
    ``smem_bytes`` of dynamic shared memory per block and ``blocks_per_sm``
    resident (occupancy API); in bf16 also ``tiles`` (128-slot tiles the
    scratch holds) and ``stages``, the ring's staged tiles."""
    plan = _plan("bwd", hidden, n_hidden, n_slots, precision)
    out = dict(grid=plan[0], smem_bytes=plan[1], blocks_per_sm=plan[2])
    if precision == BF16:
        out.update(tiles=plan[4], stages=plan[5])
    return out


#: the narrowest width the generic pair's tensor-core route takes
TC_MIN_HIDDEN = 64


def any_route(hidden: int, n_hidden: int) -> str:
    """The generic pair's route at width ``hidden`` with ``n_hidden`` MLP
    hidden layers: ``"tc"`` (3xTF32 ``wgmma`` on the tensor cores,
    ``csrc/nmp_any.cu``'s ``*_tc_*`` entries) where H is a multiple of 4
    and at least :data:`TC_MIN_HIDDEN`, else ``"fma"`` (exact fp32 FMAs on
    the CUDA cores).  The depth does not move the line: the products of
    every layer are H x H but the first.  Below it the FMA route is the one
    that holds plain's band (a LayerNorm over a few features amplifies
    3xTF32's error in the backward: at H=4 the tensor cores' g_x misses
    it), as fast forward and faster backward at H = 4 and 12, where the
    tensor cores' 128-column passes are mostly padding; from H = 64 on the
    tensor cores are faster forward and backward at every depth.  ``chip_smoke.py``'s
    generic sweep times and checks both routes at every width."""
    del n_hidden                       # see the docstring
    return TC if hidden % 4 == 0 and hidden >= TC_MIN_HIDDEN else FMA


def _route(hidden: int, n_hidden: int, route) -> str:
    route = any_route(hidden, n_hidden) if route is None else route
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; expected one of {ROUTES}")
    if route == TC and hidden % 4:
        raise ValueError(f"the tensor-core route takes H % 4 == 0, not H={hidden}")
    return route


def _tc_plan(kind: int, hidden: int, n_hidden: int, n_slots: int, n_nodes: int) -> dict:
    lib = build.load(LIB_ANY, _SIGNATURES_ANY)
    plan = (ctypes.c_longlong * 5)()
    code = lib.nmp_any_tc_plan(kind, hidden, n_hidden, n_slots, n_nodes, plan)
    build.check(lib, code, "nmp_any_tc_plan")
    return dict(route=TC, grid=plan[0], smem_bytes=plan[1], blocks_per_sm=plan[2],
                tiles=plan[3], scratch_floats=plan[4])


def fwd_any_launch_plan(hidden: int, n_hidden: int, n_slots: int, route=None) -> dict:
    """The generic forward's (``csrc/nmp_any.cu``) edge pass on the current
    card: ``route`` (:func:`any_route` unless given), ``grid``,
    ``smem_bytes`` of dynamic shared memory per block, ``blocks_per_sm``
    resident (occupancy API) and ``tiles`` (of 64 slots on the FMA route,
    128 on the tensor-core route); the FMA route's ``work_floats`` of
    global scratch per block for the activation slabs (0: they sit in
    shared memory), the tensor-core route's ``scratch_floats`` (the one
    buffer its entry carves)."""
    if _route(hidden, n_hidden, route) == TC:
        return _tc_plan(0, hidden, n_hidden, n_slots, 0)
    lib = build.load(LIB_ANY, _SIGNATURES_ANY)
    plan = (ctypes.c_longlong * 5)()
    code = lib.nmp_edge_mlp_agg_fwd_any_plan(hidden, n_hidden, n_slots, plan)
    build.check(lib, code, "nmp_edge_mlp_agg_fwd_any_plan")
    return dict(route=FMA, grid=plan[0], smem_bytes=plan[1], blocks_per_sm=plan[2],
                work_floats=plan[3], tiles=plan[4])


def bwd_any_launch_plan(hidden: int, n_hidden: int, n_slots: int, n_nodes: int = 0,
                        route=None) -> dict:
    """The generic backward's edge pass on the current card: ``route``,
    ``grid``, ``smem_bytes`` of dynamic shared memory per block and
    ``blocks_per_sm`` resident; the FMA route's ``work_floats`` of global
    scratch per block (0: the slabs sit in shared memory; its grid is the
    count of partial weight-gradient rows), the tensor-core route's
    ``tiles`` and ``scratch_floats`` (for ``n_nodes`` nodes)."""
    if _route(hidden, n_hidden, route) == TC:
        return _tc_plan(1, hidden, n_hidden, n_slots, n_nodes)
    lib = build.load(LIB_ANY, _SIGNATURES_ANY)
    plan = (ctypes.c_longlong * 4)()
    code = lib.nmp_edge_mlp_agg_bwd_any_plan(hidden, n_hidden, n_slots, plan)
    build.check(lib, code, "nmp_edge_mlp_agg_bwd_any_plan")
    return dict(route=FMA, grid=plan[0], smem_bytes=plan[1], blocks_per_sm=plan[2],
                work_floats=plan[3])


def node_dst_plain(x, w0):
    """x_dst's share of layer 0 per node: x [N, H] @ w0's rows H .. 2H - 1."""
    hid = x.shape[1]
    return x @ w0[hid:2 * hid]


def node_dst_product(x, w0):
    """:func:`node_dst_plain` on CPU tensors; on CUDA tensors the
    tensor-core route's per-node pass (``csrc/nmp_any.cu``
    ``nmp_node_dst_f32``: 3xTF32 ``wgmma``), counted as
    :data:`KERNEL_DST`, or raises."""
    if x.device.type == "cpu":
        return node_dst_plain(x, w0)
    n, hid = x.shape
    f32 = torch.float32
    x, w0 = _aligned(x), w0.contiguous()
    build.require_cuda("node_dst_product", x, w0, dtypes=(f32, f32))
    if w0.shape != (3 * hid, hid):
        raise ValueError(f"w0 {tuple(w0.shape)}, expected [3H, H] = [{3 * hid}, {hid}]")
    plan = _tc_plan(2, hid, 0, 0, n)
    out = torch.empty(n, hid, dtype=f32, device=x.device)
    scratch = torch.empty(max(1, plan["scratch_floats"]), dtype=f32, device=x.device)
    lib = build.load(LIB_ANY, _SIGNATURES_ANY)
    code = lib.nmp_node_dst_f32(x.data_ptr(), w0.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), n, hid, build.stream_of(x))
    build.check(lib, code, "nmp_node_dst_f32")
    build.count_launch(KERNEL_DST)
    return out


def _aligned(t):
    """``t`` contiguous on a 16-byte boundary (the tensor-core route copies
    its rows 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bwd(x, e, ops, n_hidden, has_ln, seg_perm, seg_src, seg_rowptr,
         seg_src_slots, seg_src_rowptr, edge_mask, edge_inv_mult, g_enew,
         g_agg, precision, route=None):
    """Backward on stacked operands: plain on CPU; on CUDA ``nmp_bwd`` (in
    bf16 ``nmp_bf16``'s backward) at the tuned shapes, ``nmp_any``'s backward at every
    other fp32 shape, on ``route`` (:func:`any_route` unless given)."""
    n, hid = x.shape
    if x.device.type == "cpu":
        return _bwd_plain_stacked(x, e, ops, n_hidden, has_ln, seg_perm,
                                  seg_src, seg_rowptr, edge_mask,
                                  edge_inv_mult, g_enew, g_agg, precision)
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
    counter = entry_counter("bwd", hid, n_hidden, precision)
    f32, i32 = torch.float32, torch.int32
    g_enew, g_agg = g_enew.contiguous(), g_agg.contiguous()
    perm = seg_perm.reshape(-1)
    args = (x, e, perm, seg_src.reshape(-1), seg_rowptr, seg_src_slots,
            seg_src_rowptr, edge_mask, edge_inv_mult, *ops, g_enew, g_agg)
    build.require_cuda("fused_nmp_edge_agg_bwd", *args,
                       dtypes=(f32, f32) + (i32,) * 5 + (f32,) * 10)
    n_slots = perm.shape[0]
    lp = ops[2].shape[0]
    sizes = (3 * hid * hid, hid, lp * hid * hid, lp * hid, hid, hid)
    wsize = sum(sizes)
    dev = x.device
    gx = torch.empty(n, hid, dtype=f32, device=dev)
    # the bf16 kernel writes every row of g_e (zeros outside the layout)
    ge = (torch.empty if precision == BF16 else torch.zeros)(e.shape[0], hid, dtype=f32,
                                                             device=dev)
    gw = torch.empty(wsize, dtype=f32, device=dev)
    if counter == KERNEL_BWD_ANY and _route(hid, n_hidden, route) == TC:
        # x_dst w0_dst per node (its own launch), then the edge pass, the
        # split-K weight gradients and the node pass; one scratch buffer
        pdst = node_dst_product(x, ops[0])
        args = (_aligned(x), _aligned(e)) + args[2:]
        plan = bwd_any_launch_plan(hid, n_hidden, n_slots, n, TC)
        scratch = torch.empty(max(1, plan["scratch_floats"]), dtype=f32, device=dev)
        lib, entry = build.load(LIB_ANY, _SIGNATURES_ANY), "nmp_edge_mlp_agg_bwd_tc_f32"
        code = getattr(lib, entry)(
            *(t.data_ptr() for t in args), pdst.data_ptr(), gx.data_ptr(), ge.data_ptr(),
            gw.data_ptr(), scratch.data_ptr(), n, n_slots, hid, n_hidden, int(has_ln),
            build.stream_of(x))
        build.check(lib, code, entry)
        build.count_launch(counter)
        return _split_wgrad(gx, ge, gw, sizes, hid, lp)
    if precision == BF16:
        # scratch: each tile's first owned node and its two partial rows of
        # the x_dst sums of the nodes its edges cut, each slot's x_src
        # gradient (slots x H bf16, 276 MB at the serving mesh's 4.3 M
        # slots, H=32), a byte per edge that the layout holds, and one row of
        # partial weight gradients per block
        plan = bwd_launch_plan(hid, n_hidden, n_slots, BF16)
        groups, tiles = plan["grid"], plan["tiles"]
        scratch = (torch.empty(tiles + 1, dtype=i32, device=dev),
                   torch.empty(tiles, 2, hid, dtype=f32, device=dev),
                   torch.empty(n_slots, hid, dtype=torch.bfloat16, device=dev),
                   torch.empty(e.shape[0], dtype=torch.uint8, device=dev),
                   torch.empty(groups, wsize, dtype=f32, device=dev))
        lib, entry = _entry("bwd", BF16)
        code = getattr(lib, entry)(
            *(t.data_ptr() for t in args), gx.data_ptr(), ge.data_ptr(),
            gw.data_ptr(), *(t.data_ptr() for t in scratch), n, n_slots, e.shape[0],
            hid, n_hidden, int(has_ln), groups, build.stream_of(x))
        build.check(lib, code, entry)
        build.count_launch(counter)
        return _split_wgrad(gx, ge, gw, sizes, hid, lp)
    # scratch: each slot's layer-0 pre-activation gradient (slots x H fp32,
    # 552 MB at the serving mesh's 4.3 M slots, H=32), each slot's
    # destination node, and one row of partial weight gradients per block
    # (~1.05 M floats a row at H=512, one hidden layer)
    gz0 = torch.empty(n_slots, hid, dtype=f32, device=dev)
    slot_dst = torch.empty(n_slots, dtype=i32, device=dev)
    if counter == KERNEL_BWD_ANY:
        plan = bwd_any_launch_plan(hid, n_hidden, n_slots, route=FMA)
        groups = plan["grid"]
        # the per-node sums of g_z0 (dst | src) and the activation slabs
        # where shared memory cannot hold them
        scratch = [gz0, slot_dst, torch.empty(n, 2 * hid, dtype=f32, device=dev),
                   torch.empty(groups, wsize, dtype=f32, device=dev),
                   torch.empty(max(1, groups * plan["work_floats"]), dtype=f32,
                               device=dev)]
        lib, entry = build.load(LIB_ANY, _SIGNATURES_ANY), "nmp_edge_mlp_agg_bwd_any_f32"
    else:
        groups = bwd_launch_plan(hid, n_hidden, n_slots)["grid"]
        scratch = [gz0, slot_dst, torch.empty(groups, wsize, dtype=f32, device=dev)]
        lib, entry = _entry("bwd", FP32)
    code = getattr(lib, entry)(
        *(t.data_ptr() for t in args), gx.data_ptr(), ge.data_ptr(),
        gw.data_ptr(), *(t.data_ptr() for t in scratch), n, n_slots, hid,
        n_hidden, int(has_ln), groups, build.stream_of(x))
    build.check(lib, code, entry)
    build.count_launch(counter)
    return _split_wgrad(gx, ge, gw, sizes, hid, lp)


def _split_wgrad(gx, ge, gw, sizes, hid, lp):
    gw0, gb0, gwr, gbr, glng, glnb = torch.split(gw, sizes)
    return (gx, ge, gw0.view(3 * hid, hid), gb0, gwr.view(lp, hid, hid),
            gbr.view(lp, hid), glng, glnb)


class _FusedNMP(torch.autograd.Function):
    """Counterpart of the reference's ``_nmp_core`` custom VJP: the forward
    and backward kernels (plain versions on CPU tensors).  The backward
    returns None for the layout, the mask and the inverse multiplicities,
    as the reference's VJP returns zeros for them."""

    @staticmethod
    def forward(ctx, save, n_hidden, has_ln, precision, x, e, w0, b0, wrest,
                brest, lng, lnb, perm, src, rowptr, src_slots, src_rowptr,
                emask, einv):
        ops = (w0, b0, wrest, brest, lng, lnb)
        out = _fwd(x, e, ops, n_hidden, has_ln, perm, src, rowptr, emask, einv,
                   precision)
        if save:
            ctx.save_for_backward(x, e, *ops, perm, src, rowptr, src_slots,
                                  src_rowptr, emask, einv)
        ctx.static = (n_hidden, has_ln, precision)
        return out

    @staticmethod
    def backward(ctx, g_enew, g_agg):
        x, e, *rest = ctx.saved_tensors
        n_hidden, has_ln, precision = ctx.static
        grads = _bwd(x, e, tuple(rest[:6]), n_hidden, has_ln, *rest[6:],
                     g_enew, g_agg, precision)
        return (None,) * 4 + tuple(grads) + (None,) * 7


def fused_nmp_edge_agg(x, e, edge_params, seg_perm, seg_src, seg_rowptr,
                       edge_mask, edge_inv_mult, *, seg_src_slots=None,
                       seg_src_rowptr=None, precision=FP32):
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
      precision: ``"fp32"`` or ``"bf16"`` (the edge MLP's products on
        bf16-rounded operands, accumulated in fp32); anything else raises.

    CPU tensors run the plain forward and backward; CUDA tensors launch
    ``csrc/nmp_fwd.cu`` (fp32 operands in memory, H in {8, 16, 32}, any
    number of hidden layers) and, in the backward, ``csrc/nmp_bwd.cu`` (at
    most 5 hidden layers), in bf16 ``csrc/nmp_bf16.cu`` at the same
    shapes, and ``csrc/nmp_any.cu`` at every other fp32 shape (any H >= 1,
    any depth); bf16 at another shape raises.  Tensors are saved for the backward only when grad is
    enabled and an input requires it.

    Returns (e_new [E_pad, H], agg [N_pad, H]).
    """
    _check_hidden(edge_params, x.shape[1])
    *ops, n_hidden, has_ln = _stack_edge_mlp(edge_params)
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, e, *ops))
    return _FusedNMP.apply(save, n_hidden, has_ln, precision, x, e, *ops, seg_perm,
                           seg_src, seg_rowptr, seg_src_slots, seg_src_rowptr,
                           edge_mask, edge_inv_mult)


def fused_nmp_edge_agg_bwd(x, e, edge_params, seg_perm, seg_src, seg_rowptr,
                           seg_src_slots, seg_src_rowptr, edge_mask,
                           edge_inv_mult, g_enew, g_agg, precision=FP32):
    """The backward on its own: VJP of :func:`fused_nmp_edge_agg` for the
    cotangents (g_enew [E_pad, H], g_agg [N_pad, H]).  CPU tensors run
    :func:`fused_nmp_edge_agg_bwd_plain`; CUDA tensors launch
    ``csrc/nmp_bwd.cu`` (``csrc/nmp_bf16.cu`` in bf16) at the tuned
    shapes, ``csrc/nmp_any.cu`` at every other fp32 shape, or raise.  Returns the tuple of
    :func:`fused_nmp_edge_agg_bwd_plain`."""
    _check_hidden(edge_params, x.shape[1])
    *ops, n_hidden, has_ln = _stack_edge_mlp(edge_params)
    return _bwd(x, e, tuple(ops), n_hidden, has_ln, seg_perm, seg_src,
                seg_rowptr, seg_src_slots, seg_src_rowptr, edge_mask,
                edge_inv_mult, g_enew, g_agg, precision)


# ---------------------------------------------------------------------------
# legacy dst-aligned op (forward only)
# ---------------------------------------------------------------------------

def dst_aligned_layout(dst: np.ndarray, n_nodes: int, block_n: int,
                       block_e: int) -> dict:
    """Legacy layout of the dst-aligned op: sort edges by destination and pad
    per node block to edge-block multiples (argsort + searchsorted).

    Edges with ``dst`` outside ``[0, n_nodes)`` (e.g. padding edges
    redirected to a sentinel) are dropped from the layout: their slots stay
    ``-1``.

    Returns {perm [NB, NE, BE] int64 (original edge id, -1 on padding),
    dstl [NB, NE, BE] int32 (block-local dst, 0 on padding), n_node_blocks,
    n_edge_blocks, block_n, block_e, waste (the padding's share of the
    slots)}.
    """
    dst = np.asarray(dst, dtype=np.int64)
    keep = np.nonzero((dst >= 0) & (dst < n_nodes))[0]
    order = keep[np.argsort(dst[keep], kind="stable")]
    dst_sorted = dst[order]
    nb = math.ceil(max(n_nodes, 1) / block_n)
    bounds = np.arange(nb + 1, dtype=np.int64) * block_n
    starts = np.searchsorted(dst_sorted, bounds[:-1], side="left")
    ends = np.searchsorted(dst_sorted, bounds[1:], side="left")
    counts = ends - starts
    max_count = int(counts.max()) if counts.size else 0
    ne = max(1, math.ceil(max_count / block_e))
    perm = np.full((nb, ne * block_e), -1, dtype=np.int64)
    if dst_sorted.size:
        blk = dst_sorted // block_n
        col = np.arange(dst_sorted.size, dtype=np.int64) - starts[blk]
        perm[blk, col] = order
    waste = 1.0 - (dst_sorted.size / perm.size) if perm.size else 0.0
    perm = perm.reshape(nb, ne, block_e)
    dstl = np.where(
        perm >= 0,
        dst[np.clip(perm, 0, None)] - np.arange(nb)[:, None, None] * block_n,
        0).astype(np.int32)
    return dict(perm=perm, dstl=dstl, n_node_blocks=nb, n_edge_blocks=ne,
                block_n=int(block_n), block_e=int(block_e), waste=waste)


def _check_tiles(feats, dst_local, weights, w1, b1, w2, b2, n_node_blocks,
                 block_n, block_e):
    name = KERNEL_MLP_AGG
    if feats.dtype not in _MLP_AGG_ENTRY:
        raise TypeError(f"{name}: feats dtype {feats.dtype} is not float32 or bfloat16")
    if feats.dim() != 4 or feats.shape[0] != n_node_blocks or feats.shape[2] != block_e:
        raise ValueError(f"{name}: feats {tuple(feats.shape)} is not [NB={n_node_blocks}, "
                         f"NE, BE={block_e}, Fin]")
    if dst_local.shape != feats.shape[:3] or weights.shape != feats.shape[:3]:
        raise ValueError(f"{name}: dst_local {tuple(dst_local.shape)} and weights "
                         f"{tuple(weights.shape)} must be feats' [NB, NE, BE] "
                         f"{tuple(feats.shape[:3])}")
    fin, hh, hid = feats.shape[3], w1.shape[-1], w2.shape[-1]
    if (w1.shape != (fin, hh) or b1.shape != (hh,) or w2.shape != (hh, hid)
            or b2.shape != (hid,)):
        raise ValueError(f"{name}: w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 "
                         f"{tuple(w2.shape)}, b2 {tuple(b2.shape)} do not form a "
                         f"{fin} -> Hh -> H MLP")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (feats, weights, w1, b1, w2, b2)):
        raise RuntimeError(f"{name} is forward-only: call it under torch.no_grad()")


def edge_mlp_agg_plain(feats, dst_local, weights, w1, b1, w2, b2, *,
                       n_node_blocks: int, block_n: int, block_e: int):
    """Plain PyTorch version of :func:`edge_mlp_agg`, on the same tiles:
    the MLP in fp32 (float64 for float64 feats, a yardstick the kernel does
    not take), then each node block's weighted sum through the sorted,
    deterministic ``segment_sum``.  Slots whose ``dst_local`` is outside
    ``[0, block_n)`` add to no node (the TPU kernel's one-hot drops them)."""
    ct = torch.promote_types(feats.dtype, torch.float32)
    h = F.elu(feats.to(ct) @ w1.to(ct) + b1.to(ct))
    e = h @ w2.to(ct) + b2.to(ct)
    d = dst_local.long()
    w = torch.where((d >= 0) & (d < block_n), weights.to(ct), 0.0)
    ids = (torch.arange(n_node_blocks, device=feats.device)[:, None, None] * block_n
           + d.clamp(0, block_n - 1))
    agg = segment_sum((e * w[..., None]).reshape(-1, e.shape[-1]), ids.reshape(-1),
                      n_node_blocks * block_n)
    return e.to(feats.dtype), agg.view(n_node_blocks, block_n, -1)


def edge_mlp_agg(feats, dst_local, weights, w1, b1, w2, b2, *,
                 n_node_blocks: int, block_n: int, block_e: int):
    """Edge MLP + weighted per-node-block aggregate over dst-aligned tiles
    (counterpart of the reference's Pallas ``edge_mlp_agg``).

    Args:
      feats: [NB, NE, BE, Fin] pre-gathered tiles (``dst_aligned_layout``),
        float32 or bfloat16; the arithmetic is fp32 either way.
      dst_local: [NB, NE, BE] int32 in [0, block_n); weights: [NB, NE, BE]
        float32 (0 = padding).
      w1 [Fin, Hh], b1 [Hh], w2 [Hh, H], b2 [H]: float32.

    CPU tensors run :func:`edge_mlp_agg_plain`; CUDA tensors launch
    ``csrc/edge_mlp_agg.cu`` (Fin <= 128, Hh and H <= 32, block_n <= 256;
    3xTF32 tensor-core products, the aggregate a one-hot product summed in
    a fixed order, so bitwise repeatable; :func:`mlp_agg_launch_plan` gives
    its launch) or raise.  Forward-only: raises when a gradient would be needed.

    Returns (e_new [NB, NE, BE, H] in feats' dtype, agg [NB, block_n, H]
    float32).
    """
    _check_tiles(feats, dst_local, weights, w1, b1, w2, b2, n_node_blocks, block_n,
                 block_e)
    if feats.device.type == "cpu":
        return edge_mlp_agg_plain(feats, dst_local, weights, w1, b1, w2, b2,
                                  n_node_blocks=n_node_blocks, block_n=block_n,
                                  block_e=block_e)
    name = KERNEL_MLP_AGG
    if feats.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {feats.device}")
    entry = _MLP_AGG_ENTRY[feats.dtype]
    (nb, ne, be, fin), hh, hid = feats.shape, w1.shape[1], w2.shape[1]
    if fin > MLP_AGG_MAX_FIN or max(hh, hid) > MLP_AGG_MAX_HIDDEN \
            or block_n > MLP_AGG_MAX_BLOCK_N:
        raise ValueError(f"{name}: Fin {fin}, Hh {hh}, H {hid}, block_n {block_n}; the "
                         f"kernel takes Fin <= {MLP_AGG_MAX_FIN}, Hh and H <= "
                         f"{MLP_AGG_MAX_HIDDEN}, block_n <= {MLP_AGG_MAX_BLOCK_N}")
    f32 = torch.float32
    args = (feats, dst_local, weights, w1, b1, w2, b2)
    build.require_cuda(name, *args, dtypes=(feats.dtype, torch.int32) + (f32,) * 5)
    e_new = torch.empty(nb, ne, be, hid, dtype=feats.dtype, device=feats.device)
    agg = torch.empty(nb, block_n, hid, dtype=f32, device=feats.device)
    lib = build.load(name, _SIGNATURES_MLP_AGG)
    code = getattr(lib, entry)(*(t.data_ptr() for t in args), e_new.data_ptr(),
                               agg.data_ptr(), nb, ne * be, fin, hh, hid, block_n,
                               build.stream_of(feats))
    build.check(lib, code, entry)
    build.count_launch(name)
    return e_new, agg


def mlp_agg_launch_plan(fin: int, block_n: int, dtype: torch.dtype,
                        n_node_blocks: int) -> dict:
    """``edge_mlp_agg``'s launch on the current card for feats of ``dtype``:
    ``grid`` (persistent blocks), ``groups`` of 4 warps per block (each on
    its own node blocks), ``smem_bytes`` of dynamic shared memory per
    block, ``blocks_per_sm`` resident (occupancy API) and ``threads`` per
    block."""
    lib = build.load(KERNEL_MLP_AGG, _SIGNATURES_MLP_AGG)
    plan = (ctypes.c_int * 5)()
    code = lib.edge_mlp_agg_plan(fin, block_n, torch.finfo(dtype).bits // 8,
                                 n_node_blocks, plan)
    build.check(lib, code, "edge_mlp_agg_plan")
    return dict(grid=plan[0], groups=plan[1], smem_bytes=plan[2],
                blocks_per_sm=plan[3], threads=plan[4])


def fused_edge_mlp_agg(feats, dst, weights, w1, b1, w2, b2, layout, *,
                       n_nodes: int, block_n: int, block_e: int):
    """feats [E, Fin] and weights [E] in original edge order: gathers the
    dst-aligned tiles through ``layout["perm"]`` (padding zeroed), runs
    :func:`edge_mlp_agg` and puts e_new back in the original edge order.
    ``dst`` and ``n_nodes`` are the ones the layout was built from (the
    reference's signature); the layout's arrays may be numpy or tensors.

    Each kept edge fills one slot, so the un-permute is a plain assignment
    of the valid slots: exact and deterministic.  Padding slots write
    nothing, and edges that the layout dropped (``dst`` outside
    ``[0, n_nodes)``) keep e_new = 0.

    Returns (e_new [E, H], agg [NB * block_n, H] float32)."""
    if (layout["block_n"], layout["block_e"]) != (block_n, block_e):
        raise ValueError(f"layout blocks ({layout['block_n']}, {layout['block_e']}) "
                         f"!= ({block_n}, {block_e})")
    dev = feats.device
    perm = torch.as_tensor(layout["perm"], device=dev)
    valid = perm >= 0
    safe = perm.clamp(min=0)
    tile_feats = torch.where(valid[..., None], feats[safe], 0)
    tile_w = torch.where(valid, weights[safe], 0).float()
    dstl = torch.as_tensor(layout["dstl"], device=dev)
    e_tiles, agg = edge_mlp_agg(tile_feats, dstl, tile_w, w1, b1, w2, b2,
                                n_node_blocks=layout["n_node_blocks"],
                                block_n=block_n, block_e=block_e)
    e_new = e_tiles.new_zeros(feats.shape[0], e_tiles.shape[-1])
    e_new[perm[valid]] = e_tiles[valid]
    return e_new, agg.reshape(-1, agg.shape[-1])


__all__ = ["KERNEL_MLP_AGG", "KERNEL_ANY", "KERNEL_BWD_ANY",
           "compact_gather_layout", "dst_aligned_layout", "entry_counter",
           "edge_mlp_agg", "edge_mlp_agg_plain", "fused_edge_mlp_agg",
           "mlp_agg_launch_plan",
           "fused_nmp_edge_agg", "fused_nmp_edge_agg_bwd",
           "fused_nmp_edge_agg_bwd_plain", "fused_nmp_edge_agg_plain"]
