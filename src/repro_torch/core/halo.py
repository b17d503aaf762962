"""Halo exchanges (Sec. II-B Eq. 4c-d): the real multi-process exchange
on ``torch.distributed`` and its single-device emulators over a stacked
[R, ...] graph (port of ``repro.core.halo``).

Modes, matching the paper's study:

* ``NONE``     — skip the exchange: the *inconsistent* baseline.
* ``A2A``      — equal-size buffers to every rank (``all_to_all_single``).
* ``NEIGHBOR`` — rounds of disjoint rank-pair swaps (one round per color of
                 the rank-adjacency edge coloring; one ``batch_isend_irecv``
                 per round); ``packed=True`` ships the bucketed per-round
                 buffers through the exchange wires: one pack launch for
                 all rounds, one unpack-add per round received
                 (``repro_torch.kernels.halo_pack``).

The "synchronization" (Eq. 4d) is fused into the exchange: received
buffers are scatter-added onto the owning local rows.  Every scatter here
adds one sender's buffer at a time, in sender (or round) order, whose real
ids are unique, so the sums are deterministic on the GPU too (only exact
zero-adds of padding slots can collide).  Only ``combine="sum"`` is
ported.

:func:`halo_sync` runs on one process's rank-local graph and a
:class:`~repro_torch.launch.mesh.Mesh`.  Every exchange is posted
(:func:`halo_sync_post`): the rows are gathered (packed: one pack launch)
and every transfer is issued at once, and :meth:`PendingSync.finish`
waits for them and adds what arrived, in round (or sender) order, so a
caller (the overlap schedule) can queue other work on the card in
between.  :func:`halo_sync` is the post and its finish at once; JAX
differentiates its collectives through their transpose rules, so here
every mode's exchange is one ``torch.autograd.Function`` whose forward
posts and finishes the exchange and whose backward does the same with
the reversed exchange.
:func:`halo_sync_stacked` emulates the same per-rank arithmetic over a
stacked aggregate on one device (each rank's :func:`halo_sync` result is
bitwise equal to its slice), and :func:`halo_sync_reference` is the
canonical-order oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels.halo_pack.ops import (
    ExchangeRound, halo_exchange, halo_exchange_rank_post)

NONE = "none"
A2A = "a2a"
NEIGHBOR = "neighbor"
AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Static halo configuration: mode, neighbor rounds, wire format.

    ``perms`` holds one tuple of (src, dst) rank pairs per NEIGHBOR round;
    ``packed`` selects the bucketed per-round ``pk{k}_*`` arrays (NEIGHBOR
    only) whose gather/scatter run as the fused pack/unpack kernels.
    """
    mode: str                                  # none | a2a | neighbor | auto
    perms: Tuple[Tuple[Tuple[int, int], ...], ...] = ()
    packed: bool = False


def halo_spec_from_plan(plan, mode: str, packed: bool = False) -> HaloSpec:
    """Build the static HaloSpec from a host-side ``HaloPlan``."""
    perms = tuple(tuple((int(a), int(b)) for a, b in rnd) for rnd in plan.perms)
    return HaloSpec(mode=mode, perms=perms, packed=packed)


def _check_spec(spec: HaloSpec, combine: str):
    if combine != "sum":
        raise NotImplementedError(
            f"combine={combine!r} is not ported to repro_torch yet (only 'sum')")
    if spec.mode == AUTO:
        raise ValueError("halo mode 'auto' must be resolved before the "
                         "exchange runs (plan.autotune)")
    if spec.packed and spec.mode == A2A:
        raise ValueError("HaloSpec(packed=True) is neighbor-only: all-to-all "
                         "needs uniform per-rank buffers — use mode='neighbor'")
    if spec.mode not in (A2A, NEIGHBOR):
        raise ValueError(f"unknown halo mode {spec.mode!r}")


def _exchange_rounds(graph, spec: HaloSpec):
    """Each packed round's :class:`ExchangeRound`: its rows' offset in the
    exchange wires ``pk_send`` / ``pk_recv`` (the earlier rounds' widths),
    its (sender, receiver) pairs by receiver, and its own wires."""
    rounds, offset = [], 0
    for k, perm in enumerate(spec.perms):
        send, recv = graph.wire(f"pk{k}_send"), graph.wire(f"pk{k}_recv")
        pairs = tuple(sorted(((int(s), int(d)) for s, d in perm), key=lambda p: p[1]))
        rounds.append(ExchangeRound(offset, pairs, send, recv))
        offset += send.idx.shape[-1]
    return rounds


def halo_sync_reference(a_stacked: torch.Tensor, graph, spec: HaloSpec,
                        combine: str = "sum") -> torch.Tensor:
    """Single-device oracle over a stacked [R, N, F] aggregate.

    Emulates the A2A exchange with plain gathers and sums contributions in
    CANONICAL ascending-rank order from a zero base (own partial spliced in
    at its rank position), so every coincident copy of a node evaluates the
    identical floating-point expression.
    """
    if combine != "sum":
        raise NotImplementedError(
            f"combine={combine!r} is not ported to repro_torch yet (only 'sum')")
    R = a_stacked.shape[0]
    send_idx, send_mask = graph["a2a_send_idx"], graph["a2a_send_mask"]
    recv_idx, recv_mask = graph["a2a_recv_idx"], graph["a2a_recv_mask"]
    outs = []
    for r in range(R):
        out_r = torch.zeros_like(a_stacked[r])
        for s in range(R):
            if s == r:
                out_r = out_r + a_stacked[r]
                continue
            buf = a_stacked[s].index_select(0, send_idx[s, r]) \
                * send_mask[s, r][:, None]
            out_r = out_r.index_add(0, recv_idx[r, s],
                                    buf * recv_mask[r, s][:, None])
        outs.append(out_r)
    return torch.stack(outs)


def halo_sync_stacked(a_stacked: torch.Tensor, graph, spec: HaloSpec,
                      combine: str = "sum") -> torch.Tensor:
    """Mode-faithful single-device emulator of the per-rank exchange over a
    stacked [R, N, F] aggregate: per-rank gathers and wire masking, the
    exchange (emulated by indexing the senders' buffers), and a
    scatter-add seeded from the local aggregate — the packed exchange op
    (one pack launch, one unpack-add per round and receiver, the reversed
    exchange as its gradient) when ``spec.packed``."""
    if spec.mode == NONE:
        return a_stacked
    _check_spec(spec, combine)
    if a_stacked.dim() != 3:
        raise ValueError("halo_sync_stacked expects a stacked [R, N, F] "
                         f"aggregate, got shape {tuple(a_stacked.shape)}")
    R = a_stacked.shape[0]

    if spec.mode == A2A:
        send_idx, send_mask = graph["a2a_send_idx"], graph["a2a_send_mask"]
        recv_idx, recv_mask = graph["a2a_recv_idx"], graph["a2a_recv_mask"]
        outs = []
        for r in range(R):
            out_r = a_stacked[r]
            # what all-to-all delivers to rank r: sender s's slice r, added
            # in sender order
            for s in range(R):
                buf = a_stacked[s].index_select(0, send_idx[s, r]) \
                    * send_mask[s, r][:, None]
                out_r = out_r.index_add(0, recv_idx[r, s],
                                        buf * recv_mask[r, s][:, None])
            outs.append(out_r)
        return torch.stack(outs)

    if spec.packed:
        return halo_exchange(a_stacked, graph.wire("pk_send"), graph.wire("pk_recv"),
                             _exchange_rounds(graph, spec))

    # NEIGHBOR, dense wires: per-round disjoint pair exchanges
    out = list(a_stacked.unbind(0))
    for k, perm in enumerate(spec.perms):
        if not perm:
            continue
        send_idx, send_mask, recv_idx, recv_mask = (
            graph[f"nbr_{side}_{part}"][:, k]
            for side in ("send", "recv") for part in ("idx", "mask"))
        src_of = {int(d): int(s) for (s, d) in perm}
        new_out = list(out)
        for r in range(R):
            s = src_of.get(r)
            if s is None:
                continue   # non-destination ranks receive nothing
            # gather from the ORIGINAL aggregate, scatter into the running one
            buf = a_stacked[s].index_select(0, send_idx[s]) * send_mask[s][:, None]
            new_out[r] = out[r].index_add(0, recv_idx[r], buf * recv_mask[r][:, None])
        out = new_out
    return torch.stack(out)


def _peers(perm, rank: int):
    """(the rank ``rank`` sends to, the rank it receives from) in one round."""
    return (next((d for s, d in perm if s == rank), None),
            next((s for s, d in perm if d == rank), None))


def _a2a_rows(a, send_idx, send_mask):
    """Every peer's rows of ``a``, masked: [R, w, F]."""
    R, w = send_idx.shape
    return a.index_select(0, send_idx.reshape(-1)).reshape(R, w, a.shape[1]) \
        * send_mask[..., None]


def _a2a_add(a, got, recv_idx, recv_mask):
    """What each sender sent, added one sender at a time in sender order,
    seeded from ``a``."""
    out = a
    for s in range(recv_idx.shape[0]):
        out = out.index_add(0, recv_idx[s], got[s] * recv_mask[s][:, None])
    return out


class PendingSync:
    """A posted halo exchange of one process (:func:`halo_sync_post`);
    :meth:`finish` waits for it and returns ``a*``."""
    __slots__ = ("_finish",)

    def __init__(self, finish):
        self._finish = finish

    def finish(self) -> torch.Tensor:
        return self._finish()


def _a2a_post(a, send_idx, send_mask, recv_idx, recv_mask, group) -> PendingSync:
    """Gather every peer's rows and post the all-to-all; the finish adds
    what each sender sent."""
    posted = group.post_all_to_all(_a2a_rows(a, send_idx, send_mask))
    return PendingSync(lambda: _a2a_add(a, posted.wait()[0], recv_idx, recv_mask))


def _neighbor_post(a, send_idx, send_mask, recv_idx, recv_mask, peers,
                   group) -> PendingSync:
    """Dense neighbor rounds, posted at once: gather from the ORIGINAL
    ``a``; the finish adds each round received into the running result, in
    round order."""
    posted = group.post_swaps(
        (a.index_select(0, send_idx[k]) * send_mask[k][:, None] if to is not None
         else None, to, frm, (recv_idx.shape[1], a.shape[1]), a.dtype)
        for k, (to, frm) in enumerate(peers))

    def finish():
        out = a
        for k, got in enumerate(posted.wait()):
            if got is not None:
                out = out.index_add(0, recv_idx[k], got * recv_mask[k][:, None])
        return out.clone() if out is a else out
    return PendingSync(finish)


class _Exchange(torch.autograd.Function):
    """One exchange, differentiable: the forward posts ``post(a)`` and
    finishes it at once, the backward does the same with ``post_back``, the
    reversed exchange, on the incoming gradient."""

    @staticmethod
    def forward(ctx, a, post, post_back):
        ctx.post_back = post_back
        return post(a).finish()

    @staticmethod
    def backward(ctx, g):
        return ctx.post_back(g.contiguous()).finish(), None, None


def _posters(graph, spec: HaloSpec, mesh):
    """(post, post_back) of one process's exchange: each takes an [N, F]
    tensor, gathers its rows to send (packed: one pack launch), issues
    every transfer at once and returns what ``finish()`` waits for and adds;
    ``post_back`` runs the reversed exchange (send and recv sides and, in
    each round, the partners swapped)."""
    group = mesh.graph_group
    if spec.mode == A2A:
        _check_a2a(graph, group)
        ends = (graph["a2a_send_idx"], graph["a2a_send_mask"],
                graph["a2a_recv_idx"], graph["a2a_recv_mask"])
        return (lambda t: _a2a_post(t, *ends, group),
                lambda t: _a2a_post(t, *ends[2:], *ends[:2], group))
    peers = tuple(_peers(perm, mesh.rank) for perm in spec.perms)
    if spec.packed:
        args = (graph.wire("pk_send"), graph.wire("pk_recv"),
                _exchange_rounds(graph, spec), peers, group.post_swaps)
        return (lambda t: halo_exchange_rank_post(t, *args),
                lambda t: halo_exchange_rank_post(t, *args, reverse=True))
    ends = (graph["nbr_send_idx"], graph["nbr_send_mask"],
            graph["nbr_recv_idx"], graph["nbr_recv_mask"])
    back = tuple((frm, to) for to, frm in peers)
    return (lambda t: _neighbor_post(t, *ends, peers, group),
            lambda t: _neighbor_post(t, *ends[2:], *ends[:2], back, group))


def _rank_local(a, graph, spec: HaloSpec, combine: str, name: str):
    _check_spec(spec, combine)
    if a.dim() != 2 or graph["node_mask"].dim() != 1:
        raise ValueError(f"{name} expects one rank's [N, F] or [B, N, F] aggregate "
                         f"and a rank-local graph; got {tuple(a.shape)} and a graph "
                         f"of node_mask {tuple(graph['node_mask'].shape)}")
    return a.contiguous()


def halo_sync_post(a: torch.Tensor, graph, spec: HaloSpec, mesh,
                   combine: str = "sum") -> PendingSync:
    """Post :func:`halo_sync`'s exchange: gather the rows to send (packed:
    one pack launch) and issue every transfer of the exchange at once
    (``Group.post_all_to_all`` / ``post_swaps``).  Returns a
    :class:`PendingSync` whose ``finish()`` waits for the rows and adds
    them as :func:`halo_sync` does, bitwise equal to it.  Not
    differentiable: ``a`` must need no gradient (under autograd call
    :func:`halo_sync`)."""
    if spec.mode == NONE:
        return PendingSync(lambda: a)
    if torch.is_grad_enabled() and a.requires_grad:
        raise ValueError("halo_sync_post: a posted exchange has no gradient; "
                         "call halo_sync under autograd")
    if a.dim() == 3:
        b, n, f = a.shape
        flat = halo_sync_post(a.permute(1, 0, 2).reshape(n, b * f), graph, spec,
                              mesh, combine)
        return PendingSync(lambda: flat.finish().reshape(n, b, f).permute(1, 0, 2))
    a = _rank_local(a, graph, spec, combine, "halo_sync_post")
    return _posters(graph, spec, mesh)[0](a)


def _check_a2a(graph, group):
    if graph["a2a_send_idx"].shape[0] != group.size:
        raise ValueError(f"the graph has {graph['a2a_send_idx'].shape[0]} "
                         f"ranks, the graph group {group.size}")


def halo_sync(a: torch.Tensor, graph, spec: HaloSpec, mesh,
              combine: str = "sum") -> torch.Tensor:
    """Exchange + synchronize one process's local aggregate across the
    coincident node copies of its graph group (reference
    ``core/halo.py::halo_sync``).

    ``a``: [N_pad, F] or [B, N_pad, F] on this process; ``graph``: its
    rank-local :class:`~repro_torch.core.graph_state.ShardedGraph`
    (``ShardedGraph.build(..., rank=mesh.rank)`` or ``.rank(r)``);
    ``mesh``: the process's :class:`~repro_torch.launch.mesh.Mesh`.  Every
    process of the graph group must call it with the same spec.  A2A is
    one ``all_to_all_single``; NEIGHBOR one ``batch_isend_irecv`` per round
    between the round's pairs (ranks outside them skip it), every round
    posted at once; packed NEIGHBOR one pack launch, the rounds' slices
    posted, then one unpack-add launch per round received.  It is
    :func:`halo_sync_post` and its finish, differentiable in ``a`` (the
    backward posts and finishes the reversed exchange).  Returns ``a*``,
    shaped as ``a``.
    """
    if spec.mode == NONE:
        return a
    if a.dim() == 3:
        # rows are exchanged whole: carry the batch as feature columns
        b, n, f = a.shape
        flat = a.permute(1, 0, 2).reshape(n, b * f)
        return halo_sync(flat, graph, spec, mesh).reshape(n, b, f).permute(1, 0, 2)
    a = _rank_local(a, graph, spec, combine, "halo_sync")
    return _Exchange.apply(a, *_posters(graph, spec, mesh))
