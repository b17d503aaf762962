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
                 (``repro_torch.kernels.halo_pack``).  A two-level spec
                 (``rounds2d``, sub-graphs on a (Ga, Gb) rank grid,
                 ``core/partition.py::partition_mesh_2d``) routes each
                 round, one uniform grid shift, as chained one-way hops
                 along the grid's axes (:class:`_ChainPost`): the middle
                 rank of a diagonal forwards what it received.

The "synchronization" (Eq. 4d) is fused into the exchange: received
buffers are combined onto the owning local rows.  ``combine="sum"`` adds
one sender's buffer at a time, in sender (or round) order, whose real ids
are unique, so the sums are deterministic on the GPU too (only exact
zero-adds of padding slots can collide).  ``combine="max"`` (the
consistent edge-softmax shift) masks padding slots to ``-1e30`` and takes
a scatter-max (``index_reduce(amax)``: order-independent, so bitwise
repeatable); the fused pack/unpack kernels implement the sum only, so a
packed spec under ``max`` gathers and scatters the narrow ``pk{k}_*``
arrays with plain ops.  The forward of ``max`` runs in every mode; a
gradient through it is refused (its one caller in the reference, GAT's
softmax shift, is not ported).

``wire_dtype`` (e.g. ``torch.bfloat16``) compresses what crosses the
wire: the send side masks padding slots to the combine's neutral, then
casts (:func:`_wire_encode`; the packed sum path casts the exchange wire
once after the pack kernel); the receive side casts back and re-masks with
a fresh fp32 neutral (:func:`_wire_decode`), so the bf16-rounded ``max``
neutral (-1e30 -> about -1.004e30) never reaches a combine.  Rounding is
to nearest even, as JAX's ``astype``; under autograd the reversed exchange
rounds the gradient on the wire too, as JAX's transposed casts do.

:func:`halo_sync` runs on one process's rank-local graph and a
:class:`~repro_torch.launch.mesh.Mesh`.  Every exchange is posted
(:func:`halo_sync_post`): the rows are gathered (packed: one pack launch)
and every transfer is issued at once, and :meth:`PendingSync.finish`
waits for them and combines what arrived, in round (or sender) order, so a
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
from typing import Optional, Tuple

import torch

from repro_torch.kernels.halo_pack.ops import (
    ExchangeRound, halo_exchange, halo_exchange_rank_post)

NONE = "none"
A2A = "a2a"
NEIGHBOR = "neighbor"
AUTO = "auto"
SUM, MAX = "sum", "max"
COMBINES = (SUM, MAX)

#: the max combine's neutral, as the reference's
_NEG = -1e30
#: halo wire dtypes by name
WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}


def wire_dtype_of(wire) -> Optional[torch.dtype]:
    """A halo wire dtype from a torch dtype, its name or None."""
    if wire is None or isinstance(wire, torch.dtype):
        return wire
    name = str(wire).removeprefix("torch.")
    if name not in WIRE_DTYPES:
        raise ValueError(f"unknown halo wire dtype {wire!r}; expected one of "
                         f"{sorted(WIRE_DTYPES)}")
    return WIRE_DTYPES[name]


def wire_name(wire) -> Optional[str]:
    """The reference's name of a wire dtype (``"bfloat16"``), or None."""
    return None if wire is None else str(wire_dtype_of(wire)).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Static halo configuration: mode, neighbor rounds, wire format.

    ``perms`` holds one tuple of (src, dst) rank pairs per NEIGHBOR round;
    ``packed`` selects the bucketed per-round ``pk{k}_*`` arrays (NEIGHBOR
    only) whose gather/scatter run as the fused pack/unpack kernels under
    ``combine="sum"``; ``wire_dtype`` compresses on-wire buffers (module
    docstring).  ``rounds2d`` (NEIGHBOR) holds each round's chain of
    per-axis hops ``((axis, ((i, j), ...)), ...)`` of a two-level plan,
    ``grid2d`` its grid axes ``((axis a, Ga), (axis b, Gb))`` (rank
    ``a * Gb + b``) and ``perms`` then the rounds' flat (src, dst) pairs,
    which the stacked emulator exchanges along.
    """
    mode: str                                  # none | a2a | neighbor | auto
    perms: Tuple[Tuple[Tuple[int, int], ...], ...] = ()
    packed: bool = False
    wire_dtype: Optional[torch.dtype] = None
    rounds2d: Tuple = ()
    grid2d: Tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "wire_dtype", wire_dtype_of(self.wire_dtype))


def halo_spec_from_plan(plan, mode: str, packed: bool = False,
                        wire_dtype=None) -> HaloSpec:
    """Build the static HaloSpec from a host-side ``HaloPlan`` (a two-level
    plan's ``rounds2d`` and ``grid2d`` ride along)."""
    perms = tuple(tuple((int(a), int(b)) for a, b in rnd) for rnd in plan.perms)
    return HaloSpec(mode=mode, perms=perms, packed=packed, wire_dtype=wire_dtype,
                    rounds2d=tuple(getattr(plan, "rounds2d", ())),
                    grid2d=tuple(getattr(plan, "grid2d", ())))


def _check_spec(spec: HaloSpec, combine: str):
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}; expected one of {COMBINES}")
    if spec.mode == AUTO:
        raise ValueError("halo mode 'auto' must be resolved before the exchange "
                         "runs: call plan.autotune(graph) after ShardedGraph.build "
                         "(the training loop and the engine do this)")
    if spec.packed and spec.mode == A2A:
        raise ValueError("HaloSpec(packed=True) is neighbor-only: all-to-all "
                         "needs uniform per-rank buffers — use mode='neighbor'")
    if spec.mode not in (A2A, NEIGHBOR):
        raise ValueError(f"unknown halo mode {spec.mode!r}")


def _refuse_max_grad(a: torch.Tensor, combine: str):
    if combine == MAX and torch.is_grad_enabled() and a.requires_grad:
        raise NotImplementedError(
            "a gradient through a combine='max' halo exchange is not ported: its "
            "one caller in the reference is GAT's softmax shift "
            "(models/gnn_zoo/gat.py), which waits on ROADMAP queue 1's GAT item; "
            "run the max exchange under torch.no_grad() or on a detached tensor")


def _neutral(rows: torch.Tensor, mask: torch.Tensor, combine: str) -> torch.Tensor:
    """Rows with the slots of a zero mask set to the combine's neutral (0
    for sum, ``-1e30`` for max); ``mask`` [..., W] against rows [..., W, F]."""
    m = mask[..., None]
    return rows * m if combine == SUM else torch.where(m > 0, rows, _NEG)


def _compress(buf: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    if spec.wire_dtype is not None and buf.dtype != spec.wire_dtype:
        return buf.to(spec.wire_dtype)
    return buf


def _wire_encode(rows, mask, spec: HaloSpec, combine: str) -> torch.Tensor:
    """Send side, every mode: mask padding slots to the combine's neutral,
    THEN compress to the wire dtype."""
    return _compress(_neutral(rows, mask, combine), spec)


def _wire_decode(got, mask, combine: str, dtype) -> torch.Tensor:
    """Receive side: back to the compute dtype, then re-neutralize masked
    slots in full precision (the compressed neutral never survives)."""
    return _neutral(got.to(dtype), mask, combine)


def _scatter_combine(a, idx, upd, combine: str) -> torch.Tensor:
    """``upd`` rows combined onto ``a``'s rows ``idx``: a new tensor."""
    if combine == SUM:
        return a.index_add(0, idx, upd)
    return a.scatter_reduce(0, idx.long()[:, None].expand_as(upd), upd, "amax",
                            include_self=True)


def _use_fused_pack(spec: HaloSpec, combine: str) -> bool:
    # the pack / unpack-add kernels implement the masked gather and the
    # scatter-ADD; combine="max" keeps plain ops on the narrow packed arrays
    return spec.packed and combine == SUM


def _round_arrays(graph, spec: HaloSpec, k: int, stacked: bool):
    """Round ``k``'s (send_idx, send_mask, recv_idx, recv_mask): the packed
    ``pk{k}_*`` arrays or the dense ``nbr_*`` arrays' round ``k`` (leading
    rank axis kept when ``stacked``)."""
    if spec.packed:
        return tuple(graph[f"pk{k}_{n}"] for n in
                     ("send_idx", "send_mask", "recv_idx", "recv_mask"))
    return tuple(graph[f"nbr_{n}"][:, k] if stacked else graph[f"nbr_{n}"][k]
                 for n in ("send_idx", "send_mask", "recv_idx", "recv_mask"))


def _rounds_of(spec: HaloSpec, rounds_perms=None):
    """Each NEIGHBOR round's flat (src, dst) pairs: ``rounds_perms`` when
    given, else ``spec.perms`` (a two-level spec's flat pairs)."""
    if rounds_perms is not None:
        return tuple(tuple((int(s), int(d)) for s, d in p) for p in rounds_perms)
    if spec.rounds2d and len(spec.perms) != len(spec.rounds2d):
        raise ValueError(
            "a rounds2d spec needs its rounds' flat (src, dst) pairs: build it "
            "with NMPPlan.build(partition_mesh_2d(...), 'neighbor'), or pass "
            "rounds_perms=flat_rounds2d_perms(grid) (core/partition.py)")
    return spec.perms


def _exchange_rounds(graph, spec: HaloSpec, rounds=None):
    """Each packed round's :class:`ExchangeRound`: its rows' offset in the
    exchange wires ``pk_send`` / ``pk_recv`` (the earlier rounds' widths),
    its (sender, receiver) pairs by receiver, and its own wires."""
    out, offset = [], 0
    for k, perm in enumerate(_rounds_of(spec) if rounds is None else rounds):
        send, recv = graph.wire(f"pk{k}_send"), graph.wire(f"pk{k}_recv")
        pairs = tuple(sorted(((int(s), int(d)) for s, d in perm), key=lambda p: p[1]))
        out.append(ExchangeRound(offset, pairs, send, recv))
        offset += send.idx.shape[-1]
    return out


def halo_sync_reference(a_stacked: torch.Tensor, graph, spec: HaloSpec,
                        combine: str = SUM) -> torch.Tensor:
    """Single-device oracle over a stacked [R, N, F] aggregate.

    Emulates the A2A exchange with plain gathers and combines contributions
    in CANONICAL ascending-rank order from a neutral base (own partial
    spliced in at its rank position), so every coincident copy of a node
    evaluates the identical floating-point expression.  ``spec.wire_dtype``
    rounds each sent buffer through the wire dtype.
    """
    _check_spec(HaloSpec(mode=A2A), combine)
    _refuse_max_grad(a_stacked, combine)
    R = a_stacked.shape[0]
    send_idx, send_mask = graph["a2a_send_idx"], graph["a2a_send_mask"]
    recv_idx, recv_mask = graph["a2a_recv_idx"], graph["a2a_recv_mask"]
    outs = []
    for r in range(R):
        out_r = (torch.zeros_like(a_stacked[r]) if combine == SUM
                 else torch.full_like(a_stacked[r], _NEG))
        for s in range(R):
            if s == r:
                out_r = (out_r + a_stacked[r] if combine == SUM
                         else torch.maximum(out_r, a_stacked[r]))
                continue
            buf = _neutral(a_stacked[s].index_select(0, send_idx[s, r]),
                           send_mask[s, r], combine)
            if spec.wire_dtype is not None:
                buf = buf.to(spec.wire_dtype).to(a_stacked.dtype)
            out_r = _scatter_combine(out_r, recv_idx[r, s],
                                     _neutral(buf, recv_mask[r, s], combine), combine)
        outs.append(out_r)
    return torch.stack(outs)


def halo_sync_stacked(a_stacked: torch.Tensor, graph, spec: HaloSpec,
                      combine: str = SUM, rounds_perms=None) -> torch.Tensor:
    """Mode-faithful single-device emulator of the per-rank exchange over a
    stacked [R, N, F] aggregate: per-rank gathers, wire masking and
    compression, the exchange (emulated by indexing the senders' buffers),
    and a combine seeded from the local aggregate — the packed exchange op
    (one pack launch, one unpack-add per round and receiver, the reversed
    exchange as its gradient) when ``spec.packed`` and the combine is sum.

    A rounds2d spec exchanges along its rounds' flat (src, dst) pairs
    (``spec.perms``, or ``rounds_perms``, the reference's argument:
    ``core/partition.py::flat_rounds2d_perms(grid)``); the per-axis hop
    chains are the multi-process exchange's."""
    if spec.mode == NONE:
        return a_stacked
    _check_spec(spec, combine)
    _refuse_max_grad(a_stacked, combine)
    if a_stacked.dim() != 3:
        raise ValueError("halo_sync_stacked expects a stacked [R, N, F] "
                         f"aggregate, got shape {tuple(a_stacked.shape)}")
    R, dtype = a_stacked.shape[0], a_stacked.dtype

    if spec.mode == A2A:
        send_idx, send_mask = graph["a2a_send_idx"], graph["a2a_send_mask"]
        recv_idx, recv_mask = graph["a2a_recv_idx"], graph["a2a_recv_mask"]
        outs = []
        for r in range(R):
            out_r = a_stacked[r]
            # what all-to-all delivers to rank r: sender s's slice r,
            # combined in sender order
            for s in range(R):
                buf = _wire_encode(a_stacked[s].index_select(0, send_idx[s, r]),
                                   send_mask[s, r], spec, combine)
                out_r = _scatter_combine(out_r, recv_idx[r, s], _wire_decode(
                    buf, recv_mask[r, s], combine, dtype), combine)
            outs.append(out_r)
        return torch.stack(outs)

    rounds = _rounds_of(spec, rounds_perms)
    if _use_fused_pack(spec, combine):
        return halo_exchange(a_stacked, graph.wire("pk_send"), graph.wire("pk_recv"),
                             _exchange_rounds(graph, spec, rounds),
                             wire_dtype=spec.wire_dtype)

    # NEIGHBOR, dense wires (or packed under max): per-round pair exchanges
    out = list(a_stacked.unbind(0))
    for k, perm in enumerate(rounds):
        if not perm:
            continue
        send_idx, send_mask, recv_idx, recv_mask = _round_arrays(graph, spec, k, True)
        src_of = {int(d): int(s) for (s, d) in perm}
        new_out = list(out)
        for r in range(R):
            s = src_of.get(r)
            if s is None:
                continue   # non-destination ranks receive nothing
            # gather from the ORIGINAL aggregate, combine into the running one
            buf = _wire_encode(a_stacked[s].index_select(0, send_idx[s]), send_mask[s],
                               spec, combine)
            new_out[r] = _scatter_combine(out[r], recv_idx[r], _wire_decode(
                buf, recv_mask[r], combine, dtype), combine)
        out = new_out
    return torch.stack(out)


def _peers(perm, rank: int):
    """(the rank ``rank`` sends to, the rank it receives from) in one round."""
    return (next((d for s, d in perm if s == rank), None),
            next((s for s, d in perm if d == rank), None))


class PendingSync:
    """A posted halo exchange of one process (:func:`halo_sync_post`);
    :meth:`finish` waits for it and returns ``a*``."""
    __slots__ = ("_finish",)

    def __init__(self, finish):
        self._finish = finish

    def finish(self) -> torch.Tensor:
        return self._finish()


def _a2a_post(a, ends, group, spec: HaloSpec, combine: str) -> PendingSync:
    """Gather every peer's rows (masked to the neutral, compressed), post
    the all-to-all; the finish combines what each sender sent, in sender
    order, seeded from ``a``."""
    send_idx, send_mask, recv_idx, recv_mask = ends
    R, w = send_idx.shape
    rows = a.index_select(0, send_idx.reshape(-1)).reshape(R, w, a.shape[1])
    posted = group.post_all_to_all(_wire_encode(rows, send_mask, spec, combine))

    def finish():
        got, out = posted.wait()[0], a
        for s in range(R):
            out = _scatter_combine(out, recv_idx[s], _wire_decode(
                got[s], recv_mask[s], combine, a.dtype), combine)
        return out
    return PendingSync(finish)


def _neighbor_post(a, rounds, peers, post, spec: HaloSpec,
                   combine: str) -> PendingSync:
    """Dense (or packed, under max) neighbor rounds, posted at once: each
    round's rows gathered from the ORIGINAL ``a``; the finish combines each
    round received into the running result, in round order.  ``rounds``
    holds each round's (send_idx, send_mask, recv_idx, recv_mask)."""
    wire = spec.wire_dtype or a.dtype
    posted = post(
        (_wire_encode(a.index_select(0, si), sm, spec, combine) if to is not None
         else None, to, frm, (ri.shape[0], a.shape[1]), wire)
        for (si, sm, ri, _), (to, frm) in zip(rounds, peers))

    def finish():
        out = a
        for (_, _, ri, rm), got in zip(rounds, posted.wait()):
            if got is not None:
                out = _scatter_combine(out, ri, _wire_decode(got, rm, combine, a.dtype),
                                       combine)
        return out.clone() if out is a else out
    return PendingSync(finish)


class _ChainPost:
    """``post(items)`` of a two-level (rounds2d) exchange for one process,
    with ``Group.post_permute``'s contract (one ``(rows, to, frm, shape,
    dtype)`` per round; ``wait()`` gives each round's rows, None where
    nothing is received): each round's rows travel its chain of hops, one
    one-way permutation along one grid axis per hop
    (``Group.post_permute``).  Only chains that start at a round's sender
    and end at its receiver (its flat pair) are sent: the middle rank of a
    diagonal forwards what it received, and a rank outside the shift
    receives nothing (JAX's chained ``ppermute`` delivers zeros there,
    which the receive mask drops).  ``reverse`` walks every chain backwards
    (the hops in reverse order, each pair reversed): the exchange's
    gradient.

    A posted two-hop round cannot forward before its first hop arrived:
    the post waits on every round's first hop, then posts the second hops;
    only those are left in flight for ``wait()``."""

    def __init__(self, spec: HaloSpec, rank: int, group, reverse: bool = False):
        if len(spec.grid2d) != 2 or len(spec.perms) != len(spec.rounds2d):
            raise ValueError("a rounds2d exchange over processes needs the spec's "
                             "grid2d and flat perms: build the plan with "
                             "NMPPlan.build(partition_mesh_2d(...), 'neighbor')")
        (axis_a, _), (axis_b, gb) = spec.grid2d
        if group.size != spec.grid2d[0][1] * gb:
            raise ValueError(f"the graph group has {group.size} ranks, the rounds2d "
                             f"grid {spec.grid2d}")
        stride = {axis_a: gb, axis_b: 1}
        self.group, self.hops, self.dest = group, [], []
        for hops, flat in zip(spec.rounds2d, spec.perms):
            steps = [stride[axis] * (pairs[0][1] - pairs[0][0])
                     for axis, pairs in hops if pairs]
            # each chain's ranks, origin to destination
            chains = [[o + sum(steps[:h]) for h in range(len(steps) + 1)]
                      for o, _ in flat]
            if reverse:
                chains = [c[::-1] for c in chains]
            per_hop = []
            for h in range(len(steps) if flat else 0):
                pairs = [(c[h], c[h + 1]) for c in chains]
                per_hop.append((next((d for s, d in pairs if s == rank), None),
                                next((s for s, d in pairs if d == rank), None)))
            self.hops.append(per_hop)
            self.dest.append(any(c[-1] == rank for c in chains))

    def __call__(self, items):
        items = list(items)
        first = self.group.post_permute(
            [(rows if hops and hops[0][0] is not None else None,
              *(hops[0] if hops else (None, None)), shape, dtype)
             for (rows, _, _, shape, dtype), hops in zip(items, self.hops)])
        if all(len(h) < 2 for h in self.hops):
            return _ChainPosted(first, None, self.dest)
        got = first.wait(count=False)
        second = self.group.post_permute(
            [(g if len(h) > 1 and h[1][0] is not None else None,
              *(h[1] if len(h) > 1 else (None, None)), shape, dtype)
             for g, h, (_, _, _, shape, dtype) in zip(got, self.hops, items)],
            tag=len(items))
        return _ChainPosted(got, second, self.dest)


class _ChainPosted:
    """A posted rounds2d exchange: each round's rows from its last hop
    (the second hop's, or the first's for a one-hop round), None where this
    rank is no receiver of the round."""

    def __init__(self, first, second, dest):
        self.first, self.second, self.dest = first, second, dest

    def wait(self) -> list:
        if self.second is None:
            last = self.first.wait()
        else:
            got2 = self.second.wait()
            last = [g2 if g2 is not None else g1 for g1, g2 in zip(self.first, got2)]
        return [g if d else None for g, d in zip(last, self.dest)]


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


def _posters(graph, spec: HaloSpec, mesh, combine: str):
    """(post, post_back) of one process's exchange: each takes an [N, F]
    tensor, gathers its rows to send (packed sum: one pack launch), issues
    every transfer at once and returns what ``finish()`` waits for and
    combines; ``post_back`` runs the reversed exchange (send and recv sides
    and, in each round, the partners swapped; a rounds2d chain walked
    backwards), the gradient of a sum."""
    group = mesh.graph_group
    if spec.mode == A2A:
        _check_a2a(graph, group)
        ends = (graph["a2a_send_idx"], graph["a2a_send_mask"],
                graph["a2a_recv_idx"], graph["a2a_recv_mask"])
        back = ends[2:] + ends[:2]
        return (lambda t: _a2a_post(t, ends, group, spec, combine),
                lambda t: _a2a_post(t, back, group, spec, combine))
    rounds = _rounds_of(spec)
    peers = tuple(_peers(perm, mesh.rank) for perm in rounds)
    back_peers = tuple((frm, to) for to, frm in peers)
    if spec.rounds2d:
        post, post_back = (_ChainPost(spec, mesh.rank, group, reverse)
                           for reverse in (False, True))
    else:
        post = post_back = group.post_permute
    if _use_fused_pack(spec, combine):
        args = (graph.wire("pk_send"), graph.wire("pk_recv"),
                _exchange_rounds(graph, spec, rounds), peers)
        return (lambda t: halo_exchange_rank_post(t, *args, post,
                                                  wire_dtype=spec.wire_dtype),
                lambda t: halo_exchange_rank_post(t, *args, post_back, reverse=True,
                                                  wire_dtype=spec.wire_dtype))
    arrays = [_round_arrays(graph, spec, k, False) for k in range(len(rounds))]
    back = [r[2:] + r[:2] for r in arrays]
    return (lambda t: _neighbor_post(t, arrays, peers, post, spec, combine),
            lambda t: _neighbor_post(t, back, back_peers, post_back, spec, combine))


def _rank_local(a, graph, spec: HaloSpec, combine: str, name: str):
    _check_spec(spec, combine)
    if a.dim() != 2 or graph["node_mask"].dim() != 1:
        raise ValueError(f"{name} expects one rank's [N, F] or [B, N, F] aggregate "
                         f"and a rank-local graph; got {tuple(a.shape)} and a graph "
                         f"of node_mask {tuple(graph['node_mask'].shape)}")
    return a.contiguous()


def halo_sync_post(a: torch.Tensor, graph, spec: HaloSpec, mesh,
                   combine: str = SUM) -> PendingSync:
    """Post :func:`halo_sync`'s exchange: gather the rows to send (packed
    sum: one pack launch) and issue every transfer of the exchange at once
    (``Group.post_all_to_all`` / ``post_permute``; a rounds2d exchange waits
    on its first hops before it posts the second: :class:`_ChainPost`).
    Returns a :class:`PendingSync` whose ``finish()`` waits for the rows
    and combines them as :func:`halo_sync` does, bitwise equal to it.  Not
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
    return _posters(graph, spec, mesh, combine)[0](a)


def _check_a2a(graph, group):
    if graph["a2a_send_idx"].shape[0] != group.size:
        raise ValueError(f"the graph has {graph['a2a_send_idx'].shape[0]} "
                         f"ranks, the graph group {group.size}")


def halo_sync(a: torch.Tensor, graph, spec: HaloSpec, mesh,
              combine: str = SUM) -> torch.Tensor:
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
    posted at once (rounds2d: one per hop of each round's chain); packed
    NEIGHBOR under sum one pack launch, the rounds' slices posted, then one
    unpack-add launch per round received.  It is :func:`halo_sync_post`
    and its finish, differentiable in ``a`` under ``combine="sum"`` (the
    backward posts and finishes the reversed exchange); ``combine="max"``
    refuses a gradient.  Returns ``a*``, shaped as ``a``.
    """
    if spec.mode == NONE:
        return a
    _refuse_max_grad(a, combine)
    if a.dim() == 3:
        # rows are exchanged whole: carry the batch as feature columns
        b, n, f = a.shape
        flat = a.permute(1, 0, 2).reshape(n, b * f)
        return halo_sync(flat, graph, spec, mesh, combine).reshape(n, b, f) \
            .permute(1, 0, 2)
    a = _rank_local(a, graph, spec, combine, "halo_sync")
    post, post_back = _posters(graph, spec, mesh, combine)
    if combine == MAX:
        return post(a).finish()
    return _Exchange.apply(a, post, post_back)
