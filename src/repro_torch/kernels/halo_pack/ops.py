"""Packed halo wire ops: the CUDA kernels' wrappers and their plain versions.

Port of ``repro.kernels.halo_pack.ops`` (``halo_pack`` /
``halo_unpack_add``), differentiable, over one round's :class:`HaloWire`:

* ``halo_pack(x, wire)``            -> ``buf = x[idx] * mask[:, None]``
* ``halo_unpack_add(a, buf, wire)`` -> ``a.index_add(0, idx, buf * mask)``

and the whole packed neighbor exchange of a stacked [R, N, F] aggregate as
one differentiable op, :func:`halo_exchange`: one pack launch for every
round and sender (the rounds' send wires concatenated into one exchange
wire), then one unpack-add per (round, receiver); its backward is the
reversed exchange (one pack of the incoming gradient through the
concatenated recv wire, then one unpack-add per (round, sender) through
the round's send wire, seeded with the gradient).

:func:`halo_exchange_rank` is the same exchange on one process's [N, F]
aggregate, given each round's peers, their rows arriving through a
``swap`` callable (the process group of ``core/halo.py::halo_sync``): one pack
launch for every round, one unpack-add per round received, and the
reversed exchange as its gradient.

On a CUDA tensor each wrapper launches its kernel in ``csrc/halo_pack.cu``
(or raises); on a CPU tensor it runs the plain version.  Both kernels are
pure data movement and bitwise equal to the plain versions, which are
bitwise equal to ``repro.kernels.halo_pack.ref`` (``tests/test_torch_kernels``).

A wire carries ``idx`` and ``mask`` and, when :func:`halo_wire` built it,
their inverse ``inv`` (``inv[r]`` is the slot with a non-zero mask that
lands on row ``r``, -1 for rows that receive nothing), so the kernels and
the plain versions read one object whose inverse matches its ids.
``ShardedGraph.build`` makes each packed round's wires, and the exchange
wires (``pk_send`` / ``pk_recv``: the rounds' wires concatenated, no
inverse), once per plan.  The unpack-add kernel is a gather through
``inv``, one pass with no seed copy; the pack kernel needs it only for its
gradient, which is an unpack-add.  Slots with mask 0 add nothing on the
card, so a non-finite value in a padding slot's buffer row (``x[0] * 0``)
does not reach row 0 there as it does in the plain version.

Each op is the other's adjoint, as in the reference's custom VJPs
(``_pack_core`` / ``_unpack_core``): d pack / d x =
``halo_unpack_add(zeros, g, wire)``, d unpack / d a = g and
d unpack / d buf = ``halo_pack(g, wire)`` — so on CUDA tensors each
backward launches the other op's kernel (and counts that launch).  When no
gradient is needed the wrappers call the op directly: these launches are
host-bound, and the ``autograd.Function`` would add its own host cost.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

KERNEL = "halo_pack"
PACK, UNPACK = "halo_pack", "halo_unpack_add"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "halo_pack_f32": (_P,) * 4 + (_I,) * 4 + (_P,),
    "halo_unpack_add_f32": (_P,) * 5 + (_I,) * 2 + (_P,),
}
_F32, _I32 = torch.float32, torch.int32
_lib = None          # (library, pack entry, unpack-add entry) once loaded


class HaloWire(NamedTuple):
    """One round's wire: ``idx`` [..., W] int32 row ids, ``mask`` [..., W]
    0/1 float32 and ``inv`` [..., N] int32, their inverse (module
    docstring), or None: the plain versions only.  A leading rank axis is
    kept until :meth:`rank` slices it.  Build one with :func:`halo_wire`."""
    idx: torch.Tensor
    mask: torch.Tensor
    inv: Optional[torch.Tensor] = None

    def rank(self, r: int) -> "HaloWire":
        return HaloWire(self.idx[r], self.mask[r],
                        None if self.inv is None else self.inv[r])

    def to(self, device) -> "HaloWire":
        return HaloWire(*(None if t is None else t.to(device) for t in self))


def halo_wire(idx: torch.Tensor, mask: torch.Tensor, n_rows: int) -> HaloWire:
    """The wire of ``idx`` / ``mask`` ([..., W]) with its inverse over the
    real slots: ``inv[..., r]`` is the one slot ``w`` with
    ``mask[..., w] != 0`` and ``idx[..., w] == r``, and -1 for rows no real
    slot maps to ([..., n_rows] int32, on idx's device).  Built once per
    halo plan, never per call (it reads back to the host); raises if two
    real slots share a row or a real id lies outside ``[0, n_rows)``."""
    if mask.shape != idx.shape:
        raise ValueError(f"halo_wire: mask {tuple(mask.shape)} does not match "
                         f"idx {tuple(idx.shape)}")
    lead, w = idx.shape[:-1], idx.shape[-1]
    flat = idx.reshape(math.prod(lead), w).long()
    b, slot = torch.nonzero(mask.reshape(flat.shape) != 0, as_tuple=True)
    rows = flat[b, slot]
    if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= n_rows):
        raise ValueError(f"halo_wire: real ids outside [0, {n_rows})")
    key = b * n_rows + rows
    if torch.unique(key).numel() != key.numel():
        raise ValueError("halo_wire: two real slots share a row")
    inv = torch.full((flat.shape[0], n_rows), -1, dtype=_I32, device=idx.device)
    inv[b, rows] = slot.to(_I32)
    return HaloWire(idx, mask, inv.reshape(*lead, n_rows))


def halo_pack_plain(x, idx, mask):
    """``buf[i] = x[idx[i]] * mask[i]`` — masked row gather, [W, F]."""
    return x.index_select(0, idx) * mask[:, None]


def halo_unpack_add_plain(a, buf, idx, mask):
    """``out = a.at[idx].add(buf * mask[:, None])`` — masked scatter-add."""
    return a.index_add(0, idx, buf * mask[:, None])


def _check_wire(name, rows, wire):
    idx, mask = wire.idx, wire.mask
    if rows.dim() != 2 or idx.dim() != 1 or mask.shape != idx.shape:
        raise ValueError(f"{name}: expected rows [N, F], idx [W], mask [W]; "
                         f"got {tuple(rows.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(mask.shape)}")
    if not (rows.is_cuda or rows.is_cpu):
        raise ValueError(f"{name}: unsupported device {rows.device}")


def _entries():
    global _lib
    if _lib is None:
        lib = build.load(KERNEL, _SIGNATURES)
        _lib = (lib, lib.halo_pack_f32, lib.halo_unpack_add_f32)
    return _lib


def _bad_args(name, tensors, dtypes):
    """Name the pointer argument that failed the wrapper's one-line check
    (dtype, device index, contiguity), and raise."""
    build.require_cuda(name, *tensors, dtypes=dtypes)
    raise ValueError(f"{name}: arguments not on one CUDA device")


def _pack(x, idx, mask):
    """``x`` [N, F] with ``idx`` / ``mask`` [W] -> [W, F]; or one pack of
    every sender: ``x`` [S, N, F] with [S, W] -> [S, W, F]."""
    if x.is_cpu:
        if x.dim() == 2:
            return halo_pack_plain(x, idx, mask)
        return torch.stack([halo_pack_plain(x[s], idx[s], mask[s])
                            for s in range(x.shape[0])])
    dev = x.get_device()
    if not (x.dtype is _F32 and idx.dtype is _I32 and mask.dtype is _F32
            and idx.get_device() == dev and mask.get_device() == dev
            and x.is_contiguous() and idx.is_contiguous() and mask.is_contiguous()):
        _bad_args(PACK, (x, idx, mask), (_F32, _I32, _F32))
    n, f = x.shape[-2:]
    w = idx.shape[-1]
    senders = x.shape[0] if x.dim() == 3 else 1
    buf = x.new_empty(idx.shape + (f,))
    lib, fn, _ = _lib or _entries()
    code = fn(x.data_ptr(), idx.data_ptr(), mask.data_ptr(), buf.data_ptr(),
              w, f, n, senders, build.stream_of(x))
    if code:
        build.check(lib, code, "halo_pack_f32")
    build.count_launch(PACK)
    return buf


def _unpack_add(a, buf, idx, mask, inv, n_rows):
    """``a`` None is a zero seed of ``n_rows`` rows (the pack's adjoint)."""
    if buf.is_cpu:
        seed = buf.new_zeros((n_rows, buf.shape[1])) if a is None else a
        return halo_unpack_add_plain(seed, buf, idx, mask)
    if inv is None:
        raise ValueError(
            f"{UNPACK}: the CUDA kernel needs the wire's inv, the inverse of "
            "idx over the slots with a non-zero mask (build it with halo_wire)")
    if inv.shape != (n_rows,):
        raise ValueError(f"{UNPACK}: inv {tuple(inv.shape)} is not [N] = [{n_rows}]")
    dev = buf.get_device()
    if not (buf.dtype is _F32 and mask.dtype is _F32 and inv.dtype is _I32
            and mask.get_device() == dev and inv.get_device() == dev
            and buf.is_contiguous() and mask.is_contiguous() and inv.is_contiguous()
            and (a is None or (a.dtype is _F32 and a.get_device() == dev
                               and a.is_contiguous()))):
        _bad_args(UNPACK, (buf, mask, inv) + (() if a is None else (a,)),
                  (_F32, _F32, _I32, _F32))
    f = buf.shape[1]
    out = buf.new_empty((n_rows, f)) if a is None else torch.empty_like(a)
    lib, _, fn = _lib or _entries()
    code = fn(None if a is None else a.data_ptr(), buf.data_ptr(), inv.data_ptr(),
              mask.data_ptr(), out.data_ptr(), n_rows, f, build.stream_of(buf))
    if code:
        build.check(lib, code, "halo_unpack_add_f32")
    build.count_launch(UNPACK)
    return out


class _Pack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, mask, inv):
        ctx.save_for_backward(idx, mask, inv)
        ctx.n_rows = x.shape[0]
        return _pack(x, idx, mask)

    @staticmethod
    def backward(ctx, g):
        idx, mask, inv = ctx.saved_tensors
        gx = _unpack_add(None, g.contiguous(), idx, mask, inv, ctx.n_rows)
        return gx, None, None, None


class _UnpackAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, buf, idx, mask, inv):
        ctx.save_for_backward(idx, mask)
        return _unpack_add(a, buf, idx, mask, inv, a.shape[0])

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        return g, _pack(g.contiguous(), idx, mask), None, None, None


def halo_pack(x: torch.Tensor, wire: HaloWire) -> torch.Tensor:
    """Fused masked row gather: ``buf = x[wire.idx] * wire.mask[:, None]``.

    x: [N, F] float32; wire: one rank's :class:`HaloWire` (idx [W] int32,
    unique among slots with a non-zero mask; mask [W] 0/1, padding slots
    become zeros; its inv is needed only for the gradient of a CUDA x).
    Returns [W, F]; differentiable in x."""
    _check_wire(PACK, x, wire)
    idx, mask, inv = wire
    if torch.is_grad_enabled() and x.requires_grad:
        if x.is_cuda and inv is None:
            raise ValueError(f"{PACK}: the gradient of a CUDA x needs the wire's "
                             "inv, the inverse of idx (build it with halo_wire)")
        return _Pack.apply(x, idx, mask, inv)
    return _pack(x, idx, mask)


def halo_unpack_add(a: torch.Tensor, buf: torch.Tensor, wire: HaloWire
                    ) -> torch.Tensor:
    """Fused masked scatter-add:
    ``out = a.at[wire.idx].add(buf * wire.mask[:, None])``.

    a: [N, F] float32 (the combine seed, not modified); buf: [W, F] recv
    buffer; wire: one rank's :class:`HaloWire` (idx [W] int32 destination
    rows, unique among slots with a non-zero mask; mask [W] 0/1; inv [N],
    which the CUDA kernel gathers through).  Returns [N, F]; differentiable
    in a and buf."""
    _check_wire(UNPACK, a, wire)
    idx, mask, inv = wire
    if buf.shape != (idx.shape[0], a.shape[1]):
        raise ValueError(f"{UNPACK}: buf {tuple(buf.shape)} does not match "
                         f"[W, F] = [{idx.shape[0]}, {a.shape[1]}]")
    if torch.is_grad_enabled() and (a.requires_grad or buf.requires_grad):
        return _UnpackAdd.apply(a, buf, idx, mask, inv)
    return _unpack_add(a, buf, idx, mask, inv, a.shape[0])


class ExchangeRound(NamedTuple):
    """One round of a packed exchange: the offset of its rows in the
    exchange wire, its (sender, receiver) pairs in the order their
    unpack-adds run (receivers ascending), and the round's own send and
    recv wires ([R, W_k], with their inverses)."""
    offset: int
    pairs: Tuple[Tuple[int, int], ...]
    send: HaloWire
    recv: HaloWire


def _exchange(a, wire, rounds, forward: bool):
    """One pack of ``a`` [R, N, F] through the exchange ``wire`` [R, W],
    then each round's unpack-adds into the running result, seeded with
    ``a``.  Forward: receiver r takes sender s's rows through the round's
    recv wire.  Backward (``a`` the incoming gradient, ``wire`` the
    concatenated recv wire): sender s takes receiver r's rows through the
    round's send wire."""
    buf = _pack(a, wire.idx, wire.mask)
    out = list(a.unbind(0))
    for rnd in rounds:
        lo = rnd.offset
        hi = lo + rnd.send.idx.shape[-1]
        for s, r in rnd.pairs:
            src, dst, w = (s, r, rnd.recv) if forward else (r, s, rnd.send)
            wr = w.rank(dst)
            out[dst] = _unpack_add(out[dst], buf[src, lo:hi], wr.idx, wr.mask, wr.inv,
                                   a.shape[1])
    return torch.stack(out)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, send, recv, rounds):
        ctx.recv, ctx.rounds = recv, rounds
        return _exchange(a, send, rounds, True)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.recv, ctx.rounds, False), None, None, None


def halo_exchange(a: torch.Tensor, send: HaloWire, recv: HaloWire,
                  rounds: Sequence[ExchangeRound]) -> torch.Tensor:
    """The packed neighbor exchange of a stacked aggregate, Eq. 4c-d.

    a: [R, N, F] float32; send / recv: the exchange wires ([R, W], the
    rounds' send / recv wires concatenated; ``ShardedGraph`` holds them as
    ``pk_send`` / ``pk_recv``); rounds: each round's :class:`ExchangeRound`.

    Every round gathers from the original ``a``, so all rounds' send
    buffers are packed by one launch, before the first unpack; then round
    by round, each receiver r adds sender s's rows into the running result
    (seeded with ``a[r]``), one unpack-add each.  Bitwise equal to the
    per-round path (a pack and an unpack-add per round and receiver).
    Differentiable in ``a``: the backward is the reversed exchange, one
    pack of the gradient through ``recv`` and one unpack-add per round and
    sender through the round's send wire, seeded with the gradient.
    Returns [R, N, F]."""
    if a.dim() != 3 or send.idx.shape != (a.shape[0], send.idx.shape[-1]) \
            or recv.idx.shape != send.idx.shape:
        raise ValueError(f"halo_exchange: expected a [R, N, F] and wires [R, W]; got "
                         f"{tuple(a.shape)}, {tuple(send.idx.shape)}, "
                         f"{tuple(recv.idx.shape)}")
    if torch.is_grad_enabled() and a.requires_grad:
        return _Exchange.apply(a, send, recv, tuple(rounds))
    return _exchange(a, send, rounds, True)


def _exchange_rank(a, wire, rounds, peers, swap, forward: bool):
    """:func:`_exchange` on one process: ``a`` [N, F] is its own, ``wire``
    and each round's wires its own slices ([W]), ``peers`` each round's
    (rank it sends to, rank it receives from).  Forward: send the round's
    rows to the receiver, unpack-add what the sender sent through the
    round's recv wire.  Backward (``a`` the incoming gradient, ``wire`` the
    concatenated recv wire): send the round's rows back to the sender,
    unpack-add what the receiver sends back through the round's send
    wire."""
    buf = _pack(a, wire.idx, wire.mask)
    out = a
    for rnd, (to, frm) in zip(rounds, peers):
        lo = rnd.offset
        hi = lo + rnd.send.idx.shape[-1]
        if not forward:
            to, frm = frm, to
        got = swap(buf[lo:hi] if to is not None else None, to, frm,
                   (hi - lo, a.shape[1]), a.dtype)
        if got is not None:
            w = rnd.recv if forward else rnd.send
            out = _unpack_add(out, got, w.idx, w.mask, w.inv, a.shape[0])
    return out.clone() if out is a else out


class _RankExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, send, recv, rounds, peers, swap):
        ctx.recv, ctx.rounds, ctx.peers, ctx.swap = recv, rounds, peers, swap
        return _exchange_rank(a, send, rounds, peers, swap, True)

    @staticmethod
    def backward(ctx, g):
        return (_exchange_rank(g.contiguous(), ctx.recv, ctx.rounds, ctx.peers,
                               ctx.swap, False), None, None, None, None, None)


def halo_exchange_rank(a: torch.Tensor, send: HaloWire, recv: HaloWire,
                       rounds: Sequence[ExchangeRound],
                       peers: Sequence[Tuple[Optional[int], Optional[int]]],
                       swap: Callable) -> torch.Tensor:
    """The packed neighbor exchange of one rank's aggregate, Eq. 4c-d: the
    per-process counterpart of :func:`halo_exchange`.

    a: [N, F] float32, this rank's; send / recv: its exchange wires ([W],
    ``graph.wire("pk_send")`` / ``("pk_recv")`` of a rank-local graph);
    rounds: each round's :class:`ExchangeRound` with this rank's wires
    ([W_k]); peers: each round's (rank this one sends to, rank it receives
    from), None where it does not; ``swap(rows, to, frm, shape, dtype)``
    sends ``rows`` to rank ``to`` and returns the ``shape`` rows rank
    ``frm`` sent (None for a missing side).

    One pack launch gathers every round's send rows from the original
    ``a``; round by round, the round's slice goes to this rank's receiver
    and the sender's rows are unpack-added into the running result (seeded
    with ``a``), one launch each.  Each rank's result is bitwise equal to
    its slice of :func:`halo_exchange`.  Differentiable in ``a``: the
    backward is the reversed exchange (one pack of the gradient through
    ``recv``, each round's slice back to its sender, one unpack-add per
    round through the round's send wire, seeded with the gradient).
    Returns [N, F]."""
    if a.dim() != 2 or send.idx.dim() != 1 or recv.idx.shape != send.idx.shape:
        raise ValueError(f"halo_exchange_rank: expected a [N, F] and wires [W]; got "
                         f"{tuple(a.shape)}, {tuple(send.idx.shape)}, "
                         f"{tuple(recv.idx.shape)}")
    rounds, peers = tuple(rounds), tuple(peers)
    if len(peers) != len(rounds):
        raise ValueError(f"halo_exchange_rank: {len(rounds)} rounds, "
                         f"{len(peers)} peer pairs")
    if torch.is_grad_enabled() and a.requires_grad:
        return _RankExchange.apply(a, send, recv, rounds, peers, swap)
    return _exchange_rank(a, send, rounds, peers, swap, True)
