"""Halo exchanges (Sec. II-B Eq. 4c-d) over a stacked [R, ...] graph on one
device (port of the single-device parts of ``repro.core.halo``).

Modes, matching the paper's study:

* ``NONE``     — skip the exchange: the *inconsistent* baseline.
* ``A2A``      — equal-size buffers to every rank.
* ``NEIGHBOR`` — rounds of disjoint rank-pair swaps (one round per color of
                 the rank-adjacency edge coloring); ``packed=True`` ships
                 the bucketed per-round buffers and runs the pack/unpack
                 CUDA kernels (``repro_torch.kernels.halo_pack``).

The "synchronization" (Eq. 4d) is fused into the exchange: received
buffers are scatter-added onto the owning local rows.  Every scatter here
adds one sender's buffer at a time, whose real ids are unique, so the sums
are deterministic on the GPU too (only exact zero-adds of padding slots
can collide).  Only ``combine="sum"`` is ported.

The real multi-process exchange (``halo_sync`` on ``torch.distributed``)
is a later slice; :func:`halo_sync_stacked` emulates its per-rank
arithmetic and :func:`halo_sync_reference` is the canonical-order oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels.halo_pack.ops import halo_pack, halo_unpack_add

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


def _gather_wire(a, idx, mask, spec: HaloSpec):
    """Pack boundary rows into one round's send buffer (Eq. 4c send side)."""
    if spec.packed:
        return halo_pack(a, idx, mask)
    return a.index_select(0, idx) * mask[:, None]


def _scatter_wire(out, idx, mask, got, spec: HaloSpec):
    """Apply one round's received buffer onto the local rows (Eq. 4d)."""
    if spec.packed:
        return halo_unpack_add(out, got, idx, mask)
    return out.index_add(0, idx, got * mask[:, None])


def _stacked_round_arrays(graph, spec: HaloSpec, k: int):
    """Round-``k`` (send_idx, send_mask, recv_idx, recv_mask), leading rank
    axis kept: bucketed ``pk{k}_*`` when packed, dense ``nbr_*`` slices
    otherwise."""
    if spec.packed:
        return (graph[f"pk{k}_send_idx"], graph[f"pk{k}_send_mask"],
                graph[f"pk{k}_recv_idx"], graph[f"pk{k}_recv_mask"])
    return (graph["nbr_send_idx"][:, k], graph["nbr_send_mask"][:, k],
            graph["nbr_recv_idx"][:, k], graph["nbr_recv_mask"][:, k])


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
    scatter-add seeded from the local aggregate — including the packed
    pack/unpack kernels when ``spec.packed``."""
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

    # NEIGHBOR: per-round disjoint pair exchanges
    out = list(a_stacked.unbind(0))
    for k, perm in enumerate(spec.perms):
        if not perm:
            continue
        sidx, smask, ridx, rmask = _stacked_round_arrays(graph, spec, k)
        src_of = {int(d): int(s) for (s, d) in perm}
        new_out = list(out)
        for r in range(R):
            s = src_of.get(r)
            if s is None:
                continue   # non-destination ranks receive nothing
            # gather from the ORIGINAL aggregate, scatter into the running one
            buf = _gather_wire(a_stacked[s], sidx[s], smask[s], spec)
            new_out[r] = _scatter_wire(out[r], ridx[r], rmask[r], buf, spec)
        out = new_out
    return torch.stack(out)
