"""Execution state for the consistent GNN: ShardedGraph + NMPPlan (port of
``repro.core.graph_state``).

* :class:`ShardedGraph` — the per-rank static arrays of one partition as a
  dict of tensors on one device, each with a leading rank axis (node/edge
  indices, masks, inverse multiplicities, halo buffers, static geometric
  edge features, the fused kernel's compact layout) and the packed halo
  rounds' wires; :meth:`rank` slices one rank out.
* :class:`NMPPlan` — a frozen execution policy: NMP backend (``xla`` |
  ``fused``), schedule, fused-layout block sizes and the
  :class:`~repro_torch.core.halo.HaloSpec`.  Layer implementations register
  per ``(backend, schedule)`` cell via :func:`register_nmp_impl`.

This slice registers the blocking schedule for both backends; the overlap
schedule, ``auto`` tuning, bf16 and multilevel graphs come later.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.halo import AUTO, HaloSpec, halo_spec_from_plan
from repro_torch.kernels.halo_pack.ops import HaloWire, halo_wire

XLA = "xla"          # plain PyTorch ops (the name mirrors the reference)
FUSED = "fused"      # the hand-written CUDA kernel
BACKENDS = (XLA, FUSED)
BLOCKING = "blocking"
OVERLAP = "overlap"
SCHEDULES = (BLOCKING, OVERLAP, AUTO)


@dataclasses.dataclass(frozen=True)
class NMPPlan:
    """Static execution policy for every consistent-NMP forward path.

    ``block_n`` / ``block_e`` key the cached compact layout (``block_e`` is
    its tile depth); the CUDA kernel itself walks the layout node by node,
    so they do not change its arithmetic.
    """
    halo: HaloSpec = HaloSpec(mode="none")
    backend: str = XLA
    schedule: str = BLOCKING
    block_n: int = 128
    block_e: int = 128

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown NMP backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"expected one of {SCHEDULES}")

    @property
    def seg_layout(self) -> Tuple[int, int] | None:
        """The (block_n, block_e) layout key the fused backend needs."""
        return (self.block_n, self.block_e) if self.backend == FUSED else None

    @property
    def wants_packed(self) -> bool:
        return self.halo.packed or self.halo.mode == AUTO

    @classmethod
    def build(cls, pg, mode: str, packed: bool = False, **policy) -> "NMPPlan":
        """Plan with its halo spec derived from ``pg``'s halo plan."""
        return cls(halo=halo_spec_from_plan(pg.halo, mode, packed=packed),
                   **policy)

    def autotune(self, graph=None, hidden: int = 8) -> "NMPPlan":
        """Plans with nothing set to ``auto`` are returned unchanged; the
        measured (schedule x halo-mode) tuner is not ported yet."""
        if self.schedule != AUTO and self.halo.mode != AUTO:
            return self
        raise NotImplementedError(
            "schedule/halo mode 'auto' is not ported to repro_torch yet: "
            "pick a fixed schedule and halo mode")

    def policy(self) -> dict:
        """JSON-able policy fields (the plan's checkpoint-fingerprint entry)."""
        return {"backend": self.backend, "schedule": self.schedule,
                "block_n": self.block_n, "block_e": self.block_e,
                "halo_mode": self.halo.mode, "halo_packed": self.halo.packed}


_NMP_IMPLS: Dict[Tuple[str, str], Callable] = {}


def register_nmp_impl(backend: str, schedule: str):
    """Register one layer implementation for a (backend, schedule) cell:
    ``impl(params, x, e, graph, plan, halo, sync_fn) -> (x', e')``."""
    def deco(fn):
        _NMP_IMPLS[(backend, schedule)] = fn
        return fn
    return deco


def nmp_impl(plan: NMPPlan) -> Callable:
    """Resolve the layer implementation registered for ``plan``."""
    try:
        return _NMP_IMPLS[(plan.backend, plan.schedule)]
    except KeyError:
        raise ValueError(
            f"no NMP implementation registered for backend={plan.backend!r}, "
            f"schedule={plan.schedule!r}; registered cells: "
            f"{sorted(_NMP_IMPLS)}") from None


def registered_nmp_impls() -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(_NMP_IMPLS))


class ShardedGraph:
    """Stacked per-rank static arrays of one partition, as tensors on one
    device.  ``graph[name]`` has a leading rank axis; ``graph.rank(r)``
    returns rank r's slice (a rank-local graph, which one process of a
    multi-process run holds).  ``graph.wire(name)`` is a
    packed halo round's :class:`HaloWire` (``pk{k}_send`` / ``pk{k}_recv``:
    ids, mask and their inverse) or an exchange wire (``pk_send`` /
    ``pk_recv``: the rounds' wires concatenated in round order, the rows of
    round k from the sum of the earlier rounds' widths on), made once by
    :meth:`build`."""

    __slots__ = ("arrays", "wires")

    def __init__(self, arrays: Dict[str, torch.Tensor],
                 wires: Dict[str, HaloWire] | None = None):
        if not isinstance(arrays, dict):
            raise TypeError(f"arrays must be a dict, got {type(arrays)}")
        self.arrays = dict(arrays)
        self.wires = dict(wires or {})

    def __getitem__(self, key: str) -> torch.Tensor:
        try:
            return self.arrays[key]
        except KeyError:
            raise KeyError(
                f"ShardedGraph has no array {key!r}; present: "
                f"{sorted(self.arrays)} — was the graph built with the plan "
                "that needs it (ShardedGraph.build(pg, coords, plan))?"
            ) from None

    def __contains__(self, key: str) -> bool:
        return key in self.arrays

    def __repr__(self) -> str:
        return f"ShardedGraph({len(self.arrays)} arrays)"

    @property
    def device(self) -> torch.device:
        return next(iter(self.arrays.values())).device

    def wire(self, name: str) -> HaloWire:
        try:
            return self.wires[name]
        except KeyError:
            raise KeyError(
                f"ShardedGraph has no halo wire {name!r}; present: "
                f"{sorted(self.wires)} — was the graph built with a packed "
                "plan (ShardedGraph.build(pg, coords, plan))?") from None

    def rank(self, r: int) -> "ShardedGraph":
        """Slice every array's (and wire's) leading rank axis."""
        return ShardedGraph({k: v[r] for k, v in self.arrays.items()},
                            {k: w.rank(r) for k, w in self.wires.items()})

    def to(self, device) -> "ShardedGraph":
        """Every array and wire on ``device``."""
        return ShardedGraph({k: v.to(device) for k, v in self.arrays.items()},
                            {k: w.to(device) for k, w in self.wires.items()})

    @classmethod
    def build(cls, pg, coords: np.ndarray, plan: NMPPlan | None = None,
              device="cuda", rank: int | None = None) -> "ShardedGraph":
        """Collect ``pg``'s static arrays plus the static geometric edge
        features from ``coords`` onto ``device``; ``plan`` decides what else
        rides along (the fused backend's compact layout, the packed halo
        arrays and their wires).  With ``rank``, only that rank's slice
        (:meth:`rank`) reaches ``device``: the stack is built on the CPU."""
        if rank is not None:
            return cls.build(pg, coords, plan, device="cpu").rank(rank).to(device)
        plan = plan or NMPPlan()
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in _level_arrays(pg, coords, plan.seg_layout,
                                            plan.wants_packed).items()}
        rounds = [k for k in range(len(pg.halo.perms)) if f"pk{k}_send_idx" in arrays]
        wires = {f"pk{k}_{side}": halo_wire(arrays[f"pk{k}_{side}_idx"],
                                            arrays[f"pk{k}_{side}_mask"], pg.n_pad)
                 for k in rounds for side in ("send", "recv")}
        if rounds:
            # the exchange wires: every round's wire, concatenated in round
            # order (a row may be sent in several rounds, so no inverse)
            for side in ("send", "recv"):
                wires[f"pk_{side}"] = HaloWire(*(
                    torch.cat([arrays[f"pk{k}_{side}_{part}"] for k in rounds], -1)
                    for part in ("idx", "mask")))
        return cls(arrays, wires)


def _level_arrays(pg, coords, seg_layout, packed: bool) -> Dict[str, np.ndarray]:
    """Stacked static arrays: halo/edge metadata + edge geometry (numpy)."""
    from repro_torch.core.mesh_gen import edge_features
    from repro_torch.core.partition import gather_node_features

    arrays = dict(pg.device_arrays(seg_layout=seg_layout, packed=packed))
    coords_r = gather_node_features(pg, coords)
    ef = []
    for r in range(pg.R):
        e = np.stack([pg.edge_src[r], pg.edge_dst[r]], axis=-1)
        ef.append(edge_features(coords_r[r], e) * pg.edge_mask[r][:, None])
    arrays["static_edge_feats"] = np.stack(ef).astype(np.float32)
    return arrays


def as_graph(graph) -> ShardedGraph:
    """Validate a ShardedGraph argument."""
    if isinstance(graph, ShardedGraph):
        return graph
    raise TypeError(f"expected a ShardedGraph, got {type(graph).__name__}")
