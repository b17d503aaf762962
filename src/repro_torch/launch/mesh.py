"""Process meshes for the multi-process consistent GNN: the port of the
``('data', 'graph')`` mesh of ``repro.core.distributed`` and of
``repro.launch.mesh::make_mesh``.

One process per (data replica, graph rank), laid out data-major as the
JAX mesh ``(data, graph)`` is: world rank ``w = replica * R + rank``.

    def worker(device):
        mesh = make_mesh(data=2, graph=2, backend="gloo", device=device)
        ...                                   # mesh.rank, mesh.graph_group
    results = spawn(worker, 4, "cpu", backend="gloo", device="cpu")

:func:`spawn` starts the processes with the ``spawn`` start method and
rendezvous through a ``FileStore`` in a temporary directory (no fixed
port, so concurrent runs never collide); each worker's return value comes
back to the parent through a file, as numpy (never a pickled CUDA
tensor), and a worker that raises makes :func:`spawn` raise.

:class:`Transport` moves tensors between processes:

* ``nccl``: device tensors go on the wire as they are, one card per
  process (``cuda:{rank}``); fewer cards than processes raises.
* ``gloo``: CPU tensors go as they are; CUDA tensors are staged through
  pinned host buffers explicitly (``staged_bytes`` counts both directions;
  ``stage_s`` / ``wire_s`` split the host time between the copies and the
  gloo transfer).  No CUDA tensor is ever handed to gloo, and no backend
  is ever switched silently.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, device: str, nprocs: int):
    """Raise unless ``nprocs`` processes can run ``backend`` on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    kind = torch.device(device).type
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("backend 'nccl' moves CUDA tensors only: use "
                             "device='cuda', or backend 'gloo' on the CPU")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < nprocs:
            raise ValueError(
                f"backend 'nccl' needs one card per process: {nprocs} processes, "
                f"{cards} card(s); run 'gloo', which stages CUDA tensors "
                "through the host and lets processes share a card")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch finds no CUDA device")


class Transport:
    """Collectives and pair swaps of one process, under one backend (module
    docstring).  ``group`` arguments are :class:`Group` objects."""

    def __init__(self, backend: str, device: torch.device):
        self.backend, self.device = backend, device
        self.stages = backend == "gloo" and device.type == "cuda"
        self.reset()

    def reset(self):
        self.staged_bytes, self.stage_s, self.wire_s = 0, 0.0, 0.0

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor to hand to the backend: a pinned host copy of a CUDA
        tensor under gloo."""
        if not self.stages:
            return t
        torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.staged_bytes += host.numel() * host.element_size()
        self.stage_s += time.perf_counter() - t0
        return host

    def _empty(self, shape, dtype) -> torch.Tensor:
        dev = "cpu" if self.stages else self.device
        return torch.empty(shape, dtype=dtype, device=dev, pin_memory=self.stages)

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        if not self.stages:
            return t
        t0 = time.perf_counter()
        out = t.to(self.device)
        self.staged_bytes += t.numel() * t.element_size()
        self.stage_s += time.perf_counter() - t0
        return out

    def _wire(self, fn):
        t0 = time.perf_counter()
        fn()
        self.wire_s += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, group: "Group") -> torch.Tensor:
        """A new tensor holding the sum of ``t`` over ``group``."""
        if group.size == 1:
            return t.clone()
        buf = self._out(t)
        if buf is t:
            buf = t.clone()
        self._wire(lambda: dist.all_reduce(buf, group=group.pg))
        return self._back(buf)

    def all_to_all(self, buf: torch.Tensor, group: "Group") -> torch.Tensor:
        """``buf`` [S, ...] with slice s for group rank s -> [S, ...] with
        slice s from group rank s."""
        send = self._out(buf.contiguous())
        got = self._empty(buf.shape, buf.dtype)
        self._wire(lambda: dist.all_to_all_single(got, send, group=group.pg))
        return self._back(got)

    def swap(self, send: Optional[torch.Tensor], dst: Optional[int],
             src: Optional[int], shape, dtype, group: "Group"
             ) -> Optional[torch.Tensor]:
        """One exchange round of this process: send ``send`` to group rank
        ``dst`` and receive a ``shape`` tensor from group rank ``src``
        (either may be None), in one ``batch_isend_irecv``.  Returns what
        arrived, or None."""
        ops, got = [], None
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, self._out(send.contiguous()),
                                  group.ranks[dst], group=group.pg))
        if src is not None:
            got = self._empty(shape, dtype)
            ops.append(dist.P2POp(dist.irecv, got, group.ranks[src], group=group.pg))
        if ops:
            def run():
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            self._wire(run)
        return None if got is None else self._back(got)


@dataclasses.dataclass(frozen=True, eq=False)
class Group:
    """One process group of a mesh: the ``torch.distributed`` group (None
    for a group of one), its members' world ranks in group order, this
    process's index among them, and the transport."""
    pg: object
    ranks: Tuple[int, ...]
    index: int
    transport: Transport

    @property
    def size(self) -> int:
        return len(self.ranks)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.transport.all_reduce(t, self)

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        return self.transport.all_to_all(buf, self)

    def swap(self, send, dst, src, shape, dtype):
        return self.transport.swap(send, dst, src, shape, dtype, self)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a ``(data, graph)`` mesh: its graph rank
    ``rank`` among the ``graph`` sub-graphs of one replica, its data
    replica ``replica`` among ``data``, the graph group (the R ranks of its
    replica), the data group (the D replicas of its rank), the world group
    and its device.  The three groups share one :class:`Transport`."""
    data: int
    graph: int
    rank: int
    replica: int
    graph_group: Group
    data_group: Group
    world_group: Group
    device: torch.device

    @property
    def world_rank(self) -> int:
        return self.world_group.index

    @property
    def lead(self) -> bool:
        """Data replica 0, graph rank 0: the process that writes."""
        return self.world_rank == 0


def process_device(backend: str, device: str, world_rank: int) -> torch.device:
    """This process's device: the CPU, ``cuda:{rank}`` under nccl, and under
    gloo the cards in turn (processes share a card when there are fewer)."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    index = world_rank if backend == "nccl" else world_rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def _group(members: Sequence[int]):
    # every process creates every group, in the same order
    members = list(members)
    return dist.new_group(members) if len(members) > 1 else None


def make_mesh(data: int, graph: int, backend: str = "gloo",
              device: str = "cuda") -> Mesh:
    """The ``(data, graph)`` mesh of the processes of the current default
    group (started by :func:`spawn`), data-major.  Every process of the
    world must call it, with the same arguments."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the processes' default group: start "
                           "them with repro_torch.launch.mesh.spawn")
    world, me = dist.get_world_size(), dist.get_rank()
    if world != data * graph:
        raise ValueError(f"a ({data}, {graph}) mesh needs {data * graph} "
                         f"processes, the world has {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the processes run backend {dist.get_backend()!r}, "
                         f"not {backend!r}")
    check_backend(backend, device, world)
    dev = process_device(backend, device, me)
    transport = Transport(backend, dev)
    graph_pgs = [_group(range(d * graph, (d + 1) * graph)) for d in range(data)]
    data_pgs = [_group(range(r, world, graph)) for r in range(graph)]
    replica, rank = divmod(me, graph)
    if backend == "nccl":
        # a group's first NCCL call must involve all of its ranks, and a
        # neighbor round leaves some out: open each group with a collective
        for pg in (graph_pgs[replica], data_pgs[rank], dist.group.WORLD):
            if pg is not None:
                dist.all_reduce(torch.zeros(1, device=dev), group=pg)
    return Mesh(
        data=data, graph=graph, rank=rank, replica=replica,
        graph_group=Group(graph_pgs[replica],
                          tuple(range(replica * graph, (replica + 1) * graph)),
                          rank, transport),
        data_group=Group(data_pgs[rank], tuple(range(rank, world, graph)),
                         replica, transport),
        world_group=Group(dist.group.WORLD if world > 1 else None,
                          tuple(range(world)), me, transport),
        device=dev)


def to_host(tree):
    """Tensors of a tree of dicts / lists / tuples as numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _worker(index, fn, nprocs, backend, device, tmp, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    # the processes are on one host: keep gloo on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if backend == "nccl":
        torch.cuda.set_device(index)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=index, world_size=nprocs)
    try:
        out = to_host(fn(*args))
        with open(os.path.join(tmp, f"proc{index}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, backend: str = "gloo", device: str = "cuda"):
    """Run ``fn(*args)`` in ``nprocs`` new processes joined in one
    ``backend`` group (``fn`` builds its mesh with :func:`make_mesh`).
    Returns each process's return value, in world-rank order, with tensors
    as numpy.  Raises if any process fails."""
    import torch.multiprocessing as mp
    check_backend(backend, device, nprocs)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        mp.start_processes(_worker, args=(fn, nprocs, backend, device, tmp, args),
                           nprocs=nprocs, join=True, start_method="spawn")
        outs = []
        for i in range(nprocs):
            with open(os.path.join(tmp, f"proc{i}.pkl"), "rb") as fh:
                outs.append(pickle.load(fh))
    return outs
