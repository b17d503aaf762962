"""Process meshes for the multi-process consistent GNN: the port of the
``('data', 'graph')`` mesh of ``repro.core.distributed``, of the
``model`` axis of the GNN cells' meshes (``repro/configs/gnn_common.py``:
edge-parallel sharding) and of ``repro.launch.mesh::make_mesh``.

One process per (data replica, graph rank, model shard), laid out
data-major as the JAX mesh ``(data, graph, model)`` is: world rank
``w = (replica * R + rank) * M + shard``.  The ``model`` axis splits one
rank's edges over M processes that each hold all of its nodes
(``core/consistent_mp.py::nmp_layer(edge_parallel_axes=)``); with
``model=1`` (the default) the layout, the groups and their order of
creation are those of the two-axis mesh, ``w = replica * R + rank``.

    def worker(device):
        mesh = make_mesh(data=2, graph=2, backend="gloo", device=device)
        ...                                   # mesh.rank, mesh.graph_group
    results = spawn(worker, 4, "cpu", backend="gloo", device="cpu")

The groups: the graph group (the R ranks of one replica at one model
shard: the halo exchange and Eq. 6's sums), the data group (the D
replicas of one rank and shard), the edge group (the M shards of one rank
of one replica: the sum of the partial aggregates; the LM's ``model`` group,
``models/transformer/model.py::ParallelCtx``, with graph = 1) and the
world.

:func:`spawn` starts the processes with the ``spawn`` start method and
rendezvous through a ``FileStore`` in a temporary directory (no fixed
port, so concurrent runs never collide); each worker's return value comes
back to the parent through a file, as numpy (never a pickled CUDA
tensor), and a worker that raises makes :func:`spawn` raise.

:class:`Transport` moves tensors between processes:

* ``nccl``: device tensors go on the wire as they are, one card per
  process (``cuda:{rank}``); fewer cards than processes raises.
* ``gloo``: CPU tensors go as they are; CUDA tensors are staged through
  pinned host buffers explicitly (``sent_bytes`` counts what this process
  hands to the backend under any backend, ``staged_bytes`` the staging
  copies in both directions;
  ``stage_s`` / ``wire_s`` split the host time between the copies and the
  gloo calls).  No CUDA tensor is ever handed to gloo, and no backend is
  ever switched silently.

Besides the exchanges, a group sums (``all_reduce``) and gathers
(``all_gather``, tiled along one dimension, as the context-parallel
attention gathers K and V).

Every halo exchange is posted (``post_all_to_all``; ``post_permute``, one
one-way permutation per round: a neighbor round's pair swaps, or one hop
of a two-level round): the
transfers are issued now and :meth:`Posted.wait` collects them later, so
work queued on the card in between runs while they are in flight; a
caller that needs the rows at once waits right away (the autograd
exchanges do).  A posted exchange under gloo with CUDA tensors takes one
stream sync (``sync_s``), stages every send row into pinned buffers and
issues every round's ``isend`` / ``irecv`` at once, each round under its
own ``tag``; the wait waits the rounds in order (``wait_s``, the host time
blocked there) and copies each round's rows back to the card.  ``posted``
counts the exchanges waited and ``overlapped`` those of them the overlap
schedule finished after queueing other work
(``core/distributed.py::HaloFn.post``), so a run can show which it took.
gloo moves a ``bfloat16`` tensor (a compressed halo wire) as its bits, a
``uint8`` view of the same bytes (gloo's all-to-all takes neither
``bfloat16`` nor ``int16``), so ``staged_bytes`` counts two bytes an
element.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
from typing import Sequence, Tuple

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
    """Collectives and posted exchanges of one process, under one backend (module
    docstring).  ``group`` arguments are :class:`Group` objects."""

    def __init__(self, backend: str, device: torch.device):
        self.backend, self.device = backend, device
        self.stages = backend == "gloo" and device.type == "cuda"
        self.reset()

    def reset(self):
        self.staged_bytes, self.sent_bytes, self.stage_s, self.wire_s = 0, 0, 0.0, 0.0
        self.sync_s, self.wait_s = 0.0, 0.0
        self.posted, self.overlapped = 0, 0

    def _sync(self):
        """Wait for the work queued on this process's stream (the rows to
        stage come out of it)."""
        t0 = time.perf_counter()
        torch.cuda.current_stream(self.device).synchronize()
        self.sync_s += time.perf_counter() - t0

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of a CUDA tensor whose producers are done."""
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.staged_bytes += host.numel() * host.element_size()
        self.stage_s += time.perf_counter() - t0
        return host

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor to hand to the backend: a pinned host copy of a CUDA
        tensor under gloo."""
        if not self.stages:
            return t
        self._sync()
        return self._stage(t)

    def _empty(self, shape, dtype) -> torch.Tensor:
        dev = "cpu" if self.stages else self.device
        return torch.empty(shape, dtype=dtype, device=dev, pin_memory=self.stages)

    def _back(self, t: torch.Tensor, non_blocking: bool = False) -> torch.Tensor:
        if not self.stages:
            return t
        t0 = time.perf_counter()
        out = t.to(self.device, non_blocking=non_blocking)
        self.staged_bytes += t.numel() * t.element_size()
        self.stage_s += time.perf_counter() - t0
        return out

    def _wire(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.wire_s += time.perf_counter() - t0
        return out

    def _bits(self, dtype, shape):
        """(dtype, shape) a ``dtype`` tensor of ``shape`` crosses the backend
        as: gloo moves bfloat16 as the uint8 view of its bytes."""
        if self.backend == "gloo" and dtype == torch.bfloat16:
            return torch.uint8, tuple(shape[:-1]) + (2 * shape[-1],)
        return dtype, tuple(shape)

    def post_all_to_all(self, buf: torch.Tensor, group: "Group") -> "Posted":
        """``buf`` [S, ...] with slice s for group rank s, posted:
        ``wait()`` returns ``[got]``, [S, ...] with slice s from group rank
        s."""
        bits, shape = self._bits(buf.dtype, buf.shape)
        send = self._out(buf.contiguous().view(bits))
        self.sent_bytes += send.numel() * send.element_size()
        got = self._empty(shape, bits)
        work = self._wire(lambda: dist.all_to_all_single(got, send, group=group.pg,
                                                         async_op=True))
        return Posted(self, [[work]], [got], [send], [buf.dtype])

    def post_permute(self, rounds, group: "Group", tag: int = 0) -> "Posted":
        """One one-way permutation per round, every round posted at once:
        ``rounds`` holds one ``(send, dst, src, shape, dtype)`` per round
        (round k under tag ``tag + k``): send ``send`` to group rank ``dst``
        and receive a ``shape`` tensor from group rank ``src``, either of
        them None where this process sits the round out.  ``wait()``
        returns what arrived in each round (None where nothing was
        received)."""
        rounds = list(rounds)
        if self.stages and any(r[0] is not None and r[1] is not None for r in rounds):
            self._sync()
        works, recvs, keep, dtypes = [], [], [], []
        for k, (send, dst, src, shape, dtype) in enumerate(rounds):
            ops, got = [], None
            bits, shape = self._bits(dtype, shape)
            if dst is not None:
                rows = send.contiguous().view(bits)
                rows = self._stage(rows) if self.stages else rows
                self.sent_bytes += rows.numel() * rows.element_size()
                keep.append(rows)
                ops.append(dist.P2POp(dist.isend, rows, group.ranks[dst],
                                      group=group.pg, tag=tag + k))
            if src is not None:
                got = self._empty(shape, bits)
                ops.append(dist.P2POp(dist.irecv, got, group.ranks[src],
                                      group=group.pg, tag=tag + k))
            works.append(self._wire(lambda: dist.batch_isend_irecv(ops)) if ops else [])
            recvs.append(got)
            dtypes.append(dtype)
        return Posted(self, works, recvs, keep, dtypes)

    def all_reduce(self, t: torch.Tensor, group: "Group") -> torch.Tensor:
        """A new tensor holding the sum of ``t`` over ``group``."""
        if group.size == 1:
            return t.clone()
        buf = self._out(t)
        if buf is t:
            buf = t.clone()
        self._wire(lambda: dist.all_reduce(buf, group=group.pg))
        return self._back(buf)

    def all_gather(self, t: torch.Tensor, group: "Group", dim: int = 0) -> torch.Tensor:
        """Every group member's ``t`` (all of one shape), concatenated along
        ``dim`` in group order: the tiled all-gather of ``jax.lax.all_gather
        (tiled=True)``.  A new tensor on this process's device."""
        if group.size == 1:
            return t.clone()
        bits, shape = self._bits(t.dtype, t.shape)
        send = self._out(t.contiguous().view(bits))
        self.sent_bytes += send.numel() * send.element_size()
        got = self._empty((group.size,) + shape, bits)
        self._wire(lambda: dist.all_gather(list(got.unbind(0)), send, group=group.pg))
        out = self._back(got).view(t.dtype)
        return out.movedim(0, dim).flatten(dim, dim + 1)


class Posted:
    """A posted exchange of one process: the backend's works per round, the
    buffers receiving each round (None where nothing is received), the send
    buffers, held until the works are done, and the dtype of each round's
    rows."""

    def __init__(self, transport: Transport, works, recvs, keep, dtypes):
        self.transport, self.works, self.recvs, self.keep = transport, works, recvs, keep
        self.dtypes = dtypes
        self.done = False

    def wait(self, count: bool = True) -> list:
        """Wait the rounds in order; each round's rows on this process's
        device, in round order.  ``count`` adds the exchange to
        ``posted`` (a two-level exchange's first hops do not count)."""
        if self.done:
            raise RuntimeError("this posted exchange was already waited")
        tr, out = self.transport, []
        for works, got, dtype in zip(self.works, self.recvs, self.dtypes):
            t0 = time.perf_counter()
            for work in works:
                work.wait()
            tr.wait_s += time.perf_counter() - t0
            out.append(None if got is None
                       else tr._back(got, non_blocking=True).view(dtype))
        self.done, self.keep = True, None
        tr.posted += int(count)
        return out


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

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self.transport.all_gather(t, self, dim)

    def post_all_to_all(self, buf: torch.Tensor) -> Posted:
        return self.transport.post_all_to_all(buf, self)

    def post_permute(self, rounds, tag: int = 0) -> Posted:
        return self.transport.post_permute(rounds, self, tag)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a ``(data, graph, model)`` mesh: its graph
    rank ``rank`` among the ``graph`` sub-graphs of one replica, its data
    replica ``replica`` among ``data``, its model shard ``shard`` among
    ``model`` (the slices of its rank's edges), the graph group (the R
    ranks of its replica at its shard), the data group (the D replicas of
    its rank and shard), the edge group (the M shards of its rank and
    replica), the world group and its device.  The groups share one
    :class:`Transport`."""
    data: int
    graph: int
    rank: int
    replica: int
    graph_group: Group
    data_group: Group
    world_group: Group
    device: torch.device
    model: int = 1
    shard: int = 0
    edge_group: Group | None = None

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
              device: str = "cuda", model: int = 1) -> Mesh:
    """The ``(data, graph, model)`` mesh of the processes of the current
    default group (started by :func:`spawn`), data-major, the model axis
    fastest.  Every process of the world must call it, with the same
    arguments."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the processes' default group: start "
                           "them with repro_torch.launch.mesh.spawn")
    world, me = dist.get_world_size(), dist.get_rank()
    if world != data * graph * model:
        shape = f"({data}, {graph})" if model == 1 else f"({data}, {graph}, {model})"
        raise ValueError(f"a {shape} mesh needs {data * graph * model} "
                         f"processes, the world has {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the processes run backend {dist.get_backend()!r}, "
                         f"not {backend!r}")
    check_backend(backend, device, world)
    dev = process_device(backend, device, me)
    transport = Transport(backend, dev)

    def proc(d, r, m):
        return (d * graph + r) * model + m
    graph_ranks = {(d, m): tuple(proc(d, r, m) for r in range(graph))
                   for d in range(data) for m in range(model)}
    data_ranks = {(r, m): tuple(proc(d, r, m) for d in range(data))
                  for r in range(graph) for m in range(model)}
    edge_ranks = {(d, r): tuple(proc(d, r, m) for m in range(model))
                  for d in range(data) for r in range(graph)}
    # every process creates every group, in the same order: the graph
    # groups, the data groups, then the edge groups (all of one process
    # under model=1, so none is created)
    graph_pgs = {k: _group(v) for k, v in graph_ranks.items()}
    data_pgs = {k: _group(v) for k, v in data_ranks.items()}
    edge_pgs = {k: _group(v) for k, v in edge_ranks.items()}
    at, shard = divmod(me, model)
    replica, rank = divmod(at, graph)
    mine = (graph_pgs[replica, shard], data_pgs[rank, shard], edge_pgs[replica, rank])
    if backend == "nccl":
        # a group's first NCCL call must involve all of its ranks, and a
        # neighbor round leaves some out: open each group with a collective
        for pg in mine + (dist.group.WORLD,):
            if pg is not None:
                dist.all_reduce(torch.zeros(1, device=dev), group=pg)
    return Mesh(
        data=data, graph=graph, rank=rank, replica=replica,
        graph_group=Group(mine[0], graph_ranks[replica, shard], rank, transport),
        data_group=Group(mine[1], data_ranks[rank, shard], replica, transport),
        world_group=Group(dist.group.WORLD if world > 1 else None,
                          tuple(range(world)), me, transport),
        device=dev, model=model, shard=shard,
        edge_group=Group(mine[2], edge_ranks[replica, rank], shard, transport))


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
