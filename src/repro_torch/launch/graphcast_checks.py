"""GraphCast's training cell over a ``(data, graph, model)`` process mesh:
the worker of the CPU tests (``tests/test_torch_graphcast_dist.py``) and
of ``chip_smoke.py``'s edge-parallel case.

    from repro_torch.launch import graphcast_checks as gcx
    job = gcx.Job(cases=(gcx.Case("g2m2", graph=2, model=2, mode="packed"),),
                  cfg=dataclasses.asdict(graphcast.smoke_config()), device="cpu")
    procs = gcx.run_world(job, 4)          # one record per process and case
    r1 = gcx.run_case(job, gcx.Case("r1"))  # the same cell on one rank

Every case runs the cell the reference's ``configs/graphcast.py`` wires:
a ``cora_like`` graph split by ``partition_graph`` over the mesh's graph
axis (``e_pad`` padded to a multiple of 128, ``core/graph_state.py::
pad_edges``, so it splits over the model axis), edge features a fixed
function of each edge's global endpoints (so every partition sees the same
values), the inputs cut by their specs (``configs/gnn_common.py::
shard_by_specs``), the rank-local graph over this process's model shard of
the edges (``core/distributed.py::local_graph_of``), and GraphCast's
consistent cross entropy through ``gnn_common``'s step builder.  Per case
and process: the eval step's forward from the job's weights (this rank's
rows), the loss and gradients of the first step, ``steps`` AdamW steps
(their losses and a checksum of the parameters after them,
``consistency.param_checksum``), the kernels'
launches per part (``kernels/build.py::launch_counts``), CUDA-event step
times on a card, the mesh's groups, and the partition's node ids and masks
that map the rows back.  Imports nothing outside this package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import nn
from repro_torch.configs import gnn_common as G
from repro_torch.configs import graphcast as gcc
from repro_torch.core.distributed import halo_fns, local_graph_of
from repro_torch.core.graph_state import XLA, NMPPlan, pad_edges
from repro_torch.core.partition import gather_node_features, partition_graph
from repro_torch.graph.datasets import cora_like
from repro_torch.kernels import build
from repro_torch.launch.consistency import param_checksum
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.models.gnn_zoo.graphcast import (
    GraphCastConfig, graphcast_forward, init_graphcast)
from repro_torch.train.optimizer import AdamWConfig, constant_lr, init_adamw


@dataclasses.dataclass(frozen=True)
class Case:
    """One mesh and exchange: ``mode`` none | a2a | neighbor | packed (the
    packed neighbor exchange, kernels 4 and 5 on a card)."""
    name: str
    data: int = 1
    graph: int = 1
    model: int = 1
    mode: str = "none"
    schedule: str = "blocking"


@dataclasses.dataclass(frozen=True)
class Job:
    """The cell: ``graph`` holds ``cora_like``'s arguments, ``cfg``
    GraphCast's config fields (in_dim and out_dim those of the graph);
    ``params`` the weights as a numpy tree in the port's layout, or None
    for ``init_graphcast`` from ``seed``; ``steps`` AdamW steps at ``lr``
    after the first step's gradient."""
    cases: tuple
    cfg: dict
    graph: dict = dataclasses.field(default_factory=lambda: dict(
        seed=1, n=64, m_und=200, d=16, n_classes=4))
    params: dict | None = None
    seed: int = 0
    backend: str = XLA
    device: str = "cuda"
    steps: int = 2
    lr: float = 1e-3
    eval: bool = True


def cell_shape(job: Job) -> dict:
    g = job.graph
    return dict(kind="full", n_nodes=g["n"], n_edges=g["m_und"], d_feat=g["d"],
                n_classes=g["n_classes"])


def edge_feats_of(pg, width: int = gcc.EDGE_IN) -> np.ndarray:
    """[R, E_pad, width] float32: a fixed smooth function of each edge's
    global (src, dst) ids, zero on padding edges, so an edge has the same
    features in every partition."""
    gid = np.clip(pg.global_ids, 0, None).astype(np.float64)
    gs = np.take_along_axis(gid, pg.edge_src, axis=1)
    gd = np.take_along_axis(gid, pg.edge_dst, axis=1)
    cols = [np.sin(0.37 * gs + 0.11 * gd + k) * np.cos(0.05 * (k + 1) * gd - 0.2 * gs)
            for k in range(width)]
    return (np.stack(cols, -1) * pg.edge_mask[..., None]).astype(np.float32)


def cell_inputs(pg, feats: np.ndarray, labels: np.ndarray) -> dict:
    """The cell's stacked inputs on partition ``pg``: node features,
    :func:`edge_feats_of` and labels (0 on padding rows)."""
    lab = gather_node_features(pg, labels[:, None].astype(np.float32))[..., 0]
    return {"x": gather_node_features(pg, feats).astype(np.float32),
            "edge_feats": edge_feats_of(pg),
            "labels": lab.astype(np.int32)}


def plan_of(pg, case: Case, backend: str) -> NMPPlan:
    mode, packed = ("neighbor", True) if case.mode == "packed" else (case.mode, False)
    return NMPPlan.build(pg, mode, packed=packed, backend=backend, schedule=case.schedule)


def params_of(job: Job, cfg: GraphCastConfig, device) -> nn.Params:
    if job.params is None:
        return init_graphcast(torch.Generator().manual_seed(job.seed), cfg, device=device)
    return nn.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(device),
                       job.params)


def _counts():
    out = {k: v for k, v in build.launch_counts.items() if v}
    build.reset_launch_counts()
    return out


class _Timer:
    """CUDA-event ms of each timed call (none on the CPU)."""

    def __init__(self, device):
        self.on, self.ms = device.type == "cuda", []

    def __call__(self, fn):
        if not self.on:
            return fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        self.ms.append(start.elapsed_time(end))
        return out


def run_case(job: Job, case: Case, mesh=None) -> dict:
    """One case on this process (one rank without a mesh): module
    docstring."""
    dev = mesh.device if mesh is not None else torch.device(job.device)
    g = job.graph
    edges, feats, labels = cora_like(**g)
    pg = pad_edges(partition_graph(g["n"], edges, case.graph))
    plan = plan_of(pg, case, job.backend)
    graph = local_graph_of(pg, None, plan, mesh, device=dev)
    shape = cell_shape(job)
    ep = case.model > 1
    _, specs = gcc._inputs_factory(shape, pg.R, pg.n_pad, pg.e_pad, edge_parallel=ep)
    inputs = G.shard_by_specs(cell_inputs(pg, feats, labels), specs, mesh, dev)
    cfg = GraphCastConfig(**job.cfg)
    ov = {"edge_parallel": ep}
    loss_local = gcc._loss_local_factory(shape, plan.halo, mesh=mesh, overrides=ov,
                                         plan=plan, cfg=cfg)
    fcfg = dataclasses.replace(cfg, edge_parallel_axes=(G.MODEL,) if ep else ())

    def fwd_local(p, i, gr):
        sync = None if mesh is None else halo_fns(plan, gr, mesh)
        return graphcast_forward(p, i["x"][0], i["edge_feats"][0], gr, plan, fcfg,
                                 sync_fns=sync, mesh=mesh)

    params = params_of(job, cfg, dev)
    rec = dict(global_ids=pg.global_ids[mesh.rank if mesh else 0],
               node_mask=pg.node_mask[mesh.rank if mesh else 0],
               e_local=int(graph["edge_mask"].shape[0]),
               edges_local=float(graph["edge_mask"].sum()))
    if mesh is not None:
        rec.update(rank=mesh.rank, shard=mesh.shard, replica=mesh.replica,
                   groups={k: getattr(mesh, f"{k}_group").ranks
                           for k in ("graph", "data", "edge", "world")})
    build.reset_launch_counts()
    if job.eval:
        rec["pred"] = G.make_gnn_eval_step(fwd_local)(params, inputs, graph)
        rec["launches_eval"] = _counts()
    loss0, grads = G.gnn_loss_and_grads(loss_local, params, inputs, graph, mesh)
    rec["loss0"], rec["grads0"] = float(loss0), nn.tree_leaves(grads)
    rec["launches_grad"] = _counts()
    del grads
    opt = AdamWConfig(schedule=constant_lr(job.lr))
    step = G.make_gnn_train_step(loss_local, opt, mesh)
    state = {"params": params, "opt": init_adamw(params, opt)}
    timer, losses, per_step = _Timer(dev), [], []
    for _ in range(job.steps):
        state, loss = timer(lambda: step(state, inputs, graph))
        losses.append(float(loss))
        per_step.append(_counts())
    rec.update(losses=losses, launches_step=per_step, step_ms=timer.ms,
               params_sum=param_checksum(state["params"]))
    if dev.type == "cuda":
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return rec


def check_process(job: Job) -> dict:
    """Every case of ``job`` on this process of the world, each on its own
    mesh (every process builds each in the same order)."""
    out = {}
    for case in job.cases:
        mesh = make_mesh(case.data, case.graph, backend="gloo", device=job.device,
                         model=case.model)
        out[case.name] = run_case(job, case, mesh)
    return out


def run_world(job: Job, nprocs: int) -> list:
    """``job`` on ``nprocs`` gloo processes (every case's mesh must hold
    them all): each process's records, in world-rank order."""
    for case in job.cases:
        if case.data * case.graph * case.model != nprocs:
            raise ValueError(f"case {case.name}: a ({case.data}, {case.graph}, "
                             f"{case.model}) mesh in a world of {nprocs}")
    return spawn(check_process, nprocs, job, backend="gloo", device=job.device)
