"""The GNN training cells over a ``(data, graph, model)`` process mesh:
GraphCast's and the rest of the GNN zoo's (GAT, NequIP, MACE), by arch id.
The worker of the CPU tests (``tests/test_torch_graphcast_dist.py``,
``tests/test_torch_gnn_zoo_dist.py``) and of ``chip_smoke.py``'s
multi-process cases.

    from repro_torch.launch import graphcast_checks as gcx
    job = gcx.Job(cases=(gcx.Case("g2m2", graph=2, model=2, mode="packed"),),
                  cfg=dataclasses.asdict(graphcast.smoke_config()), device="cpu")
    procs = gcx.run_world(job, 4)          # one record per process and case
    r1 = gcx.run_case(job, gcx.Case("r1"))  # the same cell on one rank
    gat = dataclasses.replace(job, arch="gat-cora", cfg=dataclasses.asdict(
        gat_cora.smoke_config()), cases=(gcx.Case("gat_g4", graph=4, mode="packed"),))
    procs = gcx.run_world((job4, gat), 4)  # several archs' jobs in one world

Every case runs the cell the reference's ``configs/<arch>.py`` wires: a
``cora_like`` graph split by ``partition_graph`` over the mesh's graph
axis (``e_pad`` padded to a multiple of 128, ``core/graph_state.py::
pad_edges``, so it splits over the model axis), the inputs cut by their
specs (``configs/gnn_common.py::shard_by_specs``), the rank-local graph
over this process's model shard of the edges (``core/distributed.py::
local_graph_of``), and the arch's consistent loss through ``gnn_common``'s
step builder.  The inputs are fixed functions of each node's (and edge's)
global ids, so every partition sees the same values: GraphCast and GAT
take ``cora_like``'s features and labels (GraphCast also edge features
of each edge's global endpoints, :func:`edge_feats_of`); NequIP and MACE
take species, positions and a per-node target drawn once per global node
from the job's seed (:func:`equivariant_data`).  Per case and process: the
eval step's forward from the job's weights (this rank's rows), the loss
and gradients of the first step, ``steps`` AdamW steps (their losses and a
checksum of the parameters after them, ``consistency.param_checksum``),
the kernels' launches per part (``kernels/build.py::launch_counts``),
CUDA-event step times and peak memory on a card, the mesh's groups, and
the partition's node ids and masks that map the rows back.  Imports
nothing outside this package.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.configs import gat_cora, get_arch
from repro_torch.configs import gnn_common as G
from repro_torch.configs import graphcast as gcc
from repro_torch.configs.nequip import with_overrides
from repro_torch.core.distributed import halo_fns, local_graph_of
from repro_torch.core.graph_state import XLA, NMPPlan, pad_edges
from repro_torch.core.partition import gather_node_features, partition_graph
from repro_torch.graph.datasets import cora_like
from repro_torch.kernels import build
from repro_torch.launch.consistency import param_checksum
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.models.gnn_zoo.gat import GATConfig, gat_forward, init_gat
from repro_torch.models.gnn_zoo.graphcast import (
    GraphCastConfig, graphcast_forward, init_graphcast)
from repro_torch.models.gnn_zoo.mace import MACEConfig, init_mace, mace_forward
from repro_torch.models.gnn_zoo.nequip import NequIPConfig, init_nequip, nequip_forward
from repro_torch.train.optimizer import AdamWConfig, constant_lr, init_adamw

#: arch id -> (config class, init, forward) of the cells this module runs
ARCHS = {"graphcast": (GraphCastConfig, init_graphcast, graphcast_forward),
         "gat-cora": (GATConfig, init_gat, gat_forward),
         "nequip": (NequIPConfig, init_nequip, nequip_forward),
         "mace": (MACEConfig, init_mace, mace_forward)}
EQUIVARIANT = ("nequip", "mace")


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
    """The cell: ``arch`` one of :data:`ARCHS`; ``graph`` holds
    ``cora_like``'s arguments, ``cfg`` the arch's config fields (GraphCast's
    and GAT's in_dim and out_dim those of the graph); ``params`` the weights
    as a numpy tree in the port's layout, or None for the arch's ``init_*``
    from ``seed`` (which also draws NequIP's and MACE's data); ``steps``
    AdamW steps at ``lr`` after the first step's gradient.  Case names are
    unique across the jobs of one world."""
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
    arch: str = "graphcast"


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


def equivariant_data(n: int, n_species: int, seed: int) -> dict:
    """NequIP's and MACE's inputs per global node: species in
    ``[0, n_species)``, standard-normal positions (most of ``cora_like``'s
    edges then fall inside the cutoff) and a standard-normal target."""
    rng = np.random.default_rng(seed)
    return {"species": rng.integers(0, n_species, n).astype(np.float32),
            "pos": rng.normal(size=(n, 3)).astype(np.float32),
            "target": rng.normal(size=n).astype(np.float32)}


def inputs_of(job: Job, cfg, pg) -> dict:
    """The arch's stacked inputs on partition ``pg``: :func:`cell_inputs`
    (GraphCast), its node features and labels (GAT), or
    :func:`equivariant_data` gathered to each rank's rows (NequIP, MACE;
    0 on padding rows)."""
    g = job.graph
    edges, feats, labels = cora_like(**g)
    if job.arch in EQUIVARIANT:
        data = equivariant_data(g["n"], cfg.n_species, job.seed)
        out = {k: gather_node_features(pg, v.reshape(g["n"], -1))
               for k, v in data.items()}
        return {"species": out["species"][..., 0].astype(np.int32),
                "pos": out["pos"], "target": out["target"][..., 0]}
    inputs = cell_inputs(pg, feats, labels)
    if job.arch == "gat-cora":
        del inputs["edge_feats"]
    return inputs


def plan_of(pg, case: Case, backend: str) -> NMPPlan:
    mode, packed = ("neighbor", True) if case.mode == "packed" else (case.mode, False)
    return NMPPlan.build(pg, mode, packed=packed, backend=backend, schedule=case.schedule)


def config_of(job: Job):
    return ARCHS[job.arch][0](**job.cfg)


def params_of(job: Job, cfg, device) -> nn.Params:
    if job.params is None:
        return ARCHS[job.arch][1](torch.Generator().manual_seed(job.seed), cfg,
                                  device=device)
    return nn.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(device),
                       job.params)


def _cell_fns(job: Job, cfg, shape, plan, mesh, edge_parallel: bool):
    """(loss_local, fwd_local) of the arch's cell on this process."""
    mod, _ = get_arch(job.arch)
    ov = {"edge_parallel": edge_parallel}
    if job.arch == "graphcast":
        loss_local = gcc._loss_local_factory(shape, plan.halo, mesh=mesh, overrides=ov,
                                             plan=plan, cfg=cfg)
        fcfg = dataclasses.replace(cfg, edge_parallel_axes=(G.MODEL,) if edge_parallel
                                   else ())

        def fwd_local(p, i, gr):
            sync = None if mesh is None else halo_fns(plan, gr, mesh)
            return graphcast_forward(p, i["x"][0], i["edge_feats"][0], gr, plan, fcfg,
                                     sync_fns=sync, mesh=mesh)
        return loss_local, fwd_local
    if job.arch == "gat-cora":
        if edge_parallel:
            raise ValueError("GAT has no edge-parallel form (the reference's has none)")
        loss_local = gat_cora._loss_local_factory(shape, plan.halo, mesh=mesh, cfg=cfg)

        def fwd_local(p, i, gr):
            return gat_forward(p, i["x"][0], gr, cfg,
                               sync_fn=G.sync_fn_of(gr, plan.halo, mesh))
        return loss_local, fwd_local
    loss_local = mod._loss_local_factory(shape, plan.halo, mesh=mesh, overrides=ov, cfg=cfg)
    fcfg, forward = with_overrides(cfg, ov), ARCHS[job.arch][2]

    def fwd_local(p, i, gr):
        return forward(p, i["species"][0], i["pos"][0], gr, fcfg,
                       sync_fn=G.sync_fn_of(gr, plan.halo, mesh), mesh=mesh)
    return loss_local, fwd_local


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


class Cell(NamedTuple):
    """One case's cell on this process: the partition, the plan, the
    rank-local graph, this process's inputs, the arch's loss and eval
    forward, its config and the job's weights."""
    pg: object
    plan: NMPPlan
    graph: object
    inputs: dict
    loss_local: object
    fwd_local: object
    cfg: object
    params: nn.Params


def build_cell(job: Job, case: Case, mesh=None) -> Cell:
    """The cell of ``case`` on this process (one rank without a mesh), on
    the mesh's device or ``job.device``."""
    dev = mesh.device if mesh is not None else torch.device(job.device)
    g = job.graph
    edges, _, _ = cora_like(**g)
    pg = pad_edges(partition_graph(g["n"], edges, case.graph))
    plan = plan_of(pg, case, job.backend)
    graph = local_graph_of(pg, None, plan, mesh, device=dev)
    shape = cell_shape(job)
    ep = case.model > 1
    cfg = config_of(job)
    _, specs = get_arch(job.arch)[0]._inputs_factory(shape, pg.R, pg.n_pad, pg.e_pad,
                                                     edge_parallel=ep)
    inputs = G.shard_by_specs(inputs_of(job, cfg, pg), specs, mesh, dev)
    loss_local, fwd_local = _cell_fns(job, cfg, shape, plan, mesh, ep)
    return Cell(pg, plan, graph, inputs, loss_local, fwd_local, cfg,
                params_of(job, cfg, dev))


def run_case(job: Job, case: Case, mesh=None) -> dict:
    """One case on this process (one rank without a mesh): module
    docstring."""
    pg, _, graph, inputs, loss_local, fwd_local, _, params = build_cell(job, case, mesh)
    dev = mesh.device if mesh is not None else torch.device(job.device)
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


def check_process(jobs) -> dict:
    """Every case of each job on this process of the world, each on its own
    mesh (every process builds each in the same order)."""
    out = {}
    for job in jobs:
        for case in job.cases:
            mesh = make_mesh(case.data, case.graph, backend="gloo", device=job.device,
                             model=case.model)
            out[case.name] = run_case(job, case, mesh)
    return out


def run_world(jobs, nprocs: int) -> list:
    """A job (or a sequence of jobs, of any archs, on one device) on
    ``nprocs`` gloo processes (every case's mesh must hold them all): each
    process's records by case name, in world-rank order."""
    jobs = (jobs,) if isinstance(jobs, Job) else tuple(jobs)
    names = [case.name for job in jobs for case in job.cases]
    if len(set(names)) != len(names):
        raise ValueError(f"case names repeat across the jobs: {names}")
    if len({job.device for job in jobs}) != 1:
        raise ValueError("the jobs of one world run on one device")
    for case in (case for job in jobs for case in job.cases):
        if case.data * case.graph * case.model != nprocs:
            raise ValueError(f"case {case.name}: a ({case.data}, {case.graph}, "
                             f"{case.model}) mesh in a world of {nprocs}")
    return spawn(check_process, nprocs, jobs, backend="gloo", device=jobs[0].device)
