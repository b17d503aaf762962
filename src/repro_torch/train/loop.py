"""Training loop for the consistent GNN on one device (port of the plain
path of ``repro.train.loop``), plus the run fingerprints its checkpoints
carry.

    history = train_consistent_gnn(pg, sem_mesh, GNNConfig.large(),
                                   TrainConfig(n_steps=10), device="cuda")

Two training modes, selected by ``TrainConfig.rollout_steps`` (or a
``rollout_curriculum``): 1 (default) is one-step prediction, the paper's
Fig. 6 training; K > 1 is autoregressive rollout training
(``repro_torch.train.rollout``).  Each step: a Taylor-Green batch built on
the host (pure in ``step``), the gradient of the Eq. 6 loss (through the
fused forward and backward kernels under ``backend="fused"``), AdamW, and,
with ``ckpt_dir``, a synchronous checkpoint ``{"params", "opt", "rng"}``
with the run fingerprint and the loss history in its manifest — the tree
and manifest ``repro`` writes, so either package restores it.

A partition of R > 1 ranks, and data parallelism, run one process per
(replica, rank) with ``mesh=`` (``repro_torch.launch.mesh``): each process
builds its rank's slice of the graph and of its replica's ``B / D``
samples of each step's batch, the loss is consistent over the graph group
and averaged over the replicas, the gradients are averaged over every
process, and every process runs the same AdamW on them; only replica 0,
rank 0 writes checkpoints.  Without a mesh R > 1 raises, as do
``resilience=`` (elastic resume and ``AsyncCheckpointer`` are a later
slice), schedules other than ``blocking`` and multilevel configs.
``mesh_fingerprint_hash`` hashes the global mesh exactly as the reference
does, so a checkpoint written by either package names the same mesh.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from repro_torch import nn
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import params_from_jax
from repro_torch.core.distributed import make_gnn_step_fns
from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.graph_state import BLOCKING, NMPPlan, ShardedGraph
from repro_torch.core.mesh_gen import SEMMesh, taylor_green_velocity
from repro_torch.core.partition import PartitionedGraphs, gather_node_features
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train.optimizer import (
    AdamWConfig, adamw_update_, constant_lr, init_adamw)
from repro_torch.train.rollout import (
    curriculum_k, make_rollout_step_fns, make_tgv_rollout_batch_fn)


@dataclasses.dataclass
class TrainConfig:
    """The reference's training config, field for field."""
    n_steps: int = 200
    batch: int = 1
    lr: float = 1e-3
    halo_mode: str = "neighbor"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    log_every: int = 20
    seed: int = 0
    # NMP execution policy; the halo spec is filled in from the partition
    plan: NMPPlan = NMPPlan()
    # autoregressive rollout training (repro_torch.train.rollout)
    rollout_steps: int = 1
    pushforward_noise: float = 0.0
    rollout_curriculum: tuple = ()
    pushforward_noise_final: Optional[float] = None
    partitioner: str = "block"
    # the elastic resilient driver is a later slice: must stay None
    resilience: Optional[object] = None


def make_tgv_batch_fn(pg: PartitionedGraphs, mesh_sem: SEMMesh, batch: int,
                      dt: float = 0.05, samples=None, rank=None):
    """Deterministic Taylor-Green snapshot batches keyed by step: numpy
    [B, R, N_pad, F] (autoencoding target = input).  One process's share:
    ``samples`` (indices into the batch of ``batch``) and ``rank`` (R = 1:
    that rank's rows), each sample the same as in the whole batch."""
    samples = range(batch) if samples is None else samples

    def batch_fn(step: int):
        xs = []
        for b in samples:
            t = (step * batch + b) * dt % 2.0
            xs.append(gather_node_features(
                pg, taylor_green_velocity(mesh_sem.coords, t=t), rank))
        return np.stack(xs)
    return batch_fn


def mesh_fingerprint_hash(sem_mesh: SEMMesh) -> str:
    """Content hash of the global mesh (node coords + element connectivity).
    Partition-independent: every rank count of the same mesh hashes
    identically."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(sem_mesh.coords).tobytes())
    h.update(np.ascontiguousarray(sem_mesh.elem_nodes).tobytes())
    return h.hexdigest()[:16]


def run_fingerprint(sem_mesh: SEMMesh, pg: PartitionedGraphs, cfg: GNNConfig,
                    tcfg: TrainConfig, plan: NMPPlan) -> dict:
    """The manifest ``extra["fingerprint"]`` a checkpoint carries."""
    return {
        "mesh_hash": mesh_fingerprint_hash(sem_mesh),
        "n_global": int(pg.n_global),
        "ranks": int(pg.R),
        "partitioner": tcfg.partitioner,
        "halo_mode": tcfg.halo_mode,
        "policy": plan.policy(),
        "seed": int(tcfg.seed),
        "batch": int(tcfg.batch),
        "lr": float(tcfg.lr),
        "rollout_steps": int(tcfg.rollout_steps),
        "rollout_curriculum": list(tcfg.rollout_curriculum),
        "pushforward_noise": float(tcfg.pushforward_noise),
        "pushforward_noise_final": tcfg.pushforward_noise_final,
        "n_levels": int(cfg.n_levels),
        "hidden": int(cfg.hidden),
    }


def legacy_key(seed: int) -> np.ndarray:
    """The reference's ``jax.random.PRNGKey(seed)`` as it stores it:
    uint32[2], the seed cut to 32 bits (JAX's default 32-bit types)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def _init_state(cfg: GNNConfig, tcfg: TrainConfig, opt_cfg: AdamWConfig,
                params=None, device="cuda") -> dict:
    """{"params", "opt", "rng"}: params drawn from ``tcfg.seed`` (a torch
    generator: not the reference's JAX draw) unless ``params`` (a tree of
    tensors or numpy arrays) is given, which is copied onto ``device``."""
    if params is None:
        params = init_gnn(torch.Generator().manual_seed(tcfg.seed), cfg,
                          device=device)
    else:
        params = params_from_jax(nn.tree_map(
            lambda t: t.detach().cpu().numpy() if hasattr(t, "detach")
            else np.asarray(t), params), device)
    return {"params": params, "opt": init_adamw(params, opt_cfg),
            "rng": legacy_key(tcfg.seed)}


def _to_device(arrays, device):
    return tuple(torch.as_tensor(a, dtype=torch.float32).to(device)
                 for a in arrays)


def _build_execution(pg, sem_mesh, cfg, tcfg, device, mesh=None):
    """Everything a training step needs for this partition (this process's
    share of it, under ``mesh``): the plan (halo spec from the partition),
    the graph on ``device``, the optimizer, and per-step batch / gradient
    closures."""
    if mesh is None and pg.R != 1:
        raise ValueError(
            f"training on {pg.R} ranks needs a mesh: run one process per "
            "rank (repro_torch.launch.mesh.spawn + make_mesh) and pass mesh=, "
            "or partition with ranks (1, 1, 1)")
    share = {}
    if mesh is not None:
        if mesh.graph != pg.R:
            raise ValueError(f"the partition has {pg.R} ranks, the mesh's "
                             f"graph axis {mesh.graph}")
        if tcfg.batch % mesh.data:
            raise ValueError(f"batch {tcfg.batch} does not split over "
                             f"{mesh.data} data replicas")
        n = tcfg.batch // mesh.data
        share = {"samples": range(mesh.replica * n, (mesh.replica + 1) * n),
                 "rank": mesh.rank}
    if tcfg.resilience is not None:
        raise NotImplementedError(
            "resilience= (run_resilient, AsyncCheckpointer, elastic resume) "
            "is not ported yet (ROADMAP queue: 'Checkpoint resilience'); use "
            "TrainConfig.ckpt_dir for synchronous checkpoints")
    policy = tcfg.plan
    plan = NMPPlan.build(pg, tcfg.halo_mode, packed=policy.halo.packed,
                         backend=policy.backend, schedule=policy.schedule,
                         block_n=policy.block_n, block_e=policy.block_e)
    if plan.schedule != BLOCKING:
        raise NotImplementedError(
            f"schedule {plan.schedule!r} is not ported to repro_torch yet "
            "(ROADMAP queue: 'Overlap schedule'); use 'blocking'")
    graph = ShardedGraph.build(pg, sem_mesh.coords, plan, device=device,
                               rank=None if mesh is None else mesh.rank)
    plan = plan.autotune(graph, hidden=cfg.hidden)
    opt_cfg = AdamWConfig(schedule=constant_lr(tcfg.lr), weight_decay=0.0)

    def update(params, opt_state, grads):
        return adamw_update_(grads, opt_state, params, opt_cfg)

    stages = tuple(tcfg.rollout_curriculum)
    if stages or tcfg.rollout_steps > 1:
        stages = stages or (tcfg.rollout_steps,)
        noise_scale = tcfg.pushforward_noise
        if tcfg.pushforward_noise_final is not None:
            n0, n1 = tcfg.pushforward_noise, tcfg.pushforward_noise_final
            denom = max(tcfg.n_steps - 1, 1)
            noise_scale = lambda s: n0 + (n1 - n0) * (s / denom)  # noqa: E731
        fns_by_k = {}

        def k_for_step(step: int) -> int:
            return curriculum_k(stages, tcfg.n_steps, step)

        def fns(step):
            k = k_for_step(step)
            if k not in fns_by_k:
                _, rollout_grad = make_rollout_step_fns(cfg, plan, k, mesh=mesh)
                bf = make_tgv_rollout_batch_fn(
                    pg, sem_mesh, tcfg.batch, k, noise_scale=noise_scale,
                    seed=tcfg.seed, **share)
                fns_by_k[k] = (rollout_grad, bf)
            return fns_by_k[k]

        def batch_for_step(step):
            return _to_device(fns(step)[1](step), device)

        def grad_for_batch(params, step, batch):
            return fns(step)[0](params, *batch, graph)
    else:
        _, _, grad_step, _ = make_gnn_step_fns(cfg, plan, mesh=mesh)
        batch_fn = make_tgv_batch_fn(pg, sem_mesh, tcfg.batch, **share)

        def k_for_step(step: int) -> int:
            return 1

        def batch_for_step(step):
            return _to_device((batch_fn(step),), device)

        def grad_for_batch(params, step, batch):
            return grad_step(params, batch[0], batch[0], graph)

    return SimpleNamespace(plan=plan, graph=graph, opt_cfg=opt_cfg,
                           update=update, batch_for_step=batch_for_step,
                           grad_for_batch=grad_for_batch,
                           k_for_step=k_for_step)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_consistent_gnn(pg: PartitionedGraphs, sem_mesh: SEMMesh,
                         cfg: GNNConfig, tcfg: TrainConfig, params=None,
                         device="cuda", mesh=None) -> dict:
    """Full training run of this process; returns the history.

    ``params`` (optional) is the starting parameter tree (tensors or numpy,
    e.g. another package's weights); by default they are drawn from
    ``tcfg.seed``.  ``mesh``: this process's ``(data, graph)`` mesh
    (module docstring; ``device`` is then the mesh's), or None for one
    rank on ``device``.  History: ``losses`` per step, ``rollout_k`` per
    step, ``schedule``, ``straggler_events``, final ``params``, and the host
    seconds per step: ``batch_s`` (host batch build + copy to the device)
    and ``step_s`` (the whole step, ending in a device synchronisation).
    """
    if mesh is not None:
        device = mesh.device
    ex = _build_execution(pg, sem_mesh, cfg, tcfg, device, mesh)
    fp = run_fingerprint(sem_mesh, pg, cfg, tcfg, ex.plan)
    state = _init_state(cfg, tcfg, ex.opt_cfg, params=params, device=device)
    params, opt_state = state["params"], state["opt"]
    monitor = StragglerMonitor()
    history = {"losses": [], "rollout_k": [], "schedule": ex.plan.schedule,
               "batch_s": [], "step_s": []}
    for step in range(tcfg.n_steps):
        t0 = time.perf_counter()
        monitor.start_step()
        batch = ex.batch_for_step(step)
        t1 = time.perf_counter()
        loss, grads = ex.grad_for_batch(params, step, batch)
        params, opt_state, _ = ex.update(params, opt_state, grads)
        history["losses"].append(float(loss))
        _sync(device)
        monitor.end_step(step)
        history["batch_s"].append(t1 - t0)
        history["step_s"].append(time.perf_counter() - t0)
        history["rollout_k"].append(ex.k_for_step(step))
        if tcfg.ckpt_dir and (mesh is None or mesh.lead) and (
                step % tcfg.ckpt_every == 0 or step == tcfg.n_steps - 1):
            ckpt.save(tcfg.ckpt_dir, step,
                      {"params": params, "opt": opt_state, "rng": state["rng"]},
                      extra={"reason": "periodic", "fingerprint": fp,
                             "losses": list(history["losses"]),
                             "losses_offset": 0})
    history["straggler_events"] = len(monitor.events)
    history["params"] = params
    return history
