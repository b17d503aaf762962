"""Training loop for the consistent GNN (port of ``repro.train.loop``),
plus the run fingerprints its checkpoints carry.

    history = train_consistent_gnn(pg, sem_mesh, GNNConfig.large(),
                                   TrainConfig(n_steps=10), device="cuda")

Two training modes, selected by ``TrainConfig.rollout_steps`` (or a
``rollout_curriculum``): 1 (default) is one-step prediction, the paper's
Fig. 6 training; K > 1 is autoregressive rollout training
(``repro_torch.train.rollout``).  Each step: a Taylor-Green batch built on
the host (pure in ``step``), the gradient of the Eq. 6 loss (through the
fused forward and backward kernels under ``backend="fused"``), AdamW, and,
with ``ckpt_dir``, an asynchronous checkpoint ``{"params", "opt", "rng"}``
(``ckpt.AsyncCheckpointer``: an owned host snapshot, written off-thread)
with the run fingerprint and the loss history in its manifest — the tree
and manifest ``repro`` writes, so either package restores it.

Elastic fault tolerance (``TrainConfig.resilience``): the loop is driven by
``repro_torch.runtime.fault_tolerance.run_resilient`` — periodic and
straggler-triggered checkpoints whose manifests carry the run fingerprint
(mesh hash, rank count, partitioner, plan policy, replay-critical training
config) and the loss-history tail, crash recovery with bounded backoff,
preemption on SIGTERM, and :func:`resume_elastic` restore.  A checkpoint
written on R ranks restores onto R' ranks, or under another partitioner,
and the loss trajectory continues: bitwise when the partition is
unchanged, within fp32 summation tolerance across a repartition.  The
``params=`` argument seeds the run when the directory holds no checkpoint.

A partition of R > 1 ranks, and data parallelism, run one process per
(replica, rank) with ``mesh=`` (``repro_torch.launch.mesh``): each process
builds its rank's slice of the graph and of its replica's ``B / D``
samples of each step's batch, the loss is consistent over the graph group
and averaged over the replicas, the gradients are averaged over every
process, and every process runs the same AdamW on them; only replica 0,
rank 0 writes checkpoints (under resilience every process runs the
driver, which agrees on each crash, save failure and preemption over the
world group).  ``plan.schedule`` is ``blocking``, ``overlap`` (the
interior/boundary split; a training step runs each layer's exchange
between the two sides, blocking, as the gradient needs) or ``auto``, and
``halo_mode`` may be ``auto`` too: the plan is resolved once per partition
by ``plan.autotune(graph, hidden=cfg.hidden)`` where the reference calls
it (under a mesh the lead measures on the stacked graph and every process
takes its pick).  A same-R checkpoint in the run's directory that recorded
a resolved schedule is rerun with it instead of measuring again (the lead
reads the manifest and broadcasts), so a resumed run replays the same
program.  Without a mesh R > 1 raises.  A multilevel config
(``cfg.n_levels > 1``) needs ``hierarchy=`` (``core/coarsen.py::
build_hierarchy``, whose level 0 is ``pg``): the plan gets one halo spec
per level and the graph (this process's rank of every level) the coarse
chain with its transfer maps.
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
from repro_torch.core.graph_state import AUTO, BLOCKING, OVERLAP, NMPPlan, ShardedGraph
from repro_torch.core.mesh_gen import SEMMesh, taylor_green_velocity
from repro_torch.core.partition import PartitionedGraphs, gather_node_features
from repro_torch.runtime.fault_tolerance import (
    FaultPlan, ResilientConfig, run_resilient)
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
    # not None: the run_resilient driver (auto-resume from its ckpt_dir,
    # crash recovery, fingerprinted manifests); ckpt_dir / ckpt_every
    # above are then ignored
    resilience: Optional[ResilientConfig] = None


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


# fingerprint fields that MUST match between save and resume: they define
# the trajectory (problem + deterministic batch replay + optimizer math).
# Everything else (ranks, partitioner, halo_mode, policy) is execution
# layout — arithmetically invisible under the consistency guarantee.
_REPLAY_FIELDS = ("mesh_hash", "n_global", "seed", "batch", "lr",
                  "rollout_steps", "rollout_curriculum", "pushforward_noise",
                  "pushforward_noise_final", "n_levels", "hidden")


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


def _recorded_schedule(ckpt_dir, ranks: int, plan: NMPPlan, mesh=None) -> str:
    """The schedule the newest checkpoint under ``ckpt_dir`` recorded when
    it was written at ``ranks`` ranks on ``plan``'s backend, else
    ``"auto"`` (an unreadable manifest counts as none).  Under a mesh the
    lead reads it and every process takes its answer."""
    box = [AUTO]
    if mesh is None or mesh.lead:
        try:
            manifest = ckpt.peek_manifest(ckpt_dir)
        except ckpt.CheckpointCorruption:
            manifest = None
        fp = (manifest or {}).get("extra", {}).get("fingerprint", {})
        prev = fp.get("policy", {})
        if (fp.get("ranks") == ranks and prev.get("backend") == plan.backend
                and prev.get("schedule") in (BLOCKING, OVERLAP)):
            box[0] = prev["schedule"]
    if mesh is not None and mesh.world_group.size > 1:
        group = mesh.world_group
        torch.distributed.broadcast_object_list(box, src=group.ranks[0],
                                                group=group.pg)
    return box[0]


def _build_execution(pg, sem_mesh, cfg, tcfg, device, mesh=None, hierarchy=None):
    """Everything a training step needs for this partition (this process's
    share of it, under ``mesh``): the plan (halo specs from the partition,
    or from ``hierarchy``'s levels), the graph on ``device``, the
    optimizer, and per-step batch / gradient closures."""
    if cfg.n_levels > 1 and hierarchy is None:
        raise ValueError("cfg.n_levels > 1 needs hierarchy= "
                         "(repro_torch.core.coarsen.build_hierarchy)")
    hierarchy = hierarchy if cfg.n_levels > 1 else None
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
    policy = tcfg.plan
    plan = NMPPlan.build(pg if hierarchy is None else hierarchy, tcfg.halo_mode,
                         packed=policy.halo.packed, wire_dtype=policy.halo.wire_dtype,
                         backend=policy.backend, schedule=policy.schedule,
                         precision=policy.precision, block_n=policy.block_n,
                         block_e=policy.block_e)
    graph = ShardedGraph.build(pg, sem_mesh.coords, plan, device=device,
                               rank=None if mesh is None else mesh.rank,
                               hierarchy=hierarchy)
    # schedule="auto": a same-R checkpoint's recorded schedule is rerun, so
    # a resumed trajectory runs the same program
    ckpt_dir = tcfg.resilience.ckpt_dir if tcfg.resilience else tcfg.ckpt_dir
    if plan.schedule == AUTO and ckpt_dir:
        plan = plan.replace(schedule=_recorded_schedule(ckpt_dir, pg.R, plan, mesh))
    # "auto" fields: measured once per partition (under a mesh, by the lead
    # on the stacked level-0 graph, its pick broadcast to every process)
    plan = plan.autotune(graph, hidden=cfg.hidden, mesh=mesh, stacked=lambda: (
        ShardedGraph.build(pg, sem_mesh.coords, plan, device=device)))
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


def resume_elastic(ckpt_dir, pg, sem_mesh, cfg, tcfg, plan, device="cuda"):
    """Elastic restore: the latest valid checkpoint onto the CURRENT
    partition (the caller has built it, and the plan, for the new rank
    grid — block or spectral).  The state (params, opt, rng) is
    partition-independent and every process holds all of it, so it lands
    on ``device`` as it is; the manifest's fingerprint classifies the
    resume:

      * replay-critical mismatch (different mesh, seed, batch schedule,
        optimizer or model config) → ``ValueError`` naming the field: the
        checkpoint belongs to a different trajectory;
      * execution-layout mismatch (rank count, partitioner, halo mode,
        plan policy) → allowed, returned as the ``elastic`` record.

    Returns ``None`` when no committed checkpoint exists, else
    ``(state, start_step, prior_losses, manifest, elastic_or_None)``.
    Corrupted newest checkpoints fall back to the previous committed step
    (``ckpt.restore_with_fallback``).
    """
    if not ckpt.committed_steps(ckpt_dir):
        return None
    opt_cfg = AdamWConfig(schedule=constant_lr(tcfg.lr), weight_decay=0.0)
    template = _init_state(cfg, tcfg, opt_cfg, device=device)
    state, manifest = ckpt.restore_with_fallback(ckpt_dir, template)
    fp_now = run_fingerprint(sem_mesh, pg, cfg, tcfg, plan)
    fp_old = manifest.get("extra", {}).get("fingerprint")
    elastic = None
    if fp_old:
        for field in _REPLAY_FIELDS:
            if fp_old.get(field) != fp_now.get(field):
                raise ValueError(
                    f"cannot resume from {ckpt_dir}: replay-critical "
                    f"fingerprint field {field!r} changed "
                    f"({fp_old.get(field)!r} -> {fp_now.get(field)!r}) — "
                    "this checkpoint belongs to a different trajectory")
        changed = {k: [fp_old.get(k), fp_now.get(k)]
                   for k in ("ranks", "partitioner", "halo_mode", "policy")
                   if fp_old.get(k) != fp_now.get(k)}
        if changed:
            elastic = {"step": manifest["step"] + 1,
                       "from_ranks": fp_old.get("ranks"),
                       "to_ranks": fp_now.get("ranks"),
                       "from_partitioner": fp_old.get("partitioner"),
                       "to_partitioner": fp_now.get("partitioner"),
                       "changed": changed}
    start = manifest["step"] + 1
    extra = manifest.get("extra", {})
    off = int(extra.get("losses_offset", 0))
    losses = list(extra.get("losses", []))[:max(start - off, 0)]
    return state, start, losses, manifest, elastic


def _train_resilient(ex, pg, sem_mesh, cfg, tcfg, fault, params, device,
                     mesh) -> dict:
    rcfg = tcfg.resilience
    fp = run_fingerprint(sem_mesh, pg, cfg, tcfg, ex.plan)
    monitor = StragglerMonitor()
    elastic_events = []

    def init_state_fn():
        return _init_state(cfg, tcfg, ex.opt_cfg, params=params, device=device)

    def step_fn(state, batch):
        step, tensors = batch
        loss, grads = ex.grad_for_batch(state["params"], step, tensors)
        ex.update(state["params"], state["opt"], grads)
        loss = float(loss)
        _sync(device)
        return state, {"loss": loss}

    def restore_fn():
        res = resume_elastic(rcfg.ckpt_dir, pg, sem_mesh, cfg, tcfg, ex.plan,
                             device=device)
        if res is None:
            return None
        state, start, losses, manifest, elastic = res
        if elastic is not None:
            elastic_events.append(elastic)
            # the per-step time scale changed with the layout — stale EWMA
            # stats would flag the first steps as stragglers
            monitor.reset()
        return state, start, losses

    state, history = run_resilient(
        init_state_fn, step_fn, lambda step: (step, ex.batch_for_step(step)),
        tcfg.n_steps, rcfg, monitor=monitor, fault=fault, restore_fn=restore_fn,
        manifest_extra={"fingerprint": fp}, mesh=mesh)
    history["rollout_k"] = [ex.k_for_step(s) for s in range(tcfg.n_steps)]
    history["schedule"] = ex.plan.schedule
    history["policy"] = ex.plan.policy()
    history["elastic"] = elastic_events[-1] if elastic_events else None
    history["params"] = state["params"]
    return history


def train_consistent_gnn(pg: PartitionedGraphs, sem_mesh: SEMMesh,
                         cfg: GNNConfig, tcfg: TrainConfig, params=None,
                         device="cuda", mesh=None, hierarchy=None,
                         fault: Optional[FaultPlan] = None) -> dict:
    """Full training run of this process; returns the history.

    ``params`` (optional) is the starting parameter tree (tensors or numpy,
    e.g. another package's weights); by default they are drawn from
    ``tcfg.seed``.  ``mesh``: this process's ``(data, graph)`` mesh
    (module docstring; ``device`` is then the mesh's), or None for one
    rank on ``device``.  ``hierarchy`` (``core/coarsen.py::
    MultiLevelGraphs`` with ``pg`` as level 0) runs the consistent V-cycle
    when ``cfg.n_levels > 1``.  History: ``losses`` per step, ``rollout_k`` per
    step, ``schedule`` and ``policy`` (the resolved plan's), ``straggler_events``,
    final ``params``, and the host
    seconds per step: ``batch_s`` (host batch build + copy to the device)
    and ``step_s`` (the whole step, ending in a device synchronisation).

    With ``tcfg.resilience`` set, the run is driven by ``run_resilient``
    (module docstring): it auto-resumes from the newest valid checkpoint
    in ``resilience.ckpt_dir``, elastically, recovers from crashes up to
    ``max_restarts``, and checkpoints periodically and on straggler
    events; its history adds the driver's ``restarts``,
    ``restart_steps``, ``resume_steps``, ``backoffs``, ``preempted_at``
    and ``elastic`` (the layout change of the last elastic resume, or
    None), and has no ``batch_s`` / ``step_s``.  Every process of a mesh
    must pass the same ``fault``.  ``fault`` (``FaultPlan``) injects
    failures; it is only honoured on the resilient path.
    """
    if mesh is not None:
        device = mesh.device
    ex = _build_execution(pg, sem_mesh, cfg, tcfg, device, mesh, hierarchy)
    if tcfg.resilience is not None:
        return _train_resilient(ex, pg, sem_mesh, cfg, tcfg, fault, params,
                                device, mesh)
    fp = run_fingerprint(sem_mesh, pg, cfg, tcfg, ex.plan)
    state = _init_state(cfg, tcfg, ex.opt_cfg, params=params, device=device)
    params, opt_state = state["params"], state["opt"]
    monitor = StragglerMonitor()
    saver = (ckpt.AsyncCheckpointer(tcfg.ckpt_dir)
             if tcfg.ckpt_dir and (mesh is None or mesh.lead) else None)
    history = {"losses": [], "rollout_k": [], "schedule": ex.plan.schedule,
               "policy": ex.plan.policy(), "batch_s": [], "step_s": []}
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
        if saver and (step % tcfg.ckpt_every == 0 or step == tcfg.n_steps - 1):
            # same tree + fingerprinted manifest as the resilient path, so
            # a plain run's checkpoints are elastically resumable too
            saver.save(step, {"params": params, "opt": opt_state,
                              "rng": state["rng"]},
                       extra={"reason": "periodic", "fingerprint": fp,
                              "losses": list(history["losses"]),
                              "losses_offset": 0})
    if saver:
        saver.wait()
    history["straggler_events"] = len(monitor.events)
    history["params"] = params
    return history
