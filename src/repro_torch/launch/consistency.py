"""Multi-process consistency check: the port's counterpart of
``tests/drivers/consistency_driver.py``.

    PYTHONPATH=src python -m repro_torch.launch.consistency --device cpu
    PYTHONPATH=src python -m repro_torch.launch.consistency --device cpu --levels 3
    PYTHONPATH=src python -m repro_torch.launch.consistency --device cpu \
        --partitioner spectral

On the reference check's mesh (``box_mesh((4, 4, 2), p=3)``) and model
(``GNNConfig.small()``), spawns the reference check's (rank grid, data replicas) cases, one
process per (replica, rank) joined by gloo (:data:`CASES`: 2 processes run
``(2,1,1) x 1``, 4 run ``(2,1,1) x 2`` and ``(2,2,1) x 1``), and runs in
every process, through the real ``torch.distributed`` exchange, the loss,
the gradients and the forward of ``core/distributed.py``'s step functions
for each halo mode (:data:`MODES`: ``a2a``, dense ``neighbor``, packed
``packed`` and the inconsistent ``none``) and NMP backend.  Each process
returns its results as numpy through a file (``launch/mesh.py::spawn``);
:func:`run_world` hands them back and the CLI holds them (:func:`check`)
to the R=1 stacked reference of this package, as the reference check
does: losses within rel 2e-6 and gradients within rtol 1e-3 / atol 2e-5
of R=1, ``none`` deviating by more than 1e-6, the exchanges within 1e-7
of each other.

``Job.schedules`` runs each (backend, mode) under the blocking schedule
(records under ``"steps"``) and, with ``overlap``, under the
interior/boundary overlap schedule (``"steps_overlap"``, :func:`steps_key`):
the forward (no gradient) posts each exchange and finishes it after
queueing the interior side, the gradient run finishes each exchange as
soon as it is posted, between the sides; each record counts the
exchanges each run posted and overlapped (``fwd_exchanges``,
``grad_exchanges``).  A :class:`Job` also asks for the halo exchanges
alone on a seeded aggregate (``halo``), the consistent reductions (``reductions``), a K-step
rollout gradient (``rollout``), training steps (``train_steps``), and
per-process launch counts and times (``timing``: CUDA events on a card); the tests
(``tests/test_torch_dist.py``) and ``chip_smoke.py`` phase 3c read those.
A multilevel model (``Job.cfg.n_levels > 1``, the CLI's ``--levels``)
runs every case over ``core/coarsen.py``'s hierarchy of the case's rank
grid (one halo spec per level, every level's graph on each process): the
counterpart of the reference's ``tests/drivers/multilevel_driver.py``
(:func:`multilevel_job`: its mesh, model and rank grids; gradients held to
its rtol 2e-3).  ``Job.partitioner`` (the CLI's ``--partitioner``)
splits every case by ``block`` element grids or by ``spectral`` bisection
(a vertex cut), as the reference check's ``--partitioner`` does.
``Job.forms`` runs, on the 4-rank case, every form of the exchange alone
on a seeded aggregate (:data:`FORMS`: a2a, dense and packed neighbor, the
two-level rounds2d dense and packed, each with and without the bf16 wire,
under sum and under max), and ``Job.tune`` (a width) resolves a
(schedule x halo-mode x wire) ``auto`` plan through the multi-process
tuner twice, with the launches of each call.  The workers import nothing
outside this package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import nn
from repro_torch.convert import params_from_jax
from repro_torch.core.coarsen import build_hierarchy
from repro_torch.core.consistent_loss import (
    consistent_mse, consistent_node_count, consistent_node_sum)
from repro_torch.core.distributed import make_gnn_step_fns
from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.consistent_mp import _pick_of, measure_plan_candidates
from repro_torch.core.graph_state import (
    AUTO, BLOCKING, FUSED, OVERLAP, XLA, NMPPlan, ShardedGraph)
from repro_torch.core.halo import (
    A2A, MAX, NEIGHBOR, NONE, SUM, HaloSpec, halo_sync, halo_sync_post)
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import (
    gather_node_features, partition_mesh, partition_mesh_2d)
from repro_torch.core.partition_quality import mesh_node2part
from repro_torch.core.reference import loss_and_grad_stacked
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.train.loop import TrainConfig, train_consistent_gnn
from repro_torch.train.rollout import (
    make_rollout_predict_fn, make_rollout_step_fns, make_tgv_rollout_batch_fn)

#: (rank grid, data replicas) per world size, as the reference check's
CASES = {2: (((2, 1, 1), 1),),
         4: (((2, 1, 1), 2), ((2, 2, 1), 1))}
#: halo modes: name -> (HaloSpec mode, packed)
MODES = {"a2a": (A2A, False), "neighbor": (NEIGHBOR, False),
         "packed": (NEIGHBOR, True), "none": (NONE, False)}
#: modes with a compressed wire: name -> (HaloSpec mode, packed, wire)
WIRE_MODES = {"packed_bf16": (NEIGHBOR, True, torch.bfloat16)}
#: the exchange forms of ``Job.forms``: name -> (partition: "block" or the
#: two-level "2d" grid, HaloSpec mode, packed, wire, combine)
FORMS = {f"{base}{'_bf16' if wire else ''}_{combine}": (part, mode, packed, wire, combine)
         for base, (part, mode, packed) in (
             ("a2a", ("block", A2A, False)), ("neighbor", ("block", NEIGHBOR, False)),
             ("packed", ("block", NEIGHBOR, True)), ("rounds2d", ("2d", NEIGHBOR, False)),
             ("rounds2d_packed", ("2d", NEIGHBOR, True)))
         for wire in (None, torch.bfloat16) for combine in (SUM, MAX)}
DT = 0.05
SEED = 0
#: the training run's (rank grid, data replicas) and global batch
TRAIN_CASE, TRAIN_BATCH = ((2, 1, 1), 2), 2
LOSS_REL, G_RTOL, G_ATOL = 2e-6, 1e-3, 2e-5
#: the reference multilevel check's gradient rtol (multilevel_driver.py)
ML_G_RTOL = 2e-3
#: its rank grids per world size
ML_CASES = {2: (((2, 1, 1), 1),),
            4: (((4, 1, 1), 1), ((2, 2, 1), 1))}


@dataclasses.dataclass(frozen=True)
class Job:
    """What every process of one world runs (module docstring).  ``params``
    is a numpy tree (``repro``'s weights, say) or None: drawn from
    :data:`SEED`.  ``cases`` defaults to :data:`CASES` of the world size."""
    elements: Tuple[int, int, int] = (4, 4, 2)
    order: int = 3
    cfg: GNNConfig = GNNConfig.small()
    device: str = "cuda"
    backends: Tuple[str, ...] = (XLA, FUSED)
    modes: Tuple[str, ...] = tuple(MODES)
    schedules: Tuple[str, ...] = (BLOCKING,)
    cases: Optional[tuple] = None
    params: object = None
    halo: bool = False
    reductions: bool = False
    rollout: int = 0              # K of a rollout on the last case (packed)
    train_steps: int = 0          # training steps (packed neighbor) on TRAIN_CASE
    timing: int = 0               # timed repeats of the packed forward and step
    partitioner: str = "block"    # or "spectral" (a vertex cut)
    forms: bool = False           # every exchange form alone (FORMS), 4 ranks
    tune: int = 0                 # width of the multi-process autotune (0: off)


def _params(job: Job, device):
    if job.params is None:
        return init_gnn(torch.Generator().manual_seed(SEED), job.cfg, device=device)
    return params_from_jax(job.params, device)


def plan_for(pg, mode: str, backend: str, schedule: str = BLOCKING,
             hier=None) -> NMPPlan:
    """The plan of one halo mode on ``pg`` (one spec per level of ``hier``,
    the hierarchy over ``pg``, when given)."""
    halo_mode, packed, wire = WIRE_MODES.get(mode) or MODES[mode] + (None,)
    return NMPPlan.build(pg if hier is None else hier, halo_mode, packed=packed,
                         wire_dtype=wire, backend=backend, schedule=schedule)


def partition(sem, grid, cfg: GNNConfig, partitioner: str = "block"):
    """(fine partition, hierarchy or None) of ``grid`` for ``cfg``, split by
    ``partitioner``."""
    if cfg.n_levels > 1:
        node2part = (mesh_node2part(sem, int(np.prod(grid)))
                     if partitioner == "spectral" else None)
        hier = build_hierarchy(sem, grid, cfg.n_levels, node2part=node2part)
        return hier.levels[0], hier
    return partition_mesh(sem, grid, method=partitioner), None


def form_spec(pg, name: str) -> HaloSpec:
    """The HaloSpec of one of :data:`FORMS` on ``pg`` (the form's own
    partition: :func:`form_partitions`)."""
    _, mode, packed, wire, _ = FORMS[name]
    return NMPPlan.build(pg, mode, packed=packed, wire_dtype=wire).halo


def form_partitions(sem) -> dict:
    """The 4-rank partitions of :data:`FORMS` by name: the (2, 2, 1) block
    split and the two-level split of a (2, 2) rank grid."""
    return {"block": partition_mesh(sem, (2, 2, 1)), "2d": partition_mesh_2d(sem, (2, 2))}


def build_graph(pg, hier, sem, plan: NMPPlan, device, rank=None) -> ShardedGraph:
    """The graph of ``plan`` on ``device`` (every level of ``hier``)."""
    return ShardedGraph.build(pg, sem.coords, plan, device=device, rank=rank,
                              hierarchy=hier)


def exchanges_per_forward(cfg: GNNConfig) -> int:
    """Halo exchanges of one forward: one per NMP layer, and per coarse
    level its restriction's and its prolongation's completions."""
    return cfg.n_mp_layers + (cfg.n_levels - 1) * (cfg.coarse_mp_layers + 2)


def multilevel_job(levels: int = 3, **kw) -> "Job":
    """The reference multilevel check's job: ``box_mesh((4, 4, 2), p=2)``,
    N_H=8, M=1, 2 MLP hidden layers, one NMP layer per coarse level."""
    cfg = GNNConfig(hidden=8, n_mp_layers=1, mlp_hidden_layers=2, n_levels=levels,
                    coarse_mp_layers=1)
    return Job(elements=(4, 4, 2), order=2, cfg=cfg, **kw)


def steps_key(schedule: str) -> str:
    """Where a process's record keeps one schedule's step results."""
    return "steps" if schedule == BLOCKING else f"steps_{schedule}"


def case_name(grid, data) -> str:
    return "x".join(map(str, grid)) + f"_d{data}"


def seeded(seed: int, shape) -> np.ndarray:
    """A seeded float32 normal array (the workers and the tests draw the
    same one and take their rank slices)."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def param_checksum(params) -> int:
    """Position-weighted sum of every leaf's 32-bit words, on the device."""
    total = 0
    for i, t in enumerate(nn.tree_leaves(params)):
        w = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1 + i
        total += int((w * pos).sum())
    return total


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_ms(fn, repeats, device):
    """Median ms of ``fn``, by CUDA events on a card and the host clock on
    the CPU (every process runs it alike: it holds collectives)."""
    out = []
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(out))


def _counted(fn):
    """(result, launch counts of this process) of one call."""
    build.reset_launch_counts()
    out = fn()
    return out, {k: v for k, v in build.launch_counts.items() if v}


def _exchanges(tr) -> dict:
    return {"posted": tr.posted, "overlapped": tr.overlapped}


def _halo_case(mesh, pg, graph, job, R):
    """Each mode's exchange of a seeded aggregate (through autograd, and
    posted), its gradient, and a batched one without gradient."""
    f = job.cfg.hidden
    a_all = seeded(1, (R, pg.n_pad, f))
    w_all = seeded(2, (R, pg.n_pad, f))
    b_all = seeded(3, (2, R, pg.n_pad, f))
    out = {}
    for mode in ("a2a", "neighbor", "packed"):
        spec = plan_for(pg, mode, XLA).halo
        g = graph[mode]
        a = torch.from_numpy(a_all[mesh.rank]).to(mesh.device).requires_grad_(True)
        y = halo_sync(a, g, spec, mesh)
        w = torch.from_numpy(w_all[mesh.rank]).to(mesh.device)
        ga, = torch.autograd.grad((y * w).sum(), a)
        with torch.no_grad():
            yb = halo_sync(torch.from_numpy(b_all[:, mesh.rank]).to(mesh.device),
                           g, spec, mesh)
            posted = halo_sync_post(a.detach(), g, spec, mesh).finish()
        out[mode] = {"out": y.detach(), "grad": ga, "batched": yb, "posted": posted}
    return out


def _forms_case(mesh, sem, job, R):
    """Each of :data:`FORMS` on a seeded aggregate (masked to real rows):
    the exchange without gradient, and under sum its gradient; with this
    process's launches and staged bytes of the exchange."""
    f = job.cfg.hidden
    parts = form_partitions(sem)
    graphs = {k: ShardedGraph.build(pg, sem.coords, NMPPlan.build(pg, NEIGHBOR, packed=True),
                                    device=mesh.device, rank=mesh.rank)
              for k, pg in parts.items()}
    tr, out = mesh.graph_group.transport, {}
    for name, (part, _, _, _, combine) in FORMS.items():
        pg, g = parts[part], graphs[part]
        spec = form_spec(pg, name)
        a_all = seeded(6, (R, pg.n_pad, f)) * pg.node_mask[..., None]
        a = torch.from_numpy(a_all[mesh.rank]).to(mesh.device)
        tr.reset()
        with torch.no_grad():
            y, launches = _counted(lambda: halo_sync(a, g, spec, mesh, combine))
        rec = {"out": y, "launches": launches, "staged_bytes": tr.staged_bytes,
               "sent_bytes": tr.sent_bytes}
        if combine == SUM:
            w = torch.from_numpy(seeded(7, (R, pg.n_pad, f))[mesh.rank]).to(mesh.device)
            a_g = a.clone().requires_grad_(True)
            rec["grad"], = torch.autograd.grad((halo_sync(a_g, g, spec, mesh) * w).sum(),
                                               a_g)
        out[name] = rec
    return out


def _tune_case(mesh, pg, sem, job):
    """A (schedule x halo-mode x wire) ``auto`` plan with the bf16 wire
    resolved by the multi-process tuner at width ``job.tune`` (the lead
    measures on the stacked graph, every process takes its pick), then
    again (a cache hit: nothing measured, nothing launched).  The lead's
    record holds the measured table."""
    plan = NMPPlan.build(pg, AUTO, schedule=AUTO, wire_dtype=torch.bfloat16,
                         backend=job.backends[-1])
    g = ShardedGraph.build(pg, sem.coords, plan, device=mesh.device, rank=mesh.rank)
    held = {}

    def stacked():
        held["g"] = ShardedGraph.build(pg, sem.coords, plan, device=mesh.device)
        return held["g"]
    t0 = time.perf_counter()
    first, launches = _counted(lambda: plan.autotune(g, hidden=job.tune, mesh=mesh,
                                                     stacked=stacked))
    seconds = time.perf_counter() - t0
    again, launches_again = _counted(lambda: plan.autotune(g, hidden=job.tune, mesh=mesh,
                                                           stacked=stacked))
    rec = {"pick": _pick_of(first), "pick_again": _pick_of(again), "launches": launches,
           "launches_again": launches_again, "seconds": seconds}
    if "g" in held:
        rec["table"] = measure_plan_candidates(plan, held["g"], hidden=job.tune)
    return rec


def _reductions(mesh, pg, g, R):
    y_all = seeded(4, (2, R, pg.n_pad, 3))
    t_all = seeded(5, (2, R, pg.n_pad, 3))
    r, grp, dev = mesh.rank, mesh.graph_group, mesh.device
    y, t = (torch.from_numpy(a[:, r]).to(dev) for a in (y_all, t_all))
    inv = g["node_inv_mult"]
    return {"mse": consistent_mse(y[0], t[0], inv, group=grp),
            "mse_batched": consistent_mse(y, t, inv, group=grp),
            "node_sum": consistent_node_sum(y[0], inv, group=grp),
            "node_count": consistent_node_count(inv, group=grp)}


def _steps(mesh, pg, sem, params, job, backend, mode, graph, schedule=BLOCKING,
           hier=None):
    """Loss, gradients and forward of one (backend, mode, schedule), each
    with this process's launches and exchanges; with ``job.timing`` the
    packed mode's times too (the host's per exchange: the stream sync
    before staging, the staging copies, the gloo calls and the part of them
    blocked in a posted exchange's wait)."""
    plan = plan_for(pg, mode, backend, schedule, hier)
    eval_step, _, grad_step, _ = make_gnn_step_fns(job.cfg, plan, mesh=mesh)
    dev, tr = mesh.device, mesh.world_group.transport
    # one snapshot per replica, the same on each (as the reference check)
    xs, ys = (torch.from_numpy(gather_node_features(
        pg, taylor_green_velocity(sem.coords, t=t), mesh.rank)[None]).to(dev)
        for t in (0.0, DT))
    rec = {}
    tr.reset()
    rec["pred"], rec["fwd_launches"] = _counted(lambda: eval_step(params, xs, graph))
    rec["fwd_exchanges"] = _exchanges(tr)
    rec["fwd_staged_bytes"], rec["fwd_sent_bytes"] = tr.staged_bytes, tr.sent_bytes
    tr.reset()
    (rec["loss"], rec["grads"]), rec["grad_launches"] = _counted(
        lambda: grad_step(params, xs, ys, graph))
    rec["grad_exchanges"] = _exchanges(tr)
    _sync(dev)
    if job.timing and mode == "packed":
        layers = exchanges_per_forward(job.cfg) * xs.shape[0]
        eval_step(params, xs, graph)
        rec["fwd_ms"] = _median_ms(lambda: eval_step(params, xs, graph), job.timing, dev)
        tr.reset()
        eval_step(params, xs, graph)
        _sync(dev)
        for name in ("sync", "stage", "wire", "wait"):
            rec[f"{name}_ms_per_exchange"] = 1e3 * getattr(tr, f"{name}_s") / layers
        rec["staged_bytes_per_layer"] = tr.staged_bytes / layers
        rec["grad_ms"] = _median_ms(lambda: grad_step(params, xs, ys, graph),
                                  job.timing, dev)
    return rec


def _train(mesh, pg, sem, job, hier=None):
    tcfg = TrainConfig(n_steps=job.train_steps, batch=TRAIN_BATCH, lr=1e-3, seed=SEED,
                       plan=NMPPlan(halo=HaloSpec(mode=NEIGHBOR, packed=True),
                                    backend=job.backends[-1]))
    hist = train_consistent_gnn(pg, sem, job.cfg, tcfg, params=job.params,
                                mesh=mesh, hierarchy=hier)
    sums = [None] * mesh.world_group.size
    torch.distributed.all_gather_object(sums, param_checksum(hist["params"]))
    if mesh.lead and len(set(sums)) != 1:
        raise RuntimeError(f"parameters differ between processes after "
                           f"{job.train_steps} steps: checksums {sums}")
    return {"losses": hist["losses"], "params": hist["params"],
            "checksums": sums, "step_s": hist["step_s"]}


def _world(job: Job, world: int, backend: str):
    """One process of a world: every case of ``job`` (runs in the workers)."""
    out = {}
    sem = box_mesh(tuple(job.elements), p=job.order)
    default = ML_CASES if job.cfg.n_levels > 1 else CASES
    cases = job.cases if job.cases is not None else default[world]
    for ci, (grid, data) in enumerate(cases):
        R = int(np.prod(grid))
        mesh = make_mesh(data, R, backend=backend, device=job.device)
        params = _params(job, mesh.device)
        pg, hier = partition(sem, grid, job.cfg, job.partitioner)
        rec = {"rank": mesh.rank, "replica": mesh.replica}
        rec.update((steps_key(sch), {}) for sch in job.schedules)
        # an overlap plan's graph also carries what the blocking one reads
        build_schedule = OVERLAP if OVERLAP in job.schedules else BLOCKING
        for backend_name in job.backends:
            graphs = {mode: build_graph(
                pg, hier, sem, plan_for(pg, mode, backend_name, build_schedule, hier),
                mesh.device, mesh.rank) for mode in job.modes}
            for schedule in job.schedules:
                for mode in job.modes:
                    rec[steps_key(schedule)][(backend_name, mode)] = _steps(
                        mesh, pg, sem, params, job, backend_name, mode, graphs[mode],
                        schedule, hier)
        if job.halo or job.reductions:
            g = {mode: ShardedGraph.build(pg, sem.coords, plan_for(pg, mode, XLA),
                                          device=mesh.device, rank=mesh.rank)
                 for mode in ("a2a", "neighbor", "packed")}
            if job.halo:
                rec["halo"] = _halo_case(mesh, pg, g, job, R)
            if job.reductions:
                rec["reductions"] = _reductions(mesh, pg, g["a2a"], R)
        if job.forms and R == 4:
            rec["forms"] = _forms_case(mesh, sem, job, R)
        if job.tune:
            rec["tune"] = _tune_case(mesh, pg, sem, job)
        if job.rollout and ci == len(cases) - 1:
            rec["rollout"] = _rollout(mesh, pg, sem, params, job, hier)
        out[case_name(grid, data)] = rec
    if job.train_steps:
        grid, data = TRAIN_CASE
        mesh = make_mesh(data, int(np.prod(grid)), backend=backend, device=job.device)
        pg, hier = partition(sem, grid, job.cfg, job.partitioner)
        out["train"] = _train(mesh, pg, sem, job, hier)
    return out


def _rollout(mesh, pg, sem, params, job, hier=None):
    """A K-step rollout's loss and gradients (pushforward noise on), and the
    inference rollout's predictions of the same x0."""
    k = job.rollout
    plan = plan_for(pg, "packed", job.backends[-1], hier=hier)
    g = build_graph(pg, hier, sem, plan, mesh.device, mesh.rank)
    # batch of D: replica d takes sample d
    bf = make_tgv_rollout_batch_fn(pg, sem, mesh.data, k, noise_scale=0.02, seed=1,
                                   samples=range(mesh.replica, mesh.replica + 1),
                                   rank=mesh.rank)
    x0, tg, nz = (torch.from_numpy(a).to(mesh.device) for a in bf(0))
    _, rollout_grad = make_rollout_step_fns(job.cfg, plan, k, mesh=mesh)
    loss, grads = rollout_grad(params, x0, tg, nz, g)
    preds = make_rollout_predict_fn(job.cfg, plan, k, mesh=mesh)(params, x0, g)
    return {"loss": loss, "grads": grads, "preds": preds}


def run_world(job: Job, world: int, backend: str = "gloo"):
    """Spawn ``world`` processes that run ``job``; returns each process's
    results (world-rank order): {case name: {"rank", "replica", "steps":
    {(backend, mode): {"pred", "loss", "grads", "fwd_launches",
    "grad_launches", ...}}, "halo", "reductions", "rollout"}, "train":
    {"losses", "params", "checksums", "step_s"}}."""
    return spawn(_world, world, job, world, backend, backend=backend,
                 device=job.device)


def baseline(job: Job):
    """The R=1 loss and gradients of this package's stacked reference
    (plain backend), on ``job.device``."""
    sem = box_mesh(tuple(job.elements), p=job.order)
    pg, hier = partition(sem, (1, 1, 1), job.cfg)
    params = _params(job, job.device)
    plan = plan_for(pg, "none", XLA, hier=hier)
    g = build_graph(pg, hier, sem, plan, job.device)
    x, y = (torch.from_numpy(gather_node_features(
        pg, taylor_green_velocity(sem.coords, t=t))).to(job.device) for t in (0.0, DT))
    loss, _, grads = loss_and_grad_stacked(params, x, y, g, plan, job.cfg.node_out)
    return float(loss), [t.cpu().numpy() for t in nn.tree_leaves(grads)]


def grads_close(got, want, rtol=G_RTOL, atol=G_ATOL, w_rel=None):
    """Gradient leaves (numpy, in the same order) within ``rtol`` / ``atol``
    elementwise.  With ``w_rel``, a leaf outside that band is held to a
    relative L2 norm of ``w_rel`` instead (a weight gradient summed over
    every edge, whose elements cancel to near zero).  Returns (max abs
    error, {leaf index: rel L2} of the leaves outside the band, ok)."""
    err, by_norm, ok = 0.0, {}, True
    for i, (a, b) in enumerate(zip(got, want)):
        d = np.abs(a - b)
        err = max(err, float(d.max()))
        if not np.all(d <= atol + rtol * np.abs(b)):
            by_norm[i] = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
            ok = ok and w_rel is not None and by_norm[i] <= w_rel
    return err, by_norm, ok and len(got) == len(want)


def check_step(recs, base, mode: str, w_rel=None, g_rtol=G_RTOL) -> str:
    """The reference check on one (backend, mode) of one case, ``recs``
    every process's record: the same loss on every process; ``none``
    deviating from the R=1 loss by more than 1e-6, any other mode's loss
    within :data:`LOSS_REL` of it and every process's gradients within
    :func:`grads_close` of R=1's (rtol ``g_rtol``).  ``base`` is R=1's
    (loss, gradient leaves).  Returns the line; raises AssertionError with it on failure."""
    l1, g1 = base
    loss = float(recs[0]["loss"])
    same = all(float(r["loss"]) == loss for r in recs)
    dev = abs(loss - l1) / abs(l1)
    if mode == "none":
        ok, note = same and abs(loss - l1) > 1e-6, "(must exceed 1e-6 abs)"
    else:
        err, by_norm, g_ok = 0.0, {}, True
        for r in recs:
            e, b, o = grads_close(nn.tree_leaves(r["grads"]), g1, rtol=g_rtol,
                                  w_rel=w_rel)
            err, g_ok = max(err, e), g_ok and o
            by_norm.update(b)
        ok = same and g_ok and dev <= LOSS_REL
        note = (f"(band {LOSS_REL}) | grads max|err| {err:.3g} (rtol {g_rtol} atol "
                f"{G_ATOL})" + (f"; by rel L2 (<= {w_rel}): {by_norm}" if by_norm else ""))
    line = (f"{mode:8s} loss {loss:.8f} on every process: {same}, rel to R=1 "
            f"{dev:.2e} {note} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(line)
    return line


def check_agree(losses: dict) -> str:
    """The consistent exchanges' losses (mode -> loss, ``none`` left out)
    within 1e-7 of each other; raises AssertionError otherwise."""
    vals = {m: v for m, v in losses.items() if m != "none"}
    spread = max(vals.values()) - min(vals.values())
    line = f"{', '.join(vals)} losses within {spread:.3g} (< 1e-7)"
    if not spread < 1e-7:
        raise AssertionError(f"{line}: {vals}")
    return line


def check(results, base, w_rel=None, schedule: str = BLOCKING,
          g_rtol=G_RTOL, agree: bool = True) -> list:
    """The reference check's assertions (:func:`check_step`, and with
    ``agree`` :func:`check_agree`) on every case, backend and mode of one
    world's results under ``schedule``, as lines; raises on the first that
    fails.  The reference multilevel check has no agreement assertion
    (its modes sum in other orders over more exchanges): its calls pass
    ``agree=False`` and ``g_rtol=ML_G_RTOL``."""
    lines, key = [], steps_key(schedule)
    tag = "" if schedule == BLOCKING else f" {schedule}"
    for case in (c for c in results[0] if c != "train"):
        keys = results[0][case][key]
        for backend in dict.fromkeys(k[0] for k in keys):
            losses = {}
            for (b, mode) in keys:
                if b == backend:
                    recs = [p[case][key][(b, mode)] for p in results]
                    lines.append(f"{case} {backend:5s}{tag} "
                                 + check_step(recs, base, mode, w_rel, g_rtol))
                    losses[mode] = float(recs[0]["loss"])
            if agree:
                lines.append(f"{case} {backend:5s}{tag} " + check_agree(losses))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, nargs="+", default=[2, 4], choices=sorted(CASES))
    ap.add_argument("--mp-backend", nargs="+", default=[XLA, FUSED], choices=[XLA, FUSED])
    ap.add_argument("--schedule", nargs="+", default=[BLOCKING],
                    choices=[BLOCKING, OVERLAP])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--partitioner", default="block", choices=["block", "spectral"],
                    help="split every case by element blocks or by spectral "
                         "bisection (a vertex cut)")
    ap.add_argument("--levels", type=int, default=1,
                    help="> 1: the multilevel V-cycle on the reference "
                         "multilevel check's mesh, model and rank grids")
    args = ap.parse_args(argv)
    kw = dict(device=args.device, backends=tuple(args.mp_backend),
              schedules=tuple(args.schedule), partitioner=args.partitioner)
    job = multilevel_job(args.levels, **kw) if args.levels > 1 else Job(**kw)
    g_rtol = ML_G_RTOL if args.levels > 1 else G_RTOL
    base = baseline(job)
    print(f"R=1 loss {base[0]:.8f} ({args.device})", flush=True)
    for world in args.world:
        t0 = time.perf_counter()
        results = run_world(job, world)
        for line in (l for sch in job.schedules
                     for l in check(results, base, schedule=sch, g_rtol=g_rtol,
                                    agree=args.levels == 1)):
            print(f"world {world}: {line}", flush=True)
        print(f"world {world}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"consistency": "pass", "worlds": args.world}))


if __name__ == "__main__":
    main()
