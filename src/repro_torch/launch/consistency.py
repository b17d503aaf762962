"""Multi-process consistency check: the port's counterpart of
``tests/drivers/consistency_driver.py``.

    PYTHONPATH=src python -m repro_torch.launch.consistency --device cpu

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

A :class:`Job` also asks for the halo exchanges alone on a seeded
aggregate (``halo``), the consistent reductions (``reductions``), a K-step
rollout gradient (``rollout``), training steps (``train_steps``), and
per-process launch counts and times (``timing``: CUDA events on a card); the tests
(``tests/test_torch_dist.py``) and ``chip_smoke.py`` phase 3c read those.
The workers import nothing outside this package.
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
from repro_torch.core.consistent_loss import (
    consistent_mse, consistent_node_count, consistent_node_sum)
from repro_torch.core.distributed import make_gnn_step_fns
from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
from repro_torch.core.halo import A2A, NEIGHBOR, NONE, HaloSpec, halo_sync
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import gather_node_features, partition_mesh
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
DT = 0.05
SEED = 0
#: the training run's (rank grid, data replicas) and global batch
TRAIN_CASE, TRAIN_BATCH = ((2, 1, 1), 2), 2
LOSS_REL, G_RTOL, G_ATOL = 2e-6, 1e-3, 2e-5


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
    cases: Optional[tuple] = None
    params: object = None
    halo: bool = False
    reductions: bool = False
    rollout: int = 0              # K of a rollout on the last case (packed)
    train_steps: int = 0          # training steps (packed neighbor) on TRAIN_CASE
    timing: int = 0               # timed repeats of the packed forward and step


def _params(job: Job, device):
    if job.params is None:
        return init_gnn(torch.Generator().manual_seed(SEED), job.cfg, device=device)
    return params_from_jax(job.params, device)


def plan_for(pg, mode: str, backend: str) -> NMPPlan:
    halo_mode, packed = MODES[mode]
    return NMPPlan.build(pg, halo_mode, packed=packed, backend=backend)


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


def _halo_case(mesh, pg, graph, job, R):
    """Each mode's exchange of a seeded aggregate and its gradient."""
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
        out[mode] = {"out": y.detach(), "grad": ga, "batched": yb}
    return out


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


def _steps(mesh, pg, sem, params, job, backend, mode, graph):
    """Loss, gradients and forward of one (backend, mode), each with this
    process's launches; with ``job.timing`` the packed mode's times too."""
    plan = plan_for(pg, mode, backend)
    eval_step, _, grad_step, _ = make_gnn_step_fns(job.cfg, plan, mesh=mesh)
    dev = mesh.device
    # one snapshot per replica, the same on each (as the reference check)
    xs, ys = (torch.from_numpy(gather_node_features(
        pg, taylor_green_velocity(sem.coords, t=t), mesh.rank)[None]).to(dev)
        for t in (0.0, DT))
    rec = {}
    rec["pred"], rec["fwd_launches"] = _counted(lambda: eval_step(params, xs, graph))
    (rec["loss"], rec["grads"]), rec["grad_launches"] = _counted(
        lambda: grad_step(params, xs, ys, graph))
    _sync(dev)
    if job.timing and mode == "packed":
        tr, layers = mesh.world_group.transport, job.cfg.n_mp_layers * xs.shape[0]
        eval_step(params, xs, graph)
        rec["fwd_ms"] = _median_ms(lambda: eval_step(params, xs, graph), job.timing, dev)
        tr.reset()
        eval_step(params, xs, graph)
        _sync(dev)
        rec["stage_ms_per_exchange"] = 1e3 * tr.stage_s / layers
        rec["wire_ms_per_exchange"] = 1e3 * tr.wire_s / layers
        rec["staged_bytes_per_layer"] = tr.staged_bytes / layers
        rec["grad_ms"] = _median_ms(lambda: grad_step(params, xs, ys, graph),
                                  job.timing, dev)
    return rec


def _train(mesh, pg, sem, job):
    tcfg = TrainConfig(n_steps=job.train_steps, batch=TRAIN_BATCH, lr=1e-3, seed=SEED,
                       plan=NMPPlan(halo=HaloSpec(mode=NEIGHBOR, packed=True),
                                    backend=job.backends[-1]))
    hist = train_consistent_gnn(pg, sem, job.cfg, tcfg, params=job.params,
                                mesh=mesh)
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
    cases = job.cases if job.cases is not None else CASES[world]
    for ci, (grid, data) in enumerate(cases):
        R = int(np.prod(grid))
        mesh = make_mesh(data, R, backend=backend, device=job.device)
        params = _params(job, mesh.device)
        pg = partition_mesh(sem, grid)
        rec = {"rank": mesh.rank, "replica": mesh.replica, "steps": {}}
        for backend_name in job.backends:
            graphs = {mode: ShardedGraph.build(pg, sem.coords,
                                               plan_for(pg, mode, backend_name),
                                               device=mesh.device, rank=mesh.rank)
                      for mode in job.modes}
            for mode in job.modes:
                rec["steps"][(backend_name, mode)] = _steps(
                    mesh, pg, sem, params, job, backend_name, mode, graphs[mode])
        if job.halo or job.reductions:
            g = {mode: ShardedGraph.build(pg, sem.coords, plan_for(pg, mode, XLA),
                                          device=mesh.device, rank=mesh.rank)
                 for mode in ("a2a", "neighbor", "packed")}
            if job.halo:
                rec["halo"] = _halo_case(mesh, pg, g, job, R)
            if job.reductions:
                rec["reductions"] = _reductions(mesh, pg, g["a2a"], R)
        if job.rollout and ci == len(cases) - 1:
            rec["rollout"] = _rollout(mesh, pg, sem, params, job)
        out[case_name(grid, data)] = rec
    if job.train_steps:
        grid, data = TRAIN_CASE
        mesh = make_mesh(data, int(np.prod(grid)), backend=backend, device=job.device)
        out["train"] = _train(mesh, partition_mesh(sem, grid), sem, job)
    return out


def _rollout(mesh, pg, sem, params, job):
    """A K-step rollout's loss and gradients (pushforward noise on), and the
    inference rollout's predictions of the same x0."""
    k = job.rollout
    plan = plan_for(pg, "packed", job.backends[-1])
    g = ShardedGraph.build(pg, sem.coords, plan, device=mesh.device, rank=mesh.rank)
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
    pg = partition_mesh(sem, (1, 1, 1))
    params = _params(job, job.device)
    plan = plan_for(pg, "none", XLA)
    g = ShardedGraph.build(pg, sem.coords, plan, device=job.device)
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


def check_step(recs, base, mode: str, w_rel=None) -> str:
    """The reference check on one (backend, mode) of one case, ``recs``
    every process's record: the same loss on every process; ``none``
    deviating from the R=1 loss by more than 1e-6, any other mode's loss
    within :data:`LOSS_REL` of it and every process's gradients within
    :func:`grads_close` of R=1's.  ``base`` is R=1's (loss, gradient
    leaves).  Returns the line; raises AssertionError with it on failure."""
    l1, g1 = base
    loss = float(recs[0]["loss"])
    same = all(float(r["loss"]) == loss for r in recs)
    dev = abs(loss - l1) / abs(l1)
    if mode == "none":
        ok, note = same and abs(loss - l1) > 1e-6, "(must exceed 1e-6 abs)"
    else:
        err, by_norm, g_ok = 0.0, {}, True
        for r in recs:
            e, b, o = grads_close(nn.tree_leaves(r["grads"]), g1, w_rel=w_rel)
            err, g_ok = max(err, e), g_ok and o
            by_norm.update(b)
        ok = same and g_ok and dev <= LOSS_REL
        note = (f"(band {LOSS_REL}) | grads max|err| {err:.3g} (rtol {G_RTOL} atol "
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


def check(results, base, w_rel=None) -> list:
    """The reference check's assertions (:func:`check_step`,
    :func:`check_agree`) on every case, backend and mode of one world's
    results, as lines; raises on the first that fails."""
    lines = []
    for case in (c for c in results[0] if c != "train"):
        keys = results[0][case]["steps"]
        for backend in dict.fromkeys(k[0] for k in keys):
            losses = {}
            for (b, mode) in keys:
                if b == backend:
                    recs = [p[case]["steps"][(b, mode)] for p in results]
                    lines.append(f"{case} {backend:5s} "
                                 + check_step(recs, base, mode, w_rel))
                    losses[mode] = float(recs[0]["loss"])
            lines.append(f"{case} {backend:5s} " + check_agree(losses))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, nargs="+", default=[2, 4], choices=sorted(CASES))
    ap.add_argument("--mp-backend", nargs="+", default=[XLA, FUSED], choices=[XLA, FUSED])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    job = Job(device=args.device, backends=tuple(args.mp_backend))
    base = baseline(job)
    print(f"R=1 loss {base[0]:.8f} ({args.device})", flush=True)
    for world in args.world:
        t0 = time.perf_counter()
        for line in check(run_world(job, world), base):
            print(f"world {world}: {line}", flush=True)
        print(f"world {world}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"consistency": "pass", "worlds": args.world}))


if __name__ == "__main__":
    main()
