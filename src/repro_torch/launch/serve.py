"""Solver-in-the-loop serving launcher (CLI): the port of
``repro.launch.serve``, on one CUDA device or over R processes, one graph
rank each.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --ckpt-dir /path/to/ckpt --mesh 4,4,2 --p 2 --requests 32 \
        --batch-slots 4 --rollout-steps 2 --mp-backend fused
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --ckpt-dir /tmp/ck --ranks 2 --schedule overlap --halo-mode neighbor \
        --packed --requests 4                      # 2 gloo processes

Loads a fingerprinted checkpoint (written by ``repro``'s trainer or by
``repro_torch.ckpt.checkpoint.save``; the model config is read from its
parameter shapes) into a resident
:class:`repro_torch.runtime.engine.InferenceEngine`, registers the mesh,
warms up, then streams Taylor-Green snapshots through the engine's bounded
request queue from producer threads and reports latency percentiles and
throughput.  With no committed checkpoint under ``--ckpt-dir`` and
``--bootstrap-steps N > 0``, a short one-rank training run of the paper's
small config (``repro_torch.train.loop``) writes a fingerprinted
checkpoint first, as the reference's ``_bootstrap`` does.

``--ranks R`` > 1 spawns R processes (``launch/mesh.py::spawn``) joined by
``--transport`` (gloo: CUDA tensors staged through the host, so processes
may share a card; nccl: one card per process, refused with fewer cards);
each builds the engine over the mesh and its rank's graph of the
``--rank-grid`` split (``--partitioner spectral``: the spectral bisection's
vertex cut on ``--ranks`` parts), process 0 streams and prints, the others
follow.
:class:`ServeJob` and :func:`run_world` are the same run as a library
call (several jobs in one spawn); ``run_world(..., worker=)`` runs
another per-process function in the same world, as the serving checks
of ``launch/serve_checks.py`` do.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import BLOCKING, FP32, NMPPlan
from repro_torch.core.halo import A2A, NEIGHBOR, HaloSpec
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import partition_mesh
from repro_torch.kernels import build
from repro_torch.launch.mesh import BACKENDS, check_backend, make_mesh, spawn
from repro_torch.runtime.engine import EngineConfig, InferenceEngine, config_from_checkpoint
from repro_torch.train.loop import TrainConfig, train_consistent_gnn

DT = 0.05


def snapshot(sem, step: int) -> np.ndarray:
    """The Taylor-Green velocity of request ``step``."""
    return taylor_green_velocity(sem.coords, t=(step * DT) % 2.0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ServeJob:
    """What every process of one serving world runs (:func:`run_world`):
    the box mesh served, its rank split (None for one rank), the stream,
    the engine's plan and the transport."""
    ckpt_dir: str
    elements: Tuple[int, int, int] = (4, 4, 2)
    order: int = 2
    rank_grid: Optional[Tuple[int, int, int]] = None
    requests: int = 6
    batch_slots: int = 3
    rollout_steps: int = 2
    producers: int = 2
    max_pending: int = 16
    backend: str = "fused"
    schedule: str = BLOCKING
    precision: str = FP32
    halo_mode: str = A2A
    packed: bool = False
    device: str = "cuda"
    transport: str = "gloo"
    partitioner: str = "block"

    @property
    def ranks(self) -> int:
        return 1 if self.rank_grid is None else math.prod(self.rank_grid)

    def plan(self) -> NMPPlan:
        return NMPPlan(halo=HaloSpec(mode=self.halo_mode, packed=self.packed),
                       backend=self.backend, schedule=self.schedule,
                       precision=self.precision)

    def engine_config(self) -> EngineConfig:
        return EngineConfig(batch_slots=self.batch_slots,
                            rollout_steps=self.rollout_steps,
                            max_pending=self.max_pending, halo_mode=self.halo_mode,
                            partitioner=self.partitioner)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _transport(tr) -> dict:
    if tr is None:
        return {}
    return {k: getattr(tr, k) for k in ("staged_bytes", "stage_s", "wire_s", "sync_s",
                                        "wait_s", "posted", "overlapped")}


def build_engine(job: ServeJob):
    """This process's ``(engine, mesh, sem)`` for ``job``: its mesh (None
    for one rank), the box mesh to serve and the engine loaded from the
    checkpoint, nothing registered yet."""
    mesh = (make_mesh(1, job.ranks, backend=job.transport, device=job.device)
            if job.ranks > 1 else None)
    cfg = config_from_checkpoint(job.ckpt_dir)
    engine = InferenceEngine(job.ckpt_dir, cfg, job.engine_config(), plan=job.plan(),
                             device=None if mesh is not None else job.device, mesh=mesh)
    return engine, mesh, box_mesh(tuple(job.elements), p=job.order)


def follow(engine: InferenceEngine, mesh) -> dict:
    """A follower's part: run the lead's mesh work until it closes; its
    record."""
    engine.follow()
    return dict(followed_until=time.time(), stats=dict(engine.stats),
                launches=engine.launches, peak_bytes=_peak(engine.device),
                transport=_transport(mesh.graph_group.transport))


def stream_requests(engine: InferenceEngine, job: ServeJob, sem, mesh_hash: str, mesh):
    """The lead's part: warm up, then stream ``job.requests`` snapshots from
    ``job.producers`` threads with the launch, transport and peak-memory
    counters reset just before.  Returns (record, results by step)."""
    engine.warmup()
    dev = engine.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    transport = None if mesh is None else mesh.graph_group.transport
    if transport is not None:
        transport.reset()
    engine.launches.pop("batch", None)
    build.reset_launch_counts()
    engine.start()
    t0 = time.perf_counter()
    results = dict(engine.stream(mesh_hash, lambda s: snapshot(sem, s), job.requests,
                                 n_producers=job.producers))
    wall = time.perf_counter() - t0
    lat = np.sort([r.latency_s for r in results.values()]) * 1e3
    rec = dict(stream_launches={k: v for k, v in build.launch_counts.items() if v},
               transport=_transport(transport), peak_bytes=_peak(dev), n=len(results),
               wall_s=wall, latency_ms=lat, steps=sorted(results),
               stream_stats=dict(engine.stats))
    return rec, results


def serve_process(job: ServeJob):
    """One process of a serving world (runs in the workers of
    :func:`run_world`, or alone for R = 1): builds the engine, registers
    the mesh, and streams (the lead) or follows; returns its record."""
    engine, mesh, sem = build_engine(job)
    mesh_hash = engine.register_mesh(sem, rank_grid=job.rank_grid)
    rec = {"world_rank": 0 if mesh is None else mesh.world_rank, "mesh_hash": mesh_hash,
           "build_s": engine.entry(mesh_hash).build_s}
    if not engine.lead:
        rec.update(follow(engine, mesh))
        return rec
    rec.update(stream_requests(engine, job, sem, mesh_hash, mesh)[0])
    engine.close()
    rec.update(stats=dict(engine.stats), launches=engine.launches)
    return rec


def _run_jobs(worker, jobs):
    return [worker(job) for job in jobs]


def run_world(*jobs: ServeJob, worker=serve_process):
    """Run ``worker(job)`` for each of ``jobs`` in turn on ``ranks``
    processes, spawned once (in this process for R = 1; every job of the
    same ranks, transport and device); returns each process's records, one
    per job, in world-rank order."""
    first = jobs[0]
    if any((j.ranks, j.transport, j.device) != (first.ranks, first.transport, first.device)
           for j in jobs):
        raise ValueError("run_world: the jobs of one world share ranks, transport "
                         "and device")
    if first.ranks == 1:
        return [_run_jobs(worker, jobs)]
    return spawn(_run_jobs, first.ranks, worker, jobs, backend=first.transport,
                 device=first.device)


def _bootstrap(args, sem):
    """Create a fingerprinted checkpoint via a short one-rank training run."""
    pg = partition_mesh(sem, (1, 1, 1))
    tcfg = TrainConfig(
        n_steps=args.bootstrap_steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=max(1, args.bootstrap_steps // 2),
        halo_mode="none",
        log_every=max(1, args.bootstrap_steps // 4),
        plan=NMPPlan(backend=args.mp_backend))
    print(f"[serve] no committed checkpoint under {args.ckpt_dir}; "
          f"bootstrapping with a {args.bootstrap_steps}-step training run")
    train_consistent_gnn(pg, sem, GNNConfig.small(), tcfg, device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True,
                    help="fingerprinted checkpoint directory to serve from")
    ap.add_argument("--mesh", default="4,4,2",
                    help="box mesh elements per dim, e.g. 4,4,2")
    ap.add_argument("--p", type=int, default=2, help="SEM polynomial order")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--rollout-steps", type=int, default=1,
                    help="prediction horizon K per request")
    ap.add_argument("--producers", type=int, default=2,
                    help="concurrent solver-feed producer threads")
    ap.add_argument("--max-pending", type=int, default=16,
                    help="bounded request queue depth (backpressure point)")
    ap.add_argument("--mp-backend", default="fused", choices=["xla", "fused"],
                    help="NMP hot loop: plain PyTorch (xla) or the CUDA "
                         "kernel (fused)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="graph ranks, one process each")
    ap.add_argument("--rank-grid", type=int, nargs=3, default=None,
                    help="element split of the ranks (default: R x 1 x 1)")
    ap.add_argument("--schedule", default=BLOCKING, choices=["blocking", "overlap"])
    ap.add_argument("--halo-mode", default=A2A, choices=[A2A, NEIGHBOR])
    ap.add_argument("--partitioner", default="block", choices=["block", "spectral"],
                    help="block = element blocks of --rank-grid; spectral = "
                         "recursive spectral bisection (a vertex cut)")
    ap.add_argument("--packed", action="store_true",
                    help="the packed neighbor exchange (needs --halo-mode neighbor)")
    ap.add_argument("--transport", default="gloo", choices=list(BACKENDS),
                    help="torch.distributed backend of a multi-process run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bootstrap-steps", type=int, default=20,
                    help="train this many steps to create a checkpoint when "
                         "--ckpt-dir has none (0 = refuse instead)")
    args = ap.parse_args(argv)
    for name in ("requests", "batch_slots", "rollout_steps", "producers",
                 "max_pending", "ranks"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, got "
                     f"{getattr(args, name)}")
    if args.packed and args.halo_mode != NEIGHBOR:
        ap.error("--packed needs --halo-mode neighbor (all-to-all needs uniform "
                 "buffers)")
    grid = tuple(args.rank_grid) if args.rank_grid else (args.ranks, 1, 1)
    if math.prod(grid) != args.ranks:
        ap.error(f"--rank-grid {grid} does not hold --ranks {args.ranks}")
    if args.ranks > 1:
        try:
            check_backend(args.transport, args.device, args.ranks)
        except (ValueError, RuntimeError) as err:
            ap.error(str(err))

    elements = tuple(int(v) for v in args.mesh.split(","))
    sem = box_mesh(elements, p=args.p)
    if not ckpt.committed_steps(args.ckpt_dir):
        if args.bootstrap_steps <= 0:
            ap.error(f"no committed checkpoint under {args.ckpt_dir}: nothing "
                     "to serve (--bootstrap-steps 0)")
        _bootstrap(args, sem)

    cfg = config_from_checkpoint(args.ckpt_dir)
    step = ckpt.latest_step(args.ckpt_dir)
    fp = ckpt.peek_manifest(args.ckpt_dir, step)["extra"]["fingerprint"]
    levels = (f", {cfg.n_levels} levels x {cfg.coarse_mp_layers} coarse layers"
              if cfg.n_levels > 1 else "")
    print(f"[serve] {cfg.name} config (N_H={cfg.hidden}, M={cfg.n_mp_layers}{levels}) from "
          f"step {step}, trained mesh {fp['mesh_hash']} "
          f"(n_global={fp['n_global']}), serving on {args.device} with the "
          f"{args.mp_backend} backend, {args.ranks} rank(s) {grid}, schedule "
          f"{args.schedule}, {args.partitioner} partition" + (f", {args.halo_mode}{' packed' if args.packed else ''} "
                                f"exchange over {args.transport}" if args.ranks > 1 else ""),
          flush=True)
    job = ServeJob(ckpt_dir=args.ckpt_dir, elements=elements, order=args.p,
                   rank_grid=grid if args.ranks > 1 else None, requests=args.requests,
                   batch_slots=args.batch_slots, rollout_steps=args.rollout_steps,
                   producers=args.producers, max_pending=args.max_pending,
                   backend=args.mp_backend, schedule=args.schedule,
                   halo_mode=args.halo_mode, packed=args.packed, device=args.device,
                   transport=args.transport, partitioner=args.partitioner)
    rec = run_world(job)[0][0]
    lat, st = rec["latency_ms"], rec["stream_stats"]
    print(f"[serve] {rec['n']} requests in {rec['wall_s']:.2f}s "
          f"({rec['n'] / rec['wall_s']:.1f} req/s) | latency p50 "
          f"{float(np.percentile(lat, 50)):.1f} ms, p95 "
          f"{float(np.percentile(lat, 95)):.1f} ms | {st['batches']} batches, "
          f"{st['padded_slots']} padded slots, graph cache "
          f"{st['cache_builds']} build(s) / {st['cache_hits']} hit(s)", flush=True)
    return rec


if __name__ == "__main__":
    main()
