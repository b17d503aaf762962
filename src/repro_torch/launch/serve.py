"""Solver-in-the-loop serving launcher (CLI) on one CUDA device: the port
of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --ckpt-dir /path/to/ckpt --mesh 4,4,2 --p 2 --requests 32 \
        --batch-slots 4 --rollout-steps 2 --mp-backend fused

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
"""
import argparse
import time

import numpy as np

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import NMPPlan
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import partition_mesh
from repro_torch.runtime.engine import (
    EngineConfig, InferenceEngine, config_from_checkpoint)
from repro_torch.train.loop import TrainConfig, train_consistent_gnn

DT = 0.05


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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bootstrap-steps", type=int, default=20,
                    help="train this many steps to create a checkpoint when "
                         "--ckpt-dir has none (0 = refuse instead)")
    args = ap.parse_args(argv)
    for name in ("requests", "batch_slots", "rollout_steps", "producers",
                 "max_pending"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, got "
                     f"{getattr(args, name)}")

    sem = box_mesh(tuple(int(v) for v in args.mesh.split(",")), p=args.p)
    if not ckpt.committed_steps(args.ckpt_dir):
        if args.bootstrap_steps <= 0:
            ap.error(f"no committed checkpoint under {args.ckpt_dir}: nothing "
                     "to serve (--bootstrap-steps 0)")
        _bootstrap(args, sem)

    engine = InferenceEngine(
        args.ckpt_dir, config_from_checkpoint(args.ckpt_dir),
        EngineConfig(batch_slots=args.batch_slots,
                     rollout_steps=args.rollout_steps,
                     max_pending=args.max_pending),
        plan=NMPPlan(backend=args.mp_backend), device=args.device)
    print(f"[serve] {engine.cfg.name} config (N_H={engine.cfg.hidden}, "
          f"M={engine.cfg.n_mp_layers}) from step {engine.ckpt_step}, trained mesh "
          f"{engine.fingerprint['mesh_hash']} "
          f"(n_global={engine.fingerprint['n_global']}), serving on "
          f"{args.device} with the {args.mp_backend} backend")
    mesh_hash = engine.register_mesh(sem)
    engine.warmup()

    def snapshot_fn(step: int):
        return taylor_green_velocity(sem.coords,
                                     t=(step * DT) % 2.0).astype(np.float32)

    with engine:
        t0 = time.perf_counter()
        results = list(engine.stream(mesh_hash, snapshot_fn, args.requests,
                                     n_producers=args.producers))
        wall = time.perf_counter() - t0

    lat = np.sort([r.latency_s for _, r in results]) * 1e3
    st = engine.stats
    print(f"[serve] {len(results)} requests in {wall:.2f}s "
          f"({len(results) / wall:.1f} req/s) | latency p50 "
          f"{float(np.percentile(lat, 50)):.1f} ms, p95 "
          f"{float(np.percentile(lat, 95)):.1f} ms | {st['batches']} batches, "
          f"{st['padded_slots']} padded slots, graph cache "
          f"{st['cache_builds']} build(s) / {st['cache_hits']} hit(s)")


if __name__ == "__main__":
    main()
