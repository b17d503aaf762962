"""Training launcher (CLI): the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --elements 4 4 2 --order 3 --steps 200 --model small \
        --mp-backend fused --ckpt /tmp/ckpt            # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --elements 2 2 1 --order 2 --steps 3 --batch 2 \
        --ranks 2 1 1 --data-parallel 2                # 4 processes, gloo

SEM mesh -> block (or ``--partitioner spectral``: recursive spectral
bisection, a vertex cut) partition -> ``ShardedGraph`` on the device ->
fused (or plain) NMP forward and backward -> Eq. 6 loss -> AdamW ->
asynchronous fingerprinted checkpoints (``--ckpt``), readable by either
package.  ``--ckpt-dir`` instead runs the resilient driver
(``runtime/fault_tolerance.py``): it resumes from the newest valid
checkpoint there (elastically: the checkpoint may come from another
``--ranks`` or ``--partitioner``), recovers from up to ``--max-restarts``
crashes, commits an early checkpoint on SIGTERM, and writes a checkpoint
every ``--ckpt-every`` steps.  Over processes every process runs the
driver and only process 0 writes; a process that dies takes the world
down, and the next call resumes from disk.
``--rollout-steps K`` (K > 1) trains autoregressively over the model's own
predictions; ``--pushforward-noise`` adds the detached step-1 noise.

``--ranks`` and ``--data-parallel`` other than one process spawn R * D
processes (``repro_torch.launch.mesh.spawn``), joined by
``--dist-backend``: gloo (the default; CUDA tensors staged through the
host, so processes may share a card) or nccl (one card per process).
``--batch`` must split over the replicas.  Process 0 prints the loss line
and writes the checkpoints.  ``--mp-schedule overlap`` runs the
interior/boundary split (its exchange blocking between the two sides, as
the gradient needs).  ``--mp-precision bf16`` runs the edge MLP's products
on bf16-rounded operands with fp32 accumulation.  ``--levels L`` (L > 1)
adds the consistent multilevel V-cycle (``core/coarsen.py``: level 1 the
element centroids, deeper levels the element grid clustered 2x per axis)
with ``--coarse-mp-layers`` NMP layers per coarse level, at R=1 and under
``--ranks`` (with ``--partitioner spectral`` its level 0 is the spectral
split).  ``--mp-schedule auto`` measures blocking against overlap once on
this partition at the model's width and trains with the faster (over
processes the lead measures, every process takes its pick).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --elements 2 2 1 --order 2 --steps 3 --batch 1 \
        --mp-schedule auto --partitioner spectral --ranks 2 1 1
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --elements 2 2 1 --order 2 --steps 8 --batch 1 \
        --ckpt-dir /tmp/ck --ckpt-every 3     # a second call resumes
"""
import argparse
import dataclasses
import math

from repro_torch.core.coarsen import build_hierarchy
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import FP32, PRECISIONS, NMPPlan
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.core.partition_quality import mesh_node2part
from repro_torch.launch.mesh import BACKENDS, check_backend, make_mesh, spawn
from repro_torch.runtime.fault_tolerance import ResilientConfig
from repro_torch.train.loop import TrainConfig, train_consistent_gnn


def _run(args, mesh=None):
    sem = box_mesh(tuple(args.elements), p=args.order)
    cfg = GNNConfig.small() if args.model == "small" else GNNConfig.large()
    hierarchy = None
    if args.levels > 1:
        cfg = dataclasses.replace(cfg, n_levels=args.levels,
                                  coarse_mp_layers=args.coarse_mp_layers,
                                  coarse_edge_in=sem.dim + 1)
        node2part = (mesh_node2part(sem, _ranks(args))
                     if args.partitioner == "spectral" else None)
        hierarchy = build_hierarchy(sem, tuple(args.ranks), args.levels,
                                    node2part=node2part)
        pg = hierarchy.levels[0]
        if mesh is None or mesh.lead:
            sizes = " -> ".join(str(s) for s in hierarchy.level_sizes())
            print(f"multilevel hierarchy: {sizes} nodes per level", flush=True)
    else:
        pg = partition_mesh(sem, tuple(args.ranks), method=args.partitioner)
    resilience = None
    if args.ckpt_dir:
        resilience = ResilientConfig(ckpt_dir=args.ckpt_dir,
                                     ckpt_every=args.ckpt_every,
                                     max_restarts=args.max_restarts)
    tcfg = TrainConfig(n_steps=args.steps, batch=args.batch, lr=args.lr,
                       halo_mode=args.halo, ckpt_dir=args.ckpt,
                       ckpt_every=args.ckpt_every,
                       plan=NMPPlan(backend=args.mp_backend,
                                    schedule=args.mp_schedule,
                                    precision=args.mp_precision),
                       rollout_steps=args.rollout_steps,
                       pushforward_noise=args.pushforward_noise,
                       partitioner=args.partitioner, resilience=resilience)
    hist = train_consistent_gnn(pg, sem, cfg, tcfg, device=args.device, mesh=mesh,
                                hierarchy=hierarchy)
    if mesh is None or mesh.lead:
        if args.mp_schedule == "auto":
            print(f"schedule auto resolved to {hist['schedule']}", flush=True)
        if hist.get("elastic"):
            el = hist["elastic"]
            print(f"elastic resume at step {el['step']}: "
                  f"R={el['from_ranks']}/{el['from_partitioner']} -> "
                  f"R={el['to_ranks']}/{el['to_partitioner']}", flush=True)
        if hist.get("resume_steps"):
            print(f"resumed from step {hist['resume_steps'][0]}", flush=True)
        if hist.get("restarts"):
            print(f"recovered from {hist['restarts']} crash(es)", flush=True)
        print(f"loss {hist['losses'][0]:.6f} -> {hist['losses'][-1]:.6f} "
              f"({len(hist['losses'])} steps, {hist['straggler_events']} "
              "straggler events)", flush=True)
    return hist


def _process(args):
    """One process of a multi-process run."""
    return _run(args, make_mesh(args.data_parallel, _ranks(args),
                                backend=args.dist_backend, device=args.device))


def _ranks(args) -> int:
    return math.prod(args.ranks)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, nargs=3, default=[4, 4, 2])
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--ranks", type=int, nargs=3, default=[1, 1, 1],
                    help="rank grid: one process per rank")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="data replicas: R processes each")
    ap.add_argument("--dist-backend", default="gloo", choices=list(BACKENDS),
                    help="torch.distributed backend of a multi-process run")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--halo", default="neighbor", choices=["neighbor", "a2a", "none"],
                    help="halo mode (one rank exchanges nothing in any mode)")
    ap.add_argument("--model", default="small", choices=["small", "large"])
    ap.add_argument("--ckpt", default=None,
                    help="plain fire-and-forget checkpoint dir (no resume); "
                         "for crash recovery + elastic resume use --ckpt-dir")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resilient checkpoint dir: auto-resumes from the "
                         "newest valid checkpoint (elastically: it may come "
                         "from another --ranks or --partitioner), recovers "
                         "from crashes, and writes fingerprinted manifests")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (with --ckpt or --ckpt-dir)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="in-process crash recoveries before giving up "
                         "(with --ckpt-dir)")
    ap.add_argument("--mp-backend", default="fused", choices=["xla", "fused"],
                    help="NMP hot loop: plain PyTorch (xla) or the CUDA "
                         "kernels (fused; plain versions on the CPU)")
    ap.add_argument("--mp-schedule", default="blocking",
                    choices=["blocking", "overlap", "auto"],
                    help="halo/compute schedule: auto measures both on this "
                         "graph x rank count and trains with the faster")
    ap.add_argument("--partitioner", default="block", choices=["block", "spectral"],
                    help="block = element blocks along --ranks; spectral = "
                         "recursive spectral bisection + KL refinement (a "
                         "vertex cut): lower halo volume on stretched meshes, "
                         "the same results either way")
    ap.add_argument("--mp-precision", default=FP32, choices=PRECISIONS,
                    help="edge-MLP products: bf16 rounds their operands to "
                         "bf16 and accumulates in fp32 (the kernels' bf16 "
                         "entries on the fused backend)")
    ap.add_argument("--levels", type=int, default=1,
                    help="multilevel depth: 1 = flat NMP; >1 adds a "
                         "consistent coarse-grid V-cycle")
    ap.add_argument("--coarse-mp-layers", type=int, default=2,
                    help="NMP layers smoothing each coarse level")
    ap.add_argument("--rollout-steps", type=int, default=1,
                    help="K > 1 trains autoregressively over the model's "
                         "own predictions")
    ap.add_argument("--pushforward-noise", type=float, default=0.0,
                    help="stddev of the detached step-1 pushforward noise "
                         "(needs --rollout-steps > 1)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt and args.ckpt_dir:
        ap.error("--ckpt and --ckpt-dir are mutually exclusive (plain "
                 "fire-and-forget saves vs resilient auto-resume)")
    if args.levels < 1 or args.coarse_mp_layers < 0:
        ap.error("--levels must be >= 1 and --coarse-mp-layers >= 0")
    if args.rollout_steps < 1:
        ap.error("--rollout-steps must be >= 1")
    if args.pushforward_noise and args.rollout_steps == 1:
        ap.error("--pushforward-noise needs --rollout-steps > 1 (one-step "
                 "training never feeds predictions back)")
    if min(args.ranks) < 1 or args.data_parallel < 1:
        ap.error("--ranks and --data-parallel must be >= 1")
    if args.batch % args.data_parallel:
        ap.error(f"--batch {args.batch} must split over --data-parallel "
                 f"{args.data_parallel} replicas")
    nprocs = _ranks(args) * args.data_parallel
    if nprocs > 1:
        try:
            check_backend(args.dist_backend, args.device, nprocs)
        except (ValueError, RuntimeError) as err:
            ap.error(str(err))

    sem = box_mesh(tuple(args.elements), p=args.order)
    print(f"mesh: {sem.n_elem} elems p={args.order} ({sem.n_nodes} nodes); "
          f"R={_ranks(args)} x DP={args.data_parallel} on {args.device}"
          + (f" ({nprocs} processes, {args.dist_backend})" if nprocs > 1 else "")
          + f"; partitioner={args.partitioner}; backend={args.mp_backend}, "
          f"schedule={args.mp_schedule}, "
          f"precision={args.mp_precision}; levels={args.levels}; rollout "
          f"K={args.rollout_steps}", flush=True)
    if nprocs == 1:
        return _run(args)
    return spawn(_process, nprocs, args, backend=args.dist_backend,
                 device=args.device)[0]


if __name__ == "__main__":
    main()
