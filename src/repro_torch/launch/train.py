"""Training launcher (CLI): the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --elements 4 4 2 --order 3 --steps 200 --model small \
        --mp-backend fused --ckpt /tmp/ckpt            # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --elements 2 2 1 --order 2 --steps 3 --batch 2 \
        --ranks 2 1 1 --data-parallel 2                # 4 processes, gloo

SEM mesh -> block partition -> ``ShardedGraph`` on the device -> fused (or
plain) NMP forward and backward -> Eq. 6 loss -> AdamW -> synchronous
fingerprinted checkpoints (``--ckpt``), readable by either package.
``--rollout-steps K`` (K > 1) trains autoregressively over the model's own
predictions; ``--pushforward-noise`` adds the detached step-1 noise.

``--ranks`` and ``--data-parallel`` other than one process spawn R * D
processes (``repro_torch.launch.mesh.spawn``), joined by
``--dist-backend``: gloo (the default; CUDA tensors staged through the
host, so processes may share a card) or nccl (one card per process).
``--batch`` must split over the replicas.  Process 0 prints the loss line
and writes the checkpoints.  What is not ported, the CLI refuses naming the
slice that brings it: the overlap/auto schedules, bf16, multilevel
``--levels``, the spectral partitioner and the resilient ``--ckpt-dir``
mode.
"""
import argparse
import math

from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import NMPPlan
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.launch.mesh import BACKENDS, check_backend, make_mesh, spawn
from repro_torch.train.loop import TrainConfig, train_consistent_gnn


def _run(args, mesh=None):
    sem = box_mesh(tuple(args.elements), p=args.order)
    pg = partition_mesh(sem, tuple(args.ranks))
    cfg = GNNConfig.small() if args.model == "small" else GNNConfig.large()
    tcfg = TrainConfig(n_steps=args.steps, batch=args.batch, lr=args.lr,
                       halo_mode=args.halo, ckpt_dir=args.ckpt,
                       ckpt_every=args.ckpt_every,
                       plan=NMPPlan(backend=args.mp_backend),
                       rollout_steps=args.rollout_steps,
                       pushforward_noise=args.pushforward_noise,
                       partitioner=args.partitioner)
    hist = train_consistent_gnn(pg, sem, cfg, tcfg, device=args.device, mesh=mesh)
    if mesh is None or mesh.lead:
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
                    help="synchronous fingerprinted checkpoint dir")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (with --ckpt)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="the reference's resilient auto-resume dir; refused "
                         "(checkpoint resilience is a later slice)")
    ap.add_argument("--mp-backend", default="fused", choices=["xla", "fused"],
                    help="NMP hot loop: plain PyTorch (xla) or the CUDA "
                         "kernels (fused; plain versions on the CPU)")
    ap.add_argument("--mp-schedule", default="blocking",
                    choices=["blocking", "overlap", "auto"])
    ap.add_argument("--partitioner", default="block", choices=["block", "spectral"])
    ap.add_argument("--mp-precision", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--levels", type=int, default=1)
    ap.add_argument("--rollout-steps", type=int, default=1,
                    help="K > 1 trains autoregressively over the model's "
                         "own predictions")
    ap.add_argument("--pushforward-noise", type=float, default=0.0,
                    help="stddev of the detached step-1 pushforward noise "
                         "(needs --rollout-steps > 1)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    refusals = (
        (args.mp_schedule != "blocking",
         f"--mp-schedule {args.mp_schedule} is not ported "
         "(ROADMAP queue: 'Overlap schedule')"),
        (args.mp_precision != "fp32",
         "--mp-precision bf16 is not ported (ROADMAP queue: "
         "'bf16')"),
        (args.levels != 1,
         "--levels > 1 is not ported (ROADMAP queue: 'Multilevel "
         "V-cycle')"),
        (args.partitioner != "block",
         "--partitioner spectral is not ported (ROADMAP queue: "
         "'Spectral partitioning and autotune')"),
        (args.ckpt_dir is not None,
         "--ckpt-dir (resilient auto-resume) is not ported "
         "(ROADMAP queue: 'Checkpoint resilience'); use --ckpt"),
    )
    for refused, msg in refusals:
        if refused:
            ap.error(msg)
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
          + f"; backend={args.mp_backend}; rollout K={args.rollout_steps}", flush=True)
    if nprocs == 1:
        return _run(args)
    return spawn(_process, nprocs, args, backend=args.dist_backend,
                 device=args.device)[0]


if __name__ == "__main__":
    main()
