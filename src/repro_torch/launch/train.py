"""Training launcher (CLI) on one device: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --elements 4 4 2 --order 3 --steps 200 --model small \
        --mp-backend fused --ckpt /tmp/ckpt            # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --elements 2 2 1 --order 2 --steps 3 --batch 1

SEM mesh -> block partition -> ``ShardedGraph`` on the device -> fused (or
plain) NMP forward and backward -> Eq. 6 loss -> AdamW -> synchronous
fingerprinted checkpoints (``--ckpt``), readable by either package.
``--rollout-steps K`` (K > 1) trains autoregressively over the model's own
predictions; ``--pushforward-noise`` adds the detached step-1 noise.

One rank and one data replica only: ``--ranks 1 1 1 --data-parallel 1``.
What this slice refuses, it refuses naming the slice that brings it: more
ranks (the ``torch.distributed`` halo), the overlap/auto schedules, bf16,
multilevel ``--levels``, the spectral partitioner and the resilient
``--ckpt-dir`` driver.
"""
import argparse

from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import NMPPlan
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.train.loop import TrainConfig, train_consistent_gnn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, nargs=3, default=[4, 4, 2])
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--ranks", type=int, nargs=3, default=[1, 1, 1],
                    help="rank grid; only 1 1 1 in this slice")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="data replicas; only 1 in this slice")
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
        (tuple(args.ranks) != (1, 1, 1),
         "--ranks other than 1 1 1 needs the torch.distributed halo "
         "exchange (ROADMAP queue: 'Real torch.distributed halo')"),
        (args.data_parallel != 1,
         "--data-parallel > 1 needs torch.distributed "
         "(ROADMAP queue: 'Real torch.distributed halo')"),
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

    sem = box_mesh(tuple(args.elements), p=args.order)
    pg = partition_mesh(sem, tuple(args.ranks))
    cfg = GNNConfig.small() if args.model == "small" else GNNConfig.large()
    print(f"mesh: {sem.n_elem} elems p={args.order} ({sem.n_nodes} nodes); "
          f"R=1 on {args.device}; backend={args.mp_backend}; "
          f"rollout K={args.rollout_steps}")
    tcfg = TrainConfig(n_steps=args.steps, batch=args.batch, lr=args.lr,
                       halo_mode=args.halo, ckpt_dir=args.ckpt,
                       ckpt_every=args.ckpt_every,
                       plan=NMPPlan(backend=args.mp_backend),
                       rollout_steps=args.rollout_steps,
                       pushforward_noise=args.pushforward_noise,
                       partitioner=args.partitioner)
    hist = train_consistent_gnn(pg, sem, cfg, tcfg, device=args.device)
    print(f"loss {hist['losses'][0]:.6f} -> {hist['losses'][-1]:.6f} "
          f"({len(hist['losses'])} steps, {hist['straggler_events']} "
          "straggler events)")
    return hist


if __name__ == "__main__":
    main()
