"""Time the torch port's GNN training step, AdamW apart, on one CUDA card.

Runs the training loop's own pieces (``train.loop._build_execution`` and
``_init_state``) for the paper's large config on ``box_mesh((16, 16, 8),
p=7)`` (727,833 nodes), fused backend, R=1, batch 1, lr 1e-3, from params
drawn with seed 0, and prints one JSON line: the card, the losses, and per
step the gradient and the AdamW update by CUDA events.  It imports
``repro_torch`` from ``PYTHONPATH``, so the same script times two trees in
one call (parent, change, change, parent):

    PYTHONPATH=<tree>/src python3 tools/gnn_train_step_ab.py --label <name>
"""
import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.graph_state import FUSED, NMPPlan
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.train import loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sem = box_mesh((16, 16, 8), p=7)
    pg = partition_mesh(sem, (1, 1, 1))
    cfg = GNNConfig.large()
    tcfg = loop.TrainConfig(n_steps=args.steps, batch=1, lr=1e-3, halo_mode="none",
                            plan=NMPPlan(backend=FUSED))
    ex = loop._build_execution(pg, sem, cfg, tcfg, "cuda")
    start = init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    state = loop._init_state(cfg, tcfg, ex.opt_cfg, params=start, device="cuda")
    params, opt = state["params"], state["opt"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    losses, grad_ms, adamw_ms = [], [], []
    for step in range(args.steps):
        batch = ex.batch_for_step(step)
        torch.cuda.synchronize()
        ev[0].record()
        loss, grads = ex.grad_for_batch(params, step, batch)
        ev[1].record()
        params, opt, _ = ex.update(params, opt, grads)
        ev[2].record()
        torch.cuda.synchronize()
        del grads
        losses.append(float(loss))
        grad_ms.append(ev[0].elapsed_time(ev[1]))
        adamw_ms.append(ev[1].elapsed_time(ev[2]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "label": args.label, "card": smi, "losses": losses,
        "grad_ms": grad_ms, "adamw_ms": adamw_ms,
        "adamw_ms_median_after_step0": float(np.median(adamw_ms[1:])),
        "grad_ms_median_after_step0": float(np.median(grad_ms[1:])),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))


if __name__ == "__main__":
    main()
