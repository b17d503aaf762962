"""Time the dst-aligned edge MLP + aggregate kernel (``edge_mlp_agg``) alone
on one CUDA card, at full width: the serving mesh ``box_mesh((16, 16, 8),
p=7)``'s 4,315,696 directed edges in ``dst_aligned_layout`` tiles (block_n
128, block_e 256), Fin 96, Hh = H = 32, feats fp32 and bf16, weights drawn
with seed 17.  Prints one JSON line: the card, and per dtype the CUDA-event
time of each reading (20 launches each).  It imports ``repro_torch`` from
``PYTHONPATH``, so the same script times two trees, or a tree and a copy
with one edit, in one call (A, B, B, A):

    PYTHONPATH=<tree>/src python3 tools/edge_mlp_agg_ab.py --label <name>
"""
import argparse
import json
import subprocess

import torch

from repro_torch.core.mesh_gen import box_mesh, mesh_graph_edges, undirected_to_directed
from repro_torch.kernels.segment_agg import ops as sa


def cuda_ms(fn, iters=20, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--readings", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sem = box_mesh((16, 16, 8), p=7)
    dst = undirected_to_directed(mesh_graph_edges(sem))[:, 1]
    layout = sa.dst_aligned_layout(dst, sem.n_nodes, 128, 256)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    feats = torch.randn(len(dst), 96, generator=gen, device=dev)
    wgt = torch.rand(len(dst), generator=gen, device=dev) * 0.5 + 0.5
    mlp = (torch.randn(96, 32, generator=gen, device=dev) * 96 ** -0.5,
           torch.randn(32, generator=gen, device=dev) * 0.1,
           torch.randn(32, 32, generator=gen, device=dev) * 32 ** -0.5,
           torch.randn(32, generator=gen, device=dev) * 0.1)
    perm = torch.from_numpy(layout["perm"]).to(dev)
    valid, safe = perm >= 0, perm.clamp(min=0)
    rest = (torch.from_numpy(layout["dstl"]).to(dev), torch.where(valid, wgt[safe], 0))
    tiles = {"fp32": torch.where(valid[..., None], feats[safe], 0)}
    tiles["bf16"] = tiles["fp32"].to(torch.bfloat16)
    kw = dict(n_node_blocks=layout["n_node_blocks"], block_n=128, block_e=256)
    ms = {k: [] for k in tiles}
    for _ in range(args.readings):
        for k, f in tiles.items():
            ms[k].append(cuda_ms(lambda: sa.edge_mlp_agg(f, *rest, *mlp, **kw)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "edges": len(dst),
                      "ms": ms}))


if __name__ == "__main__":
    main()
