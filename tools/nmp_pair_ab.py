"""Kernels 1 and 2's tuned entries of two source trees, side by side on one
CUDA card: the fp32 pair (``nmp_fwd``, ``nmp_bwd``) and the bf16 pair, at
the paper's large config (H=32, 5 hidden layers) on the serving mesh
``box_mesh((16, 16, 8), p=7)``, the same inputs for every tree (seed 11, as
``chip_smoke.py``'s phase 2 makes them).

Each ``--tree`` runs in a process of its own (its ``src`` first on the
path, its own ``build/kernels``), in the order given, so ``--tree A --tree
B --tree B --tree A`` times two trees in turns.  Per tree one JSON line:
the card, each call's CUDA-event ms (median of 5 rounds of ``--iters``
calls) and a SHA-256 of its outputs' bytes, which says whether two trees
give the same bits.  From the repository root, the parent unpacked under
``build/parent`` (``git archive <parent> | tar -x -C build/parent``):

    python3 tools/nmp_pair_ab.py --tree build/parent --tree . --tree . --tree build/parent
"""
import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: Path, iters: int):
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.core.gnn import GNNConfig, init_gnn
    from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh
    from repro_torch.kernels.segment_agg import ops as sa
    assert Path(sa.__file__).resolve().is_relative_to(tree.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sem = box_mesh((16, 16, 8), p=7)
    pg = partition_mesh(sem, (1, 1, 1))
    g = ShardedGraph.build(pg, sem.coords, NMPPlan(backend=FUSED), device=dev).rank(0)
    gen = torch.Generator().manual_seed(11)
    edge = init_gnn(gen, GNNConfig.large(), device=dev)["mp"][0]["edge"]
    x = torch.randn(pg.n_pad, 32, generator=gen).to(dev)
    e = torch.randn(pg.e_pad, 32, generator=gen).to(dev)
    g_enew = torch.randn(pg.e_pad, 32, generator=gen).to(dev)
    g_agg = torch.randn(pg.n_pad, 32, generator=gen).to(dev)
    lay = (g["seg_perm"], g["seg_src"], g["seg_rowptr"])
    src_lay = (g["seg_src_slots"], g["seg_src_rowptr"])
    rest = (g["edge_mask"], g["edge_inv_mult"])
    calls = {}
    for prec in ("fp32", "bf16"):
        calls[f"fwd_{prec}"] = (lambda prec=prec: sa.fused_nmp_edge_agg(
            x, e, edge, *lay, *rest, precision=prec))
        calls[f"bwd_{prec}"] = (lambda prec=prec: sa.fused_nmp_edge_agg_bwd(
            x, e, edge, *lay, *src_lay, *rest, g_enew, g_agg, precision=prec))
    out = {}
    for name, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in got:
            digest.update(t.detach().cpu().numpy().tobytes())
        del got
        rounds = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            rounds.append(start.elapsed_time(end) / iters)
        out[name] = {"ms": sorted(rounds)[2], "sha256": digest.hexdigest()[:16]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"tree": str(tree), "card": smi.strip(), "calls": out}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--worker", default=None)
    args = ap.parse_args()
    if args.worker is not None:
        return worker(Path(args.worker), args.iters)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    for tree in args.tree or ["."]:
        rc = subprocess.run([sys.executable, __file__, "--worker", str(Path(tree).resolve()),
                             "--iters", str(args.iters)], cwd=ROOT).returncode
        if rc:
            raise SystemExit(f"tree {tree}: worker exit {rc}")


if __name__ == "__main__":
    main()
