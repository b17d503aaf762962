"""How the tensor-core route of kernels 1 and 2's generic pair
(``csrc/nmp_any.cu``) sums its products, measured on one CUDA card: blocked
(each 32-k ring stage's 12 ``wgmma`` products into a fresh fragment, added
to the pass's sum in fp32: the kernel as it is) against one long ``wgmma``
accumulation over the whole of K (a copy of the tree with that one edit,
built under ``build/nmp_any_accum/``).  Per case (H, MLP hidden layers) on
the generic sweep's boxes (``chip_smoke.py``'s ``ANY_*_ELEMS``, p=7, seeded
inputs) it prints the forward's CUDA-event ms and the distance of e' and
agg from a float64 forward: relative L2, and the worst element's distance
as a share of the forward band (rtol 1e-4 / atol 1e-5; above 1 misses it),
for plain fp32 beside it.  One JSON line per tree and reading, blocked,
long, long, blocked:

    python3 tools/nmp_any_accum_ab.py          # from the repository root
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANT = ROOT / "build" / "nmp_any_accum"
# (H, hidden layers, box elements): the sweep's deep and wide cases
CASES = ((64, 7, (4, 4, 4)), (100, 7, (4, 4, 4)), (512, 1, (2, 2, 2)), (1024, 7, (2, 2, 2)))
# the blocked sum, and its replacement by one long accumulation in acc
BLOCKED = ("""      float part[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) part[i] = 0.f;
      fence_regs(part);""", """#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
""")
LONG = ("""      float (&part)[64] = acc;
      fence_regs(part);""", "")


def make_variant():
    if VARIANT.exists():
        shutil.rmtree(VARIANT)
    shutil.copytree(ROOT / "src" / "repro_torch", VARIANT / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = VARIANT / "src" / "repro_torch" / "csrc" / "nmp_any.cu"
    text = cu.read_text()
    for old, new in zip(BLOCKED, LONG):
        if text.count(old) != 1:
            raise SystemExit("the blocked sum's anchors moved in csrc/nmp_any.cu: update BLOCKED")
        text = text.replace(old, new)
    cu.write_text(text)


def measure(label):
    import torch
    from repro_torch.core.gnn import GNNConfig, init_gnn
    from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh
    from repro_torch.kernels.segment_agg import ops as sa
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def cuda_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def reading(got, exact):
        d = (got.double() - exact).abs()
        share = float((d / (1e-5 + 1e-4 * exact.abs())).max())
        return dict(rel_l2=float(d.norm() / exact.norm()), worst_band_share=share)

    out = {"label": label, "device": torch.cuda.get_device_name(0), "cases": []}
    graphs = {}
    for H, lp, elems in CASES:
        if elems not in graphs:
            sem = box_mesh(elems, p=7)
            pg = partition_mesh(sem, (1, 1, 1))
            graphs[elems] = (pg, ShardedGraph.build(pg, sem.coords, NMPPlan(backend=FUSED),
                                                    device=dev).rank(0))
        pg, g = graphs[elems]
        gen = torch.Generator().manual_seed(H + lp)
        edge = init_gnn(gen, GNNConfig(hidden=H, n_mp_layers=1, mlp_hidden_layers=lp),
                        device=dev)["mp"][0]["edge"]
        for layer in edge["layers"]:
            layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).to(dev)
        x = torch.randn(pg.n_pad, H, generator=gen).to(dev)
        e = torch.randn(pg.e_pad, H, generator=gen).to(dev)
        rest = (g["seg_perm"], g["seg_src"], g["seg_rowptr"], g["edge_mask"], g["edge_inv_mult"])
        got = sa.fused_nmp_edge_agg(x, e, edge, *rest)
        plain = sa.fused_nmp_edge_agg_plain(x, e, edge, *rest)
        p64 = {"layers": [{k: v.double() for k, v in layer.items()} for layer in edge["layers"]],
               "ln": {k: v.double() for k, v in edge["ln"].items()}}
        exact = sa.fused_nmp_edge_agg_plain(x.double(), e.double(), p64, *rest[:3],
                                            *(t.double() for t in rest[3:]))
        case = {"H": H, "Lp": lp, "edges": int(pg.edge_mask.sum()),
                "route": sa.any_route(H, lp),
                "ms": cuda_ms(lambda: sa.fused_nmp_edge_agg(x, e, edge, *rest))}
        for name, a, b, c in zip(("e_new", "agg"), got, plain, exact):
            case[name] = {"kernel": reading(a, c), "plain": reading(b, c)}
        out["cases"].append(case)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", default=None, help="measure the tree on PYTHONPATH")
    args = ap.parse_args()
    if args.child is not None:
        return measure(args.child)
    make_variant()
    trees = {"blocked": ROOT / "src", "long": VARIANT / "src"}
    for label in ("blocked", "long", "long", "blocked"):
        subprocess.run([sys.executable, __file__, "--child", label], check=True,
                       env={**os.environ, "PYTHONPATH": str(trees[label])})


if __name__ == "__main__":
    main()
