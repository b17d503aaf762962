"""Where the tensor-core route of kernels 1 and 2's generic pair
(``csrc/nmp_any.cu``) spends its time, measured on one CUDA card: the
kernel as it is against copies of the tree with one part of its product
pipeline taken out (built under ``build/nmp_any_probe/<variant>/``), each
timed by CUDA events on the same inputs (their outputs are wrong by
design; only the times are read):

  full        the kernel as it is
  no_mma      no wgmma at all (the ring, the splits and the sums still run)
  sync_only   no wgmma and no copies: the ring's mbarriers and the sums only
  sync_no_ln  sync_only without the forward's LayerNorm pass (e' not written)
  sync_no_agg sync_only without the forward's aggregate
  sync_no_epi sync_only with empty layer epilogues (no slab stores)
  no_turns    the consumer warpgroups issue their products in no fixed turns
  ks64_ring2  ring stages of 64 k, 2 of them (the same shared memory)
  ks16_ring8  ring stages of 16 k, 8 of them

Cases: the per-node pass (``node_dst_product``, the rows kernel alone) on
131,072 random rows at H=512, and the forward (``fused_nmp_edge_agg``) at
H=512, one hidden layer, on the generic sweep's (4, 4, 4) box at p=7
(141,288 edges).  One JSON line per variant and reading (full first and
last):

    python3 tools/nmp_any_tc_probe.py [--variants no_mma ...]   # from the repository root
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBE = ROOT / "build" / "nmp_any_probe"
HI_HI = ("#pragma unroll\n      for (int kk = 0; kk < kKSteps; ++kk) wgmma_tf32(part, ah[kk], "
         "make_desc(bh + kk * 4096, 2048, 128, 0));")
CROSS = """#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        wgmma_tf32(part, ah[kk], make_desc(bl + kk * 4096, 2048, 128, 0));
        wgmma_tf32(part, al[kk], make_desc(bh + kk * 4096, 2048, 128, 0));
      }"""
ROWS = ("        cp_async16_zfill(a0 + (r * kSAS + 4 * c) * 4, p != nullptr ? p : wpack, "
        "p != nullptr ? 16 : 0);")
WEIGHTS = """        mbar_expect_tx(full, kStageB);
        bulk_load(rg.b + s * kStageB, wpack + ((size_t)nc * kst_n + kst) * 2 * kBPart, kStageB,
                  full);"""
TURN_WAIT = """      if (wg == 0) {
        if (rg.it > 0) asm volatile("bar.sync 4, 256;\\n" ::: "memory");
      } else {
        asm volatile("bar.sync 3, 256;\\n" ::: "memory");
      }"""
TURN_GIVE = """      if (wg == 0)
        asm volatile("bar.arrive 3, 256;\\n" ::: "memory");
      else
        asm volatile("bar.arrive 4, 256;\\n" ::: "memory");"""
TURN_END = """  if (threadIdx.x < 128 && rg.it > 0) asm volatile("bar.sync 4, 256;\\n" ::: "memory");"""
STAGE = ("constexpr int kKS = 32;", "constexpr int kRing = 4;")
LN = [("          ln_out_rows<%d>(z, f, p.e, p.lng, p.lnb, p.e_new, H, p.has_ln, kTM, warp, "
       "kTCWarps);" % c, "") for c in (4, 32)]
AGG = [("          agg_nodes<%d>(z, f, p.rowptr, p.agg, p.partials, tile, base, end, n0, hi, H, "
        "warp,\n%s kTCWarps);" % (c, " " * (22 if c == 4 else 23)), "") for c in (4, 32)]
EPI = ("                                       float v1) {\n  const float2 d",
       "                                           int c, float v0, float v1) {\n  v0 +=")
NO_MMA = [(CROSS, "      {}"), (HI_HI, "      {}")]
SYNC_ONLY = NO_MMA + [(ROWS, "        (void)p;"), (WEIGHTS, "        mbar_arrive(full);")]
VARIANTS = {
    "full": [],
    "no_mma": NO_MMA,
    "sync_only": SYNC_ONLY,
    "sync_no_ln": SYNC_ONLY + LN,
    "sync_no_agg": SYNC_ONLY + AGG,
    "sync_no_epi": SYNC_ONLY + [(EPI[0], EPI[0].replace("{\n", "{\n  return;\n")),
                                (EPI[1], EPI[1].replace("{\n", "{\n  return;\n"))],
    "no_turns": [(TURN_WAIT, ""), (TURN_GIVE, ""), (TURN_END, "")],
    "ks64_ring2": [(STAGE[0], "constexpr int kKS = 64;"), (STAGE[1], "constexpr int kRing = 2;")],
    "ks16_ring8": [(STAGE[0], "constexpr int kKS = 16;"), (STAGE[1], "constexpr int kRing = 8;")],
}


def make_tree(name):
    tree = PROBE / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "src" / "repro_torch", tree / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = tree / "src" / "repro_torch" / "csrc" / "nmp_any.cu"
    text = cu.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: its anchor moved in csrc/nmp_any.cu")
        text = text.replace(old, new)
    cu.write_text(text)
    return tree / "src"


def measure(label):
    import torch
    from repro_torch.core.gnn import GNNConfig, init_gnn
    from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh
    from repro_torch.kernels.segment_agg import ops as sa
    dev = torch.device("cuda")

    def cuda_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    gen = torch.Generator().manual_seed(5)
    H = 512
    x = torch.randn(131072, H, generator=gen).to(dev)
    w0 = (torch.randn(3 * H, H, generator=gen) / H ** 0.5).to(dev)
    rows_ms = cuda_ms(lambda: sa.node_dst_product(x, w0))
    sem = box_mesh((4, 4, 4), p=7)
    pg = partition_mesh(sem, (1, 1, 1))
    g = ShardedGraph.build(pg, sem.coords, NMPPlan(backend=FUSED), device=dev).rank(0)
    edge = init_gnn(gen, GNNConfig(hidden=H, n_mp_layers=1, mlp_hidden_layers=1),
                    device=dev)["mp"][0]["edge"]
    xs = torch.randn(pg.n_pad, H, generator=gen).to(dev)
    es = torch.randn(pg.e_pad, H, generator=gen).to(dev)
    rest = (g["seg_perm"], g["seg_src"], g["seg_rowptr"], g["edge_mask"], g["edge_inv_mult"])
    fwd_ms = cuda_ms(lambda: sa.fused_nmp_edge_agg(xs, es, edge, *rest), iters=5)
    print(json.dumps({"variant": label, "device": torch.cuda.get_device_name(0),
                      "rows_131072_h512_ms": rows_ms,
                      "fwd_h512_lp1_edges": int(pg.edge_mask.sum()), "fwd_ms": fwd_ms}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", default=None, help="measure the tree on PYTHONPATH")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS), choices=list(VARIANTS))
    args = ap.parse_args()
    if args.child is not None:
        return measure(args.child)
    names = ["full"] + [v for v in args.variants if v != "full"]
    trees = {name: make_tree(name) for name in names}
    # every tree's library built at once (one nvcc each), then timed in turn
    builds = [subprocess.Popen([sys.executable, "-c", "from repro_torch.kernels import build; "
                                "build.build(['nmp_any'])"],
                               env={**os.environ, "PYTHONPATH": str(tree)})
              for tree in trees.values()]
    if any(b.wait() for b in builds):
        raise SystemExit("a variant did not build")
    for name in names + ["full"]:
        subprocess.run([sys.executable, __file__, "--child", name], check=True,
                       env={**os.environ, "PYTHONPATH": str(trees[name])})


if __name__ == "__main__":
    main()
