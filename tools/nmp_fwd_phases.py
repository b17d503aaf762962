"""Where a block's time goes in the fused NMP forward's edge pass, on one
CUDA card.

Copies ``src/repro_torch`` into ``build/nmp_fwd_phases/``, inserts
``clock64()`` reads between the edge pass's phases of each tile (stage:
the node walk and the copies issued; the wait for the copies; the MLP and
e' writes; the per-node sums), summed per warp into a ``__device__``
array that a C entry reads back, builds that copy, runs one forward of the
paper's large config (H=32, 5 hidden layers) on ``box_mesh((16, 16, 8),
p=7)`` and prints one JSON line: the card, kcycles per warp in each phase
(each phase ends at its group barrier, so a phase includes the wait for
the group's slowest warp) and the instrumented forward's CUDA-event time.
The counters change the kernel's code, so its time is not the kernel's:
compare phases, not totals.  From the repository root:

    python3 tools/nmp_fwd_phases.py
"""
import ctypes
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "nmp_fwd_phases"

PHASES = ("stage: node walk", "stage: copies issued", "wait for copies", "MLP and e'",
          "per-node sums")
# (text of csrc/nmp_fwd.cu, what replaces it), each text found once
PROBES = [
    ('#include "nmp_tf32.cuh"\n',
     '#include "nmp_tf32.cuh"\n'
     "__device__ unsigned long long g_phase[8];\n"
     'extern "C" int nmp_phase_read(unsigned long long* out) {\n'
     "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n"
     'extern "C" int nmp_phase_zero() {\n'
     "  unsigned long long z[8] = {};\n"
     "  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n}\n"),
    ("  prefetch_b();\n  for (int tile = first_tile;",
     "  unsigned long long ph[5] = {};\n  prefetch_b();\n  for (int tile = first_tile;"),
    ("    const int n0 = max(lo - 1, 0);          // the node walk's first node\n",
     "    const int n0 = max(lo - 1, 0);\n    unsigned long long t0 = clock64(), t1;\n"),
    ("    }\n    group_sync(grp);\n    if (tid < kRows) {\n",
     "    }\n    group_sync(grp);\n    t1 = clock64(); ph[0] += t1 - t0; t0 = t1;\n"
     "    if (tid < kRows) {\n"),
    ("    prefetch_a(tile + stride);\n",
     "    prefetch_a(tile + stride);\n    t1 = clock64(); ph[1] += t1 - t0; t0 = t1;\n"),
    ("    cp_async_wait_all();\n    group_sync(grp);\n",
     "    cp_async_wait_all();\n    group_sync(grp);\n    t1 = clock64(); ph[2] += t1 - t0; t0 = t1;\n"),
    ("    prefetch_b();\n    group_sync(grp);\n",
     "    prefetch_b();\n    group_sync(grp);\n    t1 = clock64(); ph[3] += t1 - t0; t0 = t1;\n"),
    ("      }\n    }\n    group_sync(grp);\n  }\n",
     "      }\n    }\n    group_sync(grp);\n    ph[4] += clock64() - t0;\n  }\n"
     "  if (lane == 0) {\n    for (int i = 0; i < 5; ++i) atomicAdd(&g_phase[i], ph[i]);\n"
     "    atomicAdd(&g_phase[5], 1ull);\n  }\n"),
]


def instrument(src: str) -> str:
    for old, new in PROBES:
        if src.count(old) != 1:
            raise SystemExit(f"csrc/nmp_fwd.cu changed: {old!r} not found once")
        src = src.replace(old, new)
    return src


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / "src" / "repro_torch" / "csrc" / "nmp_fwd.cu"
    cu.write_text(instrument(cu.read_text()))
    sys.path.insert(0, str(COPY / "src"))
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    build = importlib.import_module("repro_torch.kernels.build")
    sa = importlib.import_module("repro_torch.kernels.segment_agg.ops")
    from repro_torch.core.gnn import GNNConfig, init_gnn
    from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh
    assert Path(build.__file__).is_relative_to(COPY)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sem = box_mesh((16, 16, 8), p=7)
    pg = partition_mesh(sem, (1, 1, 1))
    g = ShardedGraph.build(pg, sem.coords, NMPPlan(backend=FUSED), device=dev).rank(0)
    gen = torch.Generator().manual_seed(11)
    edge = init_gnn(gen, GNNConfig.large(), device=dev)["mp"][0]["edge"]
    x = torch.randn(pg.n_pad, 32, generator=gen).to(dev)
    e = torch.randn(pg.e_pad, 32, generator=gen).to(dev)

    def fwd():
        return sa.fused_nmp_edge_agg(x, e, edge, g["seg_perm"], g["seg_src"], g["seg_rowptr"],
                                     g["edge_mask"], g["edge_inv_mult"])

    fwd()
    torch.cuda.synchronize()
    lib = ctypes.CDLL(str(build.lib_path("nmp_fwd")))
    lib.nmp_phase_zero()
    fwd()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 8)()
    lib.nmp_phase_read(buf)
    warps = buf[5]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        fwd()
    end.record()
    end.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": smi.strip(), "warps": warps,
                      "kcycles_per_warp": {k: buf[i] / warps / 1e3
                                           for i, k in enumerate(PHASES)},
                      "instrumented_ms": start.elapsed_time(end) / 10}))


if __name__ == "__main__":
    main()
