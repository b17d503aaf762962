"""Where a block's cycles go in the bf16 NMP pair's edge passes
(``csrc/nmp_bf16.cu``), on one CUDA card.

Copies ``src/repro_torch`` into ``build/nmp_bf16_phases/``, defines
``NMP_BF16_PHASES`` at the top of the copy's ``csrc/nmp_bf16.cu`` (which
turns its ``PHASE`` probe points into ``clock64()`` sums per warp and
phase, read back through a C entry), builds that copy, runs one forward
and one backward of the paper's large config (H=32, 5 hidden layers) on
``box_mesh((16, 16, 8), p=7)`` in bf16 and prints one JSON line: the card,
ptxas's registers and spills of the two H=32 edge kernels, per role (the
producer warps and the consumer warps of each kernel) the
kcycles per warp in each phase (a phase that ends at a barrier includes
the wait for the slowest warp), the tiles per block, and the instrumented
calls' CUDA-event times.  The probes change the kernels' code, so their
times are not the kernels': compare phases, not totals.  ``--set NAME=N``
(repeatable) builds the copy with the source's ``NAME = <int>`` constant
set to N (``kFwdGroups``, ``kFwdProducers``, ``kBwdProducers``, ...: a
variant of the design), and the line names the variant.  From the
repository root:

    python3 tools/nmp_bf16_phases.py [--set kFwdProducers=256 --set kFwdGroups=1]
"""
import argparse
import ctypes
import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "nmp_bf16_phases"

PHASES = {
    "fwd producer": ("wait for a free stage", "fields and destinations", "copies issued"),
    "fwd consumer": ("wait for a landed stage", "the MLP, LayerNorm and e'", "the barrier",
                     "the per-node sums"),
    "bwd producer": ("wait for a free stage", "fields and destinations", "copies issued"),
    "bwd consumer": ("wait for a landed stage", "the forward recompute",
                     "g_h, the LayerNorm's backward, a barrier", "hidden weight gradients",
                     "hidden input gradients", "their barriers",
                     "layer 0: w0's gradient, g_e, g_x's parts",
                     "the x_dst sums and their barriers"),
}


def variant(src: str, sets) -> str:
    for item in sets:
        name, value = item.split("=")
        src, n = re.subn(rf"\b({name} = )\d+", rf"\g<1>{int(value)}", src)
        if n != 1:
            raise SystemExit(f"csrc/nmp_bf16.cu: constant {name} found {n} times, not once")
    return "#define NMP_BF16_PHASES 1\n" + src


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", action="append", default=[], metavar="NAME=N")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / "src" / "repro_torch" / "csrc" / "nmp_bf16.cu"
    cu.write_text(variant(cu.read_text(), args.set))
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
    report = build.build(["nmp_bf16"]).get("nmp_bf16", "")
    ptxas = {}
    for kind in ("fwd", "bwd"):
        lines = report.splitlines()
        at = next(i for i, ln in enumerate(lines)
                  if "Function properties for" in ln and f"nmp_bf16_{kind}_kernelILi32EE" in ln)
        used = next(ln for ln in lines[at:] if "Used " in ln)
        ptxas[kind] = used.split("Used ")[1].split(",")[0] + ", " + lines[at + 1].strip()
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
    rest = (g["edge_mask"], g["edge_inv_mult"])
    calls = {
        "fwd": lambda: sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest, precision="bf16"),
        "bwd": lambda: sa.fused_nmp_edge_agg_bwd(
            x, e, edge, *lay, g["seg_src_slots"], g["seg_src_rowptr"], *rest, g_enew, g_agg,
            precision="bf16")}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    lib = ctypes.CDLL(str(build.lib_path("nmp_bf16")))
    lib.nmp_phase_zero()
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 36)()
    lib.nmp_phase_read(buf)
    ms = {}
    for kind, fn in calls.items():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        end.record()
        end.synchronize()
        ms[kind] = start.elapsed_time(end) / 5
    grid = sa.fwd_launch_plan(32, 5, lay[0].numel(), "bf16")["grid"]
    tiles = -(-int(g["seg_rowptr"][-1]) // 128)
    out = {}
    for role, (name, phases) in enumerate(PHASES.items()):
        warps = buf[role * 9 + 8]
        out[name] = {p: round(buf[role * 9 + i] / max(warps, 1) / 1e3, 1)
                     for i, p in enumerate(phases)}
        out[name]["warps"] = warps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": smi.strip(), "variant": args.set, "ptxas_h32": ptxas,
                      "kcycles_per_warp": out,
                      "tiles_per_block": round(tiles / grid, 1),
                      "instrumented_ms": ms}))


if __name__ == "__main__":
    main()
