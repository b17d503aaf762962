"""Device time of one NMP layer under the overlap schedule against the
blocking one, by part, on one CUDA card: ``chip_smoke.py``'s
``overlap_breakdown`` alone, without the rest of the script.

Builds rank 0's graph of ``box_mesh((16, 16, 8), p=7)`` split (2, 2, 1)
(the serving split of ``chip_smoke.py`` phase 4b) under the fused overlap
plan with the packed neighbor exchange, draws the paper's large config
from seed 0, and prints the breakdown ``--repeats`` times (kernel 1 on the
full layout and on each side's, the edge join, the aggregate add, both
layers; device ms per call, the calls queued behind a spin kernel, beside
ms per call issued back to back).  It imports ``repro_torch`` from
``PYTHONPATH``, so one call can time two trees (parent, change, change,
parent):

    PYTHONPATH=<tree>/src python3 tools/overlap_breakdown.py --repeats 2
"""
import argparse
import sys
from pathlib import Path

import torch

# repro_torch first, from PYTHONPATH: chip_smoke puts its own tree's src
# on the path, which must not decide the tree timed
import repro_torch
from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
from repro_torch.core.halo import NEIGHBOR
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.launch import serve

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = chip_smoke.smi_line()
    print(f"repro_torch from {Path(repro_torch.__file__).parent}", flush=True)
    sem = box_mesh(chip_smoke.SERVE_ELEMS, p=chip_smoke.ORDER)
    pg = partition_mesh(sem, chip_smoke.SERVE_GRID)
    params = init_gnn(torch.Generator().manual_seed(0), GNNConfig.large(), device="cuda")
    plan = NMPPlan.build(pg, NEIGHBOR, packed=True, backend=FUSED, schedule="overlap")
    g = ShardedGraph.build(pg, sem.coords, plan, device="cuda", rank=0)
    for _ in range(args.repeats):
        chip_smoke.overlap_breakdown(params, g, plan, pg, serve.snapshot(sem, 0), smi)


if __name__ == "__main__":
    main()
