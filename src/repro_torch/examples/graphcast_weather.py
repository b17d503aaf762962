"""GraphCast weather mode: icosahedral multimesh + grid2mesh/mesh2grid
(port of ``examples/graphcast_weather.py``).

Builds the encoder-processor-decoder weather pipeline on a reduced
icosphere (refinement 3; the full config uses refinement 6 + 0.25 deg grid)
and runs one prediction step over synthetic atmospheric state, through the
fused NMP backend (kernel 1 on the card) unless ``--mp-backend xla``.

    PYTHONPATH=src python -m repro_torch.examples.graphcast_weather            # the card
    PYTHONPATH=src python -m repro_torch.examples.graphcast_weather --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
from repro_torch.core.halo import NONE, HaloSpec
from repro_torch.core.partition import partition_graph
from repro_torch.models.gnn_zoo.graphcast import (
    GraphCastConfig, graphcast_forward, init_graphcast, weather_graph, weather_inputs,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mp-backend", default=FUSED, choices=(FUSED, XLA))
    ap.add_argument("--refinement", type=int, default=3)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("graphcast_weather: no CUDA device (pass --device cpu)")
    refinement = args.refinement
    n_vars = 16                                 # reduced from 227
    edges, xyz, n_grid, counts = weather_graph(refinement, 19, 36, k=3)  # grid reduced from 721x1440
    n_total = xyz.shape[0]
    print(f"icosphere r={refinement}: {n_total - n_grid} mesh nodes, "
          f"{counts['multimesh'] // 2} multimesh edges; grid {n_grid} "
          f"nodes, {counts['grid2mesh']} grid2mesh edges")

    # unified graph: [grid nodes | mesh nodes] with 3 edge sets
    plan = NMPPlan(halo=HaloSpec(mode=NONE), backend=args.mp_backend)
    pg = partition_graph(n_total, edges, 1)
    graph = ShardedGraph.build(pg, xyz, plan, device=dev).rank(0)

    cfg = GraphCastConfig(in_dim=n_vars + 3, hidden=64, n_layers=4,
                          out_dim=n_vars, mlp_hidden_layers=1)
    params = init_graphcast(torch.Generator().manual_seed(0), cfg, device=dev)

    rng = np.random.default_rng(0)
    state = rng.normal(size=(n_grid, n_vars)).astype(np.float32)
    x, ef = weather_inputs(state, xyz, n_grid, pg.n_pad, pg.edge_src[0], pg.edge_dst[0],
                           pg.edge_mask[0], cfg.edge_in)
    with torch.no_grad():
        out = graphcast_forward(params, torch.from_numpy(x).to(dev),
                                torch.from_numpy(ef).to(dev), graph, plan, cfg)
    pred = out.cpu().numpy()[:n_grid]
    print(f"predicted next-state grid field: {pred.shape}, finite: "
          f"{np.isfinite(pred).all()}")
    assert np.isfinite(pred).all()
    print("OK")


if __name__ == "__main__":
    main()
