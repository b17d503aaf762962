"""GraphCast [arXiv:2212.12794]: encoder-processor-decoder interaction-net
GNN, port of ``repro.models.gnn_zoo.graphcast``.

Two operating modes:

* generic-graph mode: node-feature encoder MLP -> ``n_layers``
  interaction-network processor layers on the given graph (each is exactly
  the paper's consistent NMP layer, ``core/consistent_mp.py::nmp_layer``:
  edge MLP, 1/d_ij-scaled aggregation, halo sync, node MLP, residual) ->
  decoder MLP.  On a fused plan every processor layer runs kernel 1 (and
  kernel 2 in a gradient): at GraphCast's d512 the generic-width entries of
  ``csrc/nmp_any.cu``.
* weather mode (``repro_torch.examples.graphcast_weather``): grid2mesh /
  multimesh / mesh2grid edge sets over an icosahedral refinement, built by
  :func:`icosahedral_mesh`, :func:`latlon_grid` and :func:`grid2mesh_edges`
  (numpy; the same arrays as the reference's).

Processor parameters are a list with one NMP layer's tree per layer, where
the reference stacks them along a leading axis for its scan
(``repro_torch/convert.py``'s ``graphcast_params_from_jax`` /
``graphcast_params_to_jax`` map one to the other).  ``remat`` recomputes
each layer (``remat_segment > 1``: each segment of that many layers) in the
backward through ``torch.utils.checkpoint``; ``act_dtype`` is the dtype of
the carry between layers (the reference's ``astype``), each layer computing
in fp32 on the carried values as JAX promotes them.  ``edge_parallel_axes
= ("model",)`` shards each rank's edges over the mesh's model axis
(``core/consistent_mp.py::edge_parallel_of``); over R > 1 ranks the
caller passes each level's halo exchange as ``sync_fns``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import nn
from repro_torch.core.consistent_mp import (
    edge_parallel_of, init_nmp_layer, multilevel_vcycle, nmp_layer)
from repro_torch.core.gnn import init_coarse_levels
from repro_torch.core.graph_state import NMPPlan, as_graph

@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    in_dim: int = 227           # n_vars (weather); overridden by shape d_feat
    hidden: int = 512
    n_layers: int = 16
    out_dim: int = 227
    mlp_hidden_layers: int = 1
    edge_in: int = 4            # generic geometric edge feats
    name: str = "graphcast"
    # --- perf knobs ---
    remat: bool = False             # recompute processor layers in backward
    act_dtype: torch.dtype = torch.float32   # bf16 halves activation carries
    edge_parallel_axes: tuple = ()   # 2nd-level edge sharding (sum over the edge group)
    remat_segment: int = 1           # sqrt(L) checkpointing: layers per segment
    # --- multilevel (coarse-grid) processor (core/coarsen.py) ---
    n_levels: int = 1               # >1 appends a consistent V-cycle after the layers
    coarse_mp_layers: int = 2       # NMP layers smoothing each coarse level
    coarse_edge_in: int = 4         # coarse static edge feats (dist vec + mag)


def init_graphcast(gen: torch.Generator, cfg: GraphCastConfig, device="cuda") -> nn.Params:
    """Random parameters in the reference's tree layout, ``proc`` a list of
    ``cfg.n_layers`` NMP layers, drawn from ``gen`` (a CPU
    ``torch.Generator``) and placed on ``device``."""
    h = cfg.hidden
    params = {
        "node_enc": nn.init_mlp(gen, cfg.in_dim, [h], h, device),
        "edge_enc": nn.init_mlp(gen, cfg.edge_in, [h], h, device),
        "proc": [init_nmp_layer(gen, h, cfg.mlp_hidden_layers, device)
                 for _ in range(cfg.n_layers)],
        "node_dec": nn.init_mlp(gen, h, [h], cfg.out_dim, device, final_layernorm=False),
    }
    if cfg.n_levels > 1:
        params["coarse"] = init_coarse_levels(
            gen, h, cfg.mlp_hidden_layers, cfg.n_levels, cfg.coarse_mp_layers,
            cfg.coarse_edge_in, device)
    return params


def graphcast_forward(params: nn.Params, x: torch.Tensor, edge_feats: torch.Tensor,
                      graph, plan: NMPPlan, cfg: GraphCastConfig,
                      sync_fns=None, mesh=None) -> torch.Tensor:
    """x: [N_pad, in_dim]; edge_feats: [E_pad, edge_in] -> [N_pad, out_dim].

    ``graph`` is the rank-local ShardedGraph (built with ``plan``, so a
    fused plan finds its layouts); ``plan`` the NMP execution policy.
    ``sync_fns`` holds each level's halo exchange (``core/distributed.py::
    halo_fns``), as ``core/gnn.py::gnn_forward`` takes them; None on one
    rank.  With ``cfg.n_levels > 1`` the processor acts as the fine
    pre-smoother and the consistent multilevel V-cycle runs before the
    decoder; ``graph`` must then carry the coarse chain
    (``ShardedGraph.build(..., hierarchy=...)``).  With
    ``cfg.edge_parallel_axes = ("model",)`` ``graph`` and ``edge_feats``
    hold this process's model shard of the rank's edges
    (``core/distributed.py::local_graph_of``) and every processor layer sums
    its partial aggregate over ``mesh``'s edge group
    (``core/consistent_mp.py::edge_parallel_of``, summed in the carry's
    dtype)."""
    edge_parallel = edge_parallel_of(cfg.edge_parallel_axes, mesh, cfg.act_dtype)
    graph = as_graph(graph)
    lvl0 = graph.levels[0]
    syncs = sync_fns or (None,) * graph.n_levels
    # the layers compute in fp32 on a narrower carry (JAX promotes bf16 with
    # the fp32 weights), in float64 on a float64 one
    act = cfg.act_dtype
    f32 = torch.promote_types(act, torch.float32)
    mask = lvl0["node_mask"][:, None]
    h = (nn.mlp(params["node_enc"], x) * mask).to(act)
    e = (nn.mlp(params["edge_enc"], edge_feats) * lvl0["edge_mask"][:, None]).to(act)

    def body(hc, ec, p_l):
        hn, en = nmp_layer(p_l, hc.to(f32), ec.to(f32), lvl0, plan, sync_fn=syncs[0],
                           edge_parallel_axes=edge_parallel)
        return hn.to(act), en.to(act)

    def run(hc, ec, layers):
        for p_l in layers:
            hc, ec = body(hc, ec, p_l)
        return hc, ec

    layers, seg = params["proc"], cfg.remat_segment
    if cfg.remat and seg > 1:
        # sqrt(L) checkpointing: only every seg-th layer boundary is saved;
        # inner layers recompute during the segment's backward
        if len(layers) % seg:
            raise ValueError(f"remat_segment={seg} does not divide the {len(layers)} "
                             "processor layers")
        for i in range(0, len(layers), seg):
            h, e = checkpoint(run, h, e, layers[i:i + seg], use_reentrant=False)
    elif cfg.remat:
        for p_l in layers:
            h, e = checkpoint(body, h, e, p_l, use_reentrant=False)
    else:
        h, e = run(h, e, layers)
    if "coarse" in params:
        h = multilevel_vcycle(params["coarse"], h.to(f32), graph, plan, syncs).to(act)
    return nn.mlp(params["node_dec"], h.to(f32)) * mask


# ---------------------------------------------------------------------------
# icosahedral multimesh (weather mode)
# ---------------------------------------------------------------------------

def icosahedral_mesh(refinements: int) -> Tuple[np.ndarray, np.ndarray]:
    """Refined icosahedron: (vertices [V,3] unit sphere, multimesh edges [E,2]).

    The multimesh contains the union of edge sets at every refinement level
    (GraphCast's long+short range message passing)."""
    phi = (1 + 5 ** 0.5) / 2
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    all_edges = set()

    def add_edges(fs):
        for f in fs:
            for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
                all_edges.add((min(a, b), max(a, b)))

    add_edges(faces)
    vlist = [v for v in verts]
    for _ in range(refinements):
        cache = {}
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                vlist.append(m)
                cache[key] = len(vlist) - 1
            return cache[key]

        for f in faces:
            ab, bc, ca = midpoint(f[0], f[1]), midpoint(f[1], f[2]), midpoint(f[2], f[0])
            new_faces += [[f[0], ab, ca], [ab, f[1], bc], [ca, bc, f[2]],
                          [ab, bc, ca]]
        faces = np.array(new_faces)
        add_edges(faces)
    verts = np.stack(vlist)
    edges = np.array(sorted(all_edges), dtype=np.int64)
    return verts, edges


def latlon_grid(n_lat: int, n_lon: int) -> np.ndarray:
    """[n_lat*n_lon, 3] unit-sphere points of a regular lat-lon grid."""
    lats = np.linspace(-np.pi / 2, np.pi / 2, n_lat)
    lons = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    lat, lon = np.meshgrid(lats, lons, indexing="ij")
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)], axis=-1).reshape(-1, 3)


def grid2mesh_edges(grid_xyz: np.ndarray, mesh_xyz: np.ndarray, k: int = 4) -> np.ndarray:
    """Connect each grid point to its k nearest mesh vertices ([E,2]: grid->mesh)."""
    # chunked brute-force kNN (host-side)
    out = []
    for i0 in range(0, grid_xyz.shape[0], 4096):
        chunk = grid_xyz[i0:i0 + 4096]
        d = ((chunk[:, None] - mesh_xyz[None]) ** 2).sum(-1)
        nn_idx = np.argsort(d, axis=1)[:, :k]
        gi = np.repeat(np.arange(i0, i0 + chunk.shape[0]), k)
        out.append(np.stack([gi, nn_idx.reshape(-1)], axis=-1))
    return np.concatenate(out)


def weather_graph(refinement: int, n_lat: int, n_lon: int, k: int = 3):
    """The weather pipeline's unified graph, as the reference's example
    builds it: nodes [grid | mesh], directed edges grid -> mesh (each grid
    point to its k nearest mesh vertices), the multimesh both ways, and
    mesh -> grid.  Returns (edges [E, 2], xyz [n_grid + n_mesh, 3],
    n_grid, counts {grid2mesh, multimesh, mesh2grid})."""
    mesh_xyz, mesh_edges = icosahedral_mesh(refinement)
    grid_xyz = latlon_grid(n_lat, n_lon)
    g2m = grid2mesh_edges(grid_xyz, mesh_xyz, k=k)
    n_grid = grid_xyz.shape[0]
    multimesh = np.concatenate([mesh_edges, mesh_edges[:, ::-1]]) + n_grid
    edges = np.concatenate([
        np.stack([g2m[:, 0], g2m[:, 1] + n_grid], -1),
        multimesh,
        np.stack([g2m[:, 1] + n_grid, g2m[:, 0]], -1),
    ])
    xyz = np.concatenate([grid_xyz, mesh_xyz])
    counts = dict(grid2mesh=int(g2m.shape[0]), multimesh=int(multimesh.shape[0]),
                  mesh2grid=int(g2m.shape[0]))
    return edges, xyz, n_grid, counts


def weather_edge_feats(xyz: np.ndarray, edge_src: np.ndarray, edge_dst: np.ndarray,
                       edge_mask: np.ndarray, edge_in: int = 4) -> np.ndarray:
    """The reference example's edge features [E_pad, edge_in] (numpy
    float32): the relative position dst - src and its length, zero on
    padding edges."""
    n_total = xyz.shape[0]
    xyz = xyz.astype(np.float32)
    ef = np.zeros((edge_src.shape[0], edge_in), np.float32)
    rel = (xyz[np.clip(edge_dst, 0, n_total - 1) % n_total]
           - xyz[np.clip(edge_src, 0, n_total - 1) % n_total])
    ef[:, :3] = rel * edge_mask[:, None]
    ef[:, 3] = np.linalg.norm(rel, axis=-1) * edge_mask
    return ef


def weather_inputs(state: np.ndarray, xyz: np.ndarray, n_grid: int, n_pad: int,
                   edge_src: np.ndarray, edge_dst: np.ndarray, edge_mask: np.ndarray,
                   edge_in: int = 4):
    """The reference example's model inputs (numpy float32): node features
    [n_pad, n_vars + 3] (the grid's state, every node's xyz) and the edge
    features of :func:`weather_edge_feats`."""
    n_total, n_vars = xyz.shape[0], state.shape[1]
    x = np.zeros((n_pad, n_vars + 3), np.float32)
    x[:n_grid, :n_vars] = state
    x[:n_total, n_vars:] = xyz.astype(np.float32)
    return x, weather_edge_feats(xyz, edge_src, edge_dst, edge_mask, edge_in)
