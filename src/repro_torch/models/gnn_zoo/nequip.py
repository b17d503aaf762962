"""NequIP [arXiv:2101.03164]: O(3)-equivariant interatomic potential (port
of ``repro.models.gnn_zoo.nequip``).

Structure per interaction layer (the coupling tensors derived numerically,
``irreps.py``):
  * edge vectors -> Bessel RBF (cutoff-enveloped) + real SH up to l_max;
  * message = radial-weighted tensor product (x_src (x) SH -> hidden irreps);
  * 1/d_ij-scaled segment-sum aggregation + halo sync (consistent-MP);
  * node update: equivariant self-linear + aggregate-linear, gated
    nonlinearity; residual.
Readout: per-node scalar (site energy); total energy = consistent node sum;
forces are -grad wrt positions (autograd through SH/TP).

The knobs: ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant); ``act_dtype`` is the dtype of
the carry between layers and of the SH and RBF the layers read, each layer
computing in fp32 on those values, as JAX promotes them against the fp32
weights and CG tensors; ``edge_parallel_axes = ("model",)`` sums each
layer's partial aggregate over the mesh's edge group
(``core/consistent_mp.py::edge_parallel_of``) before the halo exchange.
Over R > 1 ranks the caller passes the exchange as ``sync_fn``
(``core/distributed.py::HaloFn``); None on one rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.consistent_mp import edge_parallel_of
from repro_torch.graph.segment import gather_rows, segment_sum
from repro_torch.models.gnn_zoo import irreps as ir


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    n_layers: int = 5
    hidden_mul: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    name: str = "nequip"
    # perf knobs (as GraphCast's)
    remat: bool = False
    act_dtype: torch.dtype = torch.float32
    edge_parallel_axes: tuple = ()

    @property
    def hidden_irreps(self) -> ir.Irreps:
        return ir.Irreps.make(
            [(self.hidden_mul, l, (-1) ** l) for l in range(self.l_max + 1)])

    @property
    def sh_irreps(self) -> ir.Irreps:
        return ir.Irreps.make([(1, l, (-1) ** l) for l in range(self.l_max + 1)])


def init_nequip(gen: torch.Generator, cfg: NequIPConfig, device="cuda"):
    """Random parameters in the reference's tree, drawn from ``gen`` (a CPU
    ``torch.Generator``) and placed on ``device``."""
    hid = cfg.hidden_irreps
    sh = cfg.sh_irreps
    scalars = ir.Irreps.scalars(cfg.hidden_mul)
    embed = ir.normal(gen, (cfg.n_species, cfg.hidden_mul), device) * cfg.hidden_mul ** -0.5
    layers = []
    for i in range(cfg.n_layers):
        in_ir = scalars if i == 0 else hid
        layers.append({
            "tp": ir.init_tp_weights(gen, in_ir, sh, hid, cfg.n_rbf, device),
            "lin_self": ir.init_linear_irreps(gen, in_ir, hid, device),
            "lin_agg": ir.init_linear_irreps(gen, hid, hid, device),
        })
    return {"embed": embed, "layers": layers,
            "readout": ir.init_linear_irreps(gen, hid, ir.Irreps.scalars(1), device)}


def edge_geometry(pos: torch.Tensor, graph, cfg) -> tuple:
    """(RBF [E, n_rbf] zero on padding edges, SH [E, sh dim]) of every
    edge's vector pos[dst] - pos[src], as the reference computes them."""
    vec = gather_rows(pos, graph["edge_dst"]) - gather_rows(pos, graph["edge_src"])
    r = torch.linalg.norm(vec + 1e-12, dim=-1)
    rbf = ir.bessel_rbf(r, cfg.n_rbf, cfg.cutoff) * graph["edge_mask"][:, None]
    sh = torch.cat([ir.sh_l(vec, l) for l in range(cfg.l_max + 1)], dim=-1)
    return rbf, sh


def compute_dtype(act: torch.dtype) -> torch.dtype:
    """The dtype a layer computes in on an ``act`` carry: fp32 (JAX
    promotes a bf16 carry against the fp32 weights), float64 on a float64
    one."""
    return torch.promote_types(act, torch.float32)


def nequip_forward(params, species: torch.Tensor, pos: torch.Tensor,
                   graph: Dict, cfg: NequIPConfig, sync_fn=None,
                   mesh=None) -> torch.Tensor:
    """species [N_pad] int, pos [N_pad, 3] -> per-node site energy [N_pad].

    ``graph``: the rank-local graph (its model shard's edges under
    ``edge_parallel_axes``); ``sync_fn``: the halo exchange over the
    mesh's graph group, None on one rank; ``mesh``: the process mesh
    (the edge group of ``edge_parallel_axes``)."""
    src, dst = graph["edge_src"], graph["edge_dst"]
    hid, sh_ir = cfg.hidden_irreps, cfg.sh_irreps
    scalars = ir.Irreps.scalars(cfg.hidden_mul)
    act, f32 = cfg.act_dtype, compute_dtype(cfg.act_dtype)
    edge_parallel = edge_parallel_of(cfg.edge_parallel_axes, mesh, f32)

    rbf, sh = edge_geometry(pos, graph, cfg)
    # the layers read the SH and RBF rounded to the carry's dtype
    sh, rbf = sh.to(act).to(f32), rbf.to(act).to(f32)
    edge_w = (graph["edge_inv_mult"] * graph["edge_mask"])[:, None]
    node_mask = graph["node_mask"][:, None]

    x = gather_rows(params["embed"], species) * node_mask   # scalar irreps
    x = x.to(act)
    n_pad = x.shape[0]
    in_ir = scalars
    for p_l in params["layers"]:
        lin = in_ir

        def layer(p_l, x, lin=lin):
            xf = x.to(f32)
            msg = ir.weighted_tensor_product(p_l["tp"], gather_rows(xf, src), sh, rbf,
                                             lin, sh_ir, hid)
            msg = msg * edge_w.to(f32)
            agg = segment_sum(msg, dst, n_pad)
            if edge_parallel is not None:
                agg = edge_parallel(agg)
            if sync_fn is not None:
                agg = sync_fn(agg)                              # consistent-MP
            xn = ir.linear_irreps(p_l["lin_self"], xf, lin, hid) \
                + ir.linear_irreps(p_l["lin_agg"], agg, hid, hid)
            return (ir.gate_irreps(xn, hid) * node_mask).to(act)

        x = checkpoint(layer, p_l, x, use_reentrant=False) if cfg.remat else layer(p_l, x)
        in_ir = hid
    x = x.to(f32)
    e_site = ir.linear_irreps(params["readout"], x, hid, ir.Irreps.scalars(1))
    return e_site[..., 0] * graph["node_mask"]
