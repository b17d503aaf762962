"""MACE [arXiv:2206.07697]: higher-order equivariant message passing (ACE),
port of ``repro.models.gnn_zoo.mace``.

Per layer:
  * atomic basis  A_i = sum_j TP(lin(x_j) (x) SH(r_ij); radial)   (+ halo sync
    and 1/d_ij scaling — the consistent-MP aggregation);
  * product basis B via iterated channel-wise CG products:
        B1 = A,  B2 = ctp(A, A),  B3 = ctp(B2, A)   (correlation order 3);
  * message m_i = lin(B1) + lin(B2) + lin(B3); residual update + gate.
Readout: site energies (sum of per-layer scalar readouts, as in MACE).

The knobs (``remat``, ``act_dtype``, ``edge_parallel_axes``) and the
exchange (``sync_fn``, ``mesh``) are NequIP's (``nequip.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.consistent_mp import edge_parallel_of
from repro_torch.graph.segment import gather_rows, segment_sum
from repro_torch.models.gnn_zoo import irreps as ir
from repro_torch.models.gnn_zoo.nequip import compute_dtype, edge_geometry


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    n_layers: int = 2
    hidden_mul: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8
    name: str = "mace"
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


def init_mace(gen: torch.Generator, cfg: MACEConfig, device="cuda"):
    """Random parameters in the reference's tree, drawn from ``gen`` (a CPU
    ``torch.Generator``) and placed on ``device``."""
    hid = cfg.hidden_irreps
    sh = cfg.sh_irreps
    scalars = ir.Irreps.scalars(cfg.hidden_mul)
    embed = ir.normal(gen, (cfg.n_species, cfg.hidden_mul), device) * cfg.hidden_mul ** -0.5
    layers = []
    for i in range(cfg.n_layers):
        in_ir = scalars if i == 0 else hid
        layer = {
            "lin_pre": ir.init_linear_irreps(gen, in_ir, in_ir, device),
            "tp": ir.init_tp_weights(gen, in_ir, sh, hid, cfg.n_rbf, device),
            "lin_b1": ir.init_linear_irreps(gen, hid, hid, device),
            "lin_self": ir.init_linear_irreps(gen, in_ir, hid, device),
            "readout": ir.init_linear_irreps(gen, hid, ir.Irreps.scalars(1), device),
        }
        if cfg.correlation >= 2:
            layer["ctp2"] = ir.init_channel_tp_weights(gen, hid, hid, hid, device)
            layer["lin_b2"] = ir.init_linear_irreps(gen, hid, hid, device)
        if cfg.correlation >= 3:
            layer["ctp3"] = ir.init_channel_tp_weights(gen, hid, hid, hid, device)
            layer["lin_b3"] = ir.init_linear_irreps(gen, hid, hid, device)
        layers.append(layer)
    return {"embed": embed, "layers": layers}


def mace_forward(params, species: torch.Tensor, pos: torch.Tensor,
                 graph: Dict, cfg: MACEConfig, sync_fn=None,
                 mesh=None) -> torch.Tensor:
    """species [N_pad], pos [N_pad, 3] -> site energies [N_pad] (the
    arguments as ``nequip.py::nequip_forward``'s)."""
    src, dst = graph["edge_src"], graph["edge_dst"]
    hid, sh_ir = cfg.hidden_irreps, cfg.sh_irreps
    scalars = ir.Irreps.scalars(cfg.hidden_mul)
    act, f32 = cfg.act_dtype, compute_dtype(cfg.act_dtype)
    edge_parallel = edge_parallel_of(cfg.edge_parallel_axes, mesh, f32)

    rbf, sh = edge_geometry(pos, graph, cfg)
    sh, rbf = sh.to(act).to(f32), rbf.to(act).to(f32)
    edge_w = (graph["edge_inv_mult"] * graph["edge_mask"])[:, None]
    node_mask = graph["node_mask"][:, None]

    x = gather_rows(params["embed"], species) * node_mask
    x = x.to(act)
    n_pad = x.shape[0]
    in_ir = scalars
    e_site = torch.zeros((n_pad,), dtype=f32, device=x.device)
    for p_l in params["layers"]:
        lin = in_ir

        def layer(p_l, x, lin=lin):
            xf = x.to(f32)
            xs = ir.linear_irreps(p_l["lin_pre"], xf, lin, lin)
            msg = ir.weighted_tensor_product(p_l["tp"], gather_rows(xs, src), sh, rbf,
                                             lin, sh_ir, hid)
            msg = msg * edge_w.to(f32)
            a = segment_sum(msg, dst, n_pad)
            if edge_parallel is not None:
                a = edge_parallel(a)
            if sync_fn is not None:
                a = sync_fn(a)                                  # consistent-MP
            m = ir.linear_irreps(p_l["lin_b1"], a, hid, hid)
            if "ctp2" in p_l:
                b2 = ir.channel_tensor_product(p_l["ctp2"], a, a, hid, hid, hid)
                m = m + ir.linear_irreps(p_l["lin_b2"], b2, hid, hid)
                if "ctp3" in p_l:
                    b3 = ir.channel_tensor_product(p_l["ctp3"], b2, a, hid, hid, hid)
                    m = m + ir.linear_irreps(p_l["lin_b3"], b3, hid, hid)
            xn = ir.linear_irreps(p_l["lin_self"], xf, lin, hid) + m
            xn = ir.gate_irreps(xn, hid) * node_mask
            e_l = ir.linear_irreps(p_l["readout"], xn, hid, ir.Irreps.scalars(1))[..., 0]
            return xn.to(act), e_l.to(f32)

        if cfg.remat:
            x, e_l = checkpoint(layer, p_l, x, use_reentrant=False)
        else:
            x, e_l = layer(p_l, x)
        e_site = e_site + e_l
        in_ir = hid
    return e_site * graph["node_mask"]
