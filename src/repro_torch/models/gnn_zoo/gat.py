"""GAT [arXiv:1710.10903] with a *consistent* distributed edge softmax (port
of ``repro.models.gnn_zoo.gat``).

The edge softmax over a partitioned graph uses three halo exchanges per
layer, as the reference's does:

  1. a ``max`` exchange of the per-destination score maxima (the shift),
  2. a ``sum`` exchange of the softmax denominator,
  3. a ``sum`` exchange of the attention-weighted message aggregate,

which makes distributed GAT arithmetically the un-partitioned run.  The
shift is exchanged on a detached tensor: the softmax does not change when
every score of a destination moves by one amount, so its derivative in
the shift is 0 exactly (``jax.grad`` of the reference carries a
rounding-level remainder of it through ``segment_max``), and the port's
max exchange takes no gradient (``core/halo.py``).  Over R > 1 ranks the
caller passes the exchange as ``sync_fn`` (``core/distributed.py::HaloFn``,
called with ``combine=``); None on one rank.  On a packed neighbor spec
the two sum exchanges run kernels 4 and 5; the max exchange runs plain
gathers and scatters.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.core.halo import MAX
from repro_torch.graph.segment import gather_rows, segment_max, segment_sum

#: the masked-score fill, as the reference's
NEG = -1e30


@dataclasses.dataclass(frozen=True)
class GATConfig:
    in_dim: int = 1433
    hidden: int = 8
    heads: int = 8
    n_classes: int = 7
    n_layers: int = 2
    name: str = "gat-cora"


def init_gat(gen: torch.Generator, cfg: GATConfig, device="cuda") -> nn.Params:
    """Glorot-uniform parameters in the reference's tree, drawn from ``gen``
    (a CPU ``torch.Generator``) and placed on ``device``."""
    layers = []
    d_in = cfg.in_dim
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.hidden
        heads = 1 if last else cfg.heads
        layers.append({
            "w": nn.glorot(gen, (d_in, heads, d_out)).to(device),
            "a_src": nn.glorot(gen, (heads, d_out, 1))[..., 0].to(device),
            "a_dst": nn.glorot(gen, (heads, d_out, 1))[..., 0].to(device),
        })
        d_in = d_out * heads if not last else d_out
    return {"layers": layers}


def _gat_layer(p, x, graph, sync_fn, concat_heads: bool):
    src, dst = graph["edge_src"], graph["edge_dst"]
    emask = graph["edge_mask"][:, None]
    node_mask = graph["node_mask"][:, None]
    n_pad = x.shape[0]
    h = torch.einsum("nd,dhk->nhk", x, p["w"])                  # [N, H, K]
    s_src = torch.einsum("nhk,hk->nh", h, p["a_src"])
    s_dst = torch.einsum("nhk,hk->nh", h, p["a_dst"])
    scores = F.leaky_relu(gather_rows(s_src, src) + gather_rows(s_dst, dst), 0.2)
    scores = torch.where(emask > 0, scores, NEG)                 # [E, H]

    # --- consistent softmax: the shift, max-exchanged (detached) ---
    m = segment_max(scores.detach(), dst, n_pad)                 # [N, H]
    m = torch.where(node_mask > 0, m, NEG)
    if sync_fn is not None:
        m = sync_fn(m, combine=MAX)
    m = torch.where(torch.isfinite(m), m, 0.0)
    expv = torch.exp(scores - gather_rows(m, dst)) * emask
    expv = expv * graph["edge_inv_mult"][:, None]                # d_ij scaling
    # --- the denominator, sum-exchanged ---
    denom = segment_sum(expv, dst, n_pad)
    if sync_fn is not None:
        denom = sync_fn(denom)
    # --- the weighted message aggregate, sum-exchanged ---
    msg = expv[..., None] * gather_rows(h, src)                  # [E, H, K]
    agg = segment_sum(msg, dst, n_pad)
    if sync_fn is not None:
        agg = sync_fn(agg.reshape(n_pad, -1)).reshape(agg.shape)
    out = agg / torch.clamp(denom, min=1e-20)[..., None]
    out = out * node_mask[..., None]
    if concat_heads:
        return out.reshape(n_pad, -1)
    return out.mean(dim=1)


def gat_forward(params, x: torch.Tensor, graph, cfg: GATConfig, sync_fn=None):
    """x: [N_pad, in_dim] -> logits [N_pad, n_classes].  ``graph``: the
    rank-local graph; ``sync_fn``: its halo exchange over the mesh's graph
    group (module docstring), None on one rank."""
    del cfg  # the architecture is entirely encoded in the params tree
    layers = params["layers"]
    for i, p in enumerate(layers):
        last = i == len(layers) - 1
        x = _gat_layer(p, x, graph, sync_fn, concat_heads=not last)
        if not last:
            x = F.elu(x)
    return x
