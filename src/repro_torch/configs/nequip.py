"""NequIP [arXiv:2101.03164]: 5L, 32 channels, l_max=2, 8 RBF, cutoff 5
(port of ``repro.configs.nequip``), with the reference's overrides
``remat``, ``act_bf16`` and ``edge_parallel``."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import gnn_common as G
from repro_torch.models.gnn_zoo.nequip import NequIPConfig, init_nequip, nequip_forward

ARCH_ID = "nequip"
FAMILY = "gnn"


def config(shape: dict | None = None) -> NequIPConfig:
    return NequIPConfig(n_layers=5, hidden_mul=32, l_max=2, n_rbf=8, cutoff=5.0)


def smoke_config() -> NequIPConfig:
    return NequIPConfig(n_layers=2, hidden_mul=8, l_max=2, n_rbf=4, cutoff=3.0,
                        n_species=4)


def _inputs_factory(shape, R, n_pad, e_pad, graph_axis=G.GRAPH, edge_parallel=False):
    """The cell's stacked inputs (species, positions, per-node target) as
    meta tensors, and their specs."""
    inputs = {"species": G._meta((R, n_pad), torch.int32),
              "pos": G._meta((R, n_pad, 3), torch.float32),
              "target": G._meta((R, n_pad), torch.float32)}
    specs = {"species": (graph_axis, None), "pos": (graph_axis, None, None),
             "target": (graph_axis, None)}
    return inputs, specs


def with_overrides(cfg, overrides=None):
    """``cfg`` under the reference's overrides: ``remat``, ``act_bf16``
    (a bf16 carry) and ``edge_parallel`` (each layer's aggregate summed over
    the mesh's model axis)."""
    ov = overrides or {}
    kw = {}
    if ov.get("remat"):
        kw["remat"] = True
    if ov.get("act_bf16"):
        kw["act_dtype"] = torch.bfloat16
    if ov.get("edge_parallel"):
        kw["edge_parallel_axes"] = (G.MODEL,)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def equivariant_loss_factory(forward, config_fn):
    """The ``_loss_local_factory`` of an equivariant potential:
    ``forward(params, species, pos, graph, cfg, sync_fn=, mesh=)``'s site
    energies on this process's rank-local graph against the per-node
    target, the consistent squared error summed over the mesh's graph
    group."""
    def factory(shape, halo, graph_axis=G.GRAPH, mesh=None, overrides=None, cfg=None):
        del graph_axis  # the graph axis is the mesh's graph group
        cfg = with_overrides(config_fn(shape) if cfg is None else cfg, overrides)
        group = None if mesh is None else mesh.graph_group

        def loss_local(params, inputs, graph):
            e_site = forward(params, inputs["species"][0], inputs["pos"][0], graph, cfg,
                             sync_fn=G.sync_fn_of(graph, halo, mesh), mesh=mesh)
            return G.consistent_mse_loss(e_site, inputs["target"][0],
                                         graph["node_inv_mult"], group)
        return loss_local
    return factory


_loss_local_factory = equivariant_loss_factory(nequip_forward, config)


def _param_factory(shape):
    """The cell's parameters as meta tensors (shapes only)."""
    with torch.device("meta"):
        return init_nequip(None, config(shape), device="meta")


def build_dryrun_cell(shape_id, mesh, overrides=None):
    return G.build_gnn_dryrun_cell(
        shape_id, mesh,
        loss_local_factory=_loss_local_factory,
        inputs_factory=_inputs_factory,
        param_factory=_param_factory,
        overrides=overrides)
