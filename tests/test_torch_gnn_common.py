"""The port's GNN step builder and cell functions
(``repro_torch.configs.gnn_common``, ``repro_torch.configs.graphcast``)
against ``repro``'s, on the CPU, from the same numpy inputs and weights.

* ``cora_like`` array-equal to ``repro``'s for two seeds and sizes.
* One GraphCast training step at ``tests/test_arch_smoke.py``'s size
  (``cora_like(seed=1, n=48, m_und=140, d=16, n_classes=3)``, the
  published config: d512, 16 layers, cross entropy) through
  ``make_gnn_train_step`` on the port's fused backend (its plain versions
  on CPU tensors) against ``repro``'s ``make_gnn_train_step``
  on a (1, 1) mesh through its XLA backend: loss within 2e-6 (relative),
  gradients within rtol 1e-3 / atol 2e-5, and the AdamW step's new
  parameters within 1e-6 of ``repro``'s wherever the gradient is above
  1e-4 (elsewhere AdamW's sign of a near-zero gradient decides the step,
  so within twice the learning rate).
* Each override of ``_loss_local_factory`` against ``repro``'s loss, at
  the config's hidden 64 and 4 layers (the reference's ``config`` pointed
  at it for the test): ``edge_parallel`` (a size-1 model axis),
  ``remat``, ``remat_segment`` and ``params_bf16`` within 2e-6; ``act_bf16`` within 2e-2 (the bf16
  band) and off the fp32 loss; the ``molecule`` kind's squared error
  within 2e-6.
* The dry-run structures (``synthetic_partitioned_meta``,
  ``_inputs_factory`` at R=16, ``meta_specs``, ``xor_rounds``,
  ``build_dryrun_cell`` for the ``full`` and ``molecule`` kinds) have the
  reference's shapes, dtypes and split axes (its graph axis ``data`` is
  the port's ``graph``); the ``minibatch`` kind raises, naming its
  ROADMAP item.
* Edge sharding's structures: ``pad_edges`` / ``edge_shard`` slices that
  rebuild the padded partition, each slice's graph (fused layout,
  overlap split) equal to one built from its edges, and an empty slice.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import gnn_common as ref_G
from repro.configs import graphcast as ref_gcc
from repro.core.graph_state import ShardedGraph as RefGraph
from repro.core.halo import NONE as REF_NONE
from repro.core.halo import HaloSpec as RefHalo
from repro.core.partition import partition_graph as ref_partition_graph
from repro.graph.datasets import cora_like as ref_cora_like
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models.gnn_zoo import graphcast as ref_gc
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.optimizer import init_adamw as ref_init_adamw

from repro_torch import nn
from repro_torch.configs import gnn_common as G
from repro_torch.configs import graphcast as gcc
from repro_torch.convert import graphcast_params_from_jax, graphcast_params_to_jax
from repro_torch.core.distributed import local_graph_of
from repro_torch.core.graph_state import (
    EDGE_KEYS, FUSED, NMPPlan, ShardedGraph, edge_shard, pad_edges)
from repro_torch.core.halo import NONE, HaloSpec
from repro_torch.core.partition import partition_graph
from repro_torch.graph.datasets import cora_like
from repro_torch.train.optimizer import AdamWConfig, init_adamw

LOSS_REL, G_RTOL, G_ATOL = 2e-6, 1e-3, 2e-5
BF16_REL = 2e-2
# tests/test_arch_smoke.py's graph and shape
N, M_UND, D, CLASSES = 48, 140, 16, 3
SHAPE = dict(kind="full", n_nodes=N, n_edges=M_UND, d_feat=D, n_classes=CLASSES)
MOLECULE = dict(kind="molecule", n_nodes=N, n_edges=M_UND, batch=1)
LR = 1e-3


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, n=97, m_und=300, d=12,
                                                   n_classes=5)],
                         ids=["cora", "small"])
def test_cora_like_equal_reference(kw):
    for got, want in zip(cora_like(**kw), ref_cora_like(**kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# one training step at the reference's smoke size
# ---------------------------------------------------------------------------

REF_CONFIG = ref_gcc.config


def _small_config(shape):
    """``config(shape)`` at hidden 64 and 4 layers (the overrides' cases)."""
    return dataclasses.replace(REF_CONFIG(shape), hidden=64, n_layers=4)


@functools.lru_cache(maxsize=None)
def _data(kind="full", small=False):
    """The graph, its partition in both packages, stacked numpy inputs and
    repro's weights (numpy) of ``config(shape)`` (``_small_config``)."""
    shape = SHAPE if kind == "full" else MOLECULE
    edges, feats, labels = cora_like(seed=1, n=N, m_und=M_UND, d=D, n_classes=CLASSES)
    ref_pg = ref_partition_graph(N, edges, 1)
    pg = partition_graph(N, edges, 1)
    rng = np.random.default_rng(0)
    d = shape.get("d_feat", 8)
    x = np.zeros((1, pg.n_pad, d), np.float32)
    x[0, :N] = feats if kind == "full" else rng.normal(size=(N, d))
    ef = (rng.normal(size=(1, pg.e_pad, gcc.EDGE_IN)) * pg.edge_mask[..., None]).astype(
        np.float32)
    lab = np.zeros((1, pg.n_pad), np.int32)
    lab[0, :N] = labels
    cfg = (_small_config if small else REF_CONFIG)(shape)
    np_params = jax.tree.map(np.asarray, ref_gc.init_graphcast(jax.random.PRNGKey(0), cfg))
    return shape, ref_pg, pg, {"x": x, "edge_feats": ef, "labels": lab}, np_params


def _ref_mesh():
    return ref_make_mesh((1, 1), ("data", "model"))


def _ref_setup(kind, overrides, small=False):
    shape, ref_pg, _, inputs, np_params = _data(kind, small)
    mesh = _ref_mesh()
    halo = RefHalo(mode=REF_NONE, axis="data")
    loss_local = ref_gcc._loss_local_factory(shape, halo, "data", mesh, overrides=overrides)
    _, specs = ref_gcc._inputs_factory(shape, 1, ref_pg.n_pad, ref_pg.e_pad, "data",
                                       edge_parallel=bool(overrides.get("edge_parallel")))
    meta = {k: jnp.asarray(v) for k, v in ref_pg.device_arrays().items()}
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    return mesh, loss_local, specs, meta, jin, jax.tree.map(jnp.asarray, np_params)


def _ref_loss_and_grads(kind="full", overrides=(), small=False):
    """repro's loss and gradients as its step computes them (inside its
    shard_map, before AdamW)."""
    ov = dict(overrides)
    mesh, loss_local, specs, meta, jin, params = _ref_setup(kind, ov, small)

    def local(p, inputs, m):
        g = RefGraph.from_arrays({k: v[0] for k, v in m.items()})
        return jax.value_and_grad(lambda pp: loss_local(pp, inputs, g))(p)
    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(), specs, ref_G.meta_specs(meta, "data")),
                       out_specs=(P(), P()), check_vma=False)
    loss, grads = jax.jit(fn)(params, jin, meta)
    return float(loss), jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def _ref_step():
    """repro's loss, gradients and one AdamW step of make_gnn_train_step."""
    mesh, loss_local, specs, meta, jin, params = _ref_setup("full", {})
    opt = RefAdamW()
    state = {"params": params, "opt": ref_init_adamw(params, opt)}
    _, wrap = ref_G.make_gnn_train_step(loss_local, mesh, specs, "data", opt)
    new_state, loss = jax.jit(wrap(meta))(state, jin, meta)
    _, grads = _ref_loss_and_grads()
    return float(loss), grads, jax.tree.map(np.asarray, new_state["params"])


def _port_setup(kind, backend, overrides=None, small=False):
    shape, _, pg, inputs, np_params = _data(kind, small)
    plan = NMPPlan(halo=HaloSpec(mode=NONE), backend=backend)
    graph = local_graph_of(pg, None, plan, device="cpu")
    cfg = dataclasses.replace(gcc.config(shape), hidden=64, n_layers=4) if small else None
    loss_local = gcc._loss_local_factory(shape, plan.halo, overrides=overrides, plan=plan,
                                         cfg=cfg)
    _, specs = gcc._inputs_factory(shape, 1, pg.n_pad, pg.e_pad,
                                   edge_parallel=bool((overrides or {}).get("edge_parallel")))
    local = G.shard_by_specs(inputs, specs, None, "cpu")
    return loss_local, local, graph, graphcast_params_from_jax(np_params, "cpu")


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _flat(tree):
    """Every leaf of a reference-layout tree in one vector."""
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def test_graphcast_train_step_matches_reference():
    ref_loss, ref_grads, ref_new = _ref_step()
    loss_local, inputs, graph, params = _port_setup("full", FUSED)
    loss, grads = G.gnn_loss_and_grads(loss_local, params, inputs, graph)
    assert _rel(loss, ref_loss) <= LOSS_REL
    got = graphcast_params_to_jax(grads)
    assert jax.tree.structure(got) == jax.tree.structure(ref_grads)
    g_ref = _flat(ref_grads)
    np.testing.assert_allclose(_flat(got), g_ref, rtol=G_RTOL, atol=G_ATOL)
    assert np.abs(g_ref).max() > 0

    opt = AdamWConfig()
    step = G.make_gnn_train_step(loss_local, opt)
    state = {"params": params, "opt": init_adamw(params, opt)}
    state, step_loss = step(state, inputs, graph)
    assert _rel(step_loss, ref_loss) <= LOSS_REL
    assert int(state["opt"]["step"]) == 1
    new, want = _flat(graphcast_params_to_jax(state["params"])), _flat(ref_new)
    sure = np.abs(g_ref) > 1e-4
    np.testing.assert_allclose(new[sure], want[sure], rtol=0, atol=1e-6)
    np.testing.assert_allclose(new, want, rtol=0, atol=2 * LR + 1e-6)


OVERRIDES = {
    "edge_parallel": (("edge_parallel", True),),
    "remat": (("remat", True),),
    "remat_segment": (("remat", True), ("remat_segment", 2)),
    "params_bf16": (("params_bf16", True),),
    "act_bf16": (("act_bf16", True),),
}


@pytest.mark.parametrize("name", list(OVERRIDES) + ["molecule"])
def test_loss_local_overrides_match_reference(name, monkeypatch):
    """At ``_small_config`` (both factories read their config from the
    shape: the reference's ``config`` is pointed at it for the test)."""
    monkeypatch.setattr(ref_gcc, "config", _small_config)
    kind = "molecule" if name == "molecule" else "full"
    overrides = OVERRIDES.get(name, ())
    loss_local, inputs, graph, params = _port_setup(kind, FUSED, dict(overrides), small=True)
    with torch.no_grad():
        loss = loss_local(params, inputs, graph)
    want = _ref_loss_and_grads(kind, overrides, small=True)[0]
    if name == "act_bf16":
        assert _rel(loss, want) <= BF16_REL
        base, _, _, _ = _port_setup(kind, FUSED, small=True)
        with torch.no_grad():
            assert float(loss) != float(base(params, inputs, graph))
    else:
        assert _rel(loss, want) <= LOSS_REL


# ---------------------------------------------------------------------------
# the dry-run structures
# ---------------------------------------------------------------------------

def _spec(p):
    """A reference PartitionSpec in the port's axis names."""
    return tuple({"data": G.GRAPH}.get(a, a) for a in tuple(p))


def _same_structs(got, want):
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert got[k].device.type == "meta"


@pytest.mark.parametrize("shape_id", ["full_graph_sm", "ogb_products"])
def test_synthetic_meta_and_specs_match_reference(shape_id):
    s = G.GNN_SHAPES[shape_id]
    assert s == ref_G.GNN_SHAPES[shape_id]
    got, n_pad, e_pad = G.synthetic_partitioned_meta(16, s["n_nodes"], 2 * s["n_edges"])
    want, rn, re = ref_G.synthetic_partitioned_meta(16, s["n_nodes"], 2 * s["n_edges"])
    assert (n_pad, e_pad) == (rn, re) and e_pad % 128 == 0
    _same_structs(got, want)
    for ep in (False, True):
        ref = ref_G.meta_specs(want, "data", ep)
        assert G.meta_specs(got, G.GRAPH, ep) == {k: _spec(v) for k, v in ref.items()}
    assert G.EDGE_KEYS == ref_G.EDGE_KEYS
    assert G._round_up(1000) == ref_G._round_up(1000) == 1024


@pytest.mark.parametrize("R,k", [(16, 8), (6, 3), (2, 1)])
def test_xor_rounds_equal_reference(R, k):
    assert G.xor_rounds(R, k) == ref_G.xor_rounds(R, k)


@pytest.mark.parametrize("edge_parallel", [False, True])
def test_inputs_factory_matches_reference(edge_parallel):
    shape = ref_G.GNN_SHAPES["full_graph_sm"]
    got, gs = gcc._inputs_factory(shape, 16, 256, 1536, G.GRAPH, edge_parallel=edge_parallel)
    want, ws = ref_gcc._inputs_factory(shape, 16, 256, 1536, "data",
                                       edge_parallel=edge_parallel)
    _same_structs(got, want)
    assert gs == {k: _spec(v) for k, v in ws.items()}


@pytest.mark.parametrize("shape_id,overrides", [
    ("full_graph_sm", {}), ("full_graph_sm", {"edge_parallel": True}), ("molecule", {})])
def test_dryrun_cell_matches_reference(shape_id, overrides):
    ref_mesh = SimpleNamespace(shape={"data": 16, "model": 16}, axis_names=("data", "model"))
    _, rargs, rin, _, rmeta = ref_gcc.build_dryrun_cell(shape_id, ref_mesh, overrides)
    step, args, in_specs, out_specs, meta = gcc.build_dryrun_cell(
        shape_id, {"graph": 16, "model": 16}, overrides)
    assert callable(step) and out_specs == (None, None)
    assert {k: v for k, v in meta.items() if k != "graph_axis"} == \
        {k: v for k, v in rmeta.items() if k != "graph_axis"}
    _same_structs(args[1], rargs[1])
    _same_structs(args[2], rargs[2])
    assert in_specs[1] == {k: _spec(v) for k, v in rin[1].items()}
    assert in_specs[2] == {k: _spec(v) for k, v in rin[2].items()}
    # the parameters and the AdamW moments: the reference's shapes, with
    # proc stacked there and a list of layers here
    for got, want in ((args[0]["params"], rargs[0]["params"]),
                      (args[0]["opt"]["m"], rargs[0]["opt"]["m"])):
        assert all(t.device.type == "meta" for t in nn.tree_leaves(got))
        got = graphcast_params_to_jax(nn.tree_map(lambda t: torch.empty(t.shape), got))
        assert [a.shape for a in jax.tree.leaves(got)] == \
            [tuple(b.shape) for b in jax.tree.leaves(want)]


def test_minibatch_kind_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 4"):
        gcc.build_dryrun_cell("minibatch_lg", {"graph": 16})


# ---------------------------------------------------------------------------
# edge sharding's structures
# ---------------------------------------------------------------------------

def test_edge_shards_rebuild_the_padded_partition():
    edges, _, _ = cora_like(seed=2, n=60, m_und=150, d=4, n_classes=2)
    pg = partition_graph(60, edges, 2)
    padded = pad_edges(pg)
    assert padded.e_pad % 128 == 0 and padded.e_pad >= pg.e_pad
    for k in EDGE_KEYS:
        np.testing.assert_array_equal(getattr(padded, k)[:, :pg.e_pad], getattr(pg, k))
        assert not getattr(padded, k)[:, pg.e_pad:].any()
    shards = [edge_shard(padded, i, 4) for i in range(4)]
    for k in EDGE_KEYS:
        np.testing.assert_array_equal(np.concatenate([getattr(s, k) for s in shards], 1),
                                      getattr(padded, k))
    for s in shards:
        np.testing.assert_array_equal(s.node_inv_mult, pg.node_inv_mult)
        assert s.halo is pg.halo
    with pytest.raises(ValueError, match="pad_edges"):
        edge_shard(partition_graph(60, edges[:-1], 2), 0, 7)


@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
def test_edge_slice_graph_is_its_edges_graph(schedule):
    """A slice's rank-local graph (layout, split, masks) is the graph of a
    partition whose edges are the slice's; the last slice of a graph
    padded far past its edges holds none and still builds (one tile of
    empty slots)."""
    edges, _, _ = cora_like(seed=2, n=60, m_und=150, d=4, n_classes=2)
    pg = pad_edges(partition_graph(60, edges, 2), 512)
    plan = NMPPlan(halo=HaloSpec(mode="a2a"), backend=FUSED, schedule=schedule)
    for i in range(2):
        s = edge_shard(pg, i, 2)
        g = ShardedGraph.build(s, None, plan, device="cpu", rank=1)
        whole = ShardedGraph.build(s, None, plan, device="cpu").rank(1)
        assert set(g.arrays) == set(whole.arrays)
        for k in g.arrays:
            torch.testing.assert_close(g[k], whole[k], rtol=0, atol=0)
        assert g["edge_src"].shape[0] == pg.e_pad // 2
    last = ShardedGraph.build(edge_shard(pg, 1, 2), None, plan, device="cpu", rank=0)
    assert float(last["edge_mask"].sum()) == 0
    assert bool((last["seg_perm"] == -1).all()) and int(last["seg_rowptr"][-1]) == 0
