"""GraphCast's training cell over gloo processes on the CPU: R > 1 graph
ranks, edge-parallel model shards (``make_mesh(..., model=M)``,
``nmp_layer(edge_parallel_axes=)``) and both, against the port's one-rank
run and ``repro``'s unsplit GraphCast, from ``repro``'s weights.

Two spawns for the file (module fixtures, every case's records returned
as numpy through ``repro_torch.launch.graphcast_checks.run_world``), at
``smoke_config``'s widths (hidden 32, 3 layers, one MLP hidden layer) on
``cora_like(seed=1, n=64, m_und=200, d=16, n_classes=4)``, the fused
backend (its plain versions on CPU tensors, on each slice's own layout):

* 2 processes: graph 2 x model 1 (a2a; packed neighbor under overlap)
  and graph 1 x model 2;
* 4 processes: graph 2 x model 2 under the blocking and the overlap
  schedule, each with a2a and the packed neighbor exchange; graph 1 x
  model 4 (one slice nearly empty); data 2 x graph 2 x model 1.

Held: each process's eval-step predictions (its rank's rows, by global
id) within rtol 1e-4 / atol 1e-5 of the one-rank run, the first step's
loss within 2e-6 (relative) and its gradients within rtol 1e-3 / atol
2e-5; every process's losses and parameters after two AdamW steps equal
(bitwise), the second step's loss within 1e-4 of the one-rank run's;
graph 1 x model 2 against ``repro``'s unsplit forward, loss and
gradients in the same bands; the model shards' slices partition each
rank's edges; and a ``model=1`` mesh keeps the two-axis mesh's groups.
The workers import nothing of this file, of ``repro`` or of JAX.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import gnn_common as ref_G
from repro.core.graph_state import NMPPlan as RefPlan
from repro.core.graph_state import ShardedGraph as RefGraph
from repro.core.halo import HaloSpec as RefHalo
from repro.core.partition import partition_graph as ref_partition_graph
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models.gnn_zoo import graphcast as ref_gc

from repro_torch import nn
from repro_torch.configs import graphcast as gcc
from repro_torch.convert import graphcast_params_from_jax, graphcast_params_to_jax
from repro_torch.core.graph_state import FUSED
from repro_torch.core.partition import partition_graph
from repro_torch.graph.datasets import cora_like
from repro_torch.launch import graphcast_checks as gcx
from repro_torch.launch.mesh import to_host

F_RTOL, F_ATOL = 1e-4, 1e-5
LOSS_REL, G_RTOL, G_ATOL = 2e-6, 1e-3, 2e-5
TRAIN_REL = 1e-4
GRAPH = dict(seed=1, n=64, m_und=200, d=16, n_classes=4)

WORLD2 = (gcx.Case("g2m1_a2a", graph=2, mode="a2a"),
          gcx.Case("g2m1_packed_overlap", graph=2, mode="packed", schedule="overlap"),
          gcx.Case("g1m2", model=2))
WORLD4 = tuple(gcx.Case(f"g2m2_{mode}_{schedule}", graph=2, model=2, mode=mode,
                        schedule=schedule)
               for schedule in ("blocking", "overlap") for mode in ("a2a", "packed")) + (
    gcx.Case("g1m4", model=4), gcx.Case("d2g2m1", data=2, graph=2, mode="neighbor"))
CASES = {c.name: (2, c) for c in WORLD2} | {c.name: (4, c) for c in WORLD4}


def _ref_cfg():
    c = gcc.smoke_config()
    return ref_gc.GraphCastConfig(in_dim=c.in_dim, hidden=c.hidden, n_layers=c.n_layers,
                                  out_dim=c.out_dim, mlp_hidden_layers=c.mlp_hidden_layers)


@functools.lru_cache(maxsize=None)
def _job():
    """repro's weights in the port's layout (numpy), and the job."""
    np_params = jax.tree.map(np.asarray, ref_gc.init_graphcast(jax.random.PRNGKey(0),
                                                               _ref_cfg()))
    port = to_host(graphcast_params_from_jax(np_params, "cpu"))
    cfg = dataclasses.asdict(gcc.smoke_config())
    return gcx.Job(cases=(), cfg=cfg, graph=GRAPH, params=port, backend=FUSED,
                   device="cpu"), np_params


@pytest.fixture(scope="module")
def r1():
    job, _ = _job()
    return to_host(gcx.run_case(job, gcx.Case("r1")))


@pytest.fixture(scope="module")
def world2():
    job, _ = _job()
    return gcx.run_world(dataclasses.replace(job, cases=WORLD2), 2)


@pytest.fixture(scope="module")
def world4():
    job, _ = _job()
    return gcx.run_world(dataclasses.replace(job, cases=WORLD4), 4)


def _procs(request, name):
    world, _ = CASES[name]
    return [p[name] for p in request.getfixturevalue(f"world{world}")]


def _rows(rec):
    """{global id: row} of a process's prediction."""
    m = rec["node_mask"] > 0
    return dict(zip(rec["global_ids"][m].tolist(), rec["pred"][m]))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("name", list(CASES))
def test_predictions_match_one_rank(request, r1, name):
    want = _rows(r1)
    seen = set()
    for p in _procs(request, name):
        for gid, row in _rows(p).items():
            np.testing.assert_allclose(row, want[gid], rtol=F_RTOL, atol=F_ATOL)
            seen.add(gid)
    assert seen == set(want)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_one_rank(request, r1, name):
    for p in _procs(request, name):
        assert _rel(p["loss0"], r1["loss0"]) <= LOSS_REL
        for a, b in zip(p["grads0"], r1["grads0"]):
            np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_ATOL)
    assert max(float(np.abs(g).max()) for g in r1["grads0"]) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_training_steps_agree_everywhere(request, r1, name):
    procs = _procs(request, name)
    assert all(p["losses"] == procs[0]["losses"] for p in procs)
    assert len({p["params_sum"] for p in procs}) == 1
    losses = procs[0]["losses"]
    assert _rel(losses[0], r1["losses"][0]) <= LOSS_REL
    assert _rel(losses[1], r1["losses"][1]) <= TRAIN_REL
    assert losses[1] != losses[0]


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items() if c.model > 1])
def test_model_shards_partition_each_rank_edges(request, name):
    """The shards of one rank hold equal slices of its padded edges, and
    their real edges add up to the rank's (one rank's count from the
    one-rank partition when graph = 1)."""
    _, case = CASES[name]
    procs = _procs(request, name)
    by_rank = {}
    for p in procs:
        by_rank.setdefault((p["replica"], p["rank"]), []).append(p)
    edges, _, _ = cora_like(**GRAPH)
    pg = partition_graph(GRAPH["n"], edges, case.graph)
    for (_, rank), shards in by_rank.items():
        assert len(shards) == case.model
        assert len({s["e_local"] for s in shards}) == 1
        assert sum(s["edges_local"] for s in shards) == float(pg.edge_mask[rank].sum())


@pytest.mark.parametrize("name", ["g2m1_a2a", "d2g2m1"])
def test_model1_mesh_keeps_the_two_axis_groups(request, name):
    _, case = CASES[name]
    procs = _procs(request, name)
    G, D = case.graph, case.data
    for w, p in enumerate(procs):
        replica, rank = divmod(w, G)
        assert (p["replica"], p["rank"], p["shard"]) == (replica, rank, 0)
        assert p["groups"]["graph"] == tuple(range(replica * G, (replica + 1) * G))
        assert p["groups"]["data"] == tuple(range(rank, D * G, G))
        assert p["groups"]["edge"] == (w,)
        assert p["groups"]["world"] == tuple(range(D * G))


def test_model_axis_is_the_fastest(world4):
    """World rank w = (replica * R + rank) * M + shard."""
    for w, p in enumerate(world4):
        rec = p["g2m2_a2a_blocking"]
        assert (rec["rank"], rec["shard"]) == divmod(w, 2)
        assert rec["groups"]["edge"] == (2 * rec["rank"], 2 * rec["rank"] + 1)
        assert rec["groups"]["graph"] == (rec["shard"], 2 + rec["shard"])


# ---------------------------------------------------------------------------
# graph 1 x model 2 against repro's unsplit GraphCast
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _repro_unsplit():
    """repro's forward, cross entropy and gradients on the one-rank graph
    (inside its shard_map on a (1, 1) mesh, as its step computes them)."""
    _, np_params = _job()
    edges, feats, labels = cora_like(**GRAPH)
    pg = ref_partition_graph(GRAPH["n"], edges, 1)
    inputs = {k: jnp.asarray(v) for k, v in gcx.cell_inputs(pg, feats, labels).items()}
    meta = {k: jnp.asarray(v) for k, v in pg.device_arrays().items()}
    cfg, plan = _ref_cfg(), RefPlan(halo=RefHalo(mode="none", axis="data"))
    mesh = ref_make_mesh((1, 1), ("data", "model"))

    def local(p, i, m):
        g = RefGraph.from_arrays({k: v[0] for k, v in m.items()})

        def loss(pp):
            out = ref_gc.graphcast_forward(pp, i["x"][0], i["edge_feats"][0], g, plan, cfg)
            return ref_G.consistent_ce_loss(out, i["labels"][0], g["node_inv_mult"],
                                            ("data",)), out
        (val, out), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return val, out, grads
    specs = {"x": P("data", None, None), "edge_feats": P("data", None, None),
             "labels": P("data", None)}
    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(), specs, ref_G.meta_specs(meta, "data")),
                       out_specs=(P(), P(), P()), check_vma=False)
    val, out, grads = jax.jit(fn)(jax.tree.map(jnp.asarray, np_params), inputs, meta)
    return float(val), np.asarray(out), jax.tree.map(np.asarray, grads), pg


def test_edge_parallel_matches_repro_unsplit(world2):
    val, out, grads, pg = _repro_unsplit()
    m = pg.node_mask[0] > 0
    want_rows = dict(zip(pg.global_ids[0][m].tolist(), out[m]))
    for p in world2:
        rec = p["g1m2"]
        for gid, row in _rows(rec).items():
            np.testing.assert_allclose(row, want_rows[gid], rtol=F_RTOL, atol=F_ATOL)
        assert _rel(rec["loss0"], val) <= LOSS_REL
        got = graphcast_params_to_jax(_unflatten(rec["grads0"]))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(grads)):
            np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_ATOL)


def _unflatten(leaves):
    """The port's gradient tree of the job's weights from its leaves."""
    job, _ = _job()
    like = nn.tree_map(torch.from_numpy, job.params)
    return nn.tree_unflatten(like, [torch.from_numpy(np.asarray(a)) for a in leaves])
