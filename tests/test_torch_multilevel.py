"""The multilevel V-cycle of the torch port (``GNNConfig.n_levels > 1``)
against the JAX reference package and against itself across rank counts.

* ``from_edge_partition``, ``build_hierarchy`` (block and ``node2part``
  paths) and every level of ``ShardedGraph.build(hierarchy=)`` array-equal
  to ``repro``'s; ``build(rank=r)`` equal to the stacked graph's
  ``.rank(r)`` at every level.
* The port's stacked V-cycle (loss, prediction, gradients) against
  ``repro``'s xla V-cycle from the same weights, for both backends (the
  fused one on its plain versions here), both schedules, and A2A and the
  packed neighbor exchange: forward rtol 1e-4 / atol 1e-5, gradients rtol
  1e-3 / atol 2e-5.  ``repro``'s fused V-cycle does not trace on this JAX
  (``pl.load`` was removed), so the port is held to its xla one.
* The port alone, 1 rank vs R ranks, in ``repro``'s multilevel bands
  (``tests/test_multilevel.py``): loss 2e-6, predictions rtol 3e-5 /
  atol 5e-6, gradients rtol 2e-3 / atol 2e-5.
* ``repro``'s negative cases: halo mode none on a partitioned hierarchy
  deviates; NEIGHBOR without per-level specs, a graph without the coarse
  levels and coordinates other than the hierarchy's raise.
* A K=2 rollout over the hierarchy; the step functions on one rank.
* 2 and 4 gloo processes (``launch/consistency.py``'s multilevel job):
  R=1 within the bands, every rank's forward bitwise its slice of the
  stacked emulator, exchanges per forward as counted.
* The training loop and CLI (``--levels 3``) against ``repro``'s loop from
  ``repro``'s initial weights; the engine's ``register_mesh(hierarchy=)``,
  streamed == offline bitwise.

Test size: ``box_mesh((4, 4, 2), p=2)`` (405 -> 32 -> 4 nodes); N_H=8,
M=1, 2 MLP hidden layers, 3 levels, one NMP layer per coarse level.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import GNNConfig as RefConfig
from repro.core import NMPPlan as RefPlan
from repro.core import ShardedGraph as RefGraph
from repro.core import box_mesh as ref_box_mesh
from repro.core import init_gnn as ref_init_gnn
from repro.core.coarsen import build_hierarchy as ref_build_hierarchy
from repro.core.mesh_gen import mesh_graph_edges as ref_mesh_graph_edges
from repro.core.partition import from_edge_partition as ref_from_edge_partition
from repro.core.reference import loss_and_grad_stacked as ref_loss_and_grad
from repro.core.reference import rollout_stacked as ref_rollout_stacked
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt

from repro_torch import nn
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.coarsen import build_hierarchy
from repro_torch.core.consistent_mp import multilevel_vcycle
from repro_torch.core.distributed import make_gnn_step_fns
from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
from repro_torch.core.halo import A2A, NEIGHBOR, NONE, HaloSpec, halo_sync_stacked
from repro_torch.core.mesh_gen import (
    box_mesh, mesh_graph_edges, taylor_green_velocity, undirected_to_directed)
from repro_torch.core.partition import (
    from_edge_partition, gather_node_features, scatter_node_outputs)
from repro_torch.core.reference import (
    gnn_forward_stacked, loss_and_grad_stacked, rollout_stacked)
from repro_torch.launch import consistency as cons
from repro_torch.launch import train as train_cli
from repro_torch.runtime.engine import (
    EngineConfig, EngineError, InferenceEngine, config_from_checkpoint)
from repro_torch.train.loop import TrainConfig, run_fingerprint, train_consistent_gnn
from repro_torch.train.rollout import make_rollout_step_fns

ELEMS, ORDER, LEVELS, BLOCK_E = (4, 4, 2), 2, 3, 32
GRIDS = [(1, 1, 1), (4, 1, 1), (2, 2, 1)]
GRID_IDS = ["1x1x1", "4x1x1", "2x2x1"]
CFG = dict(hidden=8, n_mp_layers=1, mlp_hidden_layers=2, n_levels=LEVELS,
           coarse_mp_layers=1)
FY = 3
# against repro: the forward and gradient bands
RTOL, ATOL, G_RTOL, G_ATOL, LOSS_REL = 1e-4, 1e-5, 1e-3, 2e-5, 2e-6
# 1 rank vs R ranks: repro's multilevel bands (tests/test_multilevel.py)
ML_LOSS, ML_RTOL, ML_ATOL, ML_G_RTOL, ML_G_ATOL = 2e-6, 3e-5, 5e-6, 2e-3, 2e-5
# (halo mode name, HaloSpec mode, packed)
MODES = {"none": (NONE, False), "a2a": (A2A, False), "packed": (NEIGHBOR, True)}


@pytest.fixture(scope="module")
def meshes():
    return ref_box_mesh(ELEMS, p=ORDER), box_mesh(ELEMS, p=ORDER)


@pytest.fixture(scope="module")
def hierarchies(meshes):
    """(repro's, the port's) hierarchy per rank grid."""
    return {grid: (ref_build_hierarchy(meshes[0], grid, LEVELS),
                   build_hierarchy(meshes[1], grid, LEVELS)) for grid in GRIDS}


@pytest.fixture(scope="module")
def weights():
    np_params = jax.tree.map(np.asarray,
                             ref_init_gnn(jax.random.PRNGKey(0), RefConfig(**CFG)))
    return np_params, params_from_jax(np_params, "cpu")


def _assert_same(a, b, path="root"):
    """Dataclass / list / array trees equal: arrays equal in dtype and value."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if not f.name.startswith("_"):
                _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# host: partitions, hierarchy, graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("assign,extra", [("dst", False), ("src", False), ("dst", True)])
def test_from_edge_partition_matches_reference(meshes, assign, extra):
    assert np.array_equal(mesh_graph_edges(meshes[1]), ref_mesh_graph_edges(meshes[0]))
    edges = undirected_to_directed(mesh_graph_edges(meshes[1]))
    rng = np.random.default_rng(3)
    n, R = meshes[1].n_nodes, 4
    n2p = rng.integers(0, R, n)
    extra_nodes = [rng.choice(n, 7, replace=False) for _ in range(R)] if extra else None
    got = from_edge_partition(n, edges, R, node2part=n2p, assign=assign,
                              extra_nodes=extra_nodes)
    want = ref_from_edge_partition(n, edges, R, node2part=n2p, assign=assign,
                                   extra_nodes=extra_nodes)
    _assert_same(got, want)
    # the default contiguous blocks too
    _assert_same(from_edge_partition(n, edges, R), ref_from_edge_partition(n, edges, R))


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_build_hierarchy_matches_reference(hierarchies, grid):
    want, got = hierarchies[grid]
    assert got.level_sizes() == want.level_sizes() == [405, 32, 4]
    _assert_same(got, want)


def test_build_hierarchy_node2part_matches_reference(meshes):
    n2p = np.random.default_rng(0).integers(0, 4, meshes[1].n_nodes)
    _assert_same(build_hierarchy(meshes[1], (2, 2, 1), LEVELS, node2part=n2p),
                 ref_build_hierarchy(meshes[0], (2, 2, 1), LEVELS, node2part=n2p))


def _plans(hiers, mode, backend=FUSED, schedule="overlap"):
    halo_mode, packed = MODES[mode]
    ref_plan = RefPlan.build(hiers[0], halo_mode, packed=packed, backend=backend,
                             schedule=schedule, block_e=BLOCK_E)
    plan = NMPPlan.build(hiers[1], halo_mode, packed=packed, backend=backend,
                         schedule=schedule, block_e=BLOCK_E)
    return ref_plan, plan


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_graph_build_hierarchy_matches_reference(hierarchies, grid):
    """Every level's arrays that both packages build are equal (the fused
    layout's tiles, the split, the packed rounds); the reference graph's
    transfer maps are the port hierarchy's (host), and the port's sorted
    transfer maps are those sorted stably."""
    ref_ml, ml = hierarchies[grid]
    ref_plan, plan = _plans(hierarchies[grid], "packed" if grid != (1, 1, 1) else "none")
    want = RefGraph.build(ref_ml.levels[0], ref_ml.coords[0], ref_plan, hierarchy=ref_ml)
    got = ShardedGraph.build(ml.levels[0], ml.coords[0], plan, device="cpu", hierarchy=ml)
    assert got.n_levels == want.n_levels == LEVELS
    assert [(s.mode, s.perms, s.packed) for s in plan.halos(LEVELS)] == \
        [(s.mode, s.perms, s.packed) for s in ref_plan.halos(LEVELS)]
    for lw, lg in zip(want.levels, got.levels):
        common = set(lw.keys()) & set(lg.arrays)
        assert {"seg_perm_bnd", "static_edge_feats"} & common
        for k in common:
            assert np.array_equal(np.asarray(lw[k]), lg[k].numpy()), k
    for lvl in range(1, LEVELS):
        g, t = got.level(lvl), ml.transfers[lvl - 1]
        assert not {"t_fine", "t_coarse", "t_rw", "t_pw"} & set(g.arrays)
        for name, host in (("t_fine", t.fine_idx), ("t_coarse", t.coarse_idx),
                           ("t_rw", t.r_w), ("t_pw", t.p_w)):
            assert np.array_equal(np.asarray(want.level(lvl)[name]), host), name
        for r in range(ml.levels[0].R):
            for key, ids, src, n in (("tc", t.coarse_idx, t.fine_idx, ml.levels[lvl].n_pad),
                                     ("tf", t.fine_idx, t.coarse_idx,
                                      ml.levels[lvl - 1].n_pad)):
                order = np.argsort(ids[r], kind="stable")
                assert np.array_equal(g[f"{key}_src"][r].numpy(), src[r][order])
                assert np.array_equal(g[f"{key}_rw"][r].numpy(), t.r_w[r][order])
                assert np.array_equal(g[f"{key}_pw"][r].numpy(), t.p_w[r][order])
                assert np.array_equal(g[f"{key}_len"][r].numpy(),
                                      np.bincount(ids[r], minlength=n))


@pytest.mark.parametrize("grid", GRIDS[1:], ids=GRID_IDS[1:])
def test_rank_build_equals_stacked_slice_every_level(hierarchies, grid):
    ml = hierarchies[grid][1]
    plan = _plans(hierarchies[grid], "packed")[1]
    stacked = ShardedGraph.build(ml.levels[0], ml.coords[0], plan, device="cpu",
                                 hierarchy=ml)
    for r in range(ml.levels[0].R):
        got = ShardedGraph.build(ml.levels[0], ml.coords[0], plan, device="cpu",
                                 rank=r, hierarchy=ml)
        for lw, lg in zip(stacked.rank(r).levels, got.levels):
            assert set(lg.arrays) == set(lw.arrays) and set(lg.wires) == set(lw.wires)
            for k in lw.arrays:
                assert torch.equal(lg[k], lw[k]), k
            for k, w in lw.wires.items():
                assert all((a is None and b is None) or torch.equal(a, b)
                           for a, b in zip(lg.wire(k), w)), k
        assert got.n_levels == LEVELS


# ---------------------------------------------------------------------------
# the V-cycle against repro, and 1 rank vs R ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(hierarchies, weights):
    """``repro``'s xla V-cycle (jitted): loss, prediction and gradients at
    (1,1,1) and (2,2,1)."""
    params = jax.tree.map(jnp.asarray, weights[0])
    x_global = taylor_green_velocity(hierarchies[GRIDS[0]][0].coords[0])
    out = {}
    for grid, mode in (((1, 1, 1), NONE), ((2, 2, 1), A2A)):
        ml = hierarchies[grid][0]
        plan = RefPlan.build(ml, mode)
        graph = RefGraph.build(ml.levels[0], ml.coords[0], plan, hierarchy=ml)
        x = jnp.asarray(gather_node_features(ml.levels[0], x_global))
        fn = jax.jit(lambda p, x, g, plan=plan: ref_loss_and_grad(p, x, x, g, plan, FY))
        loss, y, grads = fn(params, x, graph)
        out[grid] = (float(loss), scatter_node_outputs(ml.levels[0], np.asarray(y)),
                     [np.asarray(g) for g in jax.tree.leaves(grads)])
    return out


def _port(hierarchies, weights, grid, mode, backend, schedule):
    ml = hierarchies[grid][1]
    halo_mode, packed = MODES[mode]
    plan = NMPPlan.build(ml, halo_mode, packed=packed, backend=backend,
                         schedule=schedule, block_e=BLOCK_E)
    graph = ShardedGraph.build(ml.levels[0], ml.coords[0], plan, device="cpu",
                               hierarchy=ml)
    x = torch.from_numpy(gather_node_features(
        ml.levels[0], taylor_green_velocity(ml.coords[0])))
    loss, y, grads = loss_and_grad_stacked(
        weights[1], x, x, graph, plan, FY, sync_fn=halo_sync_stacked if packed else None)
    return (float(loss), scatter_node_outputs(ml.levels[0], y.numpy()),
            [g.numpy() for g in nn.tree_leaves(grads)])


def _close(got, want, loss_rel, rtol, atol, g_rtol, g_atol):
    (lg, yg, gg), (lw, yw, gw) = got, want
    assert abs(lg - lw) <= loss_rel * max(1.0, abs(lw)), (lg, lw)
    np.testing.assert_allclose(yg, yw, rtol=rtol, atol=atol)
    assert len(gg) == len(gw)
    for a, b in zip(gg, gw):
        np.testing.assert_allclose(a, b, rtol=g_rtol, atol=g_atol)


REF_CASES = [((1, 1, 1), "none"), ((2, 2, 1), "a2a"), ((2, 2, 1), "packed")]


@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
@pytest.mark.parametrize("backend", [XLA, FUSED])
@pytest.mark.parametrize("grid,mode", REF_CASES,
                         ids=["1x1x1_none", "2x2x1_a2a", "2x2x1_packed"])
def test_vcycle_matches_reference_xla(hierarchies, weights, reference, grid, mode,
                                      backend, schedule):
    got = _port(hierarchies, weights, grid, mode, backend, schedule)
    _close(got, reference[grid], LOSS_REL, RTOL, ATOL, G_RTOL, G_ATOL)


@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
@pytest.mark.parametrize("backend", [XLA, FUSED])
@pytest.mark.parametrize("mode", ["a2a", "packed"])
@pytest.mark.parametrize("grid", GRIDS[1:], ids=GRID_IDS[1:])
def test_one_rank_equals_r_ranks(hierarchies, weights, grid, mode, backend, schedule):
    one = _port(hierarchies, weights, (1, 1, 1), "none", backend, schedule)
    many = _port(hierarchies, weights, grid, mode, backend, schedule)
    _close(many, one, ML_LOSS, ML_RTOL, ML_ATOL, ML_G_RTOL, ML_G_ATOL)


def test_halo_none_on_a_partitioned_hierarchy_deviates(hierarchies, weights):
    """The transfers' halo sums are load-bearing: skipping every exchange
    on a partitioned hierarchy does not give the 1-rank V-cycle."""
    one = _port(hierarchies, weights, (1, 1, 1), "none", XLA, "blocking")
    none = _port(hierarchies, weights, (2, 2, 1), "none", XLA, "blocking")
    assert abs(none[0] - one[0]) > 1e-6


def test_neighbor_mode_requires_per_level_halo_specs(hierarchies, weights):
    ml = hierarchies[(2, 2, 1)][1]
    full = NMPPlan.build(ml, NEIGHBOR)
    plan = NMPPlan(halo=full.halo)                      # no coarse_halos
    graph = ShardedGraph.build(ml.levels[0], ml.coords[0], plan, device="cpu",
                               hierarchy=ml)
    h = torch.zeros(ml.levels[0].n_pad, CFG["hidden"])
    with pytest.raises(ValueError, match="one HaloSpec per coarse level"):
        multilevel_vcycle(weights[1]["coarse"], h, graph.rank(0), plan)
    x = torch.zeros(ml.levels[0].R, ml.levels[0].n_pad, 3)
    with pytest.raises(ValueError, match="one HaloSpec per coarse level"):
        gnn_forward_stacked(weights[1], x, graph, plan, sync_fn=halo_sync_stacked)


def test_multilevel_requires_coarse_graph(hierarchies, weights):
    ml = hierarchies[(2, 2, 1)][1]
    plan = NMPPlan(halo=HaloSpec(mode=A2A))
    graph = ShardedGraph.build(ml.levels[0], ml.coords[0], plan, device="cpu")
    x = torch.zeros(ml.levels[0].R, ml.levels[0].n_pad, 3)
    with pytest.raises(ValueError, match="multilevel graph"):
        loss_and_grad_stacked(weights[1], x, x, graph, plan, FY)


def test_graph_build_hierarchy_guards(hierarchies, meshes):
    ml = hierarchies[(2, 2, 1)][1]
    with pytest.raises(ValueError, match="hierarchy.coords"):
        ShardedGraph.build(ml.levels[0], meshes[1].coords + 1.0, device="cpu",
                           hierarchy=ml)
    other = build_hierarchy(meshes[1], (2, 2, 1), LEVELS)
    with pytest.raises(ValueError, match="levels\\[0\\]"):
        ShardedGraph.build(other.levels[0], meshes[1].coords, device="cpu",
                           hierarchy=ml)


def test_init_and_convert_keep_the_reference_tree(weights):
    """``init_gnn`` draws the reference's tree (a ``"coarse"`` list of
    {"edge_enc", "mp"} per coarse level, the same shapes), and
    ``params_from_jax`` / ``params_to_jax`` carry it unchanged."""
    np_params, params = weights
    port = init_gnn(torch.Generator().manual_seed(0), GNNConfig(**CFG), device="cpu")
    ref_paths = jax.tree_util.tree_flatten_with_path(np_params)[0]
    port_np = params_to_jax(port)
    port_paths = jax.tree_util.tree_flatten_with_path(port_np)[0]
    assert [p for p, _ in ref_paths] == [p for p, _ in port_paths]
    assert all(a.shape == b.shape for (_, a), (_, b) in zip(ref_paths, port_paths))
    assert len(np_params["coarse"]) == LEVELS - 1
    back = params_to_jax(params)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(np_params)))


def test_rollout_over_the_hierarchy(hierarchies, weights):
    """K=2 rollout: the port's stacked rollout at R=1 against ``repro``'s
    (jitted) and at (2,2,1) packed against R=1; the rollout step functions'
    gradient against the stacked oracle."""
    k = 2
    ref_ml, ml = hierarchies[(1, 1, 1)]
    x0g = taylor_green_velocity(ml.coords[0])
    tg = np.stack([taylor_green_velocity(ml.coords[0], t=0.05 * (i + 1))
                   for i in range(k)])
    ref_plan = RefPlan.build(ref_ml, NONE)
    ref_graph = RefGraph.build(ref_ml.levels[0], ref_ml.coords[0], ref_plan,
                               hierarchy=ref_ml)
    pg = ml.levels[0]
    x0 = gather_node_features(pg, x0g)
    tgt = np.stack([gather_node_features(pg, t) for t in tg])
    want_loss, want_pred = jax.jit(lambda p: ref_rollout_stacked(
        p, jnp.asarray(x0), jnp.asarray(tgt), ref_graph, ref_plan, FY))(
        jax.tree.map(jnp.asarray, weights[0]))
    plan = NMPPlan.build(ml, NONE, backend=FUSED, block_e=BLOCK_E)
    graph = ShardedGraph.build(pg, ml.coords[0], plan, device="cpu", hierarchy=ml)
    loss, pred = rollout_stacked(weights[1], torch.from_numpy(x0),
                                 torch.from_numpy(tgt), graph, plan, FY)
    assert abs(float(loss) - float(want_loss)) <= LOSS_REL * abs(float(want_loss))
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want_pred),
                               rtol=RTOL, atol=ATOL)
    # (2,2,1), packed neighbor, against R=1
    ml4 = hierarchies[(2, 2, 1)][1]
    plan4 = NMPPlan.build(ml4, NEIGHBOR, packed=True, backend=FUSED, block_e=BLOCK_E)
    g4 = ShardedGraph.build(ml4.levels[0], ml4.coords[0], plan4, device="cpu",
                            hierarchy=ml4)
    x04 = gather_node_features(ml4.levels[0], x0g)
    tgt4 = np.stack([gather_node_features(ml4.levels[0], t) for t in tg])
    with torch.no_grad():
        loss4, pred4 = rollout_stacked(weights[1], torch.from_numpy(x04),
                                       torch.from_numpy(tgt4), g4, plan4, FY,
                                       sync_fn=halo_sync_stacked)
    assert abs(float(loss4) - float(loss)) <= ML_LOSS * abs(float(loss))
    # both steps in repro's multilevel band (on the CPU: max|err| 8.4e-7 at
    # step 1 and 4.2e-6 at step 2, 0.12 and 0.41 of the band)
    for s in range(k):
        np.testing.assert_allclose(
            scatter_node_outputs(ml4.levels[0], pred4[s].numpy()),
            scatter_node_outputs(pg, pred[s].detach().numpy()), rtol=ML_RTOL,
            atol=ML_ATOL)
    # the rollout step functions (one rank) against the stacked oracle
    _, rollout_grad = make_rollout_step_fns(None, plan, k)
    got_loss, got_g = rollout_grad(weights[1], torch.from_numpy(x0)[None],
                                   torch.from_numpy(tgt)[None],
                                   torch.zeros(1, *x0.shape), graph)
    want_l, want_g = nn.value_and_grad(
        lambda p: rollout_stacked(p, torch.from_numpy(x0), torch.from_numpy(tgt),
                                  graph, plan, FY)[0], weights[1])
    assert abs(float(got_loss) - float(want_l)) <= LOSS_REL * abs(float(want_l))
    for a, b in zip(nn.tree_leaves(got_g), nn.tree_leaves(want_g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=G_RTOL, atol=G_ATOL)


def test_step_fns_on_one_rank(hierarchies, weights, reference):
    """``make_gnn_step_fns`` without a mesh on the hierarchy's one rank:
    the 1-rank plan drops every level's exchange; loss and gradients as
    ``repro``'s."""
    ml = hierarchies[(1, 1, 1)][1]
    plan = NMPPlan.build(ml, NEIGHBOR, backend=FUSED, block_e=BLOCK_E)
    assert len(plan.coarse_halos) == LEVELS - 1
    graph = ShardedGraph.build(ml.levels[0], ml.coords[0], plan, device="cpu",
                               hierarchy=ml)
    x = torch.from_numpy(gather_node_features(
        ml.levels[0], taylor_green_velocity(ml.coords[0])))[None]
    _, _, grad_step, _ = make_gnn_step_fns(GNNConfig(**CFG), plan)
    loss, grads = grad_step(weights[1], x, x, graph)
    lw, _, gw = reference[(1, 1, 1)]
    assert abs(float(loss) - lw) <= LOSS_REL * abs(lw)
    for a, b in zip(nn.tree_leaves(grads), gw):
        np.testing.assert_allclose(a.numpy(), b, rtol=G_RTOL, atol=G_ATOL)


# ---------------------------------------------------------------------------
# through torch.distributed (gloo processes)
# ---------------------------------------------------------------------------

DIST_MODES = ("a2a", "packed", "none")


@pytest.fixture(scope="module")
def dist_job(weights):
    return cons.multilevel_job(LEVELS, device="cpu", backends=(FUSED,),
                               modes=DIST_MODES, schedules=("blocking", "overlap"),
                               params=weights[0])


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, dist_job):
    return request.param, cons.run_world(dist_job, request.param)


@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
def test_distributed_vcycle_matches_one_rank(world, dist_job, schedule):
    """The reference multilevel check on every case of the world: each
    consistent mode's loss and gradients within its bands of R=1, none
    deviating."""
    n, procs = world
    lines = cons.check(procs, cons.baseline(dist_job), schedule=schedule,
                       g_rtol=cons.ML_G_RTOL, agree=False)
    assert len(lines) == len(DIST_MODES) * len(cons.ML_CASES[n])


@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
def test_distributed_forward_bitwise_stacked(world, dist_job, schedule):
    """Every rank's forward of every case is bitwise its slice of the
    stacked emulator's (the same per-rank transfers, layers and exchange
    order), and the forward posts one exchange per layer and transfer."""
    n, procs = world
    sem = box_mesh(dist_job.elements, p=dist_job.order)
    params = params_from_jax(dist_job.params, "cpu")
    per_fwd = cons.exchanges_per_forward(dist_job.cfg)
    assert per_fwd == 1 + (LEVELS - 1) * (1 + 2)
    for grid, _ in cons.ML_CASES[n]:
        pg, hier = cons.partition(sem, grid, dist_job.cfg)
        for mode in ("a2a", "packed"):
            plan = cons.plan_for(pg, mode, FUSED, schedule, hier)
            g = cons.build_graph(pg, hier, sem, plan, "cpu")
            x = torch.from_numpy(gather_node_features(
                pg, taylor_green_velocity(sem.coords)))
            with torch.no_grad():
                want = gnn_forward_stacked(params, x, g, plan, sync_fn=halo_sync_stacked)
            for p in procs:
                case = p[cons.case_name(grid, 1)]
                rec = case[cons.steps_key(schedule)][(FUSED, mode)]
                assert np.array_equal(rec["pred"][0, 0], want[case["rank"]].numpy())
                # the overlap schedule holds back the layers' exchanges,
                # not the transfers'; the gradient run finishes each at once
                layers = CFG["n_mp_layers"] + (LEVELS - 1) * CFG["coarse_mp_layers"]
                assert rec["fwd_exchanges"] == {
                    "posted": per_fwd, "overlapped": layers if schedule == "overlap" else 0}
                assert rec["grad_exchanges"] == {"posted": 2 * per_fwd, "overlapped": 0}


# ---------------------------------------------------------------------------
# training, the CLI and the engine
# ---------------------------------------------------------------------------

def test_training_curve_matches_reference(meshes, hierarchies, weights):
    """3 steps of ``repro``'s loop (R=1, its own initial weights) and of the
    port's from the same weights, through the V-cycle."""
    cfg = RefConfig(**CFG)
    tcfg = ref_loop.TrainConfig(n_steps=3, batch=1, lr=1e-3)
    ref_ml = hierarchies[(1, 1, 1)][0]
    start = jax.tree.map(np.asarray, ref_loop._init_state(
        cfg, tcfg, ref_opt.AdamWConfig())["params"])
    want = ref_loop.train_consistent_gnn(
        ref_make_mesh((1, 1), ("data", "graph")), ref_ml.levels[0], meshes[0], cfg,
        tcfg, hierarchy=ref_ml)["losses"]
    ml = hierarchies[(1, 1, 1)][1]
    got = train_consistent_gnn(
        ml.levels[0], meshes[1], GNNConfig(**CFG),
        TrainConfig(n_steps=3, batch=1, lr=1e-3, plan=NMPPlan(backend=FUSED)),
        params=start, device="cpu", hierarchy=ml)["losses"]
    assert abs(got[0] - want[0]) <= LOSS_REL * abs(want[0])
    for a, b in zip(got[1:], want[1:]):
        assert abs(a - b) <= 1e-4 * abs(b)
    with pytest.raises(ValueError, match="hierarchy="):
        train_consistent_gnn(ml.levels[0], meshes[1], GNNConfig(**CFG),
                             TrainConfig(n_steps=1), device="cpu")


def test_train_cli_levels(capsys):
    """``--levels 3`` at R=1 and under ``--ranks 2 1 1`` (2 gloo processes):
    the hierarchy line, and the same losses within the bands."""
    argv = ["--device", "cpu", "--elements", "4", "4", "2", "--order", "2",
            "--steps", "2", "--batch", "1", "--levels", "3", "--coarse-mp-layers", "1"]
    one = train_cli.main(argv)
    out = capsys.readouterr().out
    assert "multilevel hierarchy: 405 -> 32 -> 4 nodes per level" in out
    assert "levels=3" in out
    two = train_cli.main(argv + ["--ranks", "2", "1", "1", "--mp-schedule", "overlap"])
    assert abs(two["losses"][0] - one["losses"][0]) <= ML_LOSS * abs(one["losses"][0])
    assert abs(two["losses"][1] - one["losses"][1]) <= 1e-4 * abs(one["losses"][1])
    assert one["losses"][1] < one["losses"][0]


@pytest.fixture(scope="module")
def engine_ckpt(meshes, hierarchies, weights, tmp_path_factory):
    cfg = GNNConfig(**CFG)
    ml = hierarchies[(1, 1, 1)][1]
    fp = run_fingerprint(meshes[1], ml.levels[0], cfg, TrainConfig(), NMPPlan())
    ckdir = tmp_path_factory.mktemp("ml_serve") / "ck"
    ckpt.save(ckdir, 0, {"params": weights[1], "opt": {"m": torch.zeros(4)},
                         "rng": np.zeros(2, np.uint32)},
              extra={"fingerprint": fp})
    return ckdir


def test_engine_register_mesh_hierarchy(meshes, hierarchies, weights, engine_ckpt):
    """The checkpoint's config read back with its levels; streamed
    requests bitwise equal to the batch-1 offline reference, which is the
    stacked rollout's; a hierarchy of another rank count is refused."""
    sem, cfg = meshes[1], GNNConfig(**CFG)
    assert config_from_checkpoint(engine_ckpt) == dataclasses.replace(cfg, name="custom")
    ml = hierarchies[(1, 1, 1)][1]
    eng = InferenceEngine(engine_ckpt, cfg, EngineConfig(batch_slots=2, rollout_steps=2),
                          plan=NMPPlan(backend=FUSED, block_e=BLOCK_E), device="cpu")
    with pytest.raises(EngineError, match="rank"):
        eng.register_mesh(sem, hierarchy=hierarchies[(2, 2, 1)][1])
    h = eng.register_mesh(sem, hierarchy=ml)
    assert eng.entry(h).gs.n_levels == LEVELS
    snaps = [taylor_green_velocity(sem.coords, t=0.05 * i).astype(np.float32)
             for i in range(3)]
    with eng:
        futs = [eng.submit(h, x, step=i) for i, x in enumerate(snaps)]
        got = [f.result(60).preds for f in futs]
        want = [eng.offline_reference(h, x) for x in snaps]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    entry = eng.entry(h)
    x0 = torch.from_numpy(gather_node_features(entry.pg, snaps[1]))
    with torch.no_grad():
        _, pred = rollout_stacked(eng.params, x0, torch.zeros(2, *x0.shape),
                                  entry.gs, entry.plan, FY)
    np.testing.assert_array_equal(scatter_node_outputs(entry.pg, pred[0].numpy()),
                                  want[1][0])
