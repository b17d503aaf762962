"""Model-level parity of the torch port against the JAX reference package:
MLP blocks, the 1-rank forward for both port backends, the stacked R-rank
forward under the canonical A2A oracle and the packed neighbor exchange,
and the port's own 1-rank == R-rank guarantee (Eq. 2).

Inputs are made with numpy from a seed and JAX-initialized params are
crossed into the port through ``repro_torch.convert``.  Band: rtol 1e-4 /
atol 1e-5, the one the reference holds its own forward paths to.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import nn as ref_nn
from repro.core import GNNConfig as RefConfig
from repro.core import NMPPlan as RefPlan
from repro.core import ShardedGraph as RefGraph
from repro.core import box_mesh as ref_box_mesh
from repro.core import gnn_forward as ref_gnn_forward
from repro.core import init_gnn as ref_init_gnn
from repro.core import partition_mesh as ref_partition_mesh
from repro.core.halo import halo_sync_reference as ref_halo_sync_reference
from repro.core.halo import halo_sync_stacked as ref_halo_sync_stacked
from repro.core.reference import gnn_forward_stacked as ref_forward_stacked

from repro_torch import nn
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.consistent_loss import consistent_mse
from repro_torch.core.gnn import GNNConfig, gnn_forward, init_gnn
from repro_torch.core.graph_state import (
    FUSED, XLA, NMPPlan, ShardedGraph, registered_nmp_impls)
from repro_torch.core.halo import (
    A2A, NEIGHBOR, NONE, halo_sync_reference, halo_sync_stacked)
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import (
    gather_node_features, partition_mesh, scatter_node_outputs)
from repro_torch.core.reference import gnn_forward_stacked

RTOL, ATOL = 1e-4, 1e-5
ELEMS = (4, 2, 2)


@pytest.fixture(scope="module", params=[(8, 2), (32, 5)],
                ids=["h8", "h32"])
def case(request):
    hidden, layers = request.param
    cfg = RefConfig(hidden=hidden, n_mp_layers=2, mlp_hidden_layers=layers)
    np_params = jax.tree.map(np.asarray, ref_init_gnn(jax.random.PRNGKey(0), cfg))
    sem = ref_box_mesh(ELEMS, p=2)
    x = np.random.default_rng(hidden).normal(size=(sem.n_nodes, 3)).astype(np.float32)
    return dict(np_params=np_params, sem=sem, x=x,
                params=params_from_jax(np_params, "cpu"))


def _ref_forward(case, grid, sync_mode=None):
    """The reference's prediction scattered to the global mesh."""
    sem, x = case["sem"], case["x"]
    pg = ref_partition_mesh(sem, grid)
    params = jax.tree.map(jnp.asarray, case["np_params"])
    xs = jnp.asarray(gather_node_features(pg, x))
    if sync_mode is None:
        plan = RefPlan()
        y = ref_gnn_forward(params, xs[0], RefGraph.build(pg, sem.coords, plan)
                            .rank(0), plan)[None]
    else:
        plan = RefPlan.build(pg, sync_mode)
        y = ref_forward_stacked(params, xs, RefGraph.build(pg, sem.coords, plan),
                                plan, sync_fn=ref_halo_sync_stacked)
    return scatter_node_outputs(pg, np.asarray(y))


def _port_stacked(case, grid, backend, mode, packed=False, sync_fn=None):
    sem, x = case["sem"], case["x"]
    pg = partition_mesh(box_mesh(ELEMS, p=2), grid)
    plan = NMPPlan.build(pg, mode, packed=packed, backend=backend, block_e=32)
    graph = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
    xs = torch.from_numpy(gather_node_features(pg, x))
    y = gnn_forward_stacked(case["params"], xs, graph, plan, sync_fn=sync_fn)
    return pg, scatter_node_outputs(pg, y.numpy())


def test_mlp_and_layernorm_match_reference():
    rng = np.random.default_rng(0)
    p = ref_nn.init_mlp(jax.random.PRNGKey(1), 7, [16, 16], 5)
    x = rng.normal(size=(11, 7)).astype(np.float32)
    want = np.asarray(ref_nn.mlp(p, jnp.asarray(x)))
    got = nn.mlp(params_from_jax(jax.tree.map(np.asarray, p), "cpu"),
                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_init_and_convert_keep_reference_tree():
    cfg = RefConfig(hidden=8, n_mp_layers=2, mlp_hidden_layers=2)
    ref = jax.tree.map(np.asarray, ref_init_gnn(jax.random.PRNGKey(0), cfg))
    port = init_gnn(torch.Generator().manual_seed(0),
                    GNNConfig(hidden=8, n_mp_layers=2, mlp_hidden_layers=2),
                    device="cpu")
    a = jax.tree_util.tree_flatten_with_path(ref)[0]
    b = jax.tree_util.tree_flatten_with_path(params_to_jax(port))[0]
    assert [k for k, _ in a] == [k for k, _ in b]
    assert all(u.shape == v.shape and u.dtype == v.dtype
               for (_, u), (_, v) in zip(a, b))
    back = params_to_jax(params_from_jax(ref, "cpu"))
    assert all(np.array_equal(u, v) for (_, u), (_, v) in
               zip(a, jax.tree_util.tree_flatten_with_path(back)[0]))


@pytest.mark.parametrize("backend", [XLA, FUSED])
def test_one_rank_forward_matches_reference(case, backend):
    want = _ref_forward(case, (1, 1, 1))
    pg = partition_mesh(box_mesh(ELEMS, p=2), (1, 1, 1))
    plan = NMPPlan(backend=backend, block_e=32)
    graph = ShardedGraph.build(pg, case["sem"].coords, plan, device="cpu")
    x = torch.from_numpy(gather_node_features(pg, case["x"])[0])
    y = gnn_forward(case["params"], x, graph.rank(0), plan)
    np.testing.assert_allclose(scatter_node_outputs(pg, y[None].numpy()), want,
                               rtol=RTOL, atol=ATOL)
    # a batch runs slot by slot: each slot bitwise equal to its batch-1 run
    yb = gnn_forward(case["params"], torch.stack([x, 2 * x]), graph.rank(0), plan)
    assert torch.equal(yb[0], y)


@pytest.mark.parametrize("backend", [XLA, FUSED])
@pytest.mark.parametrize("exchange", ["a2a_reference", "packed_neighbor"])
def test_four_rank_stacked_forward_matches_reference(case, backend, exchange):
    # the reference runs its dense neighbor format, bitwise equal to its
    # packed one by its own tests
    want = _ref_forward(case, (2, 2, 1), sync_mode=NEIGHBOR)
    if exchange == "a2a_reference":
        _, got = _port_stacked(case, (2, 2, 1), backend, A2A)
    else:
        _, got = _port_stacked(case, (2, 2, 1), backend, NEIGHBOR, packed=True,
                               sync_fn=halo_sync_stacked)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid", [(2, 2, 1), (4, 1, 1)])
def test_port_one_rank_equals_four_ranks(case, grid):
    _, y1 = _port_stacked(case, (1, 1, 1), FUSED, NONE)
    _, y4 = _port_stacked(case, grid, FUSED, NEIGHBOR, packed=True,
                          sync_fn=halo_sync_stacked)
    np.testing.assert_allclose(y4, y1, rtol=RTOL, atol=ATOL)
    # the inconsistent baseline (no exchange) does NOT agree
    _, y0 = _port_stacked(case, grid, FUSED, NONE)
    assert np.abs(y0 - y1).max() > 1e-3


def test_halo_exchanges_bitwise_match_reference():
    sem = ref_box_mesh(ELEMS, p=2)
    ref_pg = ref_partition_mesh(sem, (2, 2, 1))
    pg = partition_mesh(box_mesh(ELEMS, p=2), (2, 2, 1))
    a = np.random.default_rng(5).normal(size=(pg.R, pg.n_pad, 8)).astype(np.float32)
    ta = torch.from_numpy(a)
    for mode, packed in ((A2A, False), (NEIGHBOR, False), (NEIGHBOR, True)):
        rplan = RefPlan.build(ref_pg, mode)
        ref_g = RefGraph.build(ref_pg, sem.coords, rplan)
        want = np.asarray(ref_halo_sync_stacked(jnp.asarray(a), ref_g, rplan.halo))
        plan = NMPPlan.build(pg, mode, packed=packed)
        g = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
        got = halo_sync_stacked(ta, g, plan.halo).numpy()
        assert np.array_equal(got, want), (mode, packed)
        # the canonical-order oracle reads only the a2a arrays
        want = np.asarray(ref_halo_sync_reference(jnp.asarray(a), ref_g,
                                                  rplan.halo))
        assert np.array_equal(halo_sync_reference(ta, g, plan.halo).numpy(),
                              want)


def test_consistent_mse_partition_invariant(case):
    pg1, y1 = _port_stacked(case, (1, 1, 1), XLA, NONE)
    pg4 = partition_mesh(box_mesh(ELEMS, p=2), (2, 2, 1))
    tgt = np.zeros_like(y1)
    losses = []
    for pg in (pg1, pg4):
        y = torch.from_numpy(gather_node_features(pg, y1))
        t = torch.from_numpy(gather_node_features(pg, tgt))
        w = torch.from_numpy(pg.node_inv_mult)
        err = consistent_mse(y, t, w) * pg.R    # batch-mean over ranks undone
        losses.append(float(err))
    assert abs(losses[0] - losses[1]) < 1e-6 * max(1.0, abs(losses[0]))


def test_registry_cells_and_unported_paths():
    assert registered_nmp_impls() == ((FUSED, "blocking"), (FUSED, "overlap"),
                                      (XLA, "blocking"), (XLA, "overlap"))
    plan = NMPPlan(schedule="auto")
    with pytest.raises(TypeError, match="ShardedGraph"):      # auto needs a graph
        plan.autotune()
    assert NMPPlan().autotune() == NMPPlan()
    with pytest.raises(ValueError, match="backend"):
        NMPPlan(backend="pallas")
