"""GraphCast in the torch port (``repro_torch.models.gnn_zoo.graphcast``)
against ``repro.models.gnn_zoo.graphcast`` on the same numpy inputs, with
weights drawn by ``repro``'s init and converted (``repro_torch.convert``).

* ``icosahedral_mesh`` (refinements 0..3), ``latlon_grid`` and
  ``grid2mesh_edges`` array-equal to ``repro``'s.
* The parameter tree round-trips (``proc`` stacked in ``repro``, a list of
  layers in the port); the port's own init has the converted tree's shapes.
* ``graphcast_forward`` on the port's fused backend (its plain versions on
  CPU tensors) and on its xla backend against ``repro``'s xla backend,
  within the reference's forward band (rtol 1e-4 / atol 1e-5): on
  ``tests/test_gnn_zoo.py``'s tiny graph at H in {4, 12, 32} x MLP hidden
  layers {1, 2}, on the weather example's graph at refinement 2, and with
  the V-cycle (3 levels); a loss gradient against ``jax.grad`` of
  ``repro``'s within the gradient band (rtol 1e-3 / atol 2e-5); ``remat``
  (per layer and per segment) gives the same values and gradients; a bf16
  carry within 2e-2 (relative L2) of ``repro``'s bf16 carry.

``edge_parallel_axes`` over a model axis is held in
``tests/test_torch_graphcast_dist.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import box_mesh as ref_box_mesh
from repro.core.coarsen import build_hierarchy as ref_build_hierarchy
from repro.core.graph_state import NMPPlan as RefPlan
from repro.core.graph_state import ShardedGraph as RefGraph
from repro.core.halo import NONE as REF_NONE
from repro.core.halo import HaloSpec as RefHalo
from repro.core.partition import partition_graph as ref_partition_graph
from repro.graph.datasets import cora_like
from repro.models.gnn_zoo import graphcast as ref_gc

from repro_torch import nn
from repro_torch.convert import graphcast_params_from_jax, graphcast_params_to_jax
from repro_torch.core.coarsen import build_hierarchy
from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
from repro_torch.core.halo import NONE, HaloSpec
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_graph
from repro_torch.models.gnn_zoo import graphcast as gc

RTOL, ATOL = 1e-4, 1e-5
G_RTOL, G_ATOL = 1e-3, 2e-5
BACKENDS = (FUSED, XLA)


def _ref_cfg(**kw):
    return ref_gc.GraphCastConfig(**kw)


def _port_cfg(ref_cfg):
    d = dataclasses.asdict(ref_cfg)
    d["act_dtype"] = torch.bfloat16 if ref_cfg.act_dtype == jnp.bfloat16 else torch.float32
    return gc.GraphCastConfig(**d)


@functools.lru_cache(maxsize=None)
def _weights(cfg, seed=0):
    """repro's init as numpy, and the port's tree of it on the CPU (drawn
    once per config and seed: the tests only read them)."""
    np_params = jax.tree.map(np.asarray, ref_gc.init_graphcast(jax.random.PRNGKey(seed), cfg))
    return np_params, graphcast_params_from_jax(np_params, "cpu")


@pytest.mark.parametrize("refinement", [0, 1, 2, 3])
def test_icosahedral_mesh_equal(refinement):
    v, e = gc.icosahedral_mesh(refinement)
    rv, re = ref_gc.icosahedral_mesh(refinement)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(e, re)


def test_latlon_grid_and_grid2mesh_equal():
    grid = gc.latlon_grid(19, 36)
    np.testing.assert_array_equal(grid, ref_gc.latlon_grid(19, 36))
    mesh, _ = gc.icosahedral_mesh(2)
    np.testing.assert_array_equal(gc.grid2mesh_edges(grid, mesh, k=3),
                                  ref_gc.grid2mesh_edges(grid, mesh, k=3))


@pytest.mark.parametrize("n_levels", [1, 3])
def test_param_tree_round_trips(n_levels):
    cfg = _ref_cfg(in_dim=5, hidden=8, n_layers=3, out_dim=2, mlp_hidden_layers=2,
                   n_levels=n_levels, coarse_mp_layers=1)
    np_params, params = _weights(cfg)
    assert len(params["proc"]) == 3
    back = graphcast_params_to_jax(params)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    own = gc.init_graphcast(torch.Generator().manual_seed(0), _port_cfg(cfg), device="cpu")
    shapes = lambda t: [tuple(l.shape) for l in nn.tree_leaves(t)]  # noqa: E731
    assert shapes(own) == shapes(params)


# ---------------------------------------------------------------------------
# graphs in both packages
# ---------------------------------------------------------------------------

def _both_graphs(n, edges, coords, backend):
    """A one-rank graph of ``edges`` in both packages: repro's as
    tests/test_gnn_zoo.py builds it (its xla backend needs no layout), the
    port's built with a plan of ``backend``."""
    pg = ref_partition_graph(n, edges, 1)
    ref_g = RefGraph.from_arrays({k: jnp.asarray(v) for k, v in pg.device_arrays().items()}
                                 ).rank(0)
    plan = NMPPlan(halo=HaloSpec(mode=NONE), backend=backend, block_e=32)
    port_pg = partition_graph(n, edges, 1)
    return pg, ref_g, plan, ShardedGraph.build(port_pg, coords, plan, device="cpu").rank(0)


def _tiny(backend):
    edges, feats, _ = cora_like(seed=0, n=80, m_und=240, d=16, n_classes=3)
    pg, ref_g, plan, g = _both_graphs(80, edges, np.zeros((80, 3)), backend)
    x = np.zeros((pg.n_pad, 16), np.float32)
    x[:80] = feats
    ef = np.ones((pg.e_pad, 4), np.float32) * pg.edge_mask[0][:, None]
    return x, ef, ref_g, plan, g


def _weather(backend, n_vars=6):
    edges, xyz, n_grid, _ = gc.weather_graph(2, 10, 18, k=3)
    pg, ref_g, plan, g = _both_graphs(xyz.shape[0], edges, xyz, backend)
    state = np.random.default_rng(0).normal(size=(n_grid, n_vars)).astype(np.float32)
    x, ef = gc.weather_inputs(state, xyz, n_grid, pg.n_pad, pg.edge_src[0], pg.edge_dst[0],
                              pg.edge_mask[0])
    return x, ef, ref_g, plan, g


GRAPHS = {"tiny": _tiny, "weather": _weather}


def _ref_forward(np_params, x, ef, ref_g, cfg):
    fn = jax.jit(lambda p, xx, ee: ref_gc.graphcast_forward(
        p, xx, ee, ref_g, RefPlan(halo=RefHalo(mode=REF_NONE)), cfg))
    return np.asarray(fn(jax.tree.map(jnp.asarray, np_params), jnp.asarray(x), jnp.asarray(ef)))


@functools.lru_cache(maxsize=None)
def _ref_out(graph, cfg, seed, grad=False):
    """repro's forward (or loss and gradient) on the ``graph`` of ``GRAPHS``
    from ``_weights(cfg, seed)``: computed once for both port backends."""
    x, ef, ref_g, _, _ = GRAPHS[graph](XLA)
    np_params, _ = _weights(cfg, seed)
    return (_ref_grad if grad else _ref_forward)(np_params, x, ef, ref_g, cfg)


def _port_forward(params, x, ef, g, plan, cfg):
    with torch.no_grad():
        return gc.graphcast_forward(params, torch.from_numpy(x), torch.from_numpy(ef), g,
                                    plan, _port_cfg(cfg)).numpy()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mlp_hidden_layers", [1, 2])
@pytest.mark.parametrize("hidden", [4, 12, 32])
def test_forward_matches_reference_tiny_graph(hidden, mlp_hidden_layers, backend):
    x, ef, _, plan, g = _tiny(backend)
    cfg = _ref_cfg(in_dim=16, hidden=hidden, n_layers=3, out_dim=4,
                   mlp_hidden_layers=mlp_hidden_layers)
    _, params = _weights(cfg, seed=hidden)
    got = _port_forward(params, x, ef, g, plan, cfg)
    want = _ref_out("tiny", cfg, hidden)
    assert got.shape == want.shape == (x.shape[0], 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_matches_reference_weather_graph(backend):
    """The weather example's three edge sets at refinement 2 (162 mesh
    nodes, a 10 x 18 grid)."""
    x, ef, _, plan, g = _weather(backend)
    cfg = _ref_cfg(in_dim=9, hidden=12, n_layers=2, out_dim=6, mlp_hidden_layers=1)
    _, params = _weights(cfg, seed=2)
    np.testing.assert_allclose(_port_forward(params, x, ef, g, plan, cfg),
                               _ref_out("weather", cfg, 2), rtol=RTOL, atol=ATOL)


def _ref_grad(np_params, x, ef, ref_g, cfg):
    def loss(p):
        y = ref_gc.graphcast_forward(p, jnp.asarray(x), jnp.asarray(ef), ref_g,
                                     RefPlan(halo=RefHalo(mode=REF_NONE)), cfg)
        return jnp.mean(y ** 2)
    val, g = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, np_params))
    return float(val), jax.tree.map(np.asarray, g)


def _port_grad(params, x, ef, g, plan, cfg):
    def loss(p):
        y = gc.graphcast_forward(p, torch.from_numpy(x), torch.from_numpy(ef), g, plan, cfg)
        return torch.mean(y ** 2)
    val, grads = nn.value_and_grad(loss, params)
    return float(val), grads


def _assert_grads_close(port_grads, ref_grads):
    got = graphcast_params_to_jax(port_grads)
    assert jax.tree.structure(got) == jax.tree.structure(ref_grads)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_grads)):
        np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("hidden,mlp_hidden_layers", [(4, 1), (12, 2)])
def test_loss_gradient_matches_jax_grad(hidden, mlp_hidden_layers, backend):
    x, ef, _, plan, g = _tiny(backend)
    cfg = _ref_cfg(in_dim=16, hidden=hidden, n_layers=2, out_dim=4,
                   mlp_hidden_layers=mlp_hidden_layers)
    _, params = _weights(cfg, seed=7)
    ref_val, ref_grads = _ref_out("tiny", cfg, 7, grad=True)
    val, grads = _port_grad(params, x, ef, g, plan, _port_cfg(cfg))
    assert val == pytest.approx(ref_val, rel=1e-5)
    _assert_grads_close(grads, ref_grads)


@pytest.mark.parametrize("remat_segment", [1, 2])
def test_remat_gives_the_same_values_and_gradients(remat_segment):
    x, ef, _, plan, g = _tiny(FUSED)
    cfg = _ref_cfg(in_dim=16, hidden=12, n_layers=4, out_dim=4, mlp_hidden_layers=1)
    _, params = _weights(cfg, seed=3)
    base = _port_cfg(cfg)
    remat = dataclasses.replace(base, remat=True, remat_segment=remat_segment)
    val, grads = _port_grad(params, x, ef, g, plan, base)
    rval, rgrads = _port_grad(params, x, ef, g, plan, remat)
    assert rval == val
    for a, b in zip(nn.tree_leaves(rgrads), nn.tree_leaves(grads)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat_segment"):
        _port_grad(params, x, ef, g, plan, dataclasses.replace(remat, remat_segment=3))


@pytest.mark.parametrize("backend", BACKENDS)
def test_multilevel_vcycle_matches_reference(backend):
    """``n_levels=3`` built as ``tests/test_gnn_zoo.py::
    test_graphcast_multilevel_vcycle`` builds its hierarchy (one rank;
    232 -> 16 -> 8 padded nodes): forward and loss gradient against
    repro's."""
    ref_mesh = ref_box_mesh((4, 2, 2), p=2)
    ref_ml = ref_build_hierarchy(ref_mesh, (1, 1, 1), 3)
    ref_plan = RefPlan(halo=RefHalo(mode=REF_NONE))
    ref_g = RefGraph.build(ref_ml.levels[0], ref_mesh.coords, ref_plan,
                           hierarchy=ref_ml).rank(0)
    mesh = box_mesh((4, 2, 2), p=2)
    ml = build_hierarchy(mesh, (1, 1, 1), 3)
    plan = NMPPlan(halo=HaloSpec(mode=NONE), backend=backend, block_e=32)
    g = ShardedGraph.build(ml.levels[0], mesh.coords, plan, hierarchy=ml, device="cpu").rank(0)
    cfg = _ref_cfg(in_dim=3, hidden=8, n_layers=2, out_dim=3, mlp_hidden_layers=1,
                   n_levels=3, coarse_mp_layers=1)
    np_params, params = _weights(cfg)
    x = np.random.default_rng(0).normal(size=(ml.levels[0].n_pad, 3)).astype(np.float32)
    ef = np.asarray(ref_g["static_edge_feats"])
    np.testing.assert_array_equal(ef, g["static_edge_feats"].numpy())
    np.testing.assert_allclose(_port_forward(params, x, ef, g, plan, cfg),
                               _ref_forward(np_params, x, ef, ref_g, cfg), rtol=RTOL, atol=ATOL)
    ref_val, ref_grads = _ref_grad(np_params, x, ef, ref_g, cfg)
    val, grads = _port_grad(params, x, ef, g, plan, _port_cfg(cfg))
    assert val == pytest.approx(ref_val, rel=1e-5)
    _assert_grads_close(grads, ref_grads)
    assert max(float(t.abs().max()) for t in nn.tree_leaves(grads["coarse"])) > 0


def test_bf16_carry_near_reference():
    """act_dtype=bf16: the carry between layers rounded to bf16 in both
    packages, each layer computing in fp32 on it; the rounding points
    agree, the summation orders do not (2e-2 relative L2, the bf16 band)."""
    x, ef, ref_g, plan, g = _tiny(XLA)
    cfg = _ref_cfg(in_dim=16, hidden=12, n_layers=3, out_dim=4, act_dtype=jnp.bfloat16)
    np_params, params = _weights(cfg, seed=5)
    got = _port_forward(params, x, ef, g, plan, cfg)
    want = _ref_forward(np_params, x, ef, ref_g, cfg).astype(np.float32)
    f32 = _port_forward(params, x, ef, g, plan, dataclasses.replace(cfg, act_dtype=jnp.float32))
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)
    assert np.linalg.norm(got - f32) > 0                 # the carry was rounded
