"""The port's architecture registry and config modules against
``repro.configs``: ``paper_gnn``'s three configs and GraphCast's field by
field, the registry's entries and families, and the paper's smoke config
run as ``tests/test_arch_smoke.py::test_paper_gnn_smoke`` runs it (2x2x1
elements of order 2 split (2, 1, 1), the A2A exchange, the stacked loss and
gradient) held to ``repro``'s xla backend from ``repro``'s weights: loss
within 2e-6 (relative), predictions rtol 1e-4 / atol 1e-5, gradients rtol
1e-3 / atol 2e-5 — on the port's fused backend (its plain versions on CPU
tensors: H=4 is a width only the generic-width kernels take on a card) and
its xla one.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as ref_configs
from repro.configs import graphcast as ref_graphcast
from repro.configs import paper_gnn as ref_paper_gnn
from repro.core import NMPPlan as RefPlan
from repro.core import ShardedGraph as RefGraph
from repro.core import box_mesh as ref_box_mesh
from repro.core import init_gnn as ref_init_gnn
from repro.core import partition_mesh as ref_partition_mesh
from repro.core import taylor_green_velocity as ref_tgv
from repro.core.halo import A2A as REF_A2A
from repro.core.halo import HaloSpec as RefHalo
from repro.core.partition import gather_node_features as ref_gather
from repro.core.reference import loss_and_grad_stacked as ref_loss_and_grad

from repro_torch import configs
from repro_torch.configs import graphcast, paper_gnn
from repro_torch.convert import params_from_jax
from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
from repro_torch.core.halo import A2A, HaloSpec
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import gather_node_features, partition_mesh
from repro_torch.core.reference import loss_and_grad_stacked
from repro_torch.nn import tree_leaves


@pytest.mark.parametrize("name", ["config", "small_config", "smoke_config"])
def test_paper_gnn_configs_equal_reference(name):
    got = dataclasses.asdict(getattr(paper_gnn, name)())
    want = dataclasses.asdict(getattr(ref_paper_gnn, name)())
    assert got == want
    assert (paper_gnn.ARCH_ID, paper_gnn.FAMILY) == (ref_paper_gnn.ARCH_ID, ref_paper_gnn.FAMILY)


@pytest.mark.parametrize("name,args", [
    ("config", ()), ("config", ({"kind": "molecule"},)),
    ("config", ({"kind": "full", "d_feat": 602, "n_classes": 41},)),
    ("weather_config", ()), ("weather_config", (5,)), ("smoke_config", ())])
def test_graphcast_configs_equal_reference(name, args):
    got = dataclasses.asdict(getattr(graphcast, name)(*args))
    want = dataclasses.asdict(getattr(ref_graphcast, name)(*args))
    assert str(got.pop("act_dtype")).split(".")[-1] == jnp.dtype(want.pop("act_dtype")).name
    assert got == want
    assert (graphcast.ARCH_ID, graphcast.FAMILY, graphcast.EDGE_IN) == \
        (ref_graphcast.ARCH_ID, ref_graphcast.FAMILY, ref_graphcast.EDGE_IN)


def test_registry_entries_and_families_match_reference():
    for arch in configs.ARCHS:
        assert arch in ref_configs.ARCHS, arch
        assert configs.family_of(arch) == ref_configs.family_of(arch)
        module, family = configs.get_arch(arch)
        assert module.ARCH_ID == arch and family == ref_configs.family_of(arch)
    assert {"paper-gnn", "graphcast"} <= set(configs.ARCHS)
    assert configs.assigned_archs() == [a for a in ref_configs.assigned_archs()
                                        if a in configs.ARCHS]
    assert "paper-gnn" not in configs.assigned_archs()


@functools.lru_cache(maxsize=1)
def _ref_smoke():
    cfg = ref_paper_gnn.smoke_config()
    mesh = ref_box_mesh((2, 2, 1), p=2)
    pg = ref_partition_mesh(mesh, (2, 1, 1))
    params = ref_init_gnn(jax.random.PRNGKey(0), cfg)
    plan = RefPlan(halo=RefHalo(mode=REF_A2A))
    graph = RefGraph.build(pg, mesh.coords, plan)
    x = jnp.asarray(ref_gather(pg, ref_tgv(mesh.coords)))
    fn = jax.jit(lambda p, xx: ref_loss_and_grad(p, xx, xx, graph, plan, cfg.node_out))
    loss, y, grads = fn(params, x)
    return params, np.asarray(x), float(loss), np.asarray(y), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("backend", [FUSED, XLA])
def test_paper_gnn_smoke_matches_reference(backend):
    ref_params, ref_x, ref_loss, ref_y, ref_grads = _ref_smoke()
    arch, family = configs.get_arch("paper-gnn")
    cfg = arch.smoke_config()
    assert family == "gnn" and cfg.hidden == 4
    mesh = box_mesh((2, 2, 1), p=2)
    pg = partition_mesh(mesh, (2, 1, 1))
    plan = NMPPlan(halo=HaloSpec(mode=A2A), backend=backend)
    graph = ShardedGraph.build(pg, mesh.coords, plan, device="cpu")
    x = torch.from_numpy(np.asarray(gather_node_features(
        pg, taylor_green_velocity(mesh.coords)), dtype=np.float32))
    np.testing.assert_array_equal(x.numpy(), ref_x)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    loss, y, grads = loss_and_grad_stacked(params, x, x, graph, plan, cfg.node_out)
    assert float(loss) == pytest.approx(ref_loss, rel=2e-6)
    np.testing.assert_allclose(y.numpy(), ref_y, rtol=1e-4, atol=1e-5)
    got = tree_leaves(grads)
    want = jax.tree.leaves(ref_grads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=2e-5)
