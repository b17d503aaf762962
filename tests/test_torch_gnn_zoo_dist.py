"""GAT, NequIP and MACE over gloo processes on the CPU: 4 graph ranks
under the packed neighbor exchange and all-to-all, and NequIP / MACE at
graph 2 x model 2 (edge-parallel), each process against the port's
one-rank run, from ``repro``'s weights; the one-rank run against
``repro``'s unsplit forward and loss.

One spawn of 4 processes for the file (a module fixture; every case's
records returned as numpy through ``repro_torch.launch.graphcast_checks.
run_world``, one job per arch), at the reference's smoke configs (GAT
``GATConfig(16, 4, 2, 4, 2)``, NequIP and MACE ``smoke_config()``) on
``cora_like(seed=1, n=64, m_und=200, d=16, n_classes=4)``; NequIP and
MACE read species, positions and a target drawn per global node
(``graphcast_checks.equivariant_data``).

Held: each process's eval-step rows (by global id) within rtol 1e-4 /
atol 1e-5 of the one-rank run, the first step's loss within 2e-6
(relative) and its gradients within rtol 1e-3 / atol 2e-5; every
process's losses and parameters after two AdamW steps equal, the second
step's loss within 1e-4 of the one-rank run's.  GAT's softmax shift
crosses ranks through the ``max`` exchange, which takes no gradient: its
gradients over 4 ranks show that the shift is exchanged detached.  The
workers import nothing of this file, of ``repro`` or of JAX.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_get_arch
from repro.core.graph_state import ShardedGraph as RefGraph
from repro.core.halo import HaloSpec as RefHalo
from repro.core.partition import partition_graph as ref_partition_graph
from repro.models.gnn_zoo import gat as ref_gat
from repro.models.gnn_zoo import mace as ref_mace
from repro.models.gnn_zoo import nequip as ref_nequip

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.graph_state import pad_edges
from repro_torch.core.partition import partition_graph
from repro_torch.graph.datasets import cora_like
from repro_torch.launch import graphcast_checks as gcx
from repro_torch.launch.mesh import to_host

F_RTOL, F_ATOL = 1e-4, 1e-5
LOSS_REL, G_RTOL, G_ATOL = 2e-6, 1e-3, 2e-5
TRAIN_REL = 1e-4
GRAPH = dict(seed=1, n=64, m_und=200, d=16, n_classes=4)
ARCHS = ("gat-cora", "nequip", "mace")
REF_INIT = {"gat-cora": lambda cfg: ref_gat.init_gat(jax.random.PRNGKey(0), cfg),
            "nequip": lambda cfg: ref_nequip.init_nequip(jax.random.PRNGKey(0), cfg),
            "mace": lambda cfg: ref_mace.init_mace(jax.random.PRNGKey(0), cfg)}


def _cases(arch):
    tag = arch.split("-")[0]
    cases = tuple(gcx.Case(f"{tag}_g4_{mode}", graph=4, mode=mode)
                  for mode in ("packed", "a2a"))
    if arch != "gat-cora":
        cases += (gcx.Case(f"{tag}_g2m2", graph=2, model=2, mode="packed"),)
    return cases


CASES = {c.name: (arch, c) for arch in ARCHS for c in _cases(arch)}


def _configs(arch):
    """(the port's config, the reference's) at the smoke size."""
    mod, _ = get_arch(arch)
    ref_mod, _ = ref_get_arch(arch)
    if arch == "gat-cora":
        kw = dict(in_dim=GRAPH["d"], hidden=4, heads=2, n_classes=GRAPH["n_classes"],
                  n_layers=2)
        return mod.GATConfig(**kw), ref_gat.GATConfig(**kw)
    return mod.smoke_config(), ref_mod.smoke_config()


@functools.lru_cache(maxsize=None)
def _job(arch):
    """repro's weights (numpy) and the arch's job with them in the port."""
    cfg, rcfg = _configs(arch)
    np_params = jax.tree.map(np.asarray, REF_INIT[arch](rcfg))
    port = to_host(params_from_jax(np_params, "cpu"))
    return gcx.Job(cases=_cases(arch), cfg=dataclasses.asdict(cfg), graph=GRAPH,
                   params=port, device="cpu", arch=arch), np_params


@pytest.fixture(scope="module")
def r1():
    return {arch: to_host(gcx.run_case(_job(arch)[0], gcx.Case("r1"))) for arch in ARCHS}


@pytest.fixture(scope="module")
def world4():
    return gcx.run_world([_job(arch)[0] for arch in ARCHS], 4)


def _rows(rec):
    """{global id: row} of a process's prediction."""
    m = rec["node_mask"] > 0
    return dict(zip(rec["global_ids"][m].tolist(), rec["pred"][m]))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("name", list(CASES))
def test_predictions_match_one_rank(world4, r1, name):
    arch, _ = CASES[name]
    want = _rows(r1[arch])
    seen = set()
    for p in world4:
        for gid, row in _rows(p[name]).items():
            np.testing.assert_allclose(row, want[gid], rtol=F_RTOL, atol=F_ATOL)
            seen.add(gid)
    assert seen == set(want)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_one_rank(world4, r1, name):
    arch, _ = CASES[name]
    for p in world4:
        rec = p[name]
        assert _rel(rec["loss0"], r1[arch]["loss0"]) <= LOSS_REL
        for a, b in zip(rec["grads0"], r1[arch]["grads0"]):
            np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_ATOL)
    assert max(float(np.abs(g).max()) for g in r1[arch]["grads0"]) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_training_steps_agree_everywhere(world4, r1, name):
    arch, case = CASES[name]
    procs = [p[name] for p in world4]
    assert all(p["losses"] == procs[0]["losses"] for p in procs)
    assert len({p["params_sum"] for p in procs}) == 1
    losses = procs[0]["losses"]
    assert _rel(losses[0], r1[arch]["losses"][0]) <= LOSS_REL
    assert _rel(losses[1], r1[arch]["losses"][1]) <= TRAIN_REL
    assert losses[1] != losses[0]
    assert {(p["rank"], p["shard"]) for p in procs} == \
        {(r, s) for r in range(case.graph) for s in range(case.model)}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_matches_repro_unsplit(r1, arch):
    """The one-rank run's rows and first loss against ``repro``'s forward
    and cell loss on the unsplit graph (jitted)."""
    job, np_params = _job(arch)
    cfg, rcfg = _configs(arch)
    edges, _, _ = cora_like(**GRAPH)
    ref_pg = ref_partition_graph(GRAPH["n"], edges, 1)
    pg = pad_edges(partition_graph(GRAPH["n"], edges, 1))
    arrays = {k: jnp.asarray(v) for k, v in pg.device_arrays().items()}
    graph = RefGraph.from_arrays(arrays).rank(0)
    inputs = {k: jnp.asarray(v[0]) for k, v in gcx.inputs_of(job, cfg, pg).items()}
    halo = RefHalo(mode="none")
    if arch == "gat-cora":
        fwd = jax.jit(lambda p, i: ref_gat.gat_forward(p, i["x"], graph, halo, rcfg))
    else:
        f = {"nequip": ref_nequip.nequip_forward, "mace": ref_mace.mace_forward}[arch]
        fwd = jax.jit(lambda p, i: f(p, i["species"], i["pos"], graph, halo, rcfg))
    out = np.asarray(fwd(jax.tree.map(jnp.asarray, np_params), inputs))
    m = pg.node_mask[0] > 0
    want = dict(zip(pg.global_ids[0][m].tolist(), out[m]))
    got = _rows(r1[arch])
    assert set(got) == set(want)
    for gid, row in got.items():
        np.testing.assert_allclose(row, want[gid], rtol=F_RTOL, atol=F_ATOL)
    assert ref_pg.n_pad == pg.n_pad
