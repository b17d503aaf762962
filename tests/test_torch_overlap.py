"""The overlap schedule of the torch port (interior/boundary split) against
the JAX reference package and against the port's own blocking schedule.

* ``interior_split`` array-equal to ``repro``'s, every key (``interior_frac``
  too), and ``segment_layout(part=)``'s ``perm`` / ``src`` / ``dst``
  array-equal for the ``int`` and ``bnd`` sides, at grids (1,1,1), (4,1,1)
  and (2,2,1).
* The port's stacked overlap forward, Eq. 6 loss and gradients (plain
  backend, and the fused backend on its plain versions) against
  ``repro``'s xla overlap ``loss_and_grad_stacked`` from the same weights,
  and against the port's blocking schedule, within the bands
  ``tests/test_consistency.py`` holds the reference's overlap to: values
  rtol 1e-4 / atol 1e-5, loss rel 1e-6, gradients rtol 2e-3 / atol 2e-4.
  ``repro``'s fused overlap does not trace on this JAX (``pl.load`` was
  removed), so the port is held against ``repro``'s xla overlap.
* One rank: the boundary side is empty (one tile of ``perm == -1``, an
  all-zero ``rowptr``) and contributes exact zeros, forward and backward.
* An overlap plan on a graph built without the split raises, naming it.
* Through ``torch.distributed`` (4 gloo processes, the (2,2,1) split,
  ``launch/consistency.py`` with ``Job.schedules``): each mode's overlap
  loss and gradients within the reference check's bands of the port's R=1
  (loss rel 2e-6, gradients rtol 1e-3 / atol 2e-5), each rank's forward
  bitwise equal to its slice of the stacked overlap forward, the forward's
  exchanges posted and finished after the interior side, the gradient
  run's blocking; and training with ``--mp-schedule overlap``.

Inputs are numpy from a seed; weights are ``repro``'s, crossed through
``repro_torch.convert``.
"""
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
from repro.core import partition_mesh as ref_partition_mesh
from repro.core.reference import loss_and_grad_stacked as ref_loss_and_grad

from repro_torch import nn
from repro_torch.convert import params_from_jax
from repro_torch.core.consistent_mp import (
    edge_update_aggregate, edge_update_aggregate_part)
from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
from repro_torch.core.halo import A2A, NEIGHBOR, NONE, halo_sync_stacked
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import gather_node_features, partition_mesh
from repro_torch.core.reference import gnn_forward_stacked, loss_and_grad_stacked
from repro_torch.launch import consistency as cons
from repro_torch.launch import train as train_cli

ELEMS, ORDER, BLOCK_E = (4, 2, 2), 2, 32
GRIDS = [(1, 1, 1), (4, 1, 1), (2, 2, 1)]
RTOL, ATOL = 1e-4, 1e-5
LOSS_REL = 1e-6
G_RTOL, G_ATOL = 2e-3, 2e-4
# (grid, halo mode, packed): the reference's overlap cells, and the port's
# packed neighbor exchange (its mode-faithful emulator) against the same
# reference
CASES = [((1, 1, 1), NONE, False), ((4, 1, 1), A2A, False),
         ((2, 2, 1), A2A, False), ((2, 2, 1), NEIGHBOR, True)]
CASE_IDS = ["1x1x1_none", "4x1x1_a2a", "2x2x1_a2a", "2x2x1_packed"]
SPLIT_KEYS = ("node_bnd_mask", "edge_bnd_mask", "edge_int_mask", "edge_bnd_idx",
              "edge_bnd_valid", "edge_int_idx", "edge_int_valid", "interior_frac")


@pytest.fixture(scope="module")
def meshes():
    return ref_box_mesh(ELEMS, p=ORDER), box_mesh(ELEMS, p=ORDER)


@pytest.fixture(scope="module")
def weights():
    cfg = RefConfig(hidden=8, n_mp_layers=2, mlp_hidden_layers=2)
    np_params = jax.tree.map(np.asarray, ref_init_gnn(jax.random.PRNGKey(0), cfg))
    return cfg, np_params, params_from_jax(np_params, "cpu")


@pytest.fixture(scope="module")
def reference(meshes, weights):
    """``repro``'s xla overlap loss, prediction and gradients per case."""
    sem = meshes[0]
    cfg, np_params, _ = weights
    params = jax.tree.map(jnp.asarray, np_params)
    x_global = taylor_green_velocity(sem.coords)
    out = {}
    for grid, mode, packed in CASES:
        pg = ref_partition_mesh(sem, grid)
        plan = RefPlan.build(pg, mode, schedule="overlap")
        graph = RefGraph.build(pg, sem.coords, plan)
        x = jnp.asarray(gather_node_features(pg, x_global))
        # the reference's stacked loss runs its canonical-order oracle
        loss, y, grads = ref_loss_and_grad(params, x, x, graph, plan, cfg.node_out)
        out[(grid, mode, packed)] = (float(loss), np.asarray(y),
                                     [np.asarray(g) for g in jax.tree.leaves(grads)])
    return out


def _port(meshes, weights, grid, mode, packed, backend, schedule):
    sem = meshes[1]
    cfg, _, params = weights
    pg = partition_mesh(sem, grid)
    plan = NMPPlan.build(pg, mode, packed=packed, backend=backend, schedule=schedule,
                         block_e=BLOCK_E)
    graph = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
    x = torch.from_numpy(gather_node_features(pg, taylor_green_velocity(sem.coords)))
    loss, y, grads = loss_and_grad_stacked(
        params, x, x, graph, plan, cfg.node_out,
        sync_fn=halo_sync_stacked if packed else None)
    return float(loss), y.numpy(), [g.numpy() for g in nn.tree_leaves(grads)]


def _close(got, want):
    (lg, yg, gg), (lw, yw, gw) = got, want
    assert abs(lg - lw) <= LOSS_REL * max(1.0, abs(lw)), (lg, lw)
    np.testing.assert_allclose(yg, yw, rtol=RTOL, atol=ATOL)
    assert len(gg) == len(gw)
    for a, b in zip(gg, gw):
        np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("grid", GRIDS, ids=["x".join(map(str, g)) for g in GRIDS])
def test_interior_split_matches_reference(meshes, grid):
    want = ref_partition_mesh(meshes[0], grid).interior_split()
    pg = partition_mesh(meshes[1], grid)
    got = pg.interior_split()
    assert set(got) == set(want) == set(SPLIT_KEYS)
    for k in SPLIT_KEYS:
        if k == "interior_frac":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert pg.interior_split() is got        # memoised
    if grid == (1, 1, 1):
        assert got["interior_frac"] == 1.0 and not got["edge_bnd_mask"].any()
    else:
        assert 0.0 < got["interior_frac"] < 1.0


@pytest.mark.parametrize("part", ["int", "bnd"])
@pytest.mark.parametrize("grid", GRIDS, ids=["x".join(map(str, g)) for g in GRIDS])
def test_segment_layout_parts_match_reference(meshes, grid, part):
    want = ref_partition_mesh(meshes[0], grid).segment_layout(16, BLOCK_E, part=part)
    pg = partition_mesh(meshes[1], grid)
    got = pg.segment_layout(16, BLOCK_E, part=part)
    for k in ("perm", "src", "dst"):
        assert np.array_equal(got[k], want[k]), k
    assert got["n_tiles"] == want["n_tiles"]
    # the port-only keys: each rank's runs cover exactly the side's edges
    keep = pg.interior_split()[f"edge_{part}_mask"]
    for r in range(pg.R):
        n_side = int(keep[r].sum())
        assert got["rowptr"][r, -1] == n_side
        assert np.array_equal(np.sort(got["perm"][r].reshape(-1)[:n_side]),
                              np.nonzero(keep[r] > 0)[0])
        assert np.array_equal(np.sort(got["src_slots"][r, :n_side]), np.arange(n_side))
    with pytest.raises(ValueError, match="part"):
        pg.segment_layout(16, BLOCK_E, part="halo")


@pytest.mark.parametrize("backend", [XLA, FUSED])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_overlap_matches_reference_xla_overlap(meshes, weights, reference, case, backend):
    got = _port(meshes, weights, *case, backend, "overlap")
    _close(got, reference[case])


@pytest.mark.parametrize("backend", [XLA, FUSED])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_overlap_matches_port_blocking(meshes, weights, case, backend):
    overlap = _port(meshes, weights, *case, backend, "overlap")
    blocking = _port(meshes, weights, *case, backend, "blocking")
    _close(overlap, blocking)


@pytest.mark.parametrize("backend", [XLA, FUSED])
def test_one_rank_boundary_side_is_empty(meshes, weights, backend):
    sem = meshes[1]
    pg = partition_mesh(sem, (1, 1, 1))
    plan = NMPPlan.build(pg, NONE, backend=backend, schedule="overlap", block_e=BLOCK_E)
    g = ShardedGraph.build(pg, sem.coords, plan, device="cpu").rank(0)
    if backend == FUSED:
        assert tuple(g["seg_perm_bnd"].shape) == (1, BLOCK_E)
        assert bool((g["seg_perm_bnd"] == -1).all())
        assert not bool(g["seg_rowptr_bnd"].any())
    lp = weights[2]["mp"][0]
    gen = np.random.default_rng(3)
    x = torch.from_numpy(gen.normal(size=(pg.n_pad, 8)).astype(np.float32)).requires_grad_()
    e = torch.from_numpy(gen.normal(size=(pg.e_pad, 8)).astype(np.float32)).requires_grad_()
    e_b, agg_b = edge_update_aggregate_part(lp, x, e, g, "bnd", plan)
    e_i, agg_i = edge_update_aggregate_part(lp, x, e, g, "int", plan)
    assert not bool(e_b.any()) and not bool(agg_b.any())
    gx, ge = torch.autograd.grad((e_b.sum() + agg_b.sum()), (x, e), allow_unused=True)
    assert gx is None or not bool(gx.any())
    assert ge is None or not bool(ge.any())
    # the interior side is every edge: the blocking aggregate
    blocking = NMPPlan.build(pg, NONE, backend=backend, block_e=BLOCK_E)
    gb = ShardedGraph.build(pg, sem.coords, blocking, device="cpu").rank(0)
    e_full, agg_full = edge_update_aggregate(lp, x, e, gb, blocking)
    np.testing.assert_allclose(agg_i.detach().numpy(), agg_full.detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(e_i.detach().numpy(), e_full.detach().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", [XLA, FUSED])
def test_overlap_without_split_arrays_raises(meshes, weights, backend):
    sem = meshes[1]
    cfg, _, params = weights
    pg = partition_mesh(sem, (2, 1, 1))
    blocking = NMPPlan.build(pg, A2A, backend=backend, block_e=BLOCK_E)
    graph = ShardedGraph.build(pg, sem.coords, blocking, device="cpu")
    x = torch.from_numpy(gather_node_features(pg, taylor_green_velocity(sem.coords)))
    overlap = NMPPlan.build(pg, A2A, backend=backend, schedule="overlap", block_e=BLOCK_E)
    with pytest.raises(ValueError, match="split"):
        loss_and_grad_stacked(params, x, x, graph, overlap, cfg.node_out)


# ---------------------------------------------------------------------------
# through torch.distributed
# ---------------------------------------------------------------------------

DIST_GRID = (2, 2, 1)
DIST_MODES = ("a2a", "neighbor", "packed", "none")


@pytest.fixture(scope="module")
def dist_job():
    return cons.Job(elements=(4, 4, 2), order=2, device="cpu", modes=DIST_MODES,
                    schedules=("blocking", "overlap"), cases=((DIST_GRID, 1),))


@pytest.fixture(scope="module")
def world(dist_job):
    procs = cons.run_world(dist_job, 4)
    return [p[cons.case_name(DIST_GRID, 1)] for p in procs]


@pytest.mark.parametrize("mode", DIST_MODES)
@pytest.mark.parametrize("backend", [XLA, FUSED])
def test_distributed_overlap_matches_one_rank(world, dist_job, backend, mode):
    base = cons.baseline(dist_job)
    recs = [p["steps_overlap"][(backend, mode)] for p in world]
    cons.check_step(recs, base, mode)
    blocking = float(world[0]["steps"][(backend, mode)]["loss"])
    assert abs(float(recs[0]["loss"]) - blocking) <= 2e-6 * abs(blocking)


@pytest.mark.parametrize("mode", ["a2a", "neighbor", "packed"])
@pytest.mark.parametrize("backend", [XLA, FUSED])
def test_distributed_overlap_forward_bitwise_stacked(world, dist_job, backend, mode):
    sem = box_mesh(dist_job.elements, p=dist_job.order)
    pg = partition_mesh(sem, DIST_GRID)
    plan = cons.plan_for(pg, mode, backend, "overlap")
    g = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
    x = torch.from_numpy(gather_node_features(pg, taylor_green_velocity(sem.coords)))
    params = cons._params(dist_job, "cpu")
    with torch.no_grad():
        want = gnn_forward_stacked(params, x, g, plan, sync_fn=halo_sync_stacked)
    for p in world:
        assert np.array_equal(p["steps_overlap"][(backend, mode)]["pred"][0, 0],
                              want[p["rank"]].numpy())


@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
def test_distributed_exchanges_by_schedule(world, dist_job, schedule):
    """The forward (no gradient) posts every exchange, and the overlap
    schedule finishes each after queueing the interior side; the gradient
    run finishes each exchange, forward and reversal, as soon as it is
    posted."""
    layers = dist_job.cfg.n_mp_layers
    for p in world:
        rec = p[cons.steps_key(schedule)][(FUSED, "packed")]
        assert rec["fwd_exchanges"] == {
            "posted": layers, "overlapped": layers if schedule == "overlap" else 0}
        assert rec["grad_exchanges"] == {"posted": 2 * layers, "overlapped": 0}
        none = p[cons.steps_key(schedule)][(FUSED, "none")]
        assert none["fwd_exchanges"] == {"posted": 0, "overlapped": 0}


def test_train_cli_overlap_matches_blocking(capsys):
    argv = ["--device", "cpu", "--elements", "2", "2", "1", "--order", "2",
            "--steps", "2", "--batch", "1"]
    blocking = train_cli.main(argv)
    overlap = train_cli.main(argv + ["--mp-schedule", "overlap"])
    assert "schedule=overlap" in capsys.readouterr().out
    assert overlap["schedule"] == "overlap"
    for a, b in zip(overlap["losses"], blocking["losses"]):
        assert abs(a - b) <= 1e-4 * abs(b)
    assert abs(overlap["losses"][0] - blocking["losses"][0]) <= 2e-6 * abs(blocking["losses"][0])


@pytest.mark.parametrize("schedule", ["blocking", "overlap"])
def test_rank_build_equals_stacked_slice(meshes, schedule):
    """``ShardedGraph.build(rank=r)`` builds rank r's arrays alone (its own
    compact layouts, padded as in the stack): the stacked graph's slice."""
    sem = meshes[1]
    pg = partition_mesh(sem, (2, 2, 1))
    plan = NMPPlan.build(pg, NEIGHBOR, packed=True, backend=FUSED, schedule=schedule,
                         block_e=BLOCK_E)
    stacked = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
    for r in range(pg.R):
        want, got = stacked.rank(r), ShardedGraph.build(pg, sem.coords, plan,
                                                        device="cpu", rank=r)
        assert set(got.arrays) == set(want.arrays) and set(got.wires) == set(want.wires)
        for k in want.arrays:
            assert torch.equal(got[k], want[k]), k
        for k, w in want.wires.items():
            assert all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(got.wire(k), w)), k
