"""The port's multi-process consistent GNN step under gloo, on the CPU,
against the JAX reference package and the port's own stacked emulator.

One module fixture per world size (2 and 4 processes) spawns once, through
``repro_torch.launch.consistency.run_world``, and every process writes
every case's results: the reference check's (rank grid, data replicas)
cases ``(2,1,1) x 1`` (2 processes), ``(2,1,1) x 2`` and ``(2,2,1) x 1``
(4 processes), each with the ``a2a``, dense ``neighbor``, packed
``neighbor`` and ``none`` halo modes and both NMP backends (the fused one
runs its plain versions on the CPU).  The workers import nothing of this
file, of ``repro`` or of JAX.

Held here:
* ``halo_sync`` on a seeded aggregate: each rank's output (and a batched
  [B, N, F] one) bitwise equal to its slice of ``halo_sync_stacked``; its
  gradient equal to autograd through the stacked emulator (bitwise for
  the packed exchange, whose reversal runs the stacked op's order; rtol /
  atol 1e-6 for the two others, where autograd accumulates a node's
  contributions from several peers in its own order).
* Eq. 6's reductions against the stacked sums (rel 2e-6).
* The step functions: loss (rel 2e-6) and gradients (rtol 1e-3 / atol
  2e-5) against ``repro``'s R=1 ``loss_and_grad_stacked`` (xla) from the
  same weights, forward (rtol 1e-4 / atol 1e-5) against its R=1
  prediction and bitwise against the port's stacked emulator; ``none``
  deviates; ``a2a`` and ``neighbor`` agree within 1e-7.
* The K=2 rollout gradient against ``repro``'s ``rollout_stacked``: loss
  rel 2e-6 and the gradient's relative norm 5e-4 (ROADMAP, North star);
  the inference rollout's predictions bitwise against the port's.
* Two training steps at ``(2,1,1) x 2``: parameters bitwise equal on every
  process, losses within band of an R=1 run (rel 2e-6 at step 0, 1e-4
  after, as ``test_torch_train.py``'s curve).
* ``shard_inputs``: a replica's samples of its rank, and its graph slice.
* The training CLI on 4 processes (process 0 alone prints and writes the
  checkpoints, whose fingerprint keeps R), and the refusals: nccl with too
  few cards, a batch that does not split over the replicas, R > 1 without
  a mesh.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import GNNConfig as RefConfig
from repro.core import HaloSpec as RefHaloSpec
from repro.core import NMPPlan as RefPlan
from repro.core import ShardedGraph as RefGraph
from repro.core import box_mesh as ref_box_mesh
from repro.core import init_gnn as ref_init_gnn
from repro.core import partition_mesh as ref_partition_mesh
from repro.core.reference import loss_and_grad_stacked as ref_loss_and_grad
from repro.core.reference import rollout_stacked as ref_rollout_stacked

from repro_torch import nn
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import params_from_jax
from repro_torch.core.consistent_loss import consistent_mse
from repro_torch.core.distributed import make_gnn_step_fns, shard_inputs
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import FUSED, XLA, ShardedGraph
from repro_torch.core.halo import halo_sync_stacked
from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
from repro_torch.core.partition import (
    gather_node_features, partition_mesh, scatter_node_outputs)
from repro_torch.core.reference import (
    consistent_loss_stacked, gnn_forward_stacked, rollout_stacked)
from repro_torch.launch import consistency as cons
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import train as train_cli
from repro_torch.train.loop import TrainConfig, train_consistent_gnn
from repro_torch.train.rollout import make_tgv_rollout_batch_fn

ELEMS, ORDER, FY = (4, 4, 2), 3, 3
LOSS_REL, G_RTOL, G_ATOL = 2e-6, 1e-3, 2e-5
F_RTOL, F_ATOL = 1e-4, 1e-5
ROLLOUT_GRAD_REL = 5e-4
CASES = [(2, ((2, 1, 1), 1)), (4, ((2, 1, 1), 2)), (4, ((2, 2, 1), 1))]
CASE_IDS = ["2x1x1_d1", "2x1x1_d2", "2x2x1_d1"]
EXCHANGES = ["a2a", "neighbor", "packed"]
BACKENDS = [XLA, FUSED]
TRAIN_STEPS = 2


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.fixture(scope="module")
def ref():
    """``repro``'s weights and its R=1 loss, gradients and prediction."""
    cfg = RefConfig.small()
    params = ref_init_gnn(jax.random.PRNGKey(0), cfg)
    sem = ref_box_mesh(ELEMS, p=ORDER)
    pg = ref_partition_mesh(sem, (1, 1, 1))
    plan = RefPlan(halo=RefHaloSpec(mode="none"))
    graph = RefGraph.build(pg, sem.coords, plan)
    x, y = (jnp.asarray(gather_node_features(partition_mesh(box_mesh(ELEMS, p=ORDER),
                                                            (1, 1, 1)),
                                             taylor_green_velocity(sem.coords, t=t)))
            for t in (0.0, cons.DT))
    loss, pred, grads = ref_loss_and_grad(params, x, y, graph, plan, FY)
    return dict(params=jax.tree.map(np.asarray, params), ref_params=params,
                loss=float(loss), grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                pred=np.asarray(pred), ref_graph=graph, ref_plan=plan)


@pytest.fixture(scope="module")
def port():
    """The port's mesh, partitions and stacked graphs, on the CPU."""
    sem = box_mesh(ELEMS, p=ORDER)
    pgs = {grid: partition_mesh(sem, grid) for grid in ((1, 1, 1), (2, 1, 1), (2, 2, 1))}
    graphs = {(grid, mode): ShardedGraph.build(pg, sem.coords,
                                               cons.plan_for(pg, mode, FUSED), device="cpu")
              for grid, pg in pgs.items() for mode in cons.MODES}
    return dict(sem=sem, pgs=pgs, graphs=graphs)


def _job(ref, world):
    return cons.Job(elements=ELEMS, order=ORDER, cfg=GNNConfig.small(), device="cpu",
                    params=ref["params"], halo=True, reductions=True, rollout=2,
                    train_steps=TRAIN_STEPS if world == 4 else 0)


@pytest.fixture(scope="module")
def world2(ref):
    return cons.run_world(_job(ref, 2), 2)


@pytest.fixture(scope="module")
def world4(ref):
    return cons.run_world(_job(ref, 4), 4)


def _procs(request, world, grid, data):
    """Every process's record of one case."""
    results = request.getfixturevalue(f"world{world}")
    return [p[cons.case_name(grid, data)] for p in results]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,case", CASES, ids=CASE_IDS)
def test_mesh_is_data_major(request, world, case):
    grid, data = case
    R = int(np.prod(grid))
    procs = _procs(request, world, grid, data)
    assert [(p["replica"], p["rank"]) for p in procs] == \
        [divmod(w, R) for w in range(world)]


# ---------------------------------------------------------------------------
# the halo exchange
# ---------------------------------------------------------------------------

def _stacked_exchange(port, grid, mode, a):
    g = port["graphs"][(grid, mode)]
    spec = cons.plan_for(port["pgs"][grid], mode, FUSED).halo
    return halo_sync_stacked(a, g, spec)


@pytest.mark.parametrize("mode", EXCHANGES)
@pytest.mark.parametrize("world,case", CASES, ids=CASE_IDS)
def test_halo_sync_bitwise_stacked(request, port, world, case, mode):
    grid, data = case
    pg = port["pgs"][grid]
    R, f = pg.R, GNNConfig.small().hidden
    a = torch.from_numpy(cons.seeded(1, (R, pg.n_pad, f)))
    b = torch.from_numpy(cons.seeded(3, (2, R, pg.n_pad, f)))
    want = _stacked_exchange(port, grid, mode, a)
    want_b = torch.stack([_stacked_exchange(port, grid, mode, bb) for bb in b])
    for p in _procs(request, world, grid, data):
        got = p["halo"][mode]
        assert np.array_equal(got["out"], want[p["rank"]].numpy())
        assert np.array_equal(got["batched"], want_b[:, p["rank"]].numpy())
    assert not torch.equal(want, a)        # the exchange did something


@pytest.mark.parametrize("mode", EXCHANGES)
@pytest.mark.parametrize("world,case", CASES, ids=CASE_IDS)
def test_halo_sync_grad_matches_stacked_autograd(request, port, world, case, mode):
    grid, data = case
    pg = port["pgs"][grid]
    R, f = pg.R, GNNConfig.small().hidden
    a = torch.from_numpy(cons.seeded(1, (R, pg.n_pad, f))).requires_grad_(True)
    w = torch.from_numpy(cons.seeded(2, (R, pg.n_pad, f)))
    want, = torch.autograd.grad((_stacked_exchange(port, grid, mode, a) * w).sum(), a)
    tol = 0.0 if mode == "packed" else 1e-6
    for p in _procs(request, world, grid, data):
        np.testing.assert_allclose(p["halo"][mode]["grad"], want[p["rank"]].numpy(),
                                   rtol=tol, atol=tol)
    assert not torch.equal(want, w)


# ---------------------------------------------------------------------------
# Eq. 6's reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,case", CASES, ids=CASE_IDS)
def test_consistent_reductions_match_stacked_sums(request, port, world, case):
    grid, data = case
    pg = port["pgs"][grid]
    g = port["graphs"][(grid, "a2a")]
    y = torch.from_numpy(cons.seeded(4, (2, pg.R, pg.n_pad, 3)))
    t = torch.from_numpy(cons.seeded(5, (2, pg.R, pg.n_pad, 3)))
    inv = g["node_inv_mult"]
    want = {"mse": consistent_loss_stacked(y[0], t[0], g, 3),
            "mse_batched": (consistent_loss_stacked(y[0], t[0], g, 3)
                            + consistent_loss_stacked(y[1], t[1], g, 3)) / 2,
            "node_sum": (y[0] * inv[..., None]).sum(dim=(0, 1)),
            "node_count": inv.sum()}
    assert abs(float(want["node_count"]) - pg.n_global) < 1e-3
    for p in _procs(request, world, grid, data):
        for key, w in want.items():
            np.testing.assert_allclose(p["reductions"][key], w.numpy(), rtol=LOSS_REL,
                                       atol=0, err_msg=key)
    # group=None keeps the single-process arithmetic
    assert torch.equal(consistent_mse(y[0, 0], t[0, 0], inv[0]),
                       ((y[0, 0] - t[0, 0]) ** 2).sum(-1).mul(inv[0]).sum()
                       / (inv[0].sum() * 3))


# ---------------------------------------------------------------------------
# the step functions
# ---------------------------------------------------------------------------

def _global_pred(pg, procs, key):
    """The replica-0 ranks' predictions scattered to the global nodes."""
    per_rank = np.stack([p["steps"][key]["pred"][0, 0] for p in procs
                         if p["replica"] == 0])
    return scatter_node_outputs(pg, per_rank)


@pytest.mark.parametrize("mode", EXCHANGES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("world,case", CASES, ids=CASE_IDS)
def test_step_fns_match_reference(request, ref, port, world, case, backend, mode):
    grid, data = case
    procs = _procs(request, world, grid, data)
    cons.check_step([p["steps"][(backend, mode)] for p in procs],
                    (ref["loss"], ref["grads"]), mode)
    pred = _global_pred(port["pgs"][grid], procs, (backend, mode))
    want = scatter_node_outputs(port["pgs"][(1, 1, 1)], ref["pred"])
    np.testing.assert_allclose(pred, want, rtol=F_RTOL, atol=F_ATOL)


@pytest.mark.parametrize("mode", EXCHANGES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("world,case", CASES, ids=CASE_IDS)
def test_forward_bitwise_port_stacked(request, ref, port, world, case, backend, mode):
    grid, data = case
    pg = port["pgs"][grid]
    plan = cons.plan_for(pg, mode, backend)
    g = ShardedGraph.build(pg, port["sem"].coords, plan, device="cpu")
    x = torch.from_numpy(gather_node_features(pg, taylor_green_velocity(port["sem"].coords)))
    with torch.no_grad():
        want = gnn_forward_stacked(params_from_jax(ref["params"], "cpu"), x, g, plan,
                                   sync_fn=halo_sync_stacked)
    for p in _procs(request, world, grid, data):
        assert np.array_equal(p["steps"][(backend, mode)]["pred"][0, 0],
                              want[p["rank"]].numpy())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("world,case", CASES, ids=CASE_IDS)
def test_none_deviates_and_exchanges_agree(request, ref, world, case, backend):
    grid, data = case
    procs = _procs(request, world, grid, data)
    cons.check_step([p["steps"][(backend, "none")] for p in procs],
                    (ref["loss"], ref["grads"]), "none")
    cons.check_agree({m: float(procs[0]["steps"][(backend, m)]["loss"])
                      for m in cons.MODES})


def test_check_refuses_what_the_reference_check_refuses(world2, ref):
    base = (ref["loss"], ref["grads"])
    lines = cons.check(world2, base)
    assert len(lines) == len(BACKENDS) * (len(cons.MODES) + 1)
    rec = world2[0][cons.case_name((2, 1, 1), 1)]["steps"][(XLA, "packed")]
    off = dict(rec, loss=np.float32(ref["loss"] * (1 + 1e-5)))
    with pytest.raises(AssertionError, match="FAIL"):
        cons.check_step([off], base, "packed")
    with pytest.raises(AssertionError, match="FAIL"):
        cons.check_step([rec, off], base, "packed")        # differs between processes
    with pytest.raises(AssertionError, match="FAIL"):
        cons.check_step([rec], base, "none")               # an exchange does not deviate
    grads = [g.copy() for g in nn.tree_leaves(rec["grads"])]
    i = max(range(len(grads)), key=lambda j: np.abs(grads[j]).max())
    grads[i] = grads[i] * 1.01
    with pytest.raises(AssertionError, match="FAIL"):
        cons.check_step([dict(rec, grads=grads)], base, "packed")
    # a leaf outside the elementwise band passes by norm only where asked
    err, by_norm, ok = cons.grads_close(grads, ref["grads"], w_rel=2e-2)
    assert ok and list(by_norm) == [i] and err > 0
    with pytest.raises(AssertionError, match="within"):
        cons.check_agree({"a2a": 1.0, "neighbor": 1.0 + 1e-6, "none": 0.0})


def test_consistency_cli_runs_two_processes(capfd):
    cons.main(["--device", "cpu", "--world", "2"])
    out = capfd.readouterr().out.splitlines()
    assert out[-1] == '{"consistency": "pass", "worlds": [2]}'
    steps = [l for l in out if l.startswith("world 2: 2x1x1_d1") and "on every process" in l]
    assert len(steps) == len(BACKENDS) * len(cons.MODES)
    assert all(l.endswith("-> ok") for l in steps)


def test_shard_inputs_takes_the_replica_samples_of_the_rank(port):
    pg = port["pgs"][(2, 1, 1)]
    g = port["graphs"][((2, 1, 1), "packed")]
    mesh = SimpleNamespace(data=2, graph=2, replica=1, rank=1, device=torch.device("cpu"))
    x = cons.seeded(6, (4, 2, pg.n_pad, 3))
    xs, gs = shard_inputs(mesh, x, g)
    assert np.array_equal(xs.numpy(), x[2:4, 1:2])
    assert all(torch.equal(gs[k], g[k][1]) for k in g.arrays)
    assert torch.equal(gs.wire("pk_send").idx, g.wire("pk_send").idx[1])
    with pytest.raises(ValueError, match="split"):
        shard_inputs(mesh, x[:3], g)


def test_step_fns_without_a_mesh_refuse_many_ranks(ref, port):
    pg = port["pgs"][(2, 2, 1)]
    g = port["graphs"][((2, 2, 1), "packed")]
    plan = cons.plan_for(pg, "packed", FUSED)
    eval_step, _, _, _ = make_gnn_step_fns(GNNConfig.small(), plan)
    x = torch.zeros(1, 4, pg.n_pad, 3)
    with pytest.raises(ValueError, match="mesh"):
        eval_step(params_from_jax(ref["params"], "cpu"), x, g)


# ---------------------------------------------------------------------------
# rollout and training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,case", [CASES[0], CASES[2]], ids=[CASE_IDS[0], CASE_IDS[2]])
def test_rollout_grad_matches_reference(request, ref, port, world, case):
    grid, data = case
    bf = make_tgv_rollout_batch_fn(port["pgs"][(1, 1, 1)], port["sem"], data, 2,
                                   noise_scale=0.02, seed=1)
    x0, tg, nz = (jnp.asarray(a[0]) for a in bf(0))
    want, want_g = jax.value_and_grad(lambda p: ref_rollout_stacked(
        p, x0, tg, ref["ref_graph"], ref["ref_plan"], FY, noise=nz)[0])(ref["ref_params"])
    b = np.concatenate([np.asarray(t).ravel() for t in jax.tree.leaves(want_g)])
    for p in _procs(request, world, grid, data):
        assert _rel(p["rollout"]["loss"], want) <= LOSS_REL
        a = np.concatenate([t.ravel() for t in nn.tree_leaves(p["rollout"]["grads"])])
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= ROLLOUT_GRAD_REL


@pytest.mark.parametrize("world,case", [CASES[0], CASES[2]], ids=[CASE_IDS[0], CASE_IDS[2]])
def test_rollout_predictions_bitwise_port_stacked(request, ref, port, world, case):
    grid, data = case
    pg = port["pgs"][grid]
    x0 = make_tgv_rollout_batch_fn(pg, port["sem"], data, 2, noise_scale=0.02,
                                   seed=1)(0)[0]
    plan = cons.plan_for(pg, "packed", FUSED)
    with torch.no_grad():
        want = rollout_stacked(params_from_jax(ref["params"], "cpu"),
                               torch.from_numpy(x0[0]), torch.zeros(2, *x0.shape[1:]),
                               port["graphs"][(grid, "packed")], plan, FY,
                               sync_fn=halo_sync_stacked)[1]
    for p in _procs(request, world, grid, data):
        got = p["rollout"]["preds"]
        assert got.shape == (1, 2, 1, pg.n_pad, FY)
        assert np.array_equal(got[0, :, 0], want[:, p["rank"]].numpy())


def test_training_leaves_parameters_bitwise_equal_everywhere(world4, ref):
    runs = [p["train"] for p in world4]
    first = nn.tree_leaves(runs[0]["params"])
    for run in runs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(first, nn.tree_leaves(run["params"])))
        assert run["losses"] == runs[0]["losses"]
    assert len(set(runs[0]["checksums"])) == 1
    start = jax.tree.leaves(ref["params"])
    assert not any(np.array_equal(a, b) for a, b in zip(first, start) if b.any())


def test_training_losses_match_one_rank(world4, ref, port):
    from repro_torch.core.graph_state import NMPPlan
    from repro_torch.core.halo import HaloSpec
    hist = train_consistent_gnn(
        port["pgs"][(1, 1, 1)], port["sem"], GNNConfig.small(),
        TrainConfig(n_steps=TRAIN_STEPS, batch=2, lr=1e-3,
                    plan=NMPPlan(halo=HaloSpec(mode="neighbor", packed=True),
                                 backend=FUSED)),
        params=ref["params"], device="cpu")
    got = world4[0]["train"]["losses"]
    assert _rel(got[0], hist["losses"][0]) <= LOSS_REL
    for a, b in zip(got[1:], hist["losses"][1:]):
        assert _rel(a, b) <= 1e-4


# ---------------------------------------------------------------------------
# the CLI and the refusals
# ---------------------------------------------------------------------------

def test_train_cli_runs_ranks_and_replicas(capfd, tmp_path):
    hist = train_cli.main(["--device", "cpu", "--elements", "2", "2", "1", "--order", "2",
                           "--ranks", "2", "1", "1", "--data-parallel", "2",
                           "--steps", "2", "--batch", "2", "--ckpt", str(tmp_path),
                           "--ckpt-every", "1"])
    out = capfd.readouterr().out
    assert "R=2 x DP=2 on cpu (4 processes, gloo)" in out
    assert out.count("(2 steps, 0 straggler events)") == 1      # process 0 alone
    assert ckpt.committed_steps(tmp_path) == [0, 1]             # process 0 writes
    manifest = ckpt.peek_manifest(tmp_path)
    assert manifest["extra"]["fingerprint"]["ranks"] == 2
    assert manifest["extra"]["losses"] == hist["losses"]
    one = train_cli.main(["--device", "cpu", "--elements", "2", "2", "1", "--order", "2",
                          "--steps", "2", "--batch", "2"])
    assert _rel(hist["losses"][0], one["losses"][0]) <= LOSS_REL
    assert _rel(hist["losses"][1], one["losses"][1]) <= 1e-4


def test_nccl_with_too_few_cards_refuses(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--steps", "1", "--ranks", "2", "1", "1",
                        "--dist-backend", "nccl"])
    assert "nccl" in capsys.readouterr().err
    with pytest.raises(ValueError, match="one card per process"):
        pmesh.check_backend("nccl", "cuda", 2)
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--steps", "1", "--batch", "3",
                        "--data-parallel", "2"])


def test_training_without_a_mesh_refuses_many_ranks(port):
    with pytest.raises(ValueError, match="mesh"):
        train_consistent_gnn(port["pgs"][(2, 1, 1)], port["sem"], GNNConfig.small(),
                             TrainConfig(n_steps=1), device="cpu")
