"""Multi-rank serving of the torch port under gloo, on the CPU: the engine
fanned out over 2 and 4 processes (``repro_torch.launch.serve_checks``
through ``repro_torch.launch.serve.run_world``),
under the blocking and the overlap schedule, against the JAX reference
package and the port's own stacked emulator.

One module fixture per world size spawns once and runs every job in turn:
2 processes split (2,1,1) with the A2A exchange and the plain backend, 4
processes split (2,2,1) with the packed neighbor exchange and the fused
backend (its plain versions on the CPU), each under both schedules; on 2
processes also a bf16 plan (fused, blocking).  The
workers import nothing of this file, of ``repro`` or of JAX.

The four checks of the reference's ``tests/drivers/serve_driver.py``:
1. every streamed request bitwise equal to the engine's offline batch-1
   reference;
2. the first two requests within rtol 3e-4 / atol 1e-5 (its band) of
   the port's own stacked rollout at R=1 (its check),
   and of ``repro``'s ``rollout_stacked`` at R=1 from the same weights:
   the first rollout step element by element, every step by its relative
   L2 norm (1e-4).  Element by element, K=2 steps of the two packages at
   R=1 already differ by up to 9.1e-5 (one element of 2,430 outside the
   band by 1.5e-6 on this mesh): the frameworks' fp32 spread grows over
   autoregressive steps, which is why ROADMAP holds K-step rollouts across
   the packages by norms;
3. a mesh the checkpoint was not trained on refused by name at
   registration (on every process) and at submit;
4. a dying producer drains what it queued, then ends the engine and every
   follower within a bounded time.
Also: every request bitwise equal to the port's stacked rollout at R with
the same exchange (``halo_sync_stacked``), and one request's rows of every
rank; each mode's posted exchange
bitwise equal to the autograd one and to its slice of
``halo_sync_stacked``; which exchange each schedule ran; the serve CLI at
``--ranks 2``; the refusals of a mesh engine.

A multilevel checkpoint (``n_levels=3``, the V-cycle) served by 2
processes split (2,1,1), packed neighbor exchange, fused backend, under
both schedules, each process building the hierarchy from the rank grid:
streamed == offline bitwise, every request the same bits as the port's
stacked multilevel rollout at R=2 (every rank's rows too), its first
rollout step within ``repro``'s multilevel band of the R=1 rollout and the
second within the serving band, one posted exchange per layer and
transfer; and the serve CLI on that checkpoint.
"""
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
from repro.core.reference import rollout_stacked as ref_rollout_stacked

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import params_from_jax
from repro_torch.core.coarsen import build_hierarchy
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import (
    BF16, BLOCKING, FUSED, XLA, NMPPlan, ShardedGraph)
from repro_torch.core.halo import A2A, NEIGHBOR, halo_sync_stacked
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import (
    gather_node_features, partition_mesh, scatter_node_outputs)
from repro_torch.core.reference import rollout_stacked
from repro_torch.launch import serve, serve_checks
from repro_torch.runtime.engine import EngineConfig, EngineError, InferenceEngine
from repro_torch.train.loop import TrainConfig, run_fingerprint

ELEMS, ORDER, K, FY = (4, 4, 2), 2, 2, 3
CFG = dict(hidden=8, n_mp_layers=2, mlp_hidden_layers=2)
N_REQ, SLOTS = 6, 3
BAND_RTOL, BAND_ATOL = 3e-4, 1e-5
#: a K-step prediction's relative L2 distance from ``repro``'s R=1
ROLLOUT_REL = 1e-4
#: seconds from the producer's death on the lead to every follower's return
FOLLOWER_EXIT_S = 30.0
SCHEDULES = ["blocking", "overlap"]
#: world size -> (rank grid, halo mode, packed, backend)
WORLDS = {2: ((2, 1, 1), A2A, False, XLA), 4: ((2, 2, 1), NEIGHBOR, True, FUSED)}
#: the multilevel checkpoint: 3 levels (405 -> 32 -> 4 nodes), one NMP
#: layer per coarse level, served on (2,1,1) with the packed exchange
ML_CFG = dict(CFG, n_levels=3, coarse_mp_layers=1)
ML_GRID = (2, 1, 1)
#: repro's multilevel bands, 1 rank vs R ranks (tests/test_multilevel.py)
ML_RTOL, ML_ATOL = 3e-5, 5e-6


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A fingerprinted checkpoint of ``repro``'s seeded weights."""
    cfg = RefConfig(**CFG)
    np_params = jax.tree.map(np.asarray, ref_init_gnn(jax.random.PRNGKey(0), cfg))
    params = params_from_jax(np_params, "cpu")
    sem = box_mesh(ELEMS, p=ORDER)
    fp = run_fingerprint(sem, partition_mesh(sem, (1, 1, 1)), GNNConfig(**CFG),
                         TrainConfig(), NMPPlan())
    ckdir = tmp_path_factory.mktemp("serve_dist") / "ck"
    ckpt.save(ckdir, 0, {"params": params}, extra={"fingerprint": fp})
    return dict(ckdir=str(ckdir), np_params=np_params, params=params, sem=sem, fp=fp)


def _jobs(served, world):
    """One job per schedule; on 2 processes a last one on a bf16 plan
    (``ServeJob.precision``), fused, blocking."""
    grid, mode, packed, backend = WORLDS[world]
    job = dict(ckpt_dir=served["ckdir"], elements=ELEMS, order=ORDER, rank_grid=grid,
               requests=N_REQ, batch_slots=SLOTS, rollout_steps=K, halo_mode=mode,
               packed=packed, device="cpu", keep=N_REQ, rank_preds=1)
    jobs = [serve_checks.CheckJob(**job, backend=backend, schedule=schedule, halo=i == 0)
            for i, schedule in enumerate(SCHEDULES)]
    if world == 2:
        jobs.append(serve_checks.CheckJob(**job, backend=FUSED, schedule=BLOCKING,
                                          precision=BF16))
    return jobs


@pytest.fixture(scope="module")
def world2(served):
    return serve_checks.run_checks(*_jobs(served, 2))


@pytest.fixture(scope="module")
def world4(served):
    return serve_checks.run_checks(*_jobs(served, 4))


@pytest.fixture(scope="module")
def reference(served):
    """``step -> `` the R=1 rollouts of that request, scattered: ``repro``'s
    and the port's stacked one (each computed once)."""
    sem = ref_box_mesh(ELEMS, p=ORDER)
    pg = ref_partition_mesh(sem, (1, 1, 1))
    plan = RefPlan(halo=RefHaloSpec(mode="none"))
    graph = RefGraph.build(pg, sem.coords, plan)
    params = jax.tree.map(jnp.asarray, served["np_params"])
    port_plan = NMPPlan()
    port_graph = ShardedGraph.build(partition_mesh(served["sem"], (1, 1, 1)),
                                    served["sem"].coords, port_plan, device="cpu")
    cache = {}

    def at(step):
        if step not in cache:
            x = gather_node_features(pg, serve.snapshot(sem, step))
            _, preds = ref_rollout_stacked(params, jnp.asarray(x),
                                           jnp.zeros((K,) + x.shape, jnp.float32),
                                           graph, plan, FY)
            xt = torch.from_numpy(x)
            with torch.no_grad():
                _, port = rollout_stacked(served["params"], xt,
                                          torch.zeros((K,) + xt.shape), port_graph,
                                          port_plan, FY)
            cache[step] = tuple(np.stack([scatter_node_outputs(pg, np.asarray(p[k]))
                                          for k in range(K)]) for p in (preds, port))
        return cache[step]
    return at


def _records(request, world, schedule):
    """Every process's record of one schedule's job."""
    procs = request.getfixturevalue(f"world{world}")
    return [p[SCHEDULES.index(schedule)] for p in procs]


CELLS = [(w, s) for w in WORLDS for s in SCHEDULES]
CELL_IDS = [f"{w}procs-{s}" for w, s in CELLS]


@pytest.mark.parametrize("world,schedule", CELLS, ids=CELL_IDS)
def test_streamed_equals_offline_bitwise(request, world, schedule):
    lead = _records(request, world, schedule)[0]
    assert lead["n"] == N_REQ and len(lead["preds"]) == N_REQ
    assert lead["bitwise_offline"] is True
    for preds in lead["preds"].values():
        assert preds.shape == (K, box_mesh(ELEMS, p=ORDER).n_nodes, FY)
        assert np.isfinite(preds).all()


@pytest.mark.parametrize("world,schedule", CELLS, ids=CELL_IDS)
def test_within_band_of_reference_one_rank(request, reference, world, schedule):
    lead = _records(request, world, schedule)[0]
    for step in sorted(lead["preds"])[:2]:
        ref, port = reference(step)
        got = lead["preds"][step]
        np.testing.assert_allclose(got, port, rtol=BAND_RTOL, atol=BAND_ATOL)
        np.testing.assert_allclose(got[0], ref[0], rtol=BAND_RTOL, atol=BAND_ATOL)
        for k in range(K):
            assert np.linalg.norm(got[k] - ref[k]) <= ROLLOUT_REL * np.linalg.norm(ref[k])


@pytest.mark.parametrize("world,schedule", CELLS, ids=CELL_IDS)
def test_bitwise_equal_to_port_stacked_rollout(request, served, world, schedule):
    """The engine's R-rank predictions are its processes' rollouts: the same
    bits as the port's stacked rollout at R with the same exchange."""
    grid, mode, packed, backend = WORLDS[world]
    sem = served["sem"]
    pg = partition_mesh(sem, grid)
    plan = NMPPlan.build(pg, mode, packed=packed, backend=backend, schedule=schedule)
    graph = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
    lead = _records(request, world, schedule)[0]
    assert len(lead["rank_preds"]) == 1
    for step, got in lead["preds"].items():
        x = torch.from_numpy(gather_node_features(pg, serve.snapshot(sem, step)))
        with torch.no_grad():
            _, preds = rollout_stacked(served["params"], x, torch.zeros((K,) + x.shape),
                                       graph, plan, FY, sync_fn=halo_sync_stacked)
        want = np.stack([scatter_node_outputs(pg, preds[k].numpy()) for k in range(K)])
        assert np.array_equal(got, want), step
        if step in lead["rank_preds"]:      # every rank's padded rows
            assert np.array_equal(lead["rank_preds"][step], preds.numpy()), step


def _rollout_stacked(served, grid, plan, step):
    """The port's stacked rollout of ``step``'s snapshot under ``plan``:
    (scattered [K, N, F_out], per rank [K, R, N_pad, F_out])."""
    sem = served["sem"]
    pg = partition_mesh(sem, grid)
    graph = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
    x = torch.from_numpy(gather_node_features(pg, serve.snapshot(sem, step)))
    with torch.no_grad():
        _, preds = rollout_stacked(served["params"], x, torch.zeros((K,) + x.shape),
                                   graph, plan, FY, sync_fn=halo_sync_stacked)
    return (np.stack([scatter_node_outputs(pg, preds[k].numpy()) for k in range(K)]),
            preds.numpy())


def test_bf16_plan_two_procs_bitwise_equal_to_port_stacked_rollout(request, served):
    """A bf16 plan served by 2 processes through ``run_world``
    (``ServeJob(precision="bf16")``): streamed == offline bitwise, every
    request the same bits as the port's stacked bf16 rollout at R=2, and
    within the bf16 forward bands (tests/test_torch_bf16.py) of the stacked
    bf16 rollout at R=1, nearer it than the fp32 one."""
    lead = request.getfixturevalue("world2")[0][len(SCHEDULES)]
    assert lead["n"] == N_REQ and lead["bitwise_offline"] is True
    grid, mode, packed, _ = WORLDS[2]
    plan = NMPPlan.build(partition_mesh(served["sem"], grid), mode, packed=packed,
                         backend=FUSED, precision=BF16)
    for step, got in lead["preds"].items():
        want, per_rank = _rollout_stacked(served, grid, plan, step)
        assert np.array_equal(got, want), step
        if step in lead["rank_preds"]:
            assert np.array_equal(lead["rank_preds"][step], per_rank), step
    for step in sorted(lead["preds"])[:2]:
        got = lead["preds"][step]
        one, _ = _rollout_stacked(served, (1, 1, 1), NMPPlan(precision=BF16), step)
        one32, _ = _rollout_stacked(served, (1, 1, 1), NMPPlan(), step)
        rel = np.linalg.norm(got - one) / np.linalg.norm(one)
        rel32 = np.linalg.norm(got - one32) / np.linalg.norm(one32)
        assert rel <= 1e-3 and rel <= 0.2 * rel32, (step, rel, rel32)
        assert np.abs(got - one).max() <= 5e-2


@pytest.mark.parametrize("world,schedule", CELLS, ids=CELL_IDS)
def test_mesh_mismatch_refused_by_name(request, served, world, schedule):
    recs = _records(request, world, schedule)
    other = recs[0]["other_hash"]
    for rec in recs:                       # at registration, on every process
        assert served["fp"]["mesh_hash"] in rec["refused_registration"]
        assert other in rec["refused_registration"]
    assert other in recs[0]["refused_submit"]
    assert served["fp"]["mesh_hash"] in recs[0]["refused_submit"]


@pytest.mark.parametrize("world,schedule", CELLS, ids=CELL_IDS)
def test_dying_producer_ends_engine_and_followers(request, world, schedule):
    recs = _records(request, world, schedule)
    lead = recs[0]
    assert "producer" in lead["producer_error"]
    assert lead["drained"] == list(range(serve_checks.DIE_AT))
    assert lead["closed"] is True and lead["submit_after_close"]
    assert lead["died_after_s"] < 60
    for rec in recs[1:]:
        assert rec["followed_until"] - lead["died_at"] < FOLLOWER_EXIT_S


@pytest.mark.parametrize("world,schedule", CELLS, ids=CELL_IDS)
def test_exchanges_and_batches_per_process(request, world, schedule):
    """Every exchange of the no-gradient serving path is posted; under the
    overlap schedule each one is finished after the interior side is
    queued; every process ran the lead's batches."""
    recs = _records(request, world, schedule)
    lead = recs[0]
    layers = CFG["n_mp_layers"]
    exchanges = lead["stream_stats"]["batches"] * SLOTS * K * layers
    tr = lead["transport"]
    assert tr["posted"] == exchanges
    assert tr["overlapped"] == (exchanges if schedule == "overlap" else 0)
    # the dying stream's batch came after the stream's
    assert lead["stats"]["batches"] == lead["stream_stats"]["batches"] + 1
    for rec in recs[1:]:
        assert rec["stats"]["batches"] == lead["stats"]["batches"]


@pytest.mark.parametrize("mode", ["a2a", "neighbor", "packed"])
@pytest.mark.parametrize("world", list(WORLDS), ids=[f"{w}procs" for w in WORLDS])
def test_posted_exchange_bitwise_blocking_and_stacked(request, served, world, mode):
    grid = WORLDS[world][0]
    sem = served["sem"]
    pg = partition_mesh(sem, grid)
    halo_mode, packed = {"a2a": (A2A, False), "neighbor": (NEIGHBOR, False),
                         "packed": (NEIGHBOR, True)}[mode]
    plan = NMPPlan.build(pg, halo_mode, packed=packed)
    g = ShardedGraph.build(pg, sem.coords, plan, device="cpu")
    a = np.random.default_rng(11).standard_normal(
        (pg.R, pg.n_pad, CFG["hidden"])).astype(np.float32)
    want = halo_sync_stacked(torch.from_numpy(a), g, plan.halo).numpy()
    procs = request.getfixturevalue(f"world{world}")
    for r, p in enumerate(procs):
        rec = p[0]["halo"][mode]
        assert np.array_equal(rec["posted"], rec["autograd"])
        assert np.array_equal(rec["posted"], want[r])


def test_serve_cli_streams_on_two_ranks(served, capfd):
    rec = serve.main(["--ckpt-dir", served["ckdir"], "--mesh", "4,4,2", "--p", "2",
                      "--requests", "4", "--batch-slots", "2", "--rollout-steps", "2",
                      "--device", "cpu", "--ranks", "2", "--schedule", "overlap",
                      "--halo-mode", "neighbor", "--packed", "--mp-backend", "fused"])
    out = capfd.readouterr().out
    assert "2 rank(s) (2, 1, 1), schedule overlap" in out
    assert "neighbor packed exchange over gloo" in out and "4 requests" in out
    assert rec["n"] == 4 and rec["transport"]["overlapped"] == rec["transport"]["posted"]


def test_serve_cli_refusals(served, capsys):
    base = ["--ckpt-dir", served["ckdir"], "--device", "cpu"]
    for flags, msg in ((["--packed"], "--halo-mode neighbor"),
                       (["--ranks", "2", "--rank-grid", "2", "2", "1"], "does not hold"),
                       (["--ranks", "2", "--transport", "nccl"], "nccl")):
        with pytest.raises(SystemExit):
            serve.main(base + flags)
        assert msg in capsys.readouterr().err, flags


def test_mesh_engine_refusals(served):
    class _Mesh:                           # a two-replica mesh, never joined
        data, graph, device = 2, 2, torch.device("cpu")
    with pytest.raises(EngineError, match="one replica"):
        InferenceEngine(served["ckdir"], GNNConfig(**CFG), mesh=_Mesh())
    with pytest.raises(EngineError, match="neighbor-only"):
        InferenceEngine(served["ckdir"], GNNConfig(**CFG), EngineConfig(),
                        plan=NMPPlan.build(partition_mesh(served["sem"], (2, 1, 1)),
                                           NEIGHBOR, packed=True), device="cpu")
    with pytest.raises(ValueError, match="halo_mode"):
        EngineConfig(halo_mode="ring")
    eng = InferenceEngine(served["ckdir"], GNNConfig(**CFG), device="cpu")
    with pytest.raises(EngineError, match="other than the lead"):
        eng.follow()
    with pytest.raises(EngineError, match="R=1"):          # R > 1 needs a mesh
        eng.register_mesh(served["sem"], rank_grid=(2, 1, 1))


# ---------------------------------------------------------------------------
# a multilevel checkpoint (the V-cycle) served by 2 processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_ml(tmp_path_factory):
    """A fingerprinted checkpoint of ``repro``'s seeded multilevel weights."""
    np_params = jax.tree.map(np.asarray,
                             ref_init_gnn(jax.random.PRNGKey(0), RefConfig(**ML_CFG)))
    params = params_from_jax(np_params, "cpu")
    sem = box_mesh(ELEMS, p=ORDER)
    fp = run_fingerprint(sem, partition_mesh(sem, (1, 1, 1)), GNNConfig(**ML_CFG),
                         TrainConfig(), NMPPlan())
    ckdir = tmp_path_factory.mktemp("serve_dist_ml") / "ck"
    ckpt.save(ckdir, 0, {"params": params}, extra={"fingerprint": fp})
    return dict(ckdir=str(ckdir), params=params, sem=sem)


@pytest.fixture(scope="module")
def world2_ml(served_ml):
    job = dict(ckpt_dir=served_ml["ckdir"], elements=ELEMS, order=ORDER,
               rank_grid=ML_GRID, requests=N_REQ, batch_slots=SLOTS, rollout_steps=K,
               halo_mode=NEIGHBOR, packed=True, backend=FUSED, device="cpu",
               keep=N_REQ, rank_preds=1)
    return serve_checks.run_checks(*(serve_checks.CheckJob(**job, schedule=schedule)
                                     for schedule in SCHEDULES))


def _ml_rollout(served_ml, grid, schedule, step):
    """The port's stacked multilevel rollout of ``step``'s snapshot on
    ``grid``: (scattered [K, N, F_out], per rank [K, R, N_pad, F_out])."""
    sem = served_ml["sem"]
    ml = build_hierarchy(sem, grid, ML_CFG["n_levels"])
    pg = ml.levels[0]
    plan = NMPPlan.build(ml, NEIGHBOR, packed=True, backend=FUSED, schedule=schedule)
    graph = ShardedGraph.build(pg, sem.coords, plan, device="cpu", hierarchy=ml)
    x = torch.from_numpy(gather_node_features(pg, serve.snapshot(sem, step)))
    with torch.no_grad():
        _, preds = rollout_stacked(served_ml["params"], x, torch.zeros((K,) + x.shape),
                                   graph, plan, FY, sync_fn=halo_sync_stacked)
    return (np.stack([scatter_node_outputs(pg, preds[k].numpy()) for k in range(K)]),
            preds.numpy())


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_multilevel_two_procs_bitwise_equal_to_port_stacked_rollout(
        world2_ml, served_ml, schedule):
    """Streamed == offline bitwise on the lead; every request the same bits
    as the port's stacked multilevel rollout at R=2 (one request's rows of
    every rank too), and within repro's multilevel bands of the R=1 one."""
    recs = [p[SCHEDULES.index(schedule)] for p in world2_ml]
    lead = recs[0]
    assert lead["n"] == N_REQ and lead["bitwise_offline"] is True
    assert len(lead["preds"]) == N_REQ and len(lead["rank_preds"]) == 1
    for step, got in lead["preds"].items():
        want, per_rank = _ml_rollout(served_ml, ML_GRID, schedule, step)
        assert np.array_equal(got, want), step
        if step in lead["rank_preds"]:
            assert np.array_equal(lead["rank_preds"][step], per_rank), step
    # rollout step 1 in repro's multilevel band (on the CPU: at most 0.64 of
    # it); step 2 runs over step 1's outputs, whose spread grows to 1.1-2.7x
    # that band (max|err| 2.4e-5 to 3.3e-5), so it is held to the serving
    # band of the flat worlds above (at most 0.45 of it)
    for step in sorted(lead["preds"])[:2]:
        got = lead["preds"][step]
        one, _ = _ml_rollout(served_ml, (1, 1, 1), schedule, step)
        np.testing.assert_allclose(got[0], one[0], rtol=ML_RTOL, atol=ML_ATOL)
        np.testing.assert_allclose(got[1:], one[1:], rtol=BAND_RTOL, atol=BAND_ATOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_multilevel_two_procs_exchanges_and_refusals(world2_ml, served_ml, schedule):
    """One posted exchange per fine layer, per coarse layer and per
    transfer (restriction and prolongation each complete one); under the
    overlap schedule the layers' are finished after the interior side;
    the untrained mesh refused; every follower ran the lead's batches."""
    recs = [p[SCHEDULES.index(schedule)] for p in world2_ml]
    lead = recs[0]
    L, M, C = ML_CFG["n_levels"], ML_CFG["n_mp_layers"], ML_CFG["coarse_mp_layers"]
    fwds = lead["stream_stats"]["batches"] * SLOTS * K
    assert lead["transport"]["posted"] == fwds * (M + (L - 1) * (C + 2))
    assert lead["transport"]["overlapped"] == (
        fwds * (M + (L - 1) * C) if schedule == "overlap" else 0)
    for rec in recs:
        assert rec["other_hash"] in rec["refused_registration"]
    for rec in recs[1:]:
        assert rec["stats"]["batches"] == lead["stats"]["batches"]


def test_serve_cli_multilevel_checkpoint(served_ml, capfd):
    """``launch/serve.py`` on a multilevel checkpoint: the config read back
    with its levels, the engine building the hierarchy itself."""
    rec = serve.main(["--ckpt-dir", served_ml["ckdir"], "--mesh", "4,4,2", "--p", "2",
                      "--requests", "3", "--batch-slots", "2", "--rollout-steps", "2",
                      "--device", "cpu", "--mp-backend", "fused"])
    out = capfd.readouterr().out
    assert "3 levels x 1 coarse layers" in out and "3 requests" in out
    assert rec["n"] == 3
