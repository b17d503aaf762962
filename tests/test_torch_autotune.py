"""The port's measured plan autotune (``NMPPlan.autotune``) against the JAX
reference package, and the entry points that call it.

* Every autotune test of ``tests/test_partition_quality.py`` mirrored for
  the port: the R=1 shortcut, a fixed plan returned unchanged, the
  structural fallback on ``interior_frac``, the measured pick cached (a
  second call measures nothing), ``REPRO_SCHEDULE_AUTOTUNE=0``, the
  unresolved-``auto`` errors at dispatch and at the exchange, halo mode
  ``auto``'s fallback, R=1 resolution, a requested wire kept, the measured
  argmin cached, and a real sweep whose pick is the argmin of its table.
* With ``measure=False`` the port picks what ``repro`` picks on the same
  partition (``repro`` without its interpreter: on the CPU neither sweeps
  the packed candidate), schedule-only and cross-product, with and
  without a bf16 wire; ``interior_frac`` equal to ``repro``'s.
* The tuner never introduces a wire and may drop one; the grid is
  (schedule x halo mode x wire); ``policy()`` records the wire by name.
* Over 4 gloo processes (``launch/consistency.py``, ``Job.tune``): every
  process resolves the same triple, the lead's table holds the whole grid
  and its pick is the table's argmin, a second call is a cache hit.
* The training CLI with ``--mp-schedule auto --partitioner spectral``, at
  R=1 and at ``--ranks 2 1 1`` over gloo, flat and with ``--levels 3``:
  the loss equals the block partition's within rel 2e-6.
* The engine with ``partitioner="spectral"`` and an ``auto`` plan over 2
  gloo processes: every process resolves one plan, and the served
  prediction matches a one-rank engine's offline reference.

Inputs are numpy from a seed.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import NMPPlan as RefPlan
from repro.core import ShardedGraph as RefGraph
from repro.core import box_mesh as ref_box_mesh
from repro.core import consistent_mp as ref_cmp
from repro.core import partition_mesh as ref_partition_mesh

from repro_torch.core import consistent_mp as cmp
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph, nmp_impl
from repro_torch.core.halo import A2A, NONE, HaloSpec, halo_sync_stacked
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.launch import consistency as cons
from repro_torch.launch import serve, serve_checks
from repro_torch.launch import train as train_cli
from repro_torch.runtime.engine import EngineConfig, InferenceEngine
from repro_torch.train.loop import TrainConfig, train_consistent_gnn

ELEMS, ORDER = (4, 2, 2), 2
LOSS_REL = 2e-6


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    monkeypatch.setattr(cmp, "_SCHEDULE_CACHE", {})
    monkeypatch.setattr(cmp, "_TUNE_TABLE_CACHE", {})
    monkeypatch.delenv("REPRO_SCHEDULE_AUTOTUNE", raising=False)


def _auto_case(grid=(2, 2, 1)):
    mesh = box_mesh(ELEMS, p=ORDER)
    pg = partition_mesh(mesh, grid)
    plan = NMPPlan(halo=HaloSpec(mode=NONE if pg.R == 1 else A2A), schedule="auto")
    return plan, ShardedGraph.build(pg, mesh.coords, plan, device="cpu")


def _mode_auto_case(grid=(2, 2, 1), **plan_kw):
    mesh = box_mesh(ELEMS, p=ORDER)
    pg = partition_mesh(mesh, grid)
    plan = NMPPlan.build(pg, "auto", schedule="auto", **plan_kw)
    return plan, ShardedGraph.build(pg, mesh.coords, plan, device="cpu")


def _ref_case(grid, mode, **plan_kw):
    mesh = ref_box_mesh(ELEMS, p=ORDER)
    pg = ref_partition_mesh(mesh, grid)
    plan = RefPlan.build(pg, mode, schedule="auto", **plan_kw)
    return plan, RefGraph.build(pg, mesh.coords, plan)


def test_autotune_r1_shortcut():
    plan, graph = _auto_case((1, 1, 1))
    assert plan.autotune(graph).schedule == "blocking"


def test_autotune_fixed_schedule_is_noop():
    plan, graph = _auto_case()
    fixed = plan.replace(schedule="overlap")
    assert fixed.autotune(graph) is fixed


def test_autotune_heuristic_fallback_matches_interior_frac():
    plan, graph = _auto_case()
    picked = plan.autotune(graph, measure=False).schedule
    frac = cmp.interior_frac(graph.levels[0])
    assert picked == ("overlap" if frac < 0.5 else "blocking")


@pytest.mark.parametrize("grid", [(2, 1, 1), (2, 2, 1), (4, 1, 1)])
def test_interior_frac_equals_reference(grid):
    _, graph = _auto_case(grid)
    _, ref_graph = _ref_case(grid, "a2a")
    assert cmp.interior_frac(graph.levels[0]) == ref_cmp.interior_frac(ref_graph.levels[0])


def test_autotune_measured_pick_is_cached(monkeypatch):
    plan, graph = _auto_case()
    calls = []

    def fake_measure(plan, g0, hidden, iters):
        calls.append(1)
        return "overlap"

    monkeypatch.setattr(cmp, "_measure_best_schedule", fake_measure)
    p1 = plan.autotune(graph, measure=True)
    p2 = plan.autotune(graph, measure=True)
    assert p1.schedule == p2.schedule == "overlap"
    assert len(calls) == 1


def test_autotune_real_schedule_probe():
    plan, graph = _auto_case()
    out = plan.autotune(graph, measure=True, hidden=8, iters=1)
    assert out.schedule in ("blocking", "overlap") and out.halo == plan.halo
    nmp_impl(out)


def test_autotune_env_var_disables_measurement(monkeypatch):
    plan, graph = _auto_case()

    def boom(*a, **kw):
        raise AssertionError("measurement ran despite REPRO_SCHEDULE_AUTOTUNE=0")

    monkeypatch.setattr(cmp, "_measure_best_schedule", boom)
    monkeypatch.setattr(cmp, "measure_plan_candidates", boom)
    monkeypatch.setenv("REPRO_SCHEDULE_AUTOTUNE", "0")
    assert plan.autotune(graph).schedule in ("blocking", "overlap")
    mplan, mgraph = _mode_auto_case()
    assert mplan.autotune(mgraph).halo.mode == "neighbor"


def test_unresolved_auto_plan_errors_at_dispatch():
    with pytest.raises(ValueError, match="autotune"):
        nmp_impl(NMPPlan(halo=HaloSpec(mode=A2A), schedule="auto"))


def test_autotune_mode_auto_heuristic_picks_neighbor_on_cpu():
    plan, graph = _mode_auto_case()
    out = plan.autotune(graph, measure=False)
    # without the kernels (the CPU) the packed candidate is not swept
    assert out.halo.mode == "neighbor" and not out.halo.packed
    assert out.halo.wire_dtype is None          # never introduces a lossy wire
    frac = cmp.interior_frac(graph.levels[0])
    assert out.schedule == ("overlap" if frac < 0.5 else "blocking")
    nmp_impl(out)
    assert out.halo.perms == plan.halo.perms


def test_autotune_mode_auto_r1_resolves_none():
    plan, graph = _mode_auto_case((1, 1, 1))
    out = plan.autotune(graph)
    assert out.schedule == "blocking"
    assert out.halo.mode == "none" and not out.halo.packed and out.halo.wire_dtype is None


def test_autotune_mode_auto_keeps_requested_wire_in_heuristic():
    plan, graph = _mode_auto_case(wire_dtype=torch.bfloat16)
    out = plan.autotune(graph, measure=False)
    assert out.halo.wire_dtype is torch.bfloat16
    assert out.policy()["halo_wire"] == "bfloat16"
    assert NMPPlan().policy()["halo_wire"] is None


def test_autotune_mode_auto_measured_argmin_cached(monkeypatch):
    plan, graph = _mode_auto_case()
    calls = []
    table = {("blocking", "a2a", None): 3.0,
             ("blocking", "neighbor", None): 2.0,
             ("overlap", "neighbor-packed", None): 1.0}

    def fake_sweep(plan, graph, hidden, iters, schedules, modes, wires):
        calls.append(1)
        return dict(table)

    monkeypatch.setattr(cmp, "measure_plan_candidates", fake_sweep)
    p1 = plan.autotune(graph, measure=True)
    p2 = plan.autotune(graph, measure=True)
    assert p1.schedule == p2.schedule == "overlap"
    assert p1.halo.mode == "neighbor" and p1.halo.packed
    assert len(calls) == 1


@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_measure_plan_candidates_real_sweep_matches_autotune(wire, monkeypatch):
    plan, graph = _mode_auto_case((2, 1, 1), wire_dtype=wire)
    table = cmp.measure_plan_candidates(plan, graph, hidden=8, iters=1)
    wires = (None,) if wire is None else (None, "bfloat16")
    assert set(table) == {(s, m, w) for s in ("blocking", "overlap")
                          for m in ("a2a", "neighbor") for w in wires}
    assert all(np.isfinite(t) and t > 0 for t in table.values())
    # the pick argmins the same memoized table: nothing is measured again
    monkeypatch.setattr(cmp, "_min_seconds", lambda *a: pytest.fail("re-measured"))
    out = plan.autotune(graph, measure=True, hidden=8, iters=1)
    best = min(table, key=table.get)
    assert cmp._pick_of(out) == best
    # the tuner may drop the requested wire, never introduce one
    assert out.halo.wire_dtype in (None, wire)


def test_packed_candidate_grid_on_a_card_only():
    plan, graph = _mode_auto_case(wire_dtype="bfloat16")
    assert cmp._grid(plan, graph) == (("blocking", "overlap"), ("a2a", "neighbor"),
                                      (None, "bfloat16"))

    class OnCard:
        device = torch.device("cuda")
    assert cmp._grid(plan, OnCard())[1] == cmp.MODE_LABELS


def test_unresolved_mode_auto_errors_at_exchange():
    plan, graph = _mode_auto_case()
    with pytest.raises(ValueError, match="autotune"):
        halo_sync_stacked(torch.zeros(graph["node_mask"].shape + (4,)), graph, plan.halo)


@pytest.mark.parametrize("grid", [(2, 1, 1), (2, 2, 1), (4, 1, 1)])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_heuristic_pick_equals_reference(grid, wire):
    """measure=False: the same (schedule, halo mode, wire) as ``repro``'s
    on the same partition (``repro`` without its interpreter)."""
    ref_wire = None if wire is None else jnp.bfloat16
    plan, graph = _mode_auto_case(grid, wire_dtype=wire)
    ref_plan, ref_graph = _ref_case(grid, "auto", wire_dtype=ref_wire)
    got, want = plan.autotune(graph, measure=False), ref_plan.autotune(ref_graph,
                                                                       measure=False)
    assert (got.schedule, got.halo.mode, got.halo.packed) == \
        (want.schedule, want.halo.mode, want.halo.packed)
    assert (got.policy()["halo_wire"], got.halo.perms) == \
        (want.policy()["halo_wire"], want.halo.perms)
    # schedule-only: a fixed a2a halo
    sched = NMPPlan(halo=HaloSpec(mode=A2A), schedule="auto").autotune(graph, measure=False)
    ref_sched = ref_plan.replace(halo=ref_plan.halo.__class__(mode="a2a")).autotune(
        ref_graph, measure=False)
    assert sched.schedule == ref_sched.schedule


def test_rank_local_graph_needs_mesh():
    plan, graph = _mode_auto_case()
    with pytest.raises(ValueError, match="stacked"):
        plan.autotune(graph.rank(0))


# ---------------------------------------------------------------------------
# over processes
# ---------------------------------------------------------------------------

def test_every_process_resolves_the_leads_pick():
    job = cons.Job(elements=ELEMS, order=ORDER, cfg=GNNConfig.small(), device="cpu",
                   backends=(FUSED,), modes=(), cases=(((2, 2, 1), 1),), tune=8)
    case = cons.case_name((2, 2, 1), 1)
    recs = [p[case]["tune"] for p in cons.run_world(job, 4)]
    picks = {r["pick"] for r in recs} | {r["pick_again"] for r in recs}
    assert len(picks) == 1
    table = recs[0]["table"]
    assert set(table) == {(s, m, w) for s in ("blocking", "overlap")
                          for m in ("a2a", "neighbor") for w in (None, "bfloat16")}
    assert recs[0]["pick"] == min(table, key=table.get)
    assert all("table" not in r for r in recs[1:])
    assert all(not r["launches_again"] for r in recs)


def _train_loss(tmp_argv):
    return train_cli.main(["--device", "cpu", "--order", "2", "--steps", "1",
                           "--batch", "1"] + tmp_argv)["losses"][0]


@pytest.mark.parametrize("argv", [
    ["--elements", "2", "2", "1"],
    ["--elements", "2", "2", "1", "--ranks", "2", "1", "1"],
    ["--elements", "4", "4", "2", "--ranks", "2", "1", "1", "--levels", "3",
     "--halo", "neighbor"],
], ids=["r1", "ranks2", "ranks2_levels3"])
def test_train_cli_auto_spectral_matches_block(argv, capfd):
    want = _train_loss(argv)
    got = _train_loss(argv + ["--mp-schedule", "auto", "--partitioner", "spectral"])
    out = capfd.readouterr().out
    assert "partitioner=spectral" in out and "schedule auto resolved to" in out
    assert abs(got - want) <= LOSS_REL * abs(want)


def test_train_loop_auto_halo_and_wire_resolve():
    sem = box_mesh(ELEMS, p=ORDER)
    tcfg = TrainConfig(n_steps=1, batch=1, halo_mode="auto",
                       plan=NMPPlan(schedule="auto", backend=FUSED,
                                    halo=HaloSpec(mode="auto", wire_dtype="bfloat16")))
    hist = train_consistent_gnn(partition_mesh(sem, (1, 1, 1)), sem, GNNConfig.small(),
                                tcfg, device="cpu")
    assert hist["schedule"] == "blocking" and hist["policy"]["halo_mode"] == "none"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("ck")
    sem = box_mesh((4, 4, 2), p=2)
    train_consistent_gnn(partition_mesh(sem, (1, 1, 1)), sem, GNNConfig.small(),
                         TrainConfig(n_steps=1, batch=1, ckpt_dir=str(d), ckpt_every=1,
                                     halo_mode="none", plan=NMPPlan(backend=FUSED)),
                         device="cpu")
    return str(d)


def test_engine_spectral_auto_plan_over_two_processes(checkpoint):
    job = serve_checks.CheckJob(ckpt_dir=checkpoint, rank_grid=(2, 1, 1), requests=2,
                                batch_slots=2, rollout_steps=1, producers=1,
                                halo_mode="auto", schedule="auto", partitioner="spectral",
                                device="cpu", keep=2)
    recs = [p[0] for p in serve_checks.run_checks(job)]
    policies = {tuple(sorted(r["policy"].items())) for r in recs}
    assert len(policies) == 1
    policy = recs[0]["policy"]
    assert policy["schedule"] in ("blocking", "overlap")
    assert policy["halo_mode"] in ("a2a", "neighbor")
    assert recs[0]["bitwise_offline"] and recs[0]["n"] == 2
    sem = box_mesh((4, 4, 2), p=2)
    one = InferenceEngine(checkpoint, GNNConfig.small(), EngineConfig(
        batch_slots=2, rollout_steps=1, partitioner="spectral", halo_mode="auto"),
        plan=NMPPlan(schedule="auto", backend=FUSED), device="cpu")
    h = one.register_mesh(sem)
    assert one.entry(h, "spectral").plan.schedule == "blocking"
    for step, preds in recs[0]["preds"].items():
        want = one.offline_reference(h, serve.snapshot(sem, step))
        np.testing.assert_allclose(preds, want, rtol=3e-4, atol=1e-5)


def test_engine_refuses_unknown_partitioner():
    with pytest.raises(ValueError, match="partitioner"):
        EngineConfig(partitioner="metis")
