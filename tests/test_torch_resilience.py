"""Checkpoint resilience of the torch port: crash recovery, elastic resume
and preemption, against the JAX reference package and against the port's
own uninterrupted runs.

Mirrors ``tests/test_resilience.py`` case by case on the same small setup
(``box_mesh((2, 2, 2), p=2)``, ``GNNConfig(hidden=8, n_mp_layers=2)``,
R = 1 in-process): same-R recovery is bitwise (losses and params), a
repartitioned continuation is held to the reference's own 1e-6, the
port's losses to ``repro``'s at ``test_torch_train.py``'s bands (rel 2e-6
at step 0, 1e-4 after).  Then over gloo processes (``launch/
resilience_checks.py``; two spawns): an R=4 world killed by ``os._exit``
and resumed at R=2 within the reference resilience driver's
``ELASTIC_RTOL`` (1e-4) of an R=1 run, an in-process crash, a lead-only
save failure and a one-process SIGTERM, each bitwise against the R=2
world's uninterrupted run.  Parity weights come from ``repro``'s
``init_gnn`` through ``repro_torch.convert``.
"""
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro.core import GNNConfig as RefConfig
from repro.core import NMPPlan as RefPlan
from repro.core import box_mesh as ref_box_mesh
from repro.core import init_gnn as ref_init_gnn
from repro.core import partition_mesh as ref_partition_mesh
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.runtime.fault_tolerance import ResilientConfig as RefResilientConfig
from repro.train import loop as ref_loop

from repro_torch import nn
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.coarsen import build_hierarchy
from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import NMPPlan
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.launch import resilience_checks as rc
from repro_torch.runtime.fault_tolerance import (
    FaultPlan, InjectedFailure, ResilientConfig, backoff_seconds, preemption_guard,
    run_resilient)
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train import loop
from repro_torch.train.loop import TrainConfig, train_consistent_gnn
from repro_torch.train.optimizer import AdamWConfig, adamw_update_, init_adamw

LOSS_REL, CURVE_REL = 2e-6, 1e-4
ELASTIC_RTOL = 1e-4          # tests/drivers/resilience_driver.py
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def setup():
    sem = box_mesh((2, 2, 2), p=2)
    pg = partition_mesh(sem, (1, 1, 1))
    cfg = GNNConfig(hidden=8, n_mp_layers=2)
    start = jax.tree.map(np.asarray, ref_init_gnn(
        jax.random.PRNGKey(0), RefConfig(hidden=8, n_mp_layers=2)))
    return sem, pg, cfg, start


def _base(**kw):
    kw.setdefault("n_steps", 8)
    kw.setdefault("batch", 1)
    kw.setdefault("lr", 1e-3)
    kw.setdefault("halo_mode", "none")
    kw.setdefault("seed", 0)
    return TrainConfig(**kw)


def _rc(d, **kw):
    kw.setdefault("ckpt_every", 2)
    kw.setdefault("backoff_base", 0.001)
    return ResilientConfig(ckpt_dir=str(d), **kw)


def _train(setup, tcfg, pg=None, sem=None, **kw):
    s_sem, s_pg, cfg, start = setup
    return train_consistent_gnn(pg or s_pg, sem or s_sem, cfg, tcfg, params=start,
                                device="cpu", **kw)


def _same_params(a, b):
    return all(torch.equal(x, y) for x, y in zip(nn.tree_leaves(a), nn.tree_leaves(b)))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# ---------------------------------------------------------------------------
# resilient GNN training — bitwise recovery, elastic resume
# ---------------------------------------------------------------------------

def test_crash_recovery_bitwise_one_step(setup, tmp_path):
    ref = _train(setup, _base())
    hist = _train(setup, _base(resilience=_rc(tmp_path)),
                  fault=FaultPlan(crash_at_step=5))
    assert hist["restarts"] == 1
    assert hist["resume_steps"] and hist["resume_steps"][0] <= 4
    assert hist["losses"] == ref["losses"]
    assert _same_params(hist["params"], ref["params"])


def test_crash_recovery_bitwise_rollout(setup, tmp_path):
    kw = dict(rollout_curriculum=(1, 2), pushforward_noise=0.01,
              pushforward_noise_final=0.0)
    ref = _train(setup, _base(**kw))
    hist = _train(setup, _base(**kw, resilience=_rc(tmp_path)),
                  fault=FaultPlan(crash_at_step=5))
    assert hist["restarts"] == 1
    assert hist["losses"] == ref["losses"]
    assert hist["rollout_k"] == ref["rollout_k"]


def test_crash_recovery_bitwise_vcycle(tmp_path):
    """The multilevel V-cycle (``hierarchy=``) recovers like the flat path:
    it runs through the same execution build."""
    sem = box_mesh((4, 4, 2), p=2)
    hier = build_hierarchy(sem, (1, 1, 1), 3)
    cfg = GNNConfig(hidden=8, n_mp_layers=1, mlp_hidden_layers=2, n_levels=3,
                    coarse_mp_layers=1, coarse_edge_in=sem.dim + 1)

    def run(**kw):
        return train_consistent_gnn(hier.levels[0], sem, cfg, _base(n_steps=6, **kw),
                                    device="cpu", hierarchy=hier)
    ref = run()
    hist = run(resilience=_rc(tmp_path))
    again = train_consistent_gnn(hier.levels[0], sem, cfg,
                                 _base(n_steps=6, resilience=_rc(tmp_path / "b")),
                                 device="cpu", hierarchy=hier,
                                 fault=FaultPlan(crash_at_step=4))
    assert hist["losses"] == ref["losses"] == again["losses"]
    assert again["restarts"] == 1 and again["resume_steps"] == [2]
    assert _same_params(again["params"], ref["params"])


def test_resume_extends_run_bitwise(setup, tmp_path):
    ref = _train(setup, _base())
    _train(setup, _base(n_steps=4, resilience=_rc(tmp_path)))
    hist = _train(setup, _base(resilience=_rc(tmp_path)))
    assert hist["resume_steps"] == [3]
    assert hist["losses"] == ref["losses"]
    assert _same_params(hist["params"], ref["params"])


@pytest.mark.parametrize("save_with,resume_with",
                         [("block", "spectral"), ("spectral", "block")])
def test_elastic_partitioner_switch(setup, tmp_path, save_with, resume_with):
    sem = setup[0]

    def pg(method):
        return partition_mesh(sem, (1, 1, 1), method=method)
    ref = _train(setup, _base(partitioner=save_with), pg=pg(save_with))
    _train(setup, _base(n_steps=4, partitioner=save_with, resilience=_rc(tmp_path)),
           pg=pg(save_with))
    hist = _train(setup, _base(partitioner=resume_with, resilience=_rc(tmp_path)),
                  pg=pg(resume_with))
    el = hist["elastic"]
    assert el is not None and el["from_partitioner"] == save_with
    assert el["to_partitioner"] == resume_with and el["step"] == 4
    assert hist["losses"][:4] == ref["losses"][:4]
    for a, b in zip(hist["losses"][4:], ref["losses"][4:]):
        assert abs(a - b) < 1e-6 * max(1.0, abs(b))


def test_replay_critical_mismatch_rejected(setup, tmp_path):
    _train(setup, _base(n_steps=4, resilience=_rc(tmp_path)))
    sem2 = box_mesh((2, 2, 2), p=3)
    with pytest.raises(ValueError, match="mesh_hash"):
        train_consistent_gnn(partition_mesh(sem2, (1, 1, 1)), sem2, setup[2],
                             _base(resilience=_rc(tmp_path)), device="cpu")
    with pytest.raises(ValueError, match="seed"):
        _train(setup, _base(seed=1, resilience=_rc(tmp_path)))


def test_mid_checkpoint_crash_recovers_bitwise(setup, tmp_path):
    ref = _train(setup, _base())
    hist = _train(setup, _base(resilience=_rc(tmp_path)),
                  fault=FaultPlan(crash_save_at_step=4, save_stage="pre_commit"))
    assert hist["restarts"] >= 1
    assert hist["resume_steps"][0] < 4
    assert hist["losses"] == ref["losses"]


def test_corrupted_shard_falls_back_bitwise(setup, tmp_path):
    ref = _train(setup, _base())
    _train(setup, _base(n_steps=5, resilience=_rc(tmp_path)))
    newest = ckpt.latest_step(tmp_path)
    assert newest == 4
    FaultPlan.corrupt_shard(tmp_path, newest)
    hist = _train(setup, _base(resilience=_rc(tmp_path)))
    assert hist["resume_steps"][0] < newest
    assert hist["losses"] == ref["losses"]
    assert _same_params(hist["params"], ref["params"])


# ---------------------------------------------------------------------------
# against repro
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(setup, tmp_path_factory):
    """repro's uninterrupted 8-step resilient run on the same mesh, and its
    checkpoint directory (steps 4, 6 and 7 kept)."""
    rsem = ref_box_mesh((2, 2, 2), p=2)
    rpg = ref_partition_mesh(rsem, (1, 1, 1))
    mesh_dev = ref_make_mesh((1, 1), ("data", "graph"))
    cfg = RefConfig(hidden=8, n_mp_layers=2)

    d = tmp_path_factory.mktemp("ref") / "full"
    tcfg = ref_loop.TrainConfig(n_steps=8, batch=1, lr=1e-3, halo_mode="none", seed=0,
                                resilience=RefResilientConfig(ckpt_dir=str(d), ckpt_every=2,
                                                              backoff_base=0.001))
    full = ref_loop.train_consistent_gnn(mesh_dev, rpg, rsem, cfg, tcfg)
    return dict(full=full, dir=d, sem=rsem, pg=rpg, cfg=cfg)


def test_resilient_losses_match_reference(setup, reference, tmp_path):
    got = _train(setup, _base(resilience=_rc(tmp_path)))["losses"]
    want = reference["full"]["losses"]
    assert len(got) == len(want) == 8
    assert _rel(got[0], want[0]) <= LOSS_REL
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) <= CURVE_REL


def test_run_fingerprint_replay_fields_equal_reference(setup, reference):
    assert loop._REPLAY_FIELDS == ref_loop._REPLAY_FIELDS
    sem, pg, cfg, _ = setup
    for kw in ({}, dict(seed=3, batch=2, lr=2e-3, rollout_steps=2,
                        pushforward_noise=0.01, pushforward_noise_final=0.0)):
        mine = loop.run_fingerprint(sem, pg, cfg, _base(**kw), NMPPlan())
        theirs = ref_loop.run_fingerprint(
            reference["sem"], reference["pg"], reference["cfg"],
            ref_loop.TrainConfig(n_steps=8, halo_mode="none", **kw), RefPlan())
        for field in loop._REPLAY_FIELDS + ("ranks", "partitioner", "halo_mode"):
            assert mine[field] == theirs[field], field


def test_reference_checkpoint_resumed_by_port(setup, reference, tmp_path):
    """repro's step-4 checkpoint (its later ones removed), resumed by the
    port to 8 steps: the restored prefix is repro's, the rest in band."""
    d = tmp_path / "ck"
    shutil.copytree(reference["dir"], d)
    assert ref_ckpt.committed_steps(d) == [4, 6, 7]
    for step in (6, 7):
        shutil.rmtree(d / f"step_{step:010d}")
    hist = _train(setup, _base(resilience=_rc(d)))
    want = reference["full"]["losses"]
    assert hist["resume_steps"] == [4]
    assert hist["losses"][:5] == want[:5]          # the restored prefix
    for a, b in zip(hist["losses"][5:], want[5:]):
        assert _rel(a, b) <= CURVE_REL


# ---------------------------------------------------------------------------
# schedule="auto" on a same-R checkpoint (both packages)
# ---------------------------------------------------------------------------

def _manifest(d, ranks, schedule="overlap", backend="xla", corrupt=False):
    ckpt.save(d, 0, {"x": np.zeros(2, np.float32)},
              extra={"fingerprint": {"ranks": ranks, "policy": {
                  "backend": backend, "schedule": schedule}}})
    if corrupt:
        (Path(d) / f"step_{0:010d}" / "manifest.json").write_text("{not json")


@pytest.mark.parametrize("ranks,corrupt,want", [
    (1, False, "overlap"), (4, False, "blocking"), (1, True, "blocking")],
    ids=["same_r", "other_r", "corrupt_manifest"])
def test_auto_schedule_reruns_same_r_checkpoint_schedule(setup, reference, tmp_path,
                                                         ranks, corrupt, want):
    """A same-R checkpoint's recorded schedule is rerun by both packages;
    at another R, or with an unreadable manifest, both resolve it anew
    (blocking at one rank)."""
    _manifest(tmp_path / "ck", ranks, corrupt=corrupt)
    hist = _train(setup, _base(n_steps=1, ckpt_dir=str(tmp_path / "ck"), ckpt_every=5,
                               plan=NMPPlan(schedule="auto")))
    mesh_dev = ref_make_mesh((1, 1), ("data", "graph"))
    _manifest(tmp_path / "rk", ranks, corrupt=corrupt)
    ref = ref_loop.train_consistent_gnn(
        mesh_dev, reference["pg"], reference["sem"], reference["cfg"],
        ref_loop.TrainConfig(n_steps=1, halo_mode="none", ckpt_dir=str(tmp_path / "rk"),
                             ckpt_every=5, plan=RefPlan(schedule="auto")))
    assert hist["schedule"] == ref["schedule"] == want


# ---------------------------------------------------------------------------
# run_resilient catch-all recovery + backoff
# ---------------------------------------------------------------------------

def _toy():
    def init_state():
        return {"w": torch.zeros(4), "step": torch.tensor(0)}

    def step_fn(state, batch):
        w = state["w"] + batch
        return {"w": w, "step": state["step"] + 1}, {"loss": float(w.sum())}

    def batch_fn(step):
        return torch.full((4,), float(step % 7) * 0.25)

    return init_state, step_fn, batch_fn


def test_noninjected_failure_recovered(tmp_path):
    init_state, step_fn, batch_fn = _toy()
    fired = []

    def flaky_step(state, batch):
        if int(state["step"]) == 9 and not fired:
            fired.append(1)
            raise RuntimeError("spurious OOM")
        return step_fn(state, batch)

    cfg = ResilientConfig(ckpt_dir=str(tmp_path), ckpt_every=4, max_restarts=2,
                          backoff_base=0.001)
    state, hist = run_resilient(init_state, flaky_step, batch_fn, 15, cfg)
    assert hist["restarts"] == 1
    ref = init_state()
    for s in range(15):
        ref, _ = step_fn(ref, batch_fn(s))
    assert torch.equal(state["w"], ref["w"])
    assert len(hist["losses"]) == 15
    assert hist["backoffs"] == [0.001]


def test_persistent_failure_reraises_past_max_restarts(tmp_path):
    init_state, _, batch_fn = _toy()

    def broken_step(state, batch):
        raise OSError("disk gone")

    cfg = ResilientConfig(ckpt_dir=str(tmp_path), ckpt_every=4, max_restarts=2,
                          backoff_base=0.001)
    with pytest.raises(OSError, match="disk gone"):
        run_resilient(init_state, broken_step, batch_fn, 10, cfg)


def test_backoff_is_bounded_exponential():
    cfg = ResilientConfig(backoff_base=0.5, backoff_max=3.0)
    assert [backoff_seconds(r, cfg) for r in (1, 2, 3, 4, 5)] == \
        [0.5, 1.0, 2.0, 3.0, 3.0]


# ---------------------------------------------------------------------------
# checkpoint hardening
# ---------------------------------------------------------------------------

def test_restore_names_mismatched_key(tmp_path):
    ckpt.save(tmp_path, 0, {"a": torch.zeros(2, 3), "b": torch.ones(4)})
    with pytest.raises(ValueError, match="'a'"):
        ckpt.restore(tmp_path, {"a": torch.zeros(3, 2), "b": torch.ones(4)})
    with pytest.raises(ValueError, match="'b'"):
        ckpt.restore(tmp_path, {"a": torch.zeros(2, 3),
                                "b": torch.ones(4, dtype=torch.float64)})
    with pytest.raises(ValueError, match="extra"):
        ckpt.restore(tmp_path, {"a": torch.zeros(2, 3), "b": torch.ones(4),
                                "extra": torch.zeros(1)})
    tree, _ = ckpt.restore(tmp_path, {"a": torch.zeros(2, 3), "b": np.zeros(4, np.float32)})
    assert isinstance(tree["a"], torch.Tensor) and isinstance(tree["b"], np.ndarray)
    assert torch.equal(tree["a"], torch.zeros(2, 3)) and np.array_equal(tree["b"], np.ones(4))


def test_corrupted_shard_detected_and_fallback(tmp_path):
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    ckpt.save(tmp_path, 0, tree)
    ckpt.save(tmp_path, 5, {"w": tree["w"] + 1})
    FaultPlan.corrupt_shard(tmp_path, 5)
    with pytest.raises(ckpt.CheckpointCorruption, match="'w'"):
        ckpt.restore(tmp_path, tree, step=5)
    restored, manifest = ckpt.restore_with_fallback(tmp_path, tree)
    assert manifest["step"] == 0
    assert torch.equal(restored["w"], tree["w"])
    FaultPlan.corrupt_shard(tmp_path, 0)
    with pytest.raises(FileNotFoundError, match="all corrupted"):
        ckpt.restore_with_fallback(tmp_path, tree)


def test_prune_never_deletes_newest(tmp_path):
    for s in (0, 5, 10):
        ckpt.save(tmp_path, s, {"x": torch.full((3,), float(s))})
    ckpt.prune(tmp_path, keep=0)
    assert ckpt.committed_steps(tmp_path) == [10]
    ckpt.prune(tmp_path, keep=-3)
    assert ckpt.committed_steps(tmp_path) == [10]


def test_latest_step_survives_tmp_debris(tmp_path):
    ckpt.save(tmp_path, 3, {"x": torch.zeros(2)})
    (tmp_path / "step_0000000007.tmp").mkdir()
    (tmp_path / "garbage").mkdir()
    assert ckpt.latest_step(tmp_path) == 3
    ckpt.prune(tmp_path, keep=1)
    assert ckpt.latest_step(tmp_path) == 3


def test_async_checkpointer_surfaces_error_on_wait(tmp_path):
    target = tmp_path / "cannot_mkdir"
    target.write_text("a file where the ckpt dir should be")
    saver = ckpt.AsyncCheckpointer(target)
    saver.save(0, {"x": torch.zeros(2)})
    with pytest.raises(Exception):
        saver.wait()
    assert saver.last_error is None


def test_async_snapshot_survives_in_place_adamw(tmp_path):
    """The saver copies every leaf before ``save`` returns: an in-place
    AdamW step right after does not reach the checkpoint, whose bytes and
    checksums are the pre-update values'."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(1 << 21, generator=gen), "b": torch.randn(64, generator=gen)}
    cfg = AdamWConfig()
    opt = init_adamw(params, cfg)
    grads = nn.tree_map(lambda p: torch.ones_like(p), params)
    adamw_update_(grads, opt, params, cfg)
    before = nn.tree_map(torch.clone, {"params": params, "opt": opt})
    saver = ckpt.AsyncCheckpointer(tmp_path)
    saver.save(0, {"params": params, "opt": opt})
    for _ in range(3):
        adamw_update_(grads, opt, params, cfg)
    saver.wait()
    assert not torch.equal(params["w"], before["params"]["w"])
    template = {"params": nn.tree_map(torch.zeros_like, params),
                "opt": init_adamw(params, cfg)}
    restored, _ = ckpt.restore(tmp_path, template)
    for a, b in zip(nn.tree_leaves(restored), nn.tree_leaves(before)):
        assert torch.equal(a, b)


def test_crash_mid_save_leaves_no_commit(tmp_path):
    ckpt.save(tmp_path, 0, {"x": torch.zeros(2)})
    plan = FaultPlan(crash_save_at_step=5, save_stage="pre_commit")
    with plan.installed():
        with pytest.raises(InjectedFailure):
            ckpt.save(tmp_path, 5, {"x": torch.ones(2)})
    assert ckpt.latest_step(tmp_path) == 0
    assert (tmp_path / "step_0000000005.tmp").exists()
    assert not (tmp_path / "step_0000000005.tmp" / "COMMIT").exists()


def test_truncated_shard_detected(tmp_path):
    ckpt.save(tmp_path, 0, {"x": torch.arange(128, dtype=torch.float32)})
    plan = FaultPlan(crash_save_at_step=3, save_stage="truncate_shard")
    with plan.installed():
        with pytest.raises(InjectedFailure):
            ckpt.save(tmp_path, 3, {"x": torch.arange(128, dtype=torch.float32)})
    assert ckpt.latest_step(tmp_path) == 0
    _, manifest = ckpt.restore_with_fallback(tmp_path, {"x": torch.zeros(128)})
    assert manifest["step"] == 0


def test_manifest_carries_checksums_and_extra(tmp_path):
    ckpt.save(tmp_path, 2, {"x": torch.arange(4, dtype=torch.float32)},
              extra={"fingerprint": {"ranks": 2}})
    m = ckpt.peek_manifest(tmp_path)
    assert m["step"] == 2 and set(m["checksums"]) == {"x"}
    assert m["extra"]["fingerprint"]["ranks"] == 2
    json.dumps(m)
    # the reference reads the port's checkpoint, checksums included
    tree, rm = ref_ckpt.restore(tmp_path, {"x": jnp.zeros(4)})
    assert rm["checksums"] == m["checksums"]
    assert np.array_equal(np.asarray(tree["x"]), np.arange(4, dtype=np.float32))


def test_straggler_ewma_threshold_behavior():
    mon = StragglerMonitor(alpha=0.1, k_std=4.0, slack=1.5, warmup_steps=3)
    for s in range(10):
        mon.observe(s, 0.1)
    base_mean = mon.mean
    assert mon.observe(10, 0.12) is None
    ev = mon.observe(11, 2.0)
    assert ev is not None and ev.step == 11 and mon.mean < base_mean * 1.5
    assert mon.end_step(12) is None
    mon.reset()
    assert mon.mean is None and mon.n == 0 and len(mon.events) == 1


# ---------------------------------------------------------------------------
# preemption: SIGTERM -> early checkpoint -> clean exit -> resume
# ---------------------------------------------------------------------------

_PREEMPT_CHILD = r"""
import json, sys, time
import torch
from repro_torch.runtime.fault_tolerance import ResilientConfig, run_resilient

ckpt_dir, out_path = sys.argv[1], sys.argv[2]

def init_state():
    return {"w": torch.zeros(4), "step": torch.tensor(0)}

def step_fn(state, batch):
    time.sleep(0.05)
    w = state["w"] + batch
    return {"w": w, "step": state["step"] + 1}, {"loss": float(w.sum())}

def batch_fn(step):
    return torch.full((4,), float(step % 7) * 0.25)

cfg = ResilientConfig(ckpt_dir=ckpt_dir, ckpt_every=1000)
print("READY", flush=True)
state, hist = run_resilient(init_state, step_fn, batch_fn, 10000, cfg)
with open(out_path, "w") as f:
    json.dump({"preempted_at": hist["preempted_at"], "n_losses": len(hist["losses"])}, f)
"""


def test_sigterm_preemption_checkpoints_and_resumes(tmp_path):
    ckpt_dir, out_path = tmp_path / "ckpt", tmp_path / "hist.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen([sys.executable, "-c", _PREEMPT_CHILD, str(ckpt_dir),
                             str(out_path)], stdout=subprocess.PIPE, env=env, text=True)
    assert proc.stdout.readline().strip() == "READY"
    time.sleep(0.5)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0

    hist = json.loads(out_path.read_text())
    step = hist["preempted_at"]
    assert step is not None and hist["n_losses"] == step + 1
    assert ckpt.latest_step(ckpt_dir) == step
    _, manifest = ckpt.restore_with_fallback(
        ckpt_dir, {"w": torch.zeros(4), "step": torch.tensor(0)})
    assert manifest["extra"]["reason"] == "preempted"

    init_state, step_fn, batch_fn = _toy()
    n_steps = step + 5
    state, hist2 = run_resilient(init_state, step_fn, batch_fn, n_steps,
                                 _rc(ckpt_dir, ckpt_every=1000))
    assert hist2["resume_steps"] == [step]
    ref_state, ref = run_resilient(init_state, step_fn, batch_fn, n_steps,
                                   _rc(tmp_path / "ref"))
    assert hist2["losses"] == ref["losses"]
    assert torch.equal(state["w"], ref_state["w"])


def test_preemption_guard_restores_previous_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with preemption_guard() as flag:
        assert not flag["preempted"]
        os.kill(os.getpid(), signal.SIGTERM)
        assert flag["preempted"] and flag["signum"] == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) == prev
    with preemption_guard(enabled=False) as flag:
        assert signal.getsignal(signal.SIGTERM) == prev
        assert not flag["preempted"]


# ---------------------------------------------------------------------------
# over gloo processes: kill at R=4, resume at R=2, agreement points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    """One R=4 world (an uninterrupted run, then one every process
    ``os._exit``s at step 4) and one R=2 world running every scenario of
    ``launch/resilience_checks.py``; the R=1 run in this process."""
    root = tmp_path_factory.mktemp("worlds")
    job = rc.ResJob(root=str(root), grid=(2, 2, 1), params=setup[3])
    code = rc.run_kill(job, 4)
    job2 = dataclasses.replace(job, grid=(2, 1, 1))
    recs = rc.run_resume(job2, 2)
    sem = box_mesh(job.elements, p=job.order)
    r1 = rc.train(dataclasses.replace(job, grid=(1, 1, 1), halo_mode="none",
                                      packed=False),
                  sem, partition_mesh(sem, (1, 1, 1)), root / "r1")
    return dict(job=job, code=code, ref4=rc.read_ref(job), recs=recs, r1=r1)


def test_killed_world_exits_with_its_code_and_leaves_no_process(worlds):
    assert worlds["code"] == rc.KILL_EXIT
    for pid in rc.pids(worlds["job"], 4):
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert ckpt.latest_step(Path(worlds["job"].root) / "kill") is not None


def test_elastic_r4_killed_resumed_at_r2_within_band(worlds):
    recs, ref4, r1 = worlds["recs"], worlds["ref4"], worlds["r1"]
    el = recs[0]["resume"]["elastic"]
    s = el["step"]
    assert el["from_ranks"] == 4 and el["to_ranks"] == 2 and 0 < s <= worlds["job"].kill_at
    for p in recs:
        got = p["resume"]["losses"]
        assert got == recs[0]["resume"]["losses"]
        assert got[:s] == ref4["losses"][:s]               # restored prefix, bitwise
        for a, b in zip(got, r1["losses"]):
            assert abs(a - b) <= ELASTIC_RTOL * max(1.0, abs(b))
    for a, b in zip(nn.tree_leaves(recs[0]["resume"]["params"]),
                    nn.tree_leaves(recs[1]["resume"]["params"])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", ["crash", "save_fail", "preempt"])
def test_recovery_over_two_processes_bitwise(worlds, case):
    """An injected crash on both processes, a save failure only the lead
    sees, and SIGTERM to process 1 alone: each ends in one decision on
    both processes and the trajectory is bitwise the uninterrupted one."""
    recs = worlds["recs"]
    want = recs[0]["uninterrupted"]
    for p in recs:
        rec = p[case]
        if case == "preempt":
            first, rec = rec["first"], rec["relaunch"]
            assert first["preempted_at"] == rc.PREEMPT_AT
            assert first["losses"] == want["losses"][:rc.PREEMPT_AT + 1]
            assert rec["resume_steps"] == [rc.PREEMPT_AT]     # zero lost steps
        else:
            assert rec["restarts"] == 1
            assert rec["resume_steps"][0] < (rc.CRASH_AT if case == "crash"
                                             else rc.SAVE_FAIL_AT)
        assert rec["losses"] == want["losses"]
        for a, b in zip(nn.tree_leaves(rec["params"]), nn.tree_leaves(want["params"])):
            assert np.array_equal(a, b)
    manifest = ckpt.peek_manifest(Path(worlds["job"].root) / "preempt_r2", rc.PREEMPT_AT)
    assert manifest["extra"]["reason"] == "preempted"


def test_auto_schedule_reruns_recorded_schedule_on_every_process(worlds):
    assert [p["auto_reuse"]["schedule"] for p in worlds["recs"]] == ["overlap"] * 2
    assert all(p["auto_reuse"]["resume_steps"] for p in worlds["recs"])
