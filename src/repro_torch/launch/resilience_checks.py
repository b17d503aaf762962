"""Resilient training over processes: the kill / resume / recover scenarios
of the reference's resilience driver (``tests/drivers/resilience_driver.py``)
run on ``torch.distributed`` worlds started by ``launch.mesh.spawn``.

    job = ResJob(root="/tmp/r", grid=(2, 2, 1))          # 4 processes
    code = run_kill(job, 4)          # an uninterrupted run, then one that
                                     # every process os._exits at kill_at
    recs = run_resume(dataclasses.replace(job, grid=(2, 1, 1)), 2,
                      cases=("resume", "uninterrupted", "crash"))

:func:`kill_world` (the worker of :func:`run_kill`) writes each process's
pid, runs one uninterrupted resilient run into ``root/ref`` (with
``kill_ref``; the lead writes its record to ``root/ref.pkl``) and then
one into ``root/kill`` that every process leaves through
``os._exit(KILL_EXIT)`` at step ``kill_at`` — each first writes the
launches of that run to
``root/killed<rank>.json``.  :func:`resume_world` runs the named cases on
a world of any size, each into its own directory under ``root``:

* ``resume`` — resume from ``root/kill`` (written on this rank grid or,
  elastically, another);
* ``uninterrupted`` — one run from scratch, the reference of the rest;
* ``crash`` — an :class:`InjectedFailure` on every process at
  ``CRASH_AT``;
* ``save_fail`` — the lead's save at ``SAVE_FAIL_AT`` dies before its
  ``COMMIT`` (only the lead saves, so only the lead sees it);
* ``preempt`` — SIGTERM to world rank 1 alone at step ``PREEMPT_AT``,
  then a relaunch (a second call in the same processes) that resumes from
  the preempted step;
* ``auto_reuse`` — ``ckpt_every + 1`` steps on the overlap schedule, then
  the run resumed with ``schedule="auto"``, which must rerun the
  recorded schedule on every process.

Each case's record holds the history's losses, restarts, restart and
resume steps, ``preempted_at``, ``elastic``, ``schedule``, the final
params (numpy) and the launches of every kernel in that run.  The workers
import nothing of JAX or of a test module.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import signal
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.gnn import GNNConfig
from repro_torch.core.graph_state import AUTO, BLOCKING, FUSED, OVERLAP, NMPPlan
from repro_torch.core.halo import NEIGHBOR, HaloSpec
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.core.partition import partition_mesh
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_mesh, spawn, to_host
from repro_torch.runtime.fault_tolerance import FaultPlan, ResilientConfig
from repro_torch.train.loop import TrainConfig, train_consistent_gnn

KILL_EXIT = 17
CRASH_AT, SAVE_FAIL_AT, PREEMPT_AT = 3, 2, 3
LR = 1e-3
CASES = ("resume", "uninterrupted", "crash", "save_fail", "preempt", "auto_reuse")


@dataclasses.dataclass(frozen=True)
class ResJob:
    """One scenario group: the mesh (block partitioner), the model, the
    training run (fused backend, batch 1, ``LR``, seed 0) and its faults.
    ``params``: the starting parameters (a numpy tree), or None to draw
    them from the seed."""
    root: str
    elements: tuple = (2, 2, 2)
    order: int = 2
    cfg: GNNConfig = GNNConfig(hidden=8, n_mp_layers=2)
    grid: tuple = (2, 2, 1)
    halo_mode: str = NEIGHBOR
    packed: bool = True
    schedule: str = BLOCKING
    steps: int = 6
    ckpt_every: int = 2
    device: str = "cpu"
    params: Optional[dict] = None
    kill_ref: bool = True
    kill_at: int = 4


@dataclasses.dataclass
class KillRecording(FaultPlan):
    """``kill_process_at_step`` that first writes this process's launches
    to ``record`` (they die with the process otherwise)."""
    record: str = ""

    def maybe_fail(self, step: int):
        if step == self.kill_process_at_step:
            Path(self.record).write_text(json.dumps(dict(build.launch_counts)))
        super().maybe_fail(step)


@dataclasses.dataclass
class SignalAt(FaultPlan):
    """SIGTERM to this process before step ``signal_at_step`` when its
    world rank is ``signal_rank`` (a scheduler's eviction of one rank)."""
    signal_at_step: Optional[int] = None
    signal_rank: int = 0
    world_rank: int = 0

    def maybe_fail(self, step: int):
        if step == self.signal_at_step and self.world_rank == self.signal_rank:
            os.kill(os.getpid(), signal.SIGTERM)
        super().maybe_fail(step)


def _setup(job: ResJob):
    if torch.device(job.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sem = box_mesh(tuple(job.elements), p=job.order)
    pg = partition_mesh(sem, tuple(job.grid))
    world = torch.distributed.get_world_size()
    if world == 1 and pg.R == 1:
        # one process of one rank trains without a mesh, as the CLI's does
        return sem, pg, None
    return sem, pg, make_mesh(world // pg.R, pg.R,
                              backend=torch.distributed.get_backend(),
                              device=job.device)


def train(job: ResJob, sem, pg, ckpt_dir, mesh=None, fault=None) -> dict:
    """One resilient run of ``job`` into ``ckpt_dir``: its record (module
    docstring)."""
    tcfg = TrainConfig(n_steps=job.steps, batch=1, lr=LR, halo_mode=job.halo_mode,
                       plan=NMPPlan(backend=FUSED, schedule=job.schedule,
                                    halo=HaloSpec(mode=job.halo_mode,
                                                  packed=job.packed)),
                       resilience=ResilientConfig(ckpt_dir=str(ckpt_dir),
                                                  ckpt_every=job.ckpt_every,
                                                  backoff_base=0.001))
    build.reset_launch_counts()
    hist = train_consistent_gnn(pg, sem, job.cfg, tcfg, params=job.params,
                                device=job.device, mesh=mesh, fault=fault)
    rec = {k: hist[k] for k in ("losses", "restarts", "restart_steps",
                                "resume_steps", "preempted_at", "elastic",
                                "schedule")}
    rec["params"] = to_host(hist["params"])
    rec["launches"] = {k: v for k, v in build.launch_counts.items() if v}
    return rec


def kill_world(job: ResJob):
    """Worker of :func:`run_kill` (module docstring); never returns."""
    root = Path(job.root)
    sem, pg, mesh = _setup(job)
    me = torch.distributed.get_rank()
    (root / f"pid{me}").write_text(str(os.getpid()))
    if job.kill_ref:
        ref = train(job, sem, pg, root / "ref", mesh)
        if me == 0:
            with open(root / "ref.pkl", "wb") as fh:
                pickle.dump(ref, fh)
    fault = KillRecording(kill_process_at_step=job.kill_at, exit_code=KILL_EXIT,
                          record=str(root / f"killed{me}.json"))
    train(job, sem, pg, root / "kill", mesh, fault)
    raise RuntimeError(f"the run was not killed at step {job.kill_at}")


def run_kill(job: ResJob, world: int, backend: str = "gloo") -> int:
    """Spawn :func:`kill_world` on ``world`` processes; returns the exit
    code ``spawn`` reports for the first process that died."""
    import torch.multiprocessing as mp
    Path(job.root).mkdir(parents=True, exist_ok=True)
    try:
        spawn(kill_world, world, job, backend=backend, device=job.device)
    except mp.ProcessExitedException as err:
        return err.exit_code
    raise RuntimeError("the killed world exited cleanly")


def resume_world(job: ResJob, cases):
    """Worker of :func:`run_resume`: {case: record} (module docstring)."""
    root = Path(job.root)
    sem, pg, mesh = _setup(job)
    me = torch.distributed.get_rank()
    out = {}
    for case in cases:
        d = root / f"{case}_r{pg.R}"
        if case == "resume":
            out[case] = train(job, sem, pg, root / "kill", mesh)
        elif case == "uninterrupted":
            out[case] = train(job, sem, pg, d, mesh)
        elif case == "crash":
            out[case] = train(job, sem, pg, d, mesh, FaultPlan(crash_at_step=CRASH_AT))
        elif case == "save_fail":
            out[case] = train(job, sem, pg, d, mesh, FaultPlan(
                crash_save_at_step=SAVE_FAIL_AT, save_stage="pre_commit"))
        elif case == "preempt":
            first = train(job, sem, pg, d, mesh, SignalAt(
                signal_at_step=PREEMPT_AT, signal_rank=1, world_rank=me))
            out[case] = {"first": first, "relaunch": train(job, sem, pg, d, mesh)}
        elif case == "auto_reuse":
            train(dataclasses.replace(job, schedule=OVERLAP, steps=job.ckpt_every + 1),
                  sem, pg, d, mesh)
            out[case] = train(dataclasses.replace(job, schedule=AUTO), sem, pg, d, mesh)
        else:
            raise ValueError(f"unknown case {case!r}; expected one of {CASES}")
    return out


def run_resume(job: ResJob, world: int, cases=CASES, backend: str = "gloo"):
    """Spawn :func:`resume_world` on ``world`` processes; each process's
    {case: record}, in world-rank order."""
    return spawn(resume_world, world, job, tuple(cases), backend=backend,
                 device=job.device)


def read_ref(job: ResJob) -> dict:
    """The lead's record of :func:`kill_world`'s uninterrupted run."""
    with open(Path(job.root) / "ref.pkl", "rb") as fh:
        return pickle.load(fh)


def killed_launches(job: ResJob, world: int) -> list:
    """Each killed process's launches before its exit, world-rank order."""
    return [json.loads((Path(job.root) / f"killed{r}.json").read_text())
            for r in range(world)]


def pids(job: ResJob, world: int) -> list:
    return [int((Path(job.root) / f"pid{r}").read_text()) for r in range(world)]
