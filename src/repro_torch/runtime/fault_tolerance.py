"""Fault-tolerant training driver: checkpoint/restart with failure injection
(port of ``repro.runtime.fault_tolerance``).

``run_resilient`` wraps a step function with:
  * periodic async checkpoints (+ straggler-triggered early checkpoints);
  * crash recovery: on ANY exception the driver restores the latest valid
    committed checkpoint and resumes (up to ``max_restarts``, with bounded
    exponential backoff between attempts).  Corrupted checkpoints are
    skipped by ``ckpt.restore_with_fallback`` (checksum validation);
  * deterministic data replay: the batch function is keyed by step, so a
    restart replays exactly the batches after the restored step;
  * preemption handling (:func:`preemption_guard`): SIGTERM finishes the
    current step, commits an early checkpoint with reason
    ``"preempted"``, and returns cleanly so the relaunched job loses zero
    steps;
  * fault injection (:class:`FaultPlan`): step-indexed exceptions, hard
    process kills (``os._exit``), crashes inside the checkpoint save path
    and post-commit shard corruption.

Over a mesh (``mesh=``: one process per rank and replica,
``repro_torch.launch.mesh``) every process runs the driver and each
decision is taken by all of them at the same step, or the next
collective of the step would hang:
  * only the lead (world rank 0) writes, waits on and prunes checkpoints;
    a save error it sees (surfaced by the saver's next ``save``/``wait``)
    is held until the next agreement point;
  * the agreement points are each step boundary and the end of the run:
    every process all-reduces (max) one small flag over the world group —
    "preempted here" and "the lead holds a save error" — and all of them
    return, save or raise together;
  * a :class:`FaultPlan` given to every process fires at the same step on
    each of them, so an injected crash sends them all into recovery at
    once;
  * before any process restores, the lead waits for its saver and every
    process passes a barrier, so no process reads a step whose ``COMMIT``
    is not yet on disk.
A failure on one process alone that is not at an agreement point (a real
crash inside a collective, an ``os._exit``) is not recovered in-process:
``launch.mesh.spawn`` (``mp.start_processes(join=True)``) tears down the
whole world and raises, and the relaunch resumes from disk — elastically,
onto another rank count if need be (``repro_torch.train.loop``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.runtime.straggler import StragglerMonitor


@dataclasses.dataclass
class ResilientConfig:
    """The reference's resilient-driver config, field for field."""
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    straggler_checkpoint: bool = True
    # bounded exponential backoff between restarts:
    # sleep min(backoff_base * 2**(restarts-1), backoff_max) seconds
    backoff_base: float = 0.05
    backoff_max: float = 5.0
    # manifests carry the last `history_tail` losses so a resumed run's
    # history is continuous
    history_tail: int = 10000
    # SIGTERM triggers an early fingerprinted checkpoint and a clean return
    preempt_checkpoint: bool = True


class InjectedFailure(RuntimeError):
    pass


def backoff_seconds(restarts: int, cfg: ResilientConfig) -> float:
    """Bounded exponential backoff for restart attempt ``restarts`` (1-based)."""
    return min(cfg.backoff_base * (2.0 ** max(restarts - 1, 0)), cfg.backoff_max)


@dataclasses.dataclass
class FaultPlan:
    """Declarative fault injection for resilience tests and drivers.

    Step faults (checked by ``maybe_fail`` before each training step):
      * ``crash_at_step`` — raise ``exc`` (default :class:`InjectedFailure`)
        the first ``n_crashes`` times the step is reached;
      * ``kill_process_at_step`` — ``os._exit(exit_code)``: no cleanup, the
        async saver thread dies mid-flight.

    Checkpoint-save faults (installed as the ``ckpt`` fault hook while the
    plan is active via :meth:`installed`):
      * ``crash_save_at_step`` — the first save at/after this step dies at
        ``save_stage``: "pre_commit" leaves shard+manifest but no COMMIT;
        "truncate_shard" additionally truncates the shard npz.

    ``corrupt_shard`` damages an already-committed shard in place.
    """
    crash_at_step: Optional[int] = None
    exc: type = InjectedFailure
    n_crashes: int = 1
    kill_process_at_step: Optional[int] = None
    exit_code: int = 17
    crash_save_at_step: Optional[int] = None
    save_stage: str = "pre_commit"          # or "truncate_shard"
    crashes_fired: int = 0
    save_crashes_fired: int = 0

    def maybe_fail(self, step: int):
        if self.kill_process_at_step is not None and step == self.kill_process_at_step:
            os._exit(self.exit_code)
        if (self.crash_at_step is not None and step == self.crash_at_step
                and self.crashes_fired < self.n_crashes):
            self.crashes_fired += 1
            raise self.exc(f"injected failure at step {step}")

    def _ckpt_hook(self, stage: str, step: int, step_dir: Path):
        if self.crash_save_at_step is None or step < self.crash_save_at_step:
            return
        if self.save_crashes_fired >= self.n_crashes:
            return
        if self.save_stage == "truncate_shard" and stage == "arrays_written":
            shard = step_dir / "shard_0.npz"
            size = shard.stat().st_size
            with open(shard, "r+b") as f:
                f.truncate(max(size // 2, 1))
            self.save_crashes_fired += 1
            raise InjectedFailure(
                f"injected save crash (truncated shard) at step {step}")
        if self.save_stage == "pre_commit" and stage == "pre_commit":
            self.save_crashes_fired += 1
            raise InjectedFailure(
                f"injected save crash (no COMMIT) at step {step}")

    @contextlib.contextmanager
    def installed(self):
        """Activate the checkpoint-save faults for the duration."""
        if self.crash_save_at_step is None:
            yield self
            return
        prev = ckpt.set_fault_hook(self._ckpt_hook)
        try:
            yield self
        finally:
            ckpt.set_fault_hook(prev)

    @staticmethod
    def corrupt_shard(ckpt_dir: str | Path, step: int, n_bytes: int = 16):
        """Flip bytes in the middle of a COMMITTED step's shard.  Restore
        detects it by checksum."""
        shard = Path(ckpt_dir) / f"step_{step:010d}" / "shard_0.npz"
        size = shard.stat().st_size
        off = size // 2
        with open(shard, "r+b") as f:
            f.seek(off)
            chunk = f.read(n_bytes)
            f.seek(off)
            f.write(bytes(b ^ 0xFF for b in chunk))


@contextlib.contextmanager
def preemption_guard(enabled: bool = True):
    """Turn SIGTERM into a cooperative flag for the duration of the block
    (``flag["preempted"]``, ``flag["signum"]``); the previous handler is
    restored on exit.  Off the main thread (or with ``enabled=False``) the
    guard is an inert flag."""
    flag = {"preempted": False, "signum": None}
    if not enabled or threading.current_thread() is not threading.main_thread():
        yield flag
        return

    def _handler(signum, frame):
        flag["preempted"] = True
        flag["signum"] = signum

    prev = signal.signal(signal.SIGTERM, _handler)
    try:
        yield flag
    finally:
        signal.signal(signal.SIGTERM, prev)


def _default_restore(cfg: ResilientConfig, init_state_fn):
    """Restore the newest valid committed step, or None for a fresh start.
    Returns (state, start_step, prior_losses, manifest)."""
    if not ckpt.committed_steps(cfg.ckpt_dir):
        return None
    state, manifest = ckpt.restore_with_fallback(cfg.ckpt_dir, init_state_fn())
    start = manifest["step"] + 1
    extra = manifest.get("extra", {})
    off = int(extra.get("losses_offset", 0))
    losses = list(extra.get("losses", []))[:max(start - off, 0)]
    return state, start, losses, manifest


class SaveFailedOnLead(ckpt.CheckpointError):
    """Raised on a follower when the lead's checkpoint save failed: the
    whole mesh recovers together."""


class _Agreement:
    """The decisions every process of ``mesh`` takes at the same step
    (module docstring).  Without a mesh, or with one process, the lead's
    save errors raise where they surface, as in the reference."""

    def __init__(self, mesh):
        self.mesh = mesh if mesh is not None and mesh.world_group.size > 1 else None
        self.lead = mesh is None or mesh.lead
        self.pending: Optional[BaseException] = None

    def hold(self, err: BaseException):
        """A save error seen by the lead."""
        if self.mesh is None:
            raise err
        self.pending = err

    def _max(self, flags):
        group = self.mesh.world_group
        dev = (self.mesh.device if group.transport.backend == "nccl"
               else torch.device("cpu"))
        t = torch.tensor(flags, dtype=torch.int32, device=dev)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                     group=group.pg)
        return [bool(v) for v in t.tolist()]

    def preempted(self, here: bool) -> bool:
        """Whether any process was preempted; raises on every process if
        the lead holds a save error."""
        if self.mesh is None:
            return here
        anywhere, failed = self._max([int(here), int(self.pending is not None)])
        if failed:
            err, self.pending = self.pending, None
            raise err if err is not None else SaveFailedOnLead(
                "the lead's checkpoint save failed")
        return anywhere

    def barrier(self):
        self.pending = None
        if self.mesh is not None:
            self._max([0])


def run_resilient(
    init_state_fn: Callable[[], Any],
    step_fn: Callable[[Any, Any], tuple],     # (state, batch) -> (state, metrics)
    batch_fn: Callable[[int], Any],           # step -> batch (deterministic replay)
    n_steps: int,
    cfg: ResilientConfig,
    inject_failure_at: Optional[int] = None,
    monitor: Optional[StragglerMonitor] = None,
    fault: Optional[FaultPlan] = None,
    restore_fn: Optional[Callable[[], Optional[tuple]]] = None,
    manifest_extra: Optional[dict] = None,
    mesh=None,
):
    """Returns (final_state, history dict).

    Any ``Exception`` from a step (or a surfaced async-save failure) counts
    as a crash: the driver restores the latest valid committed checkpoint,
    sleeps a bounded exponential backoff, and replays.  After
    ``cfg.max_restarts`` failed restarts the exception propagates.
    ``KeyboardInterrupt``/``SystemExit`` always propagate.

    ``restore_fn`` overrides the default restore — it must return
    ``(state, start_step, prior_losses)`` (extra trailing values are
    allowed) or None for a fresh start.  ``manifest_extra`` is merged into
    every checkpoint manifest's ``extra``.  With ``cfg.preempt_checkpoint``
    SIGTERM commits an early checkpoint (reason ``"preempted"``) after the
    current step and returns with ``history["preempted_at"]`` set.
    ``mesh``: this process's mesh; every process of it calls the driver
    with the same arguments (module docstring).
    """
    agree = _Agreement(mesh)
    saver = ckpt.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep) if agree.lead else None
    monitor = monitor or StragglerMonitor()
    history = {"losses": [], "restarts": 0, "straggler_events": 0,
               "restart_steps": [], "resume_steps": [], "backoffs": [],
               "preempted_at": None}
    if inject_failure_at is not None and fault is None:
        fault = FaultPlan(crash_at_step=inject_failure_at)

    def save_extra(reason: str) -> dict:
        tail = history["losses"][-cfg.history_tail:]
        extra = {"reason": reason,
                 "losses": list(tail),     # copy: async thread serializes later
                 "losses_offset": len(history["losses"]) - len(tail)}
        if manifest_extra:
            extra.update(manifest_extra)
        return extra

    def save(step, state, reason):
        if saver is not None:
            try:
                saver.save(step, state, extra=save_extra(reason))
            except Exception as err:
                agree.hold(err)

    def wait():
        if saver is not None:
            try:
                saver.wait()
            except Exception as err:
                agree.hold(err)

    restarts = 0
    step = 0
    with preemption_guard(cfg.preempt_checkpoint) as sig:
        while True:
            try:
                with (fault.installed() if fault is not None
                      else contextlib.nullcontext()):
                    restored = (restore_fn() if restore_fn is not None
                                else _default_restore(cfg, init_state_fn))
                    if restored is None:
                        state, start = init_state_fn(), 0
                        history["losses"] = []
                    else:
                        state, start, prior_losses = (
                            restored[0], restored[1], restored[2])
                        # truncate to the restored prefix — replayed steps
                        # must not be double-counted in the history
                        history["losses"] = list(prior_losses)
                        history["resume_steps"].append(start - 1)

                    for step in range(start, n_steps):
                        if fault is not None:
                            fault.maybe_fail(step)
                        batch = batch_fn(step)
                        monitor.start_step()
                        state, metrics = step_fn(state, batch)
                        ev = monitor.end_step(step)
                        history["losses"].append(float(metrics.get("loss", 0.0)))
                        if agree.preempted(sig["preempted"]):
                            # eviction warning: commit NOW, exit cleanly —
                            # the relaunch resumes from this exact step
                            history["preempted_at"] = step
                            save(step, state, "preempted")
                            wait()
                            agree.preempted(False)
                            return state, history
                        if ev is not None:
                            history["straggler_events"] += 1
                            if cfg.straggler_checkpoint:
                                save(step, state, "straggler")
                        if step % cfg.ckpt_every == 0 or step == n_steps - 1:
                            save(step, state, "periodic")
                    wait()
                    agree.preempted(False)
                    return state, history

            except Exception:
                restarts += 1
                history["restarts"] = restarts
                history["restart_steps"].append(step)
                if restarts > cfg.max_restarts:
                    raise
                # a failed in-flight save must not abort the recovery itself
                if saver is not None:
                    try:
                        saver.wait()
                    except Exception:
                        pass
                # every COMMIT the lead wrote is on disk before anyone reads
                agree.barrier()
                delay = backoff_seconds(restarts, cfg)
                history["backoffs"].append(delay)
                time.sleep(delay)
