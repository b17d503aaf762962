"""Resident solver-in-the-loop inference engine (port of
``repro.runtime.engine``) on one CUDA device.

* :class:`InferenceEngine` holds the trained params — loaded ONCE from a
  fingerprinted checkpoint in the reference's format (written by ``repro``
  or ``repro_torch``) — and a graph cache keyed by
  ``(mesh_fingerprint_hash, partitioner)``: the first request for a mesh
  pays the ``partition_mesh`` + ``ShardedGraph`` + ``NMPPlan`` build, every
  later request reuses it.
* Requests (global ``[N, F]`` snapshot fields) arrive on a BOUNDED
  thread-safe queue — :meth:`InferenceEngine.submit` blocks when the engine
  is saturated (backpressure) — get grouped into ``batch_slots`` fixed,
  zero-padded slots, and run through the K-step rollout of
  ``repro_torch.train.rollout``.
* Results stream back per request through single-shot futures;
  :meth:`InferenceEngine.stream` puts a multi-producer
  ``PrefetchingLoader`` in front of the queue for solver-style feeds.

Consistency contract: streamed predictions are BITWISE identical to the
batch-1 :meth:`InferenceEngine.offline_reference` of the same snapshot —
batching, slot padding, queueing and threading are arithmetically
invisible.  That holds because each slot runs on its own (same matmul
shapes at any slot count) and every reduction on the path is
deterministic (the fused kernel's slot-ordered aggregate, the sorted
segment sum of the plain backend).

Checkpoint contract: the engine refuses a checkpoint without a mesh
fingerprint, refuses params whose recorded model config disagrees with the
engine's ``GNNConfig``, and refuses requests or mesh registrations whose
``mesh_fingerprint_hash`` differs from the checkpoint's, naming BOTH
hashes.  A corrupted newest checkpoint falls back to the previous
committed step.

This slice serves one rank on one device (halo mode none); serving a
multi-rank partition (requests fanned out to the processes of a mesh)
is a later slice.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.graph_state import NMPPlan, ShardedGraph
from repro_torch.core.mesh_gen import SEMMesh
from repro_torch.core.partition import (
    gather_node_features, partition_mesh, scatter_node_outputs)
from repro_torch.data.pipeline import PrefetchingLoader
from repro_torch.train.loop import mesh_fingerprint_hash
from repro_torch.train.rollout import make_rollout_predict_fn


class EngineError(RuntimeError):
    """Engine lifecycle/request failure (shutdown, saturation, bad input)."""


class MeshMismatchError(EngineError):
    """Request/registration mesh hash differs from the checkpoint's."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine policy: ``batch_slots`` fixed slots per batch (requests
    zero-padded up to it), ``max_pending`` bounds the request queue (the
    backpressure point), ``flush_timeout_s`` is how long a non-full batch
    waits for more requests."""
    batch_slots: int = 4
    rollout_steps: int = 1
    max_pending: int = 16
    flush_timeout_s: float = 0.02
    result_timeout_s: float = 300.0
    partitioner: str = "block"

    def __post_init__(self):
        if self.batch_slots < 1 or self.rollout_steps < 1 \
                or self.max_pending < 1:
            raise ValueError(
                "batch_slots, rollout_steps and max_pending must be >= 1 "
                f"(got {self.batch_slots}/{self.rollout_steps}/"
                f"{self.max_pending})")


@dataclasses.dataclass
class InferenceResult:
    """One request's K-step prediction, scattered back to the global mesh."""
    step: int
    mesh_hash: str
    preds: np.ndarray          # [K, N_global, F_out]
    latency_s: float


class RequestFuture:
    """Single-shot future for one submitted snapshot."""

    def __init__(self, step: int):
        self.step = step
        self._ev = threading.Event()
        self._val: Optional[InferenceResult] = None
        self._err: Optional[BaseException] = None

    def _set(self, val: InferenceResult):
        self._val = val
        self._ev.set()

    def _fail(self, err: BaseException):
        self._err = err
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> InferenceResult:
        if not self._ev.wait(timeout):
            raise EngineError(
                f"request step={self.step} not completed after {timeout}s — "
                "is the engine started?")
        if self._err is not None:
            raise self._err
        return self._val


@dataclasses.dataclass
class _Request:
    step: int
    key: tuple
    x: np.ndarray              # global [N, F] snapshot
    future: RequestFuture
    t_submit: float


@dataclasses.dataclass
class _GraphEntry:
    """One mesh's cached execution state (built once, reused per request)."""
    mesh_hash: str
    pg: Any
    plan: NMPPlan
    gs: ShardedGraph
    predict: Callable
    build_s: float


def config_from_checkpoint(ckpt_dir, step: Optional[int] = None) -> GNNConfig:
    """The flat GNN config whose parameters a checkpoint holds, read from the
    array shapes in its manifest (the newest committed step by default).
    Returns ``GNNConfig.small()``/``large()`` when the shapes are theirs."""
    manifest = ckpt.peek_manifest(ckpt_dir, step)
    if manifest is None:
        raise EngineError(f"no committed checkpoint under {ckpt_dir}")
    shapes = manifest["shapes"]
    if "params/node_enc/layers/0/w" not in shapes:
        raise EngineError(f"checkpoint under {ckpt_dir} holds no GNN params")

    def indices(prefix, pos):
        return {k.split("/")[pos] for k in shapes if k.startswith(prefix)}

    n_layers = len(indices("params/node_enc/layers/", 3))
    enc = shapes["params/node_enc/layers/0/w"]
    fields = dict(hidden=enc[1], n_mp_layers=len(indices("params/mp/", 2)),
                  mlp_hidden_layers=n_layers - 1, node_in=enc[0],
                  edge_in=shapes["params/edge_enc/layers/0/w"][0],
                  node_out=shapes[f"params/node_dec/layers/{n_layers - 1}/w"][1])
    for named in (GNNConfig.small(), GNNConfig.large()):
        if all(getattr(named, k) == v for k, v in fields.items()):
            return named
    return GNNConfig(**fields, name="custom")


class InferenceEngine:
    """Resident serving engine over the K-step rollout on one device.

    Lifecycle: construct (loads params from ``ckpt_dir``), then
    :meth:`register_mesh` each geometry, optionally :meth:`warmup`,
    :meth:`start` the engine thread, feed it via :meth:`submit` /
    :meth:`stream`, and :meth:`close`.  Also a context manager.
    """

    def __init__(self, ckpt_dir, cfg: GNNConfig,
                 config: EngineConfig = EngineConfig(),
                 plan: NMPPlan = NMPPlan(), device="cuda"):
        self.cfg = cfg
        self.config = config
        self.device = torch.device(device)
        # execution-policy fields forwarded into each mesh's NMPPlan.build
        self._policy = {"backend": plan.backend, "schedule": plan.schedule,
                        "block_n": plan.block_n, "block_e": plan.block_e}
        self.R = 1
        self.params, self.fingerprint, self.ckpt_step = \
            self._load_params(ckpt_dir)
        self._graphs: dict[tuple, _GraphEntry] = {}
        self._q: queue.Queue = queue.Queue(maxsize=config.max_pending)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._failure: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                      "cache_hits": 0, "cache_builds": 0}

    # -- checkpoint ---------------------------------------------------------

    def _load_params(self, ckpt_dir):
        steps = ckpt.committed_steps(ckpt_dir)
        if not steps:
            raise EngineError(
                f"no committed checkpoint under {ckpt_dir} — write one with "
                "repro.train.loop (TrainConfig.ckpt_dir) or ckpt.save")
        template = params_to_jax(
            init_gnn(torch.Generator().manual_seed(0), self.cfg, device="cpu"))
        last_err: Optional[BaseException] = None
        for step in reversed(steps):
            try:
                manifest = ckpt.peek_manifest(ckpt_dir, step)
                fp = (manifest.get("extra") or {}).get("fingerprint")
                if not fp or "mesh_hash" not in fp:
                    raise EngineError(
                        f"checkpoint step {step} under {ckpt_dir} carries no "
                        "mesh fingerprint — the engine only serves "
                        "fingerprinted checkpoints (run_fingerprint)")
                for field, have in (("hidden", self.cfg.hidden),
                                    ("n_levels", self.cfg.n_levels)):
                    if fp.get(field) is not None \
                            and int(fp[field]) != int(have):
                        raise EngineError(
                            f"engine GNNConfig.{field}={have} disagrees with "
                            f"the checkpoint fingerprint {field}={fp[field]} "
                            "— these params belong to a different model")
                tree, _ = ckpt.restore_partial(ckpt_dir, template, "params",
                                               step=step)
                return params_from_jax(tree, self.device), fp, step
            except ckpt.CheckpointCorruption as e:
                # damaged-after-commit newest step: fall back (config
                # problems raise EngineError/ValueError immediately)
                print(f"[engine] checkpoint step {step} corrupted, "
                      f"falling back: {e}")
                last_err = e
        raise EngineError(
            f"no valid committed checkpoint under {ckpt_dir} "
            f"({len(steps)} committed steps, all corrupted; last error: "
            f"{last_err})")

    # -- graph cache --------------------------------------------------------

    def _mismatch(self, mesh_hash: str) -> MeshMismatchError:
        return MeshMismatchError(
            f"mesh {mesh_hash} does not match the checkpoint's trained mesh "
            f"{self.fingerprint['mesh_hash']} "
            f"(n_global={self.fingerprint.get('n_global')}) — the engine "
            "refuses to run a model on a geometry it was not trained on")

    def register_mesh(self, sem_mesh: SEMMesh, rank_grid=None,
                      partitioner: Optional[str] = None) -> str:
        """Build (or fetch from cache) the execution state for one mesh;
        returns its ``mesh_fingerprint_hash``, the key of every later
        :meth:`submit` / :meth:`stream` call."""
        mesh_hash = mesh_fingerprint_hash(sem_mesh)
        if mesh_hash != self.fingerprint["mesh_hash"]:
            raise self._mismatch(mesh_hash)
        partitioner = partitioner or self.config.partitioner
        key = (mesh_hash, partitioner)
        with self._lock:
            if key in self._graphs:
                self.stats["cache_hits"] += 1
                return mesh_hash
            t0 = time.perf_counter()
            grid = tuple(rank_grid) if rank_grid is not None \
                else (self.R,) + (1,) * (sem_mesh.dim - 1)
            if int(np.prod(grid)) != self.R:
                raise EngineError(
                    f"rank_grid {grid} does not cover the engine's "
                    f"R={self.R} rank(s)")
            pg = partition_mesh(sem_mesh, grid, method=partitioner)
            plan = NMPPlan.build(pg, "none", **self._policy)
            graph = ShardedGraph.build(pg, sem_mesh.coords, plan,
                                       device=self.device)
            plan = plan.autotune(graph, hidden=self.cfg.hidden)
            predict = make_rollout_predict_fn(self.cfg, plan,
                                              self.config.rollout_steps)
            self._graphs[key] = _GraphEntry(
                mesh_hash=mesh_hash, pg=pg, plan=plan, gs=graph,
                predict=predict, build_s=time.perf_counter() - t0)
            self.stats["cache_builds"] += 1
        return mesh_hash

    def entry(self, mesh_hash: str, partitioner: Optional[str] = None
              ) -> _GraphEntry:
        """The cached execution state of a registered mesh."""
        if mesh_hash != self.fingerprint["mesh_hash"]:
            raise self._mismatch(mesh_hash)
        key = (mesh_hash, partitioner or self.config.partitioner)
        with self._lock:
            found = self._graphs.get(key)
        if found is None:
            raise EngineError(
                f"mesh {mesh_hash} (partitioner={key[1]!r}) is not "
                "registered — call register_mesh(sem_mesh) before "
                "submitting requests")
        return found

    def _predict_global(self, entry: _GraphEntry, xs: list) -> np.ndarray:
        """Global snapshots -> per-rank predictions [B, K, R, N_pad, F]."""
        x0 = np.stack([gather_node_features(entry.pg, x) for x in xs])
        return entry.predict(self.params, x0, entry.gs).cpu().numpy()

    def warmup(self, mesh_hash: Optional[str] = None):
        """Run one zero batch per cached mesh (loads the CUDA kernels and
        warms the allocator) so the first real request does not pay it."""
        with self._lock:
            entries = [e for k, e in self._graphs.items()
                       if mesh_hash is None or k[0] == mesh_hash]
        for entry in entries:
            zero = np.zeros((entry.pg.n_global, self.cfg.node_in), np.float32)
            self._predict_global(entry, [zero] * self.config.batch_slots)

    # -- lifecycle ----------------------------------------------------------

    def _shutdown_error(self) -> EngineError:
        if self._failure is not None:
            return EngineError(f"engine terminated: {self._failure!r}")
        return EngineError("engine is shut down")

    def start(self) -> "InferenceEngine":
        if self._thread is not None:
            raise EngineError("engine already started")
        if self._stop.is_set():
            raise self._shutdown_error()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="inference-engine")
        self._thread.start()
        return self

    def close(self, error: Optional[BaseException] = None):
        """Stop the engine thread and fail every still-queued request."""
        if error is not None and self._failure is None:
            self._failure = error
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._drain_failed()

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def _drain_failed(self):
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            req.future._fail(self._shutdown_error())

    # -- request path -------------------------------------------------------

    def submit(self, mesh_hash: str, x, step: int = 0,
               timeout: Optional[float] = None,
               partitioner: Optional[str] = None) -> RequestFuture:
        """Queue one global ``[N, F]`` snapshot; returns its future.  Blocks
        while ``max_pending`` requests are queued, for at most ``timeout``
        seconds (:class:`EngineError` on expiry)."""
        if self._stop.is_set():
            raise self._shutdown_error()
        entry = self.entry(mesh_hash, partitioner)
        x = np.asarray(x, np.float32)
        want = (int(entry.pg.n_global), int(self.cfg.node_in))
        if tuple(x.shape) != want:
            raise EngineError(
                f"snapshot shape {tuple(x.shape)} does not match the "
                f"registered mesh ({want[0]} nodes x {want[1]} fields)")
        fut = RequestFuture(step)
        req = _Request(step=step,
                       key=(mesh_hash, partitioner or self.config.partitioner),
                       x=x, future=fut, t_submit=time.perf_counter())
        try:
            self._q.put(req, timeout=timeout)
        except queue.Full:
            raise EngineError(
                f"request queue full ({self.config.max_pending} pending) "
                f"after {timeout}s — the engine is saturated "
                "(backpressure)") from None
        if self._stop.is_set():
            self._drain_failed()      # raced a shutdown: never hang
        return fut

    def stream(self, mesh_hash: str, batch_fn: Callable[[int], Any],
               n_requests: int, n_producers: int = 1, prefetch: int = 4,
               start_step: int = 0):
        """Producer-threaded streaming: yields ``(step, InferenceResult)``
        in submission order.  A dead producer drains what it queued, then
        SHUTS THE ENGINE DOWN and raises :class:`EngineError`."""
        loader = PrefetchingLoader(batch_fn, prefetch=prefetch,
                                   start_step=start_step,
                                   n_producers=n_producers)
        futs: queue.Queue = queue.Queue()
        done = object()
        box: dict = {"err": None}

        def feed():
            try:
                for _ in range(n_requests):
                    step, batch = next(loader)
                    futs.put((step, self.submit(mesh_hash, np.asarray(batch),
                                                step=step)))
            except StopIteration:
                pass
            except BaseException as e:
                box["err"] = e
            finally:
                loader.close()
                futs.put(done)

        feeder = threading.Thread(target=feed, daemon=True,
                                  name="engine-stream-feeder")
        feeder.start()
        try:
            while True:
                item = futs.get()
                if item is done:
                    break
                step, fut = item
                yield step, fut.result(timeout=self.config.result_timeout_s)
        finally:
            feeder.join(timeout=30)
        if box["err"] is not None:
            err = box["err"]
            self.close(error=err)
            raise EngineError(
                f"producer feed for mesh {mesh_hash} died; engine shut "
                f"down: {err!r}") from err

    # -- engine thread ------------------------------------------------------

    def _loop(self):
        try:
            while not self._stop.is_set():
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
                batch = [first]
                deadline = time.perf_counter() + self.config.flush_timeout_s
                while len(batch) < self.config.batch_slots:
                    rem = deadline - time.perf_counter()
                    if rem <= 0:
                        break
                    try:
                        batch.append(self._q.get(timeout=rem))
                    except queue.Empty:
                        break
                groups: dict = {}
                for r in batch:
                    groups.setdefault(r.key, []).append(r)
                for key, reqs in groups.items():
                    self._run_batch(key, reqs)
        except BaseException as e:
            # an internal failure poisons the engine: record it, fail every
            # queued request, and refuse further submits
            self._failure = e
            self._stop.set()
            self._drain_failed()

    def _run_batch(self, key: tuple, reqs: list):
        entry = self._graphs[key]
        slots = self.config.batch_slots
        try:
            xs = [r.x for r in reqs]
            n_pad = slots - len(xs)
            xs.extend(np.zeros_like(xs[0]) for _ in range(n_pad))
            preds = self._predict_global(entry, xs)
            t_done = time.perf_counter()
            for i, r in enumerate(reqs):
                out = np.stack([
                    scatter_node_outputs(entry.pg, preds[i, k])
                    for k in range(self.config.rollout_steps)])
                r.future._set(InferenceResult(
                    step=r.step, mesh_hash=key[0], preds=out,
                    latency_s=t_done - r.t_submit))
            self.stats["requests"] += len(reqs)
            self.stats["batches"] += 1
            self.stats["padded_slots"] += n_pad
        except BaseException as e:
            for r in reqs:
                r.future._fail(e)
            raise

    # -- offline oracle -----------------------------------------------------

    def offline_reference(self, mesh_hash: str, x,
                          partitioner: Optional[str] = None) -> np.ndarray:
        """Run ONE snapshot synchronously at batch=1 through the same cached
        plan/graph, bypassing the queue — the oracle of the bitwise
        streamed == offline contract.  Returns [K, N_global, F_out]."""
        entry = self.entry(mesh_hash, partitioner)
        preds = self._predict_global(entry, [np.asarray(x, np.float32)])[0]
        return np.stack([scatter_node_outputs(entry.pg, preds[k])
                         for k in range(self.config.rollout_steps)])
