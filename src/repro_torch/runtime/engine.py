"""Resident solver-in-the-loop inference engine (port of
``repro.runtime.engine``) on one CUDA device or over the processes of a
``torch.distributed`` mesh, one graph rank each.

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

Serving R graph ranks (``mesh=`` from ``launch/mesh.py::make_mesh(1, R)``,
one process per rank): every process builds the engine (each loads the
params and checks every fingerprint) and calls :meth:`register_mesh`
with the same arguments, which builds only its own rank's graph.  The lead
(world rank 0) runs the public API (``start``, ``submit``, ``stream``,
``warmup``, ``offline_reference``, ``close``); every other process calls
:meth:`follow`, which returns when the lead closes.  Per batch the lead
sends a small header over a CPU gloo control group (command, graph-cache
key, slot count), scatters each rank's gathered rows
(``gather_node_features``, ``[slots, N_pad, F]``), every process runs the
rollout on its rank (each layer's exchange through ``halo_sync`` on the
graph group: posted, and under the overlap schedule finished after the
interior side is queued), and the lead gathers each rank's ``[slots, K,
N_pad, F_out]`` and scatters them back to the global mesh.  One lock on
the lead serialises all mesh work, so batches of the engine thread and
``warmup`` / ``offline_reference`` of the caller's thread reach the other
processes as one sequence.  The control group's collectives time out
after :data:`CONTROL_TIMEOUT_S`; the engine thread sends a ``ping`` after
:data:`HEARTBEAT_S` without a command, so an idle lead does not time its
followers out; :meth:`close` sends ``stop``.

Consistency contract: streamed predictions are BITWISE identical to the
batch-1 :meth:`InferenceEngine.offline_reference` of the same snapshot at
any R — batching, slot padding, queueing and threading are arithmetically
invisible.  That holds because each slot runs on its own (same matmul
shapes at any slot count) and every reduction on the path is
deterministic (the fused kernel's slot-ordered aggregate, the sorted
segment sum of the plain backend, the exchange's fixed order).  Across
R the predictions agree to fp32 tolerance (Eqs. 2-3).

Checkpoint contract: the engine refuses a checkpoint without a mesh
fingerprint, refuses params whose recorded model config disagrees with the
engine's ``GNNConfig``, and refuses requests or mesh registrations whose
``mesh_fingerprint_hash`` differs from the checkpoint's, naming BOTH
hashes (on every process).  A corrupted newest checkpoint falls back to
the previous committed step.
"""
from __future__ import annotations

import dataclasses
import datetime
import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.coarsen import build_hierarchy
from repro_torch.core.gnn import GNNConfig, init_gnn
from repro_torch.core.graph_state import NMPPlan, ShardedGraph
from repro_torch.core.halo import A2A, AUTO, NEIGHBOR, NONE
from repro_torch.core.mesh_gen import SEMMesh
from repro_torch.core.partition import (
    gather_node_features, partition_mesh, scatter_node_outputs)
from repro_torch.core.partition_quality import mesh_node2part
from repro_torch.data.pipeline import PrefetchingLoader
from repro_torch.kernels import build
from repro_torch.train.loop import mesh_fingerprint_hash
from repro_torch.train.rollout import make_rollout_predict_fn

#: seconds a process waits in a control collective of a mesh engine (the
#: next command, a scatter, a gather) before it fails: a dead peer fails
#: the others' collectives within this time
CONTROL_TIMEOUT_S = 300.0
#: seconds the lead's engine thread goes without a command before it sends
#: a ``ping`` to the followers
HEARTBEAT_S = 30.0
#: the commands of the control group's header
BATCH, OFFLINE, WARMUP, PING, STOP = "batch", "offline", "warmup", "ping", "stop"


class EngineError(RuntimeError):
    """Engine lifecycle/request failure (shutdown, saturation, bad input)."""


class MeshMismatchError(EngineError):
    """Request/registration mesh hash differs from the checkpoint's."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine policy: ``batch_slots`` fixed slots per batch (requests
    zero-padded up to it), ``max_pending`` bounds the request queue (the
    backpressure point), ``flush_timeout_s`` is how long a non-full batch
    waits for more requests, ``halo_mode`` the exchange of R > 1 ranks
    (``a2a``, ``neighbor`` or ``auto``, resolved with the plan's ``auto``
    schedule by ``plan.autotune`` when a mesh is registered; the packed
    neighbor exchange is the plan's ``halo.packed``), ``partitioner``
    ``block`` or ``spectral``."""
    batch_slots: int = 4
    rollout_steps: int = 1
    max_pending: int = 16
    flush_timeout_s: float = 0.02
    result_timeout_s: float = 300.0
    halo_mode: str = "a2a"
    partitioner: str = "block"

    def __post_init__(self):
        if self.halo_mode not in (A2A, NEIGHBOR, AUTO):
            raise ValueError(f"halo_mode {self.halo_mode!r}: expected {A2A!r}, "
                             f"{NEIGHBOR!r} or {AUTO!r}")
        if self.partitioner not in ("block", "spectral"):
            raise ValueError(f"partitioner {self.partitioner!r}: expected 'block' "
                             "or 'spectral'")
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
    """One mesh's cached execution state (built once, reused per request):
    over a mesh, ``gs`` is this process's rank-local graph."""
    key: tuple                 # (mesh_hash, partitioner)
    mesh_hash: str
    pg: Any
    plan: NMPPlan
    gs: ShardedGraph
    predict: Callable
    build_s: float


def config_from_checkpoint(ckpt_dir, step: Optional[int] = None) -> GNNConfig:
    """The GNN config whose parameters a checkpoint holds, read from the
    array shapes in its manifest (the newest committed step by default),
    its V-cycle's levels too.  Returns ``GNNConfig.small()``/``large()``
    (with those levels) when the shapes are theirs."""
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
    coarse = indices("params/coarse/", 2)
    levels = {} if not coarse else dict(
        n_levels=len(coarse) + 1,
        coarse_mp_layers=len(indices("params/coarse/0/mp/", 4)),
        coarse_edge_in=shapes["params/coarse/0/edge_enc/layers/0/w"][0])
    for named in (GNNConfig.small(), GNNConfig.large()):
        if all(getattr(named, k) == v for k, v in fields.items()):
            return dataclasses.replace(named, **levels)
    return GNNConfig(**fields, **levels, name="custom")


class InferenceEngine:
    """Resident serving engine over the K-step rollout, on one device or
    over the processes of a mesh (module docstring).

    Lifecycle: construct (loads params from ``ckpt_dir``), then
    :meth:`register_mesh` each geometry, optionally :meth:`warmup`,
    :meth:`start` the engine thread, feed it via :meth:`submit` /
    :meth:`stream`, and :meth:`close`.  Also a context manager.  Over a
    mesh every process constructs and registers; the lead does the rest
    and the other processes :meth:`follow`.
    """

    def __init__(self, ckpt_dir, cfg: GNNConfig,
                 config: EngineConfig = EngineConfig(),
                 plan: NMPPlan = NMPPlan(), device=None, mesh=None):
        self.cfg = cfg
        self.config = config
        self.mesh = mesh
        if mesh is None:
            self.device = torch.device("cuda" if device is None else device)
            self.R = 1
        else:
            if mesh.data != 1:
                raise EngineError(
                    f"the engine serves one replica: a mesh of data={mesh.data} "
                    "replicas was given (make_mesh(1, R))")
            if device is not None and torch.device(device).type != mesh.device.type:
                raise EngineError(f"device {device!r} disagrees with the mesh's "
                                  f"{mesh.device}")
            self.device = mesh.device
            self.R = mesh.graph
        if plan.halo.packed and config.halo_mode != NEIGHBOR:
            raise EngineError(
                f"a packed halo exchange is neighbor-only; EngineConfig.halo_mode "
                f"is {config.halo_mode!r}")
        # execution-policy fields forwarded into each mesh's NMPPlan.build
        self._policy = {"backend": plan.backend, "schedule": plan.schedule,
                        "precision": plan.precision,
                        "block_n": plan.block_n, "block_e": plan.block_e}
        self._packed = plan.halo.packed
        self._wire = plan.halo.wire_dtype
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
        #: kernel launches of this process per mesh command
        self.launches: dict[str, dict] = {}
        # mesh work: one sequence of commands, whichever thread issues them
        self._mesh_lock = threading.Lock()
        self._ctrl = None
        self._followers_stopped = mesh is None
        self._last_cmd = time.monotonic()
        if mesh is not None:
            # every process of the world creates the control group, in order
            self._ctrl = dist.new_group(
                list(mesh.world_group.ranks), backend="gloo",
                timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))

    @property
    def lead(self) -> bool:
        """Whether this process runs the public API (no mesh, or world rank 0)."""
        return self.mesh is None or self.mesh.lead

    def _lead_only(self, what: str):
        if not self.lead:
            raise EngineError(f"{what} runs on the lead process (world rank 0); "
                              "the other processes of the mesh call follow()")

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
                      partitioner: Optional[str] = None,
                      hierarchy=None) -> str:
        """Build (or fetch from cache) the execution state for one mesh;
        returns its ``mesh_fingerprint_hash``, the key of every later
        :meth:`submit` / :meth:`stream` call.  Over a mesh every process
        calls it with the same arguments; each builds its own rank's graph
        (the lead keeps the whole partition for the host gather and
        scatter).  A multilevel model (``cfg.n_levels > 1``) runs over
        ``hierarchy`` (``core/coarsen.py::build_hierarchy`` of this mesh on
        the engine's R ranks; built here from ``rank_grid`` when not
        given; with ``partitioner="spectral"`` over its spectral split):
        one halo spec per level, every level's graph.  ``auto`` fields of
        the plan are resolved here (over a mesh the lead measures on the
        stacked graph and every process takes its pick)."""
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
            if self.cfg.n_levels > 1:
                if hierarchy is None:
                    node2part = (mesh_node2part(sem_mesh, self.R)
                                 if partitioner == "spectral" else None)
                    hierarchy = build_hierarchy(sem_mesh, grid, self.cfg.n_levels,
                                                node2part=node2part)
                if hierarchy.n_levels != self.cfg.n_levels \
                        or hierarchy.levels[0].R != self.R:
                    raise EngineError(
                        f"hierarchy of {hierarchy.n_levels} levels on "
                        f"{hierarchy.levels[0].R} rank(s); the engine runs "
                        f"{self.cfg.n_levels} levels on R={self.R}")
                pg, part = hierarchy.levels[0], hierarchy
            else:
                hierarchy = None
                pg = part = partition_mesh(sem_mesh, grid, method=partitioner)
            mode = self.config.halo_mode if self.R > 1 else NONE
            plan = NMPPlan.build(part, mode,
                                 packed=self._packed and mode == NEIGHBOR,
                                 wire_dtype=self._wire, **self._policy)
            graph = ShardedGraph.build(
                pg, sem_mesh.coords, plan, device=self.device,
                rank=None if self.mesh is None else self.mesh.rank,
                hierarchy=hierarchy)
            plan = plan.autotune(graph, hidden=self.cfg.hidden, mesh=self.mesh,
                                 stacked=lambda: ShardedGraph.build(
                                     pg, sem_mesh.coords, plan, device=self.device))
            predict = make_rollout_predict_fn(self.cfg, plan,
                                              self.config.rollout_steps,
                                              mesh=self.mesh)
            self._graphs[key] = _GraphEntry(
                key=key, mesh_hash=mesh_hash, pg=pg, plan=plan, gs=graph,
                predict=predict, build_s=time.perf_counter() - t0)
            self.stats["cache_builds"] += 1
        return mesh_hash

    def entry(self, mesh_hash: str, partitioner: Optional[str] = None
              ) -> _GraphEntry:
        """The cached execution state of a registered mesh."""
        if mesh_hash != self.fingerprint["mesh_hash"]:
            raise self._mismatch(mesh_hash)
        return self._entry_at((mesh_hash, partitioner or self.config.partitioner))

    def _entry_at(self, key: tuple) -> _GraphEntry:
        with self._lock:
            found = self._graphs.get(key)
        if found is None:
            raise EngineError(
                f"mesh {key[0]} (partitioner={key[1]!r}) is not "
                "registered — call register_mesh(sem_mesh) before "
                "submitting requests (on every process of the mesh)")
        return found

    def _predict_global(self, entry: _GraphEntry, xs: list,
                        cmd: str = BATCH) -> np.ndarray:
        """Global snapshots -> per-rank predictions [B, K, R, N_pad, F]."""
        x0 = np.stack([gather_node_features(entry.pg, x) for x in xs])
        if self.mesh is None:
            with _counted(self.launches, cmd):
                return entry.predict(self.params, x0, entry.gs).cpu().numpy()
        with self._mesh_lock:
            self._send(cmd, entry.key, len(xs))
            mine = torch.empty(x0.shape[0], x0.shape[2], x0.shape[3])
            dist.scatter(mine, [torch.from_numpy(np.ascontiguousarray(x0[:, r], np.float32))
                                for r in range(self.R)], src=0, group=self._ctrl)
            preds = self._run_rank(entry, mine, cmd)
            got = [torch.empty_like(preds) for _ in range(self.R)]
            dist.gather(preds, got, dst=0, group=self._ctrl)
        # [R, B, K, N, F] -> [B, K, R, N, F]
        return torch.stack(got).permute(1, 2, 0, 3, 4).numpy()

    def _run_rank(self, entry: _GraphEntry, x: torch.Tensor, cmd: str) -> torch.Tensor:
        """This process's rank of one mesh command: [B, N_pad, F] rows ->
        [B, K, N_pad, F_out] predictions on the CPU."""
        with _counted(self.launches, cmd):
            preds = entry.predict(self.params, x[:, None], entry.gs)[:, :, 0]
            return preds.cpu().contiguous()

    def _send(self, cmd: str, key=None, slots: int = 0):
        """The lead's header of one mesh command (under the mesh lock)."""
        dist.broadcast_object_list([(cmd, key, slots)], src=0, group=self._ctrl)
        self._last_cmd = time.monotonic()

    def follow(self):
        """Serve the lead's mesh commands on this process's rank until the
        lead closes (the processes of a mesh other than the lead)."""
        if self.lead:
            raise EngineError("follow() runs on the processes of a mesh other "
                              "than the lead")
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self._ctrl)
            cmd, key, slots = box[0]
            if cmd == STOP:
                return
            if cmd == PING:
                continue
            entry = self._entry_at(key)
            mine = torch.empty(slots, entry.pg.n_pad, self.cfg.node_in)
            dist.scatter(mine, None, src=0, group=self._ctrl)
            dist.gather(self._run_rank(entry, mine, cmd), None, dst=0, group=self._ctrl)
            if cmd == BATCH:
                self.stats["batches"] += 1

    def warmup(self, mesh_hash: Optional[str] = None):
        """Run one zero batch per cached mesh (loads the CUDA kernels and
        warms the allocator) so the first real request does not pay it."""
        self._lead_only("warmup")
        with self._lock:
            entries = [e for k, e in self._graphs.items()
                       if mesh_hash is None or k[0] == mesh_hash]
        for entry in entries:
            zero = np.zeros((entry.pg.n_global, self.cfg.node_in), np.float32)
            self._predict_global(entry, [zero] * self.config.batch_slots, WARMUP)

    # -- lifecycle ----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def _shutdown_error(self) -> EngineError:
        if self._failure is not None:
            return EngineError(f"engine terminated: {self._failure!r}")
        return EngineError("engine is shut down")

    def start(self) -> "InferenceEngine":
        self._lead_only("start")
        if self._thread is not None:
            raise EngineError("engine already started")
        if self._stop.is_set():
            raise self._shutdown_error()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="inference-engine")
        self._thread.start()
        return self

    def close(self, error: Optional[BaseException] = None):
        """Stop the engine thread, fail every still-queued request and, over
        a mesh, send ``stop`` to the other processes (once)."""
        if error is not None and self._failure is None:
            self._failure = error
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._drain_failed()
        if not self._followers_stopped and self.lead:
            self._followers_stopped = True
            if self._mesh_lock.acquire(timeout=CONTROL_TIMEOUT_S):
                try:
                    self._send(STOP)
                except Exception as e:     # a follower already gone
                    print(f"[engine] stop not delivered to every process: {e!r}")
                finally:
                    self._mesh_lock.release()

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
        self._lead_only("submit")
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
        self._lead_only("stream")
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
                    if self.mesh is not None \
                            and time.monotonic() - self._last_cmd > HEARTBEAT_S:
                        with self._mesh_lock:
                            self._send(PING)
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
                          partitioner: Optional[str] = None,
                          per_rank: bool = False) -> np.ndarray:
        """Run ONE snapshot synchronously at batch=1 through the same cached
        plan/graph, bypassing the queue — the oracle of the bitwise
        streamed == offline contract.  Returns [K, N_global, F_out], or with
        ``per_rank`` each rank's padded rows, [K, R, N_pad, F_out]."""
        self._lead_only("offline_reference")
        entry = self.entry(mesh_hash, partitioner)
        preds = self._predict_global(entry, [np.asarray(x, np.float32)], OFFLINE)[0]
        if per_rank:
            return preds
        return np.stack([scatter_node_outputs(entry.pg, preds[k])
                         for k in range(self.config.rollout_steps)])


class _counted:
    """Adds the kernel launches of this process inside the block to
    ``into[cmd]``."""

    def __init__(self, into: dict, cmd: str):
        self.into, self.cmd = into, cmd

    def __enter__(self):
        self.before = dict(build.launch_counts)

    def __exit__(self, *exc):
        tally = self.into.setdefault(self.cmd, {})
        for k, v in build.launch_counts.items():
            if v != self.before.get(k, 0):
                tally[k] = tally.get(k, 0) + v - self.before.get(k, 0)
        return False
