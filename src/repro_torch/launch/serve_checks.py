"""The reference's serving checks (``tests/drivers/serve_driver.py``) on
the port's engine, one or R processes: a worker for
``launch/serve.py::run_world``.

    from repro_torch.launch import serve, serve_checks
    procs = serve.run_world(serve_checks.CheckJob(ckpt_dir=..., rank_grid=(2, 2, 1),
                                                  device="cpu"),
                            worker=serve_checks.check_process)

Each process builds the engine as ``launch/serve.py`` does, and:

* every process has the mesh of :data:`OTHER_ELEMENTS`, which the
  checkpoint was not trained on, refused by name at registration;
* the lead streams the job's requests, holds every one bitwise against
  :meth:`InferenceEngine.offline_reference`, has the other mesh refused at
  submit, and ends with a producer that dies at step :data:`DIE_AT`, which
  must close the engine and end every follower.

The records say what happened (the tests and ``chip_smoke.py`` hold them
to their limits): ``keep`` requests' predictions come back (``preds``),
``rank_preds`` requests' offline predictions of every rank, unscattered
([K, R, N_pad, F_out]), and ``halo`` compares each mode's exchange posted
(with work queued before its finish) with the autograd one on a seeded
aggregate.  Imports nothing outside this package.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.graph_state import NMPPlan, ShardedGraph
from repro_torch.core.halo import A2A, NEIGHBOR, halo_sync, halo_sync_post
from repro_torch.core.mesh_gen import box_mesh
from repro_torch.launch import serve
from repro_torch.runtime.engine import EngineError, MeshMismatchError
from repro_torch.train.loop import mesh_fingerprint_hash

#: the step at which the dying producer raises
DIE_AT = 2
#: the box mesh registered and submitted, which the checkpoint was not
#: trained on
OTHER_ELEMENTS = (3, 3, 2)


@dataclasses.dataclass(frozen=True)
class CheckJob(serve.ServeJob):
    """A :class:`~repro_torch.launch.serve.ServeJob` with the checks'
    extra records (module docstring)."""
    keep: int = 0
    rank_preds: int = 0
    halo: bool = False


def _halo_check(mesh, pg, coords, width: int):
    """Each mode's exchange of a seeded [N_pad, width] aggregate on this
    rank: posted (with work queued before the finish) and under autograd."""
    out = {}
    a_all = np.random.default_rng(11).standard_normal(
        (pg.R, pg.n_pad, width)).astype(np.float32)
    for name, mode, packed in (("a2a", A2A, False), ("neighbor", NEIGHBOR, False),
                               ("packed", NEIGHBOR, True)):
        plan = NMPPlan.build(pg, mode, packed=packed)
        g = ShardedGraph.build(pg, coords, plan, device=mesh.device, rank=mesh.rank)
        a = torch.from_numpy(a_all[mesh.rank]).to(mesh.device)
        with torch.no_grad():
            pending = halo_sync_post(a, g, plan.halo, mesh)
            (a * 2.0).sum()                 # work queued while the rows travel
            posted = pending.finish()
        autograd = halo_sync(a.clone().requires_grad_(True), g, plan.halo, mesh)
        out[name] = {"posted": posted, "autograd": autograd.detach()}
    return out


def _lead_checks(engine, job: CheckJob, sem, mesh_hash: str, other_hash: str,
                 results) -> dict:
    """The lead's checks after its stream: offline bitwise, the other mesh
    at submit, the dying producer."""
    rec = {"bitwise_offline": all(
        np.array_equal(res.preds, engine.offline_reference(mesh_hash,
                                                           serve.snapshot(sem, s)))
        for s, res in results.items())}
    try:
        engine.submit(other_hash, serve.snapshot(sem, 0))
        rec["refused_submit"] = ""
    except MeshMismatchError as e:
        rec["refused_submit"] = str(e)

    def dying(step):
        if step >= DIE_AT:
            raise RuntimeError("injected producer death")
        return serve.snapshot(sem, step)
    got, t1 = [], time.monotonic()
    try:
        for s, _ in engine.stream(mesh_hash, dying, job.requests, n_producers=1):
            got.append(s)
        rec["producer_error"] = ""
    except EngineError as e:
        rec["producer_error"] = str(e)
    rec.update(died_after_s=time.monotonic() - t1, died_at=time.time(), drained=got,
               closed=engine.closed)
    try:
        engine.submit(mesh_hash, serve.snapshot(sem, 0))
        rec["submit_after_close"] = ""
    except EngineError as e:
        rec["submit_after_close"] = str(e)
    return rec


def check_process(job: CheckJob):
    """One process of a checked serving world (module docstring); returns
    its record."""
    engine, mesh, sem = serve.build_engine(job)
    other = box_mesh(OTHER_ELEMENTS, p=job.order)
    rec = {"world_rank": 0 if mesh is None else mesh.world_rank,
           "other_hash": mesh_fingerprint_hash(other)}
    try:
        engine.register_mesh(other, rank_grid=job.rank_grid)
        rec["refused_registration"] = ""
    except MeshMismatchError as e:
        rec["refused_registration"] = str(e)
    mesh_hash = engine.register_mesh(sem, rank_grid=job.rank_grid)
    entry = engine.entry(mesh_hash)
    rec.update(mesh_hash=mesh_hash, build_s=entry.build_s, policy=entry.plan.policy())
    if job.halo and mesh is not None:
        rec["halo"] = _halo_check(mesh, entry.pg, sem.coords, engine.cfg.hidden)
    if not engine.lead:
        rec.update(serve.follow(engine, mesh))
        return rec

    streamed, results = serve.stream_requests(engine, job, sem, mesh_hash, mesh)
    rec.update(streamed)
    steps = sorted(results)
    rec["preds"] = {s: results[s].preds for s in steps[:job.keep]}
    rec["rank_preds"] = {s: engine.offline_reference(mesh_hash, serve.snapshot(sem, s),
                                                     per_rank=True)
                         for s in steps[:job.rank_preds]}
    rec.update(_lead_checks(engine, job, sem, mesh_hash, rec["other_hash"], results))
    engine.close()
    rec.update(stats=dict(engine.stats), launches=engine.launches)
    return rec


def run_checks(*jobs: CheckJob):
    """:func:`~repro_torch.launch.serve.run_world` with :func:`check_process`."""
    return serve.run_world(*jobs, worker=check_process)
