"""The LM serving path over a ``(data, model)`` process mesh: the worker of
the CPU tests (``tests/test_torch_lm_seq.py``) and of ``chip_smoke.py``'s
context-parallel phase.

    from repro_torch.launch import lm_checks as lmx
    job = lmx.Job(cases=(lmx.Case("d2m2", data=2, model=2), lmx.Case("m4", model=4)),
                  cfg=lmx.cfg_dict(llama3_2_3b.smoke_config()), params=np_params,
                  prompts=np_prompts, steps=4, device="cpu")
    procs = lmx.run_world(job, 4)          # one record per process and case
    one = lmx.run_case(job, lmx.Case("one"))   # the same on one device

A case serves ``prompts`` [B, S] on its mesh: each data replica takes its
``B / data`` rows, and each process of a replica's model group runs the
prefill step on the whole prompt (keeping its own ``S / model`` rows,
``models/transformer/model.py``) and then ``steps`` decode steps over its
shard of the cache (capacity ``S + steps``), each step fed
``feed``'s next column or, without ``feed``, the greedy token.  Weights come
from ``params`` (a numpy tree in the reference's layout, as
``repro_torch.convert`` reads it) or, without it, from the arch's
``build_cell("prefill_32k", seed=)`` (which also draws the prompt, ``batch``
sequences of its 32,768 tokens, of which the first ``prompt_len`` are
served), so every process draws the same.  Per
case and process: the logits of the prefill and of every step (fp32
numpy, [B / data, steps + 1, V]), their argmax tokens, optionally the
cache after the prefill (``return_cache``) and ``greedy_generate``'s tokens
(``greedy``: ``steps`` tokens at capacity ``S + steps``), the kernels'
launches in the prefill and in the decode steps
(``kernels/build.py::launch_counts``), the model group's host seconds in
its gathers (``ParallelCtx.host_s``) and its transport's counters
(``launch/mesh.py::Transport``), CUDA-event ms of the prefill and of each
step and the peak memory on a card, and the mesh's place.  Imports nothing
outside this package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.model import ParallelCtx
from repro_torch.models.transformer.steps import (
    greedy_generate, make_decode_step, make_prefill_step)
from repro_torch.nn import tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Case:
    """One mesh: ``data`` replicas x a model group of ``model`` processes."""
    name: str
    data: int = 1
    model: int = 1


@dataclasses.dataclass(frozen=True)
class Job:
    """What every case serves (module docstring), on the card unless
    ``device`` says otherwise.  ``cfg``: the ``TransformerConfig`` fields,
    dtypes by name (:func:`cfg_dict`)."""
    cases: tuple
    cfg: dict
    arch: str = "llama3.2-3b"
    params: dict | None = None
    prompts: np.ndarray | None = None
    feed: np.ndarray | None = None
    steps: int = 4
    seed: int = 0
    batch: int = 1
    device: str = "cuda"
    greedy: bool = False
    return_cache: bool = False
    upcast: bool = False
    prompt_len: int | None = None


def cfg_dict(cfg: TransformerConfig) -> dict:
    out = dataclasses.asdict(cfg)
    for k in ("param_dtype", "cache_dtype"):
        out[k] = str(out[k]).split(".")[1]
    return out


def config_of(job: Job) -> TransformerConfig:
    kw = dict(job.cfg)
    for k in ("param_dtype", "cache_dtype"):
        kw[k] = DTYPES[kw[k]]
    kw["seq_shard_decode"] = tuple(kw["seq_shard_decode"])
    return TransformerConfig(**kw)


def inputs_of(job: Job, cfg: TransformerConfig, device):
    """(params, prompts [B, S]) on ``device``; with ``upcast`` the weights
    are drawn in bf16 and cast to ``cfg``'s dtype (the bf16 draw's values)."""
    if job.params is not None:
        return params_from_jax(job.params, device), torch.from_numpy(
            np.asarray(job.prompts)).to(device)
    draw = cfg.with_(param_dtype=torch.bfloat16) if job.upcast else cfg
    _, (params, tokens), _ = get_arch(job.arch)[0].build_cell(
        "prefill_32k", device, job.seed, cfg=draw, batch=job.batch)
    if job.upcast:
        params = tree_map(lambda t: t.to(cfg.param_dtype), params)
    return params, tokens[:, :job.prompt_len]


def _counts():
    out = {k: v for k, v in build.launch_counts.items() if v}
    build.reset_launch_counts()
    return out


class _Timer:
    """CUDA-event ms of each timed call (none on the CPU)."""

    def __init__(self, device):
        self.on, self.ms = device.type == "cuda", []

    def __call__(self, fn):
        if not self.on:
            return fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        self.ms.append(start.elapsed_time(end))
        return out


def run_case(job: Job, case: Case, mesh=None) -> dict:
    """One case on this process (one device without a mesh): module
    docstring."""
    ctx = ParallelCtx(mesh) if mesh is not None else None
    dev = mesh.device if mesh is not None else torch.device(job.device)
    cfg = config_of(job)
    params, prompts = inputs_of(job, cfg, dev)
    replica = mesh.replica if mesh is not None else 0
    per = prompts.shape[0] // case.data
    rows = prompts[replica * per:(replica + 1) * per]
    S = rows.shape[1]
    capacity = S + job.steps
    rec = dict(replica=replica, shard=mesh.shard if mesh is not None else 0,
               rows=(replica * per, (replica + 1) * per))
    if mesh is not None:
        rec["groups"] = {k: getattr(mesh, f"{k}_group").ranks for k in ("data", "edge", "world")}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    timer = _Timer(dev)
    logits, cache = timer(lambda: make_prefill_step(cfg, capacity, ctx)(params, rows))
    rec["launches_prefill"] = _counts()
    if job.return_cache:
        rec["cache0"] = {k: v.to(torch.float32, copy=True) for k, v in cache.items()}
    decode = make_decode_step(cfg, ctx)
    out = [logits.float()]
    for i in range(job.steps):
        feed = (torch.from_numpy(np.asarray(job.feed)[replica * per:(replica + 1) * per,
                                                      i:i + 1]).to(dev)
                if job.feed is not None else out[-1].argmax(dim=-1, keepdim=True))
        logits, cache = timer(lambda: decode(params, cache, feed, S + i))
        out.append(logits[:, 0].float())
    rec["launches_decode"] = _counts()
    logits = torch.stack(out, 1)
    rec.update(logits=logits, tokens=logits.argmax(dim=-1),
               host_s=dict(ctx.host_s) if ctx else {}, prefill_ms=timer.ms[:1], step_ms=timer.ms[1:])
    if mesh is not None:
        tr = mesh.edge_group.transport
        rec["transport"] = dict(sync_s=tr.sync_s, stage_s=tr.stage_s, wire_s=tr.wire_s,
                                staged_bytes=tr.staged_bytes, sent_bytes=tr.sent_bytes)
    if dev.type == "cuda":
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del cache
    if job.greedy:
        rec["greedy"] = greedy_generate(params, rows, cfg, job.steps, ctx)
    return rec


def check_process(jobs) -> dict:
    """Every case of each job on this process of the world, each on its own
    mesh (every process builds each in the same order)."""
    out = {}
    for job in jobs:
        for case in job.cases:
            mesh = make_mesh(case.data, 1, backend="gloo", device=job.device, model=case.model)
            out[case.name] = run_case(job, case, mesh)
    return out


def run_world(jobs, nprocs: int) -> list:
    """A job (or a sequence of jobs on one device) on ``nprocs`` gloo
    processes (every case's mesh must hold them all): each process's
    records by case name, in world-rank order."""
    jobs = (jobs,) if isinstance(jobs, Job) else tuple(jobs)
    names = [case.name for job in jobs for case in job.cases]
    if len(set(names)) != len(names):
        raise ValueError(f"case names repeat across the jobs: {names}")
    if len({job.device for job in jobs}) != 1:
        raise ValueError("the jobs of one world run on one device")
    for case in (case for job in jobs for case in job.cases):
        if case.data * case.model != nprocs:
            raise ValueError(f"case {case.name}: a ({case.data}, {case.model}) mesh in a "
                             f"world of {nprocs}")
    return spawn(check_process, nprocs, jobs, backend="gloo", device=jobs[0].device)
