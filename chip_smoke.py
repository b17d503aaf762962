#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written CUDA kernels from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version at the shapes the main paths
give it, checks the paper's 1-rank == R-rank consistency on the card for
values and gradients, serves the paper's large GNN (N_H=32, M=4, 5 MLP
hidden layers) on a p=7 spectral-element box mesh through the resident
inference engine, trains it on that mesh through the training loop,
serves and trains DLRM RM2 at full width (50,003,968 x 64 fp32 table)
through its cell builder, and serves Granite-34B-code (MQA, 48:1) at full
width (88 layers for the prefill and the serving loop, 44 for decode and
the full-width check) through its cell builder and the greedy serving
loop.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (one line each, prefixed ``[n name]``):
  1 device       nvidia-smi name / power limit, TF32 off, kernel build
  2 kernels      fused NMP forward and backward on the serving mesh's
                 edges (each also held to a float64 forward or VJP, with
                 its launch plan and ptxas registers), pack and unpack-add on
                 every round and rank of the 2x2 partition and the exchange
                 pack (one launch for every round and rank) against the
                 per-round packs it replaces (each wrapper's host time per
                 call beside its bare C call, and its device time under
                 torch.profiler; phase_kernels runs any of these alone), the
                 embedding bag at DLRM RM2's serve_bulk
                 lookup (fp32, H=1, the full table, whose offsets pass 2^31
                 elements) and at fp32 H=8 and bf16 H=4: error vs the plain
                 version, repeatability, CUDA-event times, and the
                 embedding bag's F.embedding_bag time; flash attention at
                 tests/test_kernels.py's FLASH_CASES in fp32 and bf16 and at
                 one Granite prefill layer (B=1, S=32,768, 48:1 heads of 128,
                 bf16, causal): error vs the plain version within that
                 file's TOL, two launches bitwise equal, CUDA-event times,
                 the bound and F.scaled_dot_product_attention's time;
                 the dst-aligned edge MLP + aggregate (kernel 3) at full
                 width (Fin 96, Hh = H = 32, blocks 128/256) on the serving
                 mesh's directed edges and at kernel_bench's 8k-edge shape
                 (E 8192, N 2048, Fin 24, H 16): kernel and plain version
                 against edge_mlp_agg_ref within tests/test_kernels.py's
                 bands, two launches bitwise equal, CUDA-event times, the
                 bound, the launch plan, the layout's waste, at full width
                 each output against a float64 forward and bf16 feats
                 against plain (time and bound), and one launch-counted
                 call of fused_edge_mlp_agg (phase_segment_agg runs alone)
  3 consistency  stacked forward, large config, fused backend: R=1 vs R=4
                 (2x2 grid) under the packed neighbor exchange and the A2A
                 oracle, and fused vs the plain backend at R=1; the R=4
                 forward's launches checked exactly
  3b gradients   stacked loss and parameter gradients, same mesh: R=1 vs
                 R=4 packed neighbor (fused), and fused vs plain at R=4; the
                 R=4 gradient run's launches checked exactly
  3c distributed 4 gloo processes sharing the card
                 (``repro_torch.launch.consistency``): the 2x2 split through
                 the real torch.distributed exchange (packed neighbor, a2a,
                 none), each rank's prediction bitwise equal to its slice of
                 phase 3's stacked forward, loss and gradients within the
                 bands of 3b's R=1, every process's launches checked
                 exactly, rank 0's CUDA-event times and host ms per
                 exchange (staging copies, gloo transfer); then 3 training
                 steps at (2,1,1) x 2 replicas, batch 2, step 0 against an
                 R=1 run and the parameters bitwise equal everywhere
  4 serve        fingerprinted checkpoint of seeded random large params,
                 InferenceEngine(batch_slots=4, rollout_steps=2), >=16
                 streamed Taylor-Green requests, each bitwise equal to the
                 engine's offline batch-1 reference
  5 profile      where one served forward's time goes, on the engine's own
                 graph and params: CUDA-event times per stage, device busy
                 share and the top kernels under torch.profiler, and the
                 engine's host work per request and rollout step
  6 train        train_consistent_gnn on the serving mesh, large config,
                 fused backend, K=1, batch 1: 10 steps (losses, step time,
                 peak memory, host batch time, checkpoints), one step's
                 breakdown, a 3-step run repeated bitwise, 3 steps of the
                 plain backend, a 2-step K=2 rollout run on the consistency
                 mesh, and ``launch/serve.py --bootstrap-steps 2``
  7 dlrm         DLRM RM2 at full width through
                 ``repro_torch.configs.get_arch("dlrm-rm2")``'s
                 ``build_cell``, weights drawn on the card from a seeded
                 generator, TF32 off: serve_p99 (200 batches of 512 from
                 the host; latency p50/p99 by host clock and CUDA events,
                 H2D apart), serve_bulk (10 batches of 262,144; samples/s),
                 retrieval_cand (1M candidates, top 100) and train_batch
                 (5 steps of 65,536: losses, step time, forward / backward /
                 AdamW split by CUDA events, peak memory; a 3-step run
                 repeated from the seed bitwise, the table by a device-side
                 checksum of its bytes); for each path the forward through
                 the plain lookup against the kernel's (bitwise), the top
                 device kernels under torch.profiler and the busy share
  8 lm           Granite-34B-code through
                 ``repro_torch.configs.get_arch("granite-34b")``'s
                 ``build_cell``, bf16, weights drawn on the card from a
                 seeded generator: prefill_32k (88 layers, B=1, 3 prefills:
                 ms, tokens/s, peak memory, profiler), the greedy serving
                 loop (88 layers, 4 prompts of 2,048 tokens, 32 tokens
                 each), at 44 layers a prompt
                 of 4,096 tokens prefilled and decoded 8 steps against the
                 full forward over 4,104 tokens through the plain attention
                 (bf16: drift reported; fp32 weights and cache: within the
                 reference's band 2e-2; each bf16 path's drift from the fp32
                 forward at 2, 11 and 44 layers, and the served path's once
                 more with torch's default bf16-reduction flag, reported),
                 and decode_32k (B=32 over a cache
                 filled to 32,767: ms per step, tokens/s, profiler)
The script reads each main path's launch counters on its own: zeroed just
before the path and read right after it — one full-width call of
fused_edge_mlp_agg (phase 2; exactly one launch), the R=4 packed-neighbor
forward (phase 3; exactly 16 fused forwards, 4 exchange packs, 48
unpack-adds), the R=4 packed-neighbor gradient run (3b; 16 forwards, 16
backwards, 8 packs, 96 unpack-adds), the distributed R=4 forward and
gradient run (3c; per process 4 forwards, 4 packs, 12 unpack-adds, and 4
forwards, 4 backwards, 8 packs, 24 unpack-adds; the paths' counts are the
sums over the 4 processes), the serve stream
after warm-up (4), the 10 training steps (6), the K=2 rollout run (6) and
each DLRM path (7; the embedding bag must launch exactly once per
forward on serve_p99, serve_bulk and train_batch) and each LM path (8;
flash attention exactly once per layer per prefill, never in a decode
step).
Every kernel must have launched on the paths that use it.  The two lines
before the last are a JSON record of the kernels (``launches`` on the
kernel's own path, ``launches_by_path`` on all) and the card's nvidia-smi
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
Any failure raises (exit code != 0); without a CUDA device the script
exits 1 before printing any result.
"""
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# serving mesh: p=7 box (NekRS order) -> 727,833 nodes, ~4.2M directed edges
SERVE_ELEMS, ORDER = (16, 16, 8), 7
# consistency mesh: 94,221 nodes, split 2x2 for R=4
CONS_ELEMS, CONS_GRID = (8, 8, 4), (2, 2, 1)
N_REQUESTS, BATCH_SLOTS, ROLLOUT_K, DT = 16, 4, 2, 0.05
RTOL, ATOL = 1e-4, 1e-5          # the reference's forward band
G_RTOL, G_ATOL = 1e-3, 2e-5      # the reference's gradient band
W_REL = 5e-4                     # weight gradients summed over every edge
# a 3xTF32 kernel's rel L2 from the float64 forward or VJP (nmp_fwd,
# nmp_bwd, edge_mlp_agg), each output, at most this multiple of the plain
# fp32 version's (sound runs read <= 2.1x; a 3xTF32 fragment carried across
# tiles read 70x on nmp_bwd's w0)
F64_FACTOR = 10.0
LOSS_REL = 2e-6                  # the reference's loss band
TRAIN_STEPS, TRAIN_LR = 10, 1e-3
# DLRM RM2 (phase 7): batches per path and the seed of weights and inputs
P99_BATCHES, BULK_BATCHES, DLRM_TRAIN_STEPS, DLRM_SEED = 200, 10, 5, 0
# Granite-34B-code (phase 8): seed, prefills timed, decode steps timed,
# the serving loop (prompts, prompt length, tokens generated) and the check
# (prompt length, decode steps)
LM_SEED, PREFILL_RUNS, DECODE_STEPS = 0, 3, 10
SERVE_PROMPTS, SERVE_PROMPT_LEN, SERVE_GEN = 4, 2048, 32
CHECK_PROMPT, CHECK_STEPS = 4096, 8
LM_BAND = 2e-2                   # the reference's band for prefill + decode
# the served bf16 path's drift from the fp32 forward, per position, at most
# this multiple of the bf16 forward's through the plain attention
DRIFT_FACTOR = 2.0
# the shallower depths (first layers of the check's weights) at which the
# witness is also reported, beside the check's own depth
WITNESS_DEPTHS = (2, 11)
# tests/test_kernels.py:23-30's FLASH_CASES (B, S, Hq, Hkv, D, causal, window,
# softcap; one S for queries and keys) and its TOL (:15) by dtype name
FLASH_CASES = [(1, 128, 2, 2, 64, True, 0, None), (2, 96, 4, 2, 32, True, 0, None),
               (1, 160, 2, 1, 64, True, 48, None), (1, 64, 2, 2, 128, False, 0, 30.0),
               (1, 72, 1, 1, 16, True, 0, None)]
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
# the kernel's largest relative L2 error of one output row (one query of
# one head) against the plain version, by dtype: TOL's atol is as large as
# the outputs of late rows at S=32k, so each row is held to its own size.
ROW_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRANITE_LAYER = (1, 32768, 48, 1, 128, True, 0, None)
# the planted fault that the row check must catch at the Granite layer:
# from FAULT_ROW on, each row loses the keys of its own diagonal tile
FAULT_ROW, FAULT_TILE = 2048, 64
# kernel 3, the dst-aligned edge MLP + aggregate: blocks (block_n, block_e),
# tests/test_kernels.py's bands for the op (e_new, agg) and its bf16 TOL
MLP_AGG_BLOCKS = (128, 256)
# phase 2's GNN cases (phase_kernels), each of which can run alone; the
# readings of each host-bound halo timing, taken in turns
GNN_CASES = ("nmp_fwd", "nmp_bwd", "halo")
HALO_ROUNDS = 5
MLP_AGG_E_TOL, MLP_AGG_TOL, MLP_AGG_BF16_TOL = 3e-5, 1e-4, 2e-2
# published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 on CUDA cores,
# bf16 dense on tensor cores, HBM3 bandwidth
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_S = 67e12, 989e12, 3.35e12
PEAK_TF32_FLOPS = 495e12         # tensor cores, dense


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_ms(fns, iters):
    """{name: median over HALO_ROUNDS readings of cuda_ms(fn, iters)}, the
    functions timed in turns (order reversed every other round), so that
    host-bound calls are compared over the same stretch of host time."""
    got = {k: [] for k in fns}
    for r in range(HALO_ROUNDS):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[k].append(cuda_ms(fns[k], iters))
    return {k: float(np.median(v)) for k, v in got.items()}


def bound_ms(n_bytes, flops, peak_flops=PEAK_FP32_FLOPS):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def within_band(got, want, rtol=RTOL, atol=ATOL):
    import torch
    err = float((got - want).abs().max())
    ok = bool(torch.all((got - want).abs() <= atol + rtol * want.abs()))
    return err, ok


def rel_norm(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def row_rel_err(got, want):
    """Largest relative L2 error of one row (last axis) of ``got``."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())


def leaf_names(tree, prefix=""):
    """Key paths of a parameter tree in ``repro_torch.nn.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def grads_close(got, want):
    """Gradient trees within rtol 1e-3 / atol 2e-5 elementwise.  A leaf that
    misses the elementwise band is named and held to a relative L2 norm of
    5e-4 instead (its elements cancel to near zero).  Returns (max abs
    error, {leaf: rel norm} of the leaves held by norm, ok)."""
    from repro_torch.launch.consistency import grads_close as close
    from repro_torch.nn import tree_leaves
    names = leaf_names(want)
    err, by_norm, ok = close([t.detach().cpu().numpy() for t in tree_leaves(got)],
                             [t.detach().cpu().numpy() for t in tree_leaves(want)],
                             G_RTOL, G_ATOL, W_REL)
    return err, {names[i]: v for i, v in by_norm.items()}, ok


def ptxas_summary(report, needle):
    """'<regs> registers, <spill stores>/<spill loads> spill bytes' of the
    first kernel whose mangled name contains ``needle``."""
    lines = report.splitlines()
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and needle in ln:
            spill = lines[i + 1].strip()
            regs = next(l for l in lines[i + 1:] if "Used " in l)
            return (regs.split("Used ")[1].split(",")[0] + ", "
                    + spill.split(", ", 1)[1])
    return "not found"


def device_kernels(prof):
    """[(ms, name)] of the device kernels a torch.profiler run recorded,
    longest first.  Only events that ran on the card count: host ranges
    (aten ops, autograd nodes, autograd.Function scopes) carry their
    children's device time and would count it twice."""
    from torch.autograd import DeviceType
    kern = sorted(((getattr(a, "device_time_total", 0.0)
                    or getattr(a, "cuda_time_total", 0.0), a.key)
                   for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA), reverse=True)
    return [(t / 1e3, k) for t, k in kern if t > 0]


def host_ms(fn, iters):
    """Host wall per call of ``iters`` calls of ``fn`` enqueued back to back
    (the loop never waits on the card)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host


def host_device_split(fn, iters):
    """(host ms per call, {device op name: ms per call}) of ``fn``: the host
    time by :func:`host_ms`; the device times are the device events
    torch.profiler records over another ``iters`` calls."""
    import torch
    host = host_ms(fn, iters)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return host, {name: ms / iters for ms, name in device_kernels(prof)}


def phase_device():
    import torch
    from repro_torch.kernels import build
    smi = smi_line()
    say("1 device", f"nvidia-smi: {smi} | torch.cuda: {torch.cuda.get_device_name(0)}"
        f" x{torch.cuda.device_count()} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in fp32 throughout, as the reference's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    reports = build.build(["nmp_fwd", "halo_pack", "nmp_bwd", "embedding_bag",
                           "flash_attention", "edge_mlp_agg"])
    regs = {k: sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in v.splitlines() if "Used " in ln})
            for k, v in reports.items()}
    say("1 device", f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, sm_90a, in parallel); ptxas: {regs}")
    # {key: (source, mangled-name needle)}
    kernels = {"nmp_fwd": ("nmp_fwd", "nmp_fwd_tile_kernelILi32E"),
               "nmp_bwd": ("nmp_bwd", "nmp_bwd_edge_kernelILi32E"),
               "embedding_bag": ("embedding_bag", "embedding_bag_kernelIfLi4E"),
               "flash_attention": ("flash_attention", "flash_fwd_bf16_kernelILi128E"),
               "edge_mlp_agg": ("edge_mlp_agg", "edge_mlp_agg_kernelIfLi2E"),
               "edge_mlp_agg_bf16": ("edge_mlp_agg", "edge_mlp_agg_kernelI13__nv_bfloat16Li2E"),
               "halo_pack": ("halo_pack", "11pack_kernelILi4E"),
               "halo_unpack_add": ("halo_pack", "unpack_add_kernelILi4E")}
    ptxas = {key: ptxas_summary(reports.get(src, ""), needle)
             for key, (src, needle) in kernels.items()}
    say("1 device", f"ptxas at H=32 (embedding bag: fp32, 16-byte loads; flash "
        f"attention: bf16, D=128; edge_mlp_agg: fp32 and bf16 feats, block_n <= 128; "
        f"halo pack and unpack-add: 16-byte accesses): {ptxas}")
    return smi, ptxas


def double(*trees):
    """float64 copies of tensors and of parameter trees (dicts and lists)."""
    def f64(v):
        if isinstance(v, dict):
            return {k: f64(u) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(f64(u) for u in v)
        return v.double()
    return [f64(t) for t in trees]


def nmp_fwd_case(x, e, edge, g, n_real, n_pad, flops, weights, ptxas):
    """Kernel 1 against its plain version: e' and agg within the forward
    band, each one's distance from a float64 plain forward within
    F64_FACTOR of plain fp32's, two launches bitwise equal, times, the bound
    (3xTF32 on tensor cores, the kernel's arithmetic; the fp32 CUDA-core one
    beside it), the launch as the card plans it and ptxas's registers and
    spills."""
    import torch
    from repro_torch.kernels.segment_agg import ops as sa
    H, Lp = x.shape[1], len(edge["layers"]) - 1
    lay = (g["seg_perm"], g["seg_src"], g["seg_rowptr"])
    rest = (g["edge_mask"], g["edge_inv_mult"])

    def fwd():
        return sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)

    def fwd_plain():
        return sa.fused_nmp_edge_agg_plain(x, e, edge, *lay, *rest)

    got, again = fwd(), fwd()
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = fwd_plain()
    err_e, ok_e = within_band(got[0], want[0])
    err_a, ok_a = within_band(got[1], want[1])
    # both against the same forward in float64
    exact = sa.fused_nmp_edge_agg_plain(*double(x, e, edge), *lay, *double(*rest))
    vs64 = {n: (rel_norm(a.double(), r), rel_norm(b.double(), r))
            for n, a, b, r in zip(("e_new", "agg"), got, want, exact)}
    del want, exact
    f64_ok = all(a <= F64_FACTOR * b for a, b in vs64.values())
    ms = cuda_ms(fwd, iters=20)
    plain = cuda_ms(fwd_plain, iters=5, warmup=1)
    _, dev_ops = host_device_split(fwd, 3)      # the kernels of one call
    moved = nbytes(x, e, *lay, *rest, *weights, *got)
    # the products' FMAs, each three TF32 products in the kernel's 3xTF32
    # (the lower bound), beside the fp32 CUDA-core bound
    fp32_ms, fp32_by = bound_ms(moved, flops)
    b_ms, b_by = min((fp32_ms, fp32_by), bound_ms(moved, 3 * flops, PEAK_TF32_FLOPS))
    plan = sa.fwd_launch_plan(H, Lp, g["seg_perm"].numel())
    say("2 kernels", f"nmp_fwd H={H} Lp={Lp} E={n_real} N={n_pad}: max|err| e_new "
        f"{err_e:.3g} agg {err_a:.3g} (rtol {RTOL} atol {ATOL}) | two launches bitwise "
        f"equal: {repeat} | kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by}: 3 x {flops / 1e9:.1f} GFLOP in 3xTF32 on tensor cores, "
        f"{moved / 1e9:.2f} GB; fp32 on CUDA cores {fp32_ms:.3f} ms) | edge pass: grid "
        f"{plan['grid']}, {plan['smem_bytes']} B shared memory per block, "
        f"{plan['blocks_per_sm']} block(s) per SM, {plan['smem_layers']} hidden layer(s) "
        f"in shared memory, {plan['tiles']} tiles | ptxas {ptxas['nmp_fwd']}")
    say("2 kernels", "nmp_fwd rel L2 against the float64 forward, kernel / plain fp32 "
        f"(kernel <= {F64_FACTOR:g}x plain: {f64_ok}): "
        + ", ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in vs64.items())
        + " | one call's device kernels under torch.profiler: "
        + "; ".join(f"{n[:40]} {t:.3f} ms" for n, t in dev_ops.items()))
    if not (ok_e and ok_a and f64_ok and repeat):
        raise RuntimeError("fused NMP kernel disagrees with its plain version or the "
                           "float64 forward, or is not repeatable")
    return dict(name=sa.KERNEL, route="cuda", source="src/repro_torch/csrc/nmp_fwd.cu",
                replaces="src/repro/kernels/segment_agg/kernel.py:215",
                max_abs_err=max(err_e, err_a), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, fp32_bound_ms=fp32_ms)


def nmp_bwd_case(x, e, edge, g, n_real, n_pad, flops, weights, ptxas, gen):
    """Kernel 2 against its plain version: g_x / g_e within the gradient
    band, weight gradients by relative L2, every output's distance from the
    float64 VJP within F64_FACTOR of plain fp32's, two launches bitwise
    equal, times, the bound (3xTF32 on tensor cores, the kernel's
    arithmetic; the fp32 CUDA-core one beside it), the launch as the card
    plans it and ptxas's registers and spills."""
    import torch
    from repro_torch.kernels.segment_agg import ops as sa
    H, Lp = x.shape[1], len(edge["layers"]) - 1
    dev = x.device
    g_enew = torch.randn(e.shape[0], H, generator=gen).to(dev)
    g_agg = torch.randn(n_pad, H, generator=gen).to(dev)
    lay = (g["seg_perm"], g["seg_src"], g["seg_rowptr"])
    src_lay = (g["seg_src_slots"], g["seg_src_rowptr"])
    rest = (g["edge_mask"], g["edge_inv_mult"], g_enew, g_agg)

    def bwd():
        return sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest)

    def bwd_plain():
        return sa.fused_nmp_edge_agg_bwd_plain(x, e, edge, *lay, *rest)

    got, again = bwd(), bwd()
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = bwd_plain()
    err_x, ok_x = within_band(got[0], want[0], G_RTOL, G_ATOL)
    err_g, ok_g = within_band(got[1], want[1], G_RTOL, G_ATOL)
    names = ("w0", "b0", "wrest", "brest", "ln_g", "ln_b")
    wrel = {n: rel_norm(a, b) for n, a, b in zip(names, got[2:], want[2:])}
    # both against the same VJP in float64: where the gap to plain comes from
    exact = sa.fused_nmp_edge_agg_bwd_plain(*double(x, e, edge), *lay, *double(*rest))
    vs64 = {n: (rel_norm(a.double(), r), rel_norm(b.double(), r))
            for n, a, b, r in zip(("g_x", "g_e") + names, got, want, exact)}
    del want, exact
    ms = cuda_ms(bwd, iters=10, warmup=1)
    plain = cuda_ms(bwd_plain, iters=3, warmup=1)
    _, dev_ops = host_device_split(bwd, 3)      # the kernels of one call
    moved = nbytes(x, e, *lay, *src_lay, *rest, *weights, *got)
    # recompute, input gradients and weight gradients: 3x the forward's
    # FMAs, each three TF32 products in the kernel's 3xTF32 (the lower bound)
    fp32_ms, fp32_by = bound_ms(moved, flops)
    b_ms, b_by = min((fp32_ms, fp32_by), bound_ms(moved, 3 * flops, PEAK_TF32_FLOPS))
    f64_ok = all(a <= F64_FACTOR * b for a, b in vs64.values())
    plan = sa.bwd_launch_plan(H, Lp, g["seg_perm"].numel())
    say("2 kernels", f"nmp_bwd H={H} Lp={Lp} E={n_real} N={n_pad}: max|err| "
        f"g_x {err_x:.3g} g_e {err_g:.3g} (rtol {G_RTOL} atol {G_ATOL}); weight "
        f"grads rel L2 " + ", ".join(f"{k} {v:.2e}" for k, v in wrel.items())
        + f" (<= {W_REL}: sums over {n_real} edges, so an elementwise atol says "
        f"nothing there) | two launches bitwise equal: {repeat} | kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}: 3 x "
        f"{flops / 1e9:.1f} GFLOP in 3xTF32 on tensor cores, {moved / 1e9:.2f} GB; "
        f"fp32 on CUDA cores {fp32_ms:.3f} ms) | edge pass: grid {plan['grid']}, "
        f"{plan['smem_bytes']} B shared memory per block, {plan['blocks_per_sm']} "
        f"block(s) per SM | ptxas {ptxas['nmp_bwd']}")
    say("2 kernels", "nmp_bwd rel L2 against the float64 VJP, kernel / plain fp32 "
        f"(kernel <= {F64_FACTOR:g}x plain: {f64_ok}): "
        + ", ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in vs64.items())
        + " | one call's device kernels under torch.profiler: "
        + "; ".join(f"{n[:40]} {t:.3f} ms" for n, t in dev_ops.items()))
    if not (ok_x and ok_g and all(v <= W_REL for v in wrel.values()) and f64_ok
            and repeat):
        raise RuntimeError("fused NMP backward kernel disagrees with its plain "
                           "version or the float64 VJP, or is not repeatable")
    return dict(name=sa.KERNEL_BWD, route="cuda", source="src/repro_torch/csrc/nmp_bwd.cu",
                replaces="src/repro/kernels/segment_agg/kernel.py:357",
                max_abs_err=max(err_x, err_g), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, fp32_bound_ms=fp32_ms)


def halo_cases(F, gen):
    """Kernels 4 and 5 on every round and rank of the 2x2 partition of the
    consistency mesh, bitwise against the plain versions: the pack of one
    round and the exchange pack (one launch over every round and sender,
    through the concatenated send and recv wires), the unpack-add of one
    round.  Times: the exchange pack against the per-round packs it
    replaces and against plain; the unpack-add at the widest round; each
    kernel's host and device time per call apart."""
    import torch
    from repro_torch.core.graph_state import NMPPlan, ShardedGraph
    from repro_torch.core.halo import NEIGHBOR
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh
    from repro_torch.kernels import build
    from repro_torch.kernels.halo_pack import ops as hp
    dev = torch.device("cuda")
    csem = box_mesh(CONS_ELEMS, p=ORDER)
    cpg = partition_mesh(csem, CONS_GRID)
    plan = NMPPlan.build(cpg, NEIGHBOR, packed=True)
    cg = ShardedGraph.build(cpg, csem.coords, plan, device=dev)
    R, rounds = cpg.R, range(len(plan.halo.perms))
    widths = [int(cg[f"pk{k}_send_idx"].shape[1]) for k in rounds]
    offsets = np.cumsum([0] + widths[:-1])
    src = torch.randn(cpg.n_pad, F, generator=gen).to(dev)
    seed = torch.randn(cpg.n_pad, F, generator=gen).to(dev)
    stacked = torch.randn(R, cpg.n_pad, F, generator=gen).to(dev)
    wire = lambda k, side, r: cg.wire(f"pk{k}_{side}").rank(r)  # noqa: E731
    pack_err = unpack_err = 0.0
    for k in rounds:
        for r in range(R):
            swire, rwire = wire(k, "send", r), wire(k, "recv", r)
            got, want = hp.halo_pack(src, swire), hp.halo_pack_plain(src, *swire[:2])
            if not torch.equal(got, want):
                raise RuntimeError(f"pack kernel != plain (round {k}, rank {r})")
            pack_err = max(pack_err, float((got - want).abs().max()))
            got = hp.halo_unpack_add(seed, want, rwire)
            ref = hp.halo_unpack_add_plain(seed, want, *rwire[:2])
            if not torch.equal(got, ref):
                raise RuntimeError(f"unpack kernel != plain (round {k}, rank {r})")
            unpack_err = max(unpack_err, float((got - ref).abs().max()))
    # the exchange pack: every round's rows of every sender, one launch,
    # bitwise equal to each round's plain pack of that sender
    ex = {side: cg.wire(f"pk_{side}") for side in ("send", "recv")}
    for side, w in ex.items():
        got = hp._pack(stacked, w.idx, w.mask)
        for k in rounds:
            for r in range(R):
                part = got[r, offsets[k]:offsets[k] + widths[k]]
                want = hp.halo_pack_plain(stacked[r], *wire(k, side, r)[:2])
                if not torch.equal(part, want):
                    raise RuntimeError(f"exchange pack != plain ({side}, round {k}, "
                                       f"rank {r})")
                pack_err = max(pack_err, float((part - want).abs().max()))
    kw = int(np.argmax(widths))
    swire, rwire = wire(kw, "send", 0), wire(kw, "recv", 0)
    idx, mask, _ = swire
    ridx, rmask, rinv = rwire
    buf = hp.halo_pack_plain(src, idx, mask)
    W, W_ex = widths[kw], sum(widths)
    sidx, smask, _ = ex["send"]
    round_wires = [wire(k, "send", r) for k in rounds for r in range(R)]
    calls = {hp.PACK: lambda: hp._pack(stacked, sidx, smask),
             hp.UNPACK: lambda: hp.halo_unpack_add(seed, buf, rwire)}
    # host-bound calls: kernel, plain version and library call timed in
    # turns, the median of HALO_ROUNDS readings each
    t = interleaved_ms({
        "exchange pack": calls[hp.PACK],
        "per-round packs": lambda: [hp.halo_pack(stacked[i % R], w)
                                    for i, w in enumerate(round_wires)],
        "exchange pack plain": lambda: torch.stack(
            [hp.halo_pack_plain(stacked[r], sidx[r], smask[r]) for r in range(R)]),
        "pack": lambda: hp.halo_pack(src, swire),
        "unpack": calls[hp.UNPACK],
        "unpack plain": lambda: hp.halo_unpack_add_plain(seed, buf, ridx, rmask),
        # one library call on the pre-masked buffer
        "index_add": lambda: torch.index_add(seed, 0, ridx, buf)}, 200)
    timings = {hp.PACK: (t["exchange pack"], t["exchange pack plain"], None),
               hp.UNPACK: (t["unpack"], t["unpack plain"], t["index_add"])}
    # each wrapper's host time per call (checks, allocation, ctypes, launch)
    # and device time per call under torch.profiler; beside it the bare C
    # call (ctypes and the launch) on the same pointers, without the wrapper
    splits = {name: host_device_split(fn, 200) for name, fn in calls.items()}
    _, pack_c, unpack_c = hp._entries()
    stream = build.stream_of(seed)
    out = torch.empty(R, W_ex, F, device=dev)
    pack_args = (stacked.data_ptr(), sidx.data_ptr(), smask.data_ptr(), out.data_ptr(),
                 W_ex, F, cpg.n_pad, R, stream)
    unpack_args = (seed.data_ptr(), buf.data_ptr(), rinv.data_ptr(), rmask.data_ptr(),
                   out.data_ptr(), cpg.n_pad, F, stream)
    bare = {hp.PACK: host_ms(lambda: pack_c(*pack_args), 200),
            hp.UNPACK: host_ms(lambda: unpack_c(*unpack_args), 200)}
    # the functions' own bytes, whatever index the kernel reads: rows
    # gathered + buffer written (and the wire); seed read + out written +
    # buffer and wire
    moved = {hp.PACK: nbytes(sidx, smask, out, out),
             hp.UNPACK: nbytes(seed, seed, buf, ridx, rmask)}
    shapes = {hp.PACK: f"the exchange: {R} senders x {len(widths)} rounds, widths {widths} "
                       f"(W={W_ex}), F={F}, N={cpg.n_pad}",
              hp.UNPACK: f"widths {widths} (timed W={W}, F={F}, N={cpg.n_pad})"}
    records = []
    for name, err in ((hp.PACK, pack_err), (hp.UNPACK, unpack_err)):
        ms, plain, lib = timings[name]
        host, dev_ops = splits[name]
        dev_ms = sum(dev_ops.values())
        b_ms, b_by = bound_ms(moved[name], 0)
        extra = (f", the {len(round_wires)} per-round launches it replaces "
                 f"{t['per-round packs'] * 1e3:.2f} us, one round's (W={W}) "
                 f"{t['pack'] * 1e3:.2f} us" if name == hp.PACK else "")
        say("2 kernels", f"{name} {shapes[name]}: bitwise equal to plain over all rounds "
            f"and ranks | kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us (medians of "
            f"{HALO_ROUNDS} readings in turns)"
            + (f", torch.index_add {lib * 1e3:.2f} us" if lib is not None else "") + extra
            + f", bound {b_ms * 1e3:.3f} us ({b_by}) | host {host * 1e3:.2f} us per "
            f"call (of which the bare C call, ctypes + launch, {bare[name] * 1e3:.2f} us), "
            f"device {dev_ms * 1e3:.2f} us per call under torch.profiler ("
            + "; ".join(f"{n[:48]} {t_ * 1e3:.2f} us" for n, t_ in dev_ops.items()) + ")")
        rec = dict(name=name, route="cuda", source="src/repro_torch/csrc/halo_pack.cu",
                   replaces=("src/repro/kernels/halo_pack/kernel.py:44"
                             if name == hp.PACK else
                             "src/repro/kernels/halo_pack/kernel.py:91"),
                   max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib, host_ms_per_call=host,
                   bare_c_call_ms=bare[name], device_ms_per_call=dev_ms)
        if name == hp.PACK:
            rec.update(per_round_packs_ms=t["per-round packs"], one_round_ms=t["pack"])
        records.append(rec)
    return records


def phase_kernels(ptxas, cfg=None, cases=GNN_CASES):
    """The GNN's kernels at the shapes its main paths give them: ``cases``
    from GNN_CASES (the fused NMP forward and backward on the serving mesh,
    pack / unpack-add on the 2x2 partition's rounds).  A subset runs those
    alone, the way two source trees are compared on one card: ``python3 -c
    'import chip_smoke as c; c.phase_kernels(c.phase_device()[1],
    cases=("nmp_bwd", "halo"))'`` from the root of each tree.  Returns
    (serving mesh, its partition, one record per kernel run)."""
    import torch
    from repro_torch.core.gnn import GNNConfig, init_gnn
    from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh

    cfg = cfg or GNNConfig.large()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    sem = box_mesh(SERVE_ELEMS, p=ORDER)
    pg = partition_mesh(sem, (1, 1, 1))
    g = ShardedGraph.build(pg, sem.coords, NMPPlan(backend=FUSED),
                           device=dev).rank(0)
    n_real = int(pg.edge_mask.sum())
    say("2 kernels", f"serving mesh {SERVE_ELEMS} p={ORDER}: {pg.n_global} nodes, "
        f"{n_real} directed edges (host build {time.perf_counter() - t0:.1f} s)")
    records = []
    gen = torch.Generator().manual_seed(11)
    edge = init_gnn(gen, cfg, device=dev)["mp"][0]["edge"]
    H, Lp = cfg.hidden, cfg.mlp_hidden_layers
    x = torch.randn(pg.n_pad, H, generator=gen).to(dev)
    e = torch.randn(pg.e_pad, H, generator=gen).to(dev)
    weights = [t for l in edge["layers"] for t in l.values()] + list(edge["ln"].values())
    # the dense layers' FMAs: per edge the x_src and e slices of layer 0 and
    # the Lp hidden layers; the x_dst slice once per node that has edges
    n_dst = int((g["seg_rowptr"].diff() > 0).sum())
    fwd_flops = n_real * 2 * (2 * H * H + Lp * H * H) + n_dst * 2 * H * H
    if "nmp_fwd" in cases:
        records.append(nmp_fwd_case(x, e, edge, g, n_real, pg.n_pad, fwd_flops, weights,
                                    ptxas))
    if "nmp_bwd" in cases:
        records.append(nmp_bwd_case(x, e, edge, g, n_real, pg.n_pad, 3 * fwd_flops,
                                    weights, ptxas, gen))
    del x, e, g
    torch.cuda.empty_cache()
    if "halo" in cases:
        records.extend(halo_cases(cfg.hidden, gen))
    return sem, pg, records


def phase_segment_agg(sem, ptxas):
    """Kernel 3, the dst-aligned edge MLP + aggregate, at full width (Fin
    96, Hh 32, H 32) on the serving mesh's directed edges and at
    kernel_bench's segment_agg_ref_8k_edges shape (E 8192, N 2048, Fin 24,
    H 16): the kernel's and the plain version's error against
    edge_mlp_agg_ref, repeatability, times, bound, the launch plan and the
    layout's waste; at full width each output's distance from a float64
    forward against plain fp32's, and the kernel on bf16 feats against
    plain (time and bound too).  The op's own path is one launch-counted
    call of fused_edge_mlp_agg at full width.  Runs alone, the way two
    source trees are compared on one card: ``python3 -c 'import chip_smoke
    as c; c.phase_segment_agg(None, c.phase_device()[1])'`` (None: the
    serving mesh).  Returns (record, launch counts of that call)."""
    import torch
    from repro_torch.core.mesh_gen import (
        box_mesh, mesh_graph_edges, undirected_to_directed)
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as sa
    from repro_torch.kernels.segment_agg.ref import edge_mlp_agg_ref

    dev = torch.device("cuda")
    bn, be = MLP_AGG_BLOCKS
    t0 = time.perf_counter()
    sem = sem or box_mesh(SERVE_ELEMS, p=ORDER)
    full_dst = undirected_to_directed(mesh_graph_edges(sem))[:, 1]
    cases = [("full width", full_dst, sem.n_nodes, 96, 32, 32),
             ("8k edges", np.random.default_rng(0).integers(0, 2048, 8192), 2048, 24, 16, 16)]
    record = counts = None
    for name, dst, n, fin, hh, hid in cases:
        full = record is None
        layout = sa.dst_aligned_layout(dst, n, bn, be)
        host_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(17)
        E = len(dst)
        feats = torch.randn(E, fin, generator=gen, device=dev)
        wgt = torch.rand(E, generator=gen, device=dev) * 0.5 + 0.5
        mlp = (torch.randn(fin, hh, generator=gen, device=dev) * fin ** -0.5,
               torch.randn(hh, generator=gen, device=dev) * 0.1,
               torch.randn(hh, hid, generator=gen, device=dev) * hh ** -0.5,
               torch.randn(hid, generator=gen, device=dev) * 0.1)
        dst_t = torch.from_numpy(dst).to(dev)
        perm = torch.from_numpy(layout["perm"]).to(dev)
        dstl = torch.from_numpy(layout["dstl"]).to(dev)
        kw = dict(n_nodes=n, block_n=bn, block_e=be)
        want_e, want_agg = edge_mlp_agg_ref(feats, *mlp, dst_t, wgt, n)
        op_note = ""
        if full:
            # the op's own path: one call through the entry point, counted
            build.reset_launch_counts()
            e_op, agg_op = sa.fused_edge_mlp_agg(feats, dst_t, wgt, *mlp,
                                                 dict(layout, perm=perm, dstl=dstl), **kw)
            torch.cuda.synchronize()
            counts = dict(build.launch_counts)
            err_oe, ok_oe = within_band(e_op, want_e, MLP_AGG_E_TOL, MLP_AGG_E_TOL)
            err_oa, ok_oa = within_band(agg_op[:n], want_agg, MLP_AGG_TOL, MLP_AGG_TOL)
            launches = counts.get(sa.KERNEL_MLP_AGG, 0)
            op_note = (f" | fused_edge_mlp_agg vs ref: e_new {err_oe:.3g}, agg {err_oa:.3g}, "
                       f"launches {launches}")
            if not (ok_oe and ok_oa and launches == 1):
                raise RuntimeError("fused_edge_mlp_agg disagrees with edge_mlp_agg_ref or "
                                   "did not launch its kernel exactly once")
            del e_op, agg_op
        valid = perm >= 0
        safe = perm.clamp(min=0)
        tiles = (torch.where(valid[..., None], feats[safe], 0), dstl,
                 torch.where(valid, wgt[safe], 0))
        tkw = dict(n_node_blocks=layout["n_node_blocks"], block_n=bn, block_e=be)

        def kernel(f=tiles[0]):
            return sa.edge_mlp_agg(f, *tiles[1:], *mlp, **tkw)

        def plain(f=tiles[0]):
            return sa.edge_mlp_agg_plain(f, *tiles[1:], *mlp, **tkw)

        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        del again
        slot_e = want_e[safe[valid]]
        errs, checks = {}, {"two launches bitwise equal": same}
        for label, (e_t, a_t) in (("kernel", got), ("plain", ref)):
            err_e, ok_e = within_band(e_t[valid], slot_e, MLP_AGG_E_TOL, MLP_AGG_E_TOL)
            err_a, ok_a = within_band(a_t.reshape(-1, hid)[:n], want_agg, MLP_AGG_TOL,
                                      MLP_AGG_TOL)
            errs[label] = (f"e_new {err_e:.3g} agg {err_a:.3g}", max(err_e, err_a))
            checks[f"{label} vs edge_mlp_agg_ref"] = ok_e and ok_a
        f64_note = ""
        if full:
            # kernel and plain fp32 against the same forward in float64
            exact = sa.edge_mlp_agg_plain(tiles[0].double(), tiles[1], tiles[2].double(),
                                          *(t.double() for t in mlp), **tkw)
            vs64 = {k: (rel_norm(a.double(), x), rel_norm(b.double(), x))
                    for k, a, b, x in zip(("e_new", "agg"), got, ref, exact)}
            del exact
            f64_ok = all(a <= F64_FACTOR * b for a, b in vs64.values())
            checks["float64 distance"] = f64_ok
            f64_note = (f" | rel L2 against the float64 forward, kernel / plain fp32 (kernel "
                        f"<= {F64_FACTOR:g}x plain: {f64_ok}): "
                        + ", ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in vs64.items()))
        del ref, slot_e
        ms = cuda_ms(kernel, iters=20)
        plain_ms = cuda_ms(plain, iters=5, warmup=1)
        moved = nbytes(*tiles, *mlp, *got)
        n_real = int(valid.sum())
        # the real edges' MLP and their multiply-add into the aggregate; the
        # least time is the lower of fp32 on the CUDA cores and 3xTF32 (each
        # product three TF32 products) on the tensor cores
        flops = n_real * 2 * (fin * hh + hh * hid + hid)
        fp32_ms, fp32_by = bound_ms(moved, flops)
        b_ms, b_by = min((fp32_ms, fp32_by), bound_ms(moved, 3 * flops, PEAK_TF32_FLOPS))
        plan = sa.mlp_agg_launch_plan(fin, bn, torch.float32, layout["n_node_blocks"])
        bf16_note, bf16 = "", {}
        if full:
            fb = tiles[0].to(torch.bfloat16)
            kb, kb2, pb = kernel(fb), kernel(fb), plain(fb)
            torch.cuda.synchronize()
            same_b = torch.equal(kb[0], kb2[0]) and torch.equal(kb[1], kb2[1])
            err_be, ok_be = within_band(kb[0].float(), pb[0].float(), MLP_AGG_BF16_TOL,
                                        MLP_AGG_BF16_TOL)
            err_ba, ok_ba = within_band(kb[1], pb[1], MLP_AGG_TOL, MLP_AGG_TOL)
            ms_b = cuda_ms(lambda: kernel(fb), iters=20)
            moved_b = nbytes(fb, *tiles[1:], *mlp, *kb)
            b_ms_b, b_by_b = min(bound_ms(moved_b, flops),
                                 bound_ms(moved_b, 3 * flops, PEAK_TF32_FLOPS))
            plan_b = sa.mlp_agg_launch_plan(fin, bn, torch.bfloat16, layout["n_node_blocks"])
            checks.update({"bf16 bitwise repeatable": same_b, "bf16 e_new vs plain": ok_be,
                           "bf16 agg vs plain": ok_ba})
            bf16 = dict(bf16_ms=ms_b, bf16_bound_ms=b_ms_b, bf16_bound_by=b_by_b)
            bf16_note = (f" | bf16 feats: vs plain e_new {err_be:.3g} (band "
                         f"{MLP_AGG_BF16_TOL}) agg {err_ba:.3g}, bitwise repeatable: {same_b}, "
                         f"kernel {ms_b:.4f} ms, bound {b_ms_b:.4f} ms ({b_by_b}, "
                         f"{moved_b / 1e9:.3f} GB), {plan_b['groups']} groups of 4 warps, "
                         f"{plan_b['smem_bytes']} B shared memory per block, "
                         f"{plan_b['blocks_per_sm']} block(s) per SM | ptxas fp32 "
                         f"{ptxas['edge_mlp_agg']}, bf16 {ptxas['edge_mlp_agg_bf16']}")
            del fb, kb, kb2, pb
        say("2 kernels", f"edge_mlp_agg {name}: E={E} N={n} Fin={fin} Hh={hh} H={hid} "
            f"blocks {bn}/{be}: {layout['n_node_blocks']} x {layout['n_edge_blocks']} x {be} "
            f"slots, waste {layout['waste']:.4f} (host layout {host_s:.1f} s) | max|err| vs "
            f"edge_mlp_agg_ref (e_new rtol/atol {MLP_AGG_E_TOL}, agg {MLP_AGG_TOL}): kernel "
            f"{errs['kernel'][0]}, plain {errs['plain'][0]} | two launches bitwise equal: "
            f"{same} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {flops / 1e9:.2f} GFLOP, 3 x that in 3xTF32 on tensor cores, "
            f"{moved / 1e9:.3f} GB; fp32 on CUDA cores {fp32_ms:.4f} ms) | launch: grid "
            f"{plan['grid']}, {plan['groups']} groups of 4 warps, {plan['smem_bytes']} B "
            f"shared memory per block, {plan['blocks_per_sm']} block(s) per SM"
            f"{f64_note}{op_note}{bf16_note}")
        failed = [k for k, v in checks.items() if not v]
        if failed:
            raise RuntimeError(f"edge_mlp_agg ({name}) failed: {failed}")
        if full:
            record = dict(name=sa.KERNEL_MLP_AGG, route="cuda",
                          source="src/repro_torch/csrc/edge_mlp_agg.cu",
                          replaces="src/repro/kernels/segment_agg/kernel.py:435",
                          max_abs_err=errs["kernel"][1], ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          fp32_bound_ms=fp32_ms, **bf16)
        else:
            record["ms_8k_edges"] = ms
        del feats, wgt, tiles, got, want_e, want_agg, perm, dstl, dst_t
        t0 = time.perf_counter()
    torch.cuda.empty_cache()
    return record, counts


def phase_embedding_bag(ptxas):
    """The embedding bag at DLRM RM2's serve_bulk lookup on the full table,
    and at fp32 H=8 and bf16 H=4: bitwise vs plain, repeatability, times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import dlrm_rm2
    from repro_torch.graph.datasets import criteo_like
    from repro_torch.kernels.embedding_bag import ops as eb

    dev = torch.device("cuda")
    cfg = dlrm_rm2.config()
    V, D = sum(cfg.vocab_sizes), cfg.embed_dim
    gen = torch.Generator(device=dev).manual_seed(7)
    table = torch.randn(V, D, generator=gen, device=dev).mul_(0.01)
    _, sparse, _ = criteo_like(262144, cfg, seed=DLRM_SEED)
    bulk = torch.from_numpy(sparse.reshape(-1, cfg.multi_hot)).to(dev)
    top_elem = int(bulk.max()) * D
    if top_elem < 2 ** 31:
        raise RuntimeError("the serve_bulk lookup never passes 2^31 table elements")
    cases = [("serve_bulk fp32", table, bulk),
             ("fp32 H=8", table,
              torch.randint(0, V, (65536, 8), generator=gen, device=dev, dtype=torch.int32)),
             ("bf16 H=4", table.to(torch.bfloat16),
              torch.randint(0, V, (65536, 4), generator=gen, device=dev, dtype=torch.int32))]
    record = None
    for name, tab, idx in cases:
        got, again = eb.embedding_bag(tab, idx), eb.embedding_bag(tab, idx)
        want = eb.embedding_bag_plain(tab, idx)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise RuntimeError(f"embedding bag ({name}) != plain or not repeatable")
        err = float((got.float() - want.float()).abs().max())
        lib_out = F.embedding_bag(idx, tab, mode="sum")
        lib_err = float((lib_out.float() - want.float()).abs().max())
        ms = cuda_ms(lambda: eb.embedding_bag(tab, idx), 20)
        plain = cuda_ms(lambda: eb.embedding_bag_plain(tab, idx), 5, warmup=1)
        lib = cuda_ms(lambda: F.embedding_bag(idx, tab, mode="sum"), 20)
        (B, H), s_el = idx.shape, tab.element_size()
        # every gathered row read once, every bag written once, every index once
        moved = B * H * D * s_el + B * D * s_el + B * H * 4
        b_ms, b_by = bound_ms(moved, B * H * D)
        say("2 kernels", f"embedding_bag {name} (V={V}, D={D}, {B} bags of {H}, "
            f"{tab.dtype}): bitwise equal to plain, two launches bitwise equal"
            + (f", largest element offset {top_elem} > 2^31" if record is None else "")
            + f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, F.embedding_bag "
            f"{lib:.4f} ms (max|diff| vs plain {lib_err:.3g}), bound {b_ms:.4f} ms "
            f"({b_by}, {moved / 1e9:.3f} GB) | ptxas {ptxas['embedding_bag']}")
        if record is None:
            record = dict(name=eb.KERNEL, route="cuda",
                          source="src/repro_torch/csrc/embedding_bag.cu",
                          replaces="src/repro/kernels/embedding_bag/kernel.py:35",
                          max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib)
        del got, again, want, lib_out
    del cases, table, bulk, tab, idx
    torch.cuda.empty_cache()
    return record


def attention_pairs(S, causal, window):
    """(query, key) pairs that the mask keeps, one S for both."""
    q = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(S, np.int64)
    hi = q + 1 if causal else np.full(S, S, np.int64)
    return int((hi - lo).sum())


def drop_diagonal_tiles(q, k, v, want, scale):
    """The plain causal output ``want`` with a planted fault: every row
    from FAULT_ROW on attends only to the keys before its own FAULT_TILE-key
    diagonal tile (the fault of a kernel that skips that tile)."""
    from repro_torch.kernels.flash_attention.ref import attention_plain
    out = want.clone()
    for t0 in range(FAULT_ROW, q.shape[1], FAULT_TILE):
        out[:, t0:t0 + FAULT_TILE] = attention_plain(
            q[:, t0:t0 + FAULT_TILE], k[:, :t0], v[:, :t0], scale=scale, causal=False)
    return out


def phase_flash_attention(ptxas, cases=FLASH_CASES):
    """Flash attention at ``cases`` in fp32 and bf16 and at one Granite
    prefill layer: error vs plain within TOL and, row by row, within
    ROW_REL_TOL (at the Granite layer beside the reading of a planted
    fault, which must fail it), repeatability, times, bound and
    F.scaled_dot_product_attention's time where it computes the same
    function (no window, no softcap).  ``cases=()`` runs the Granite layer
    alone, the way two source trees are compared on one card:
    ``python3 -c 'import chip_smoke as c; c.phase_flash_attention(
    c.phase_device()[1], cases=())'`` from the root of each tree."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import ops as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = [(c, dt) for dt in (torch.float32, torch.bfloat16) for c in cases]
    cases.append((GRANITE_LAYER, torch.bfloat16))
    record = None
    for (B, S, Hq, Hkv, D, causal, window, cap), dtype in cases:
        granite = (B, S, Hq, Hkv, D, causal, window, cap) == GRANITE_LAYER
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev, dtype=dtype)
                   for h in (Hq, Hkv, Hkv))
        kw = dict(scale=D ** -0.5, causal=causal, window=window, softcap=cap)

        def plain():
            return fa.attention_plain(q, k, v, chunk=512 if granite else None, **kw)

        got, again = fa.flash_attention(q, k, v, **kw), fa.flash_attention(q, k, v, **kw)
        want = plain()
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        diff = (got.float() - want.float()).abs()
        dname = str(dtype).split(".")[1]
        rtol, atol = FLASH_TOL[dname]
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        err = float(diff.max())
        del again, diff
        row_err, row_tol = row_rel_err(got, want), ROW_REL_TOL[dname]
        ok = ok and row_err <= row_tol
        fault_note = ""
        if granite:
            fault = drop_diagonal_tiles(q, k, v, want, D ** -0.5)
            fault_err = row_rel_err(fault, want)
            fault_in_tol = bool(((fault.float() - want.float()).abs()
                                 <= atol + rtol * want.float().abs()).all())
            ok = ok and fault_err > row_tol
            fault_note = (f" (planted fault, rows >= {FAULT_ROW} without their diagonal "
                          f"{FAULT_TILE}-key tile: {fault_err:.3g}, must exceed it; within "
                          f"the elementwise TOL: {fault_in_tol})")
            del fault
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), 5 if granite else 20)
        plain_ms = cuda_ms(plain, 1 if granite else 5, warmup=1)
        lib_ms, lib_note = None, "none (window or softcap)"
        if window == 0 and cap is None:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            backend = SDPBackend.FLASH_ATTENTION if dtype == torch.bfloat16 else SDPBackend.MATH
            with sdpa_kernel(backend):
                def lib():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, scale=D ** -0.5, enable_gqa=True)
                lib_err = float((lib().transpose(1, 2).float() - want.float()).abs().max())
                lib_ms = cuda_ms(lib, 5 if granite else 20)
            lib_note = f"{lib_ms:.4f} ms ({backend.name}, max|diff| vs plain {lib_err:.3g})"
        flops = 4 * D * Hq * B * attention_pairs(S, causal, window)
        moved = nbytes(q, k, v, got)
        b_ms, b_by = bound_ms(moved, flops, PEAK_BF16_FLOPS if dtype == torch.bfloat16
                              else PEAK_FP32_FLOPS)
        say("2 kernels", f"flash_attention {'Granite prefill layer ' if granite else ''}"
            f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal={causal} window={window} "
            f"softcap={cap} {dtype}: max|err| vs plain {err:.3g} (rtol {rtol} atol {atol}), "
            f"largest row rel L2 err {row_err:.3g} (limit {row_tol}){fault_note} "
            f"-> {'ok' if ok else 'FAIL'} | two launches bitwise equal: {same} | kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"SDPA {lib_note}, bound {b_ms:.4f} ms ({b_by}, {flops / 1e12:.3f} TFLOP, "
            f"{moved / 1e9:.3f} GB)" + (f" | ptxas {ptxas['flash_attention']}" if granite else ""))
        if not (ok and same):
            raise RuntimeError(f"flash attention kernel disagrees with its plain version, is "
                               f"not repeatable or its row check let the planted fault pass "
                               f"at {(B, S, Hq, Hkv, D)} {dtype}")
        if granite:
            record = dict(name=fa.KERNEL, route="cuda",
                          source="src/repro_torch/csrc/flash_attention.cu",
                          replaces="src/repro/kernels/flash_attention/kernel.py:75",
                          max_abs_err=err, max_row_rel_err=row_err,
                          planted_fault_row_rel_err=fault_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return record


def check_launches(phase, path, got, want):
    """Every kernel's launches on ``path`` exactly as ``want`` says (0 for
    the kernels it does not name).  On the 2x2 partition's 4 NMP layers:
    per layer one fused forward (and backward) per rank, one exchange pack
    (all 3 rounds and 4 ranks) per halo exchange and its reversal, one
    unpack-add per round and receiver (3 rounds x 4 ranks)."""
    bad = {k: (got.get(k, 0), want.get(k, 0)) for k in set(got) | set(want)
           if got.get(k, 0) != want.get(k, 0)}
    say(phase, f"launches on {path}: {got} (expected exactly {want}) -> "
        f"{'ok' if not bad else 'FAIL'}")
    if bad:
        raise RuntimeError(f"launch counts on {path}: (got, expected) {bad}")


def phase_consistency(cfg):
    import torch
    from repro_torch.core.gnn import init_gnn
    from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
    from repro_torch.core.halo import A2A, NEIGHBOR, NONE, halo_sync_stacked
    from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
    from repro_torch.core.partition import (
        gather_node_features, partition_mesh, scatter_node_outputs)
    from repro_torch.core.reference import gnn_forward_stacked
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    sem = box_mesh(CONS_ELEMS, p=ORDER)
    x = taylor_green_velocity(sem.coords)

    def run(grid, mode, backend, packed=False, sync_fn=None, per_rank=None):
        pg = partition_mesh(sem, grid)
        plan = NMPPlan.build(pg, mode, packed=packed, backend=backend)
        g = ShardedGraph.build(pg, sem.coords, plan, device=dev)
        xs = torch.from_numpy(gather_node_features(pg, x)).to(dev)
        y = gnn_forward_stacked(params, xs, g, plan, sync_fn=sync_fn).cpu().numpy()
        if per_rank is not None:
            per_rank[mode] = y
        return torch.from_numpy(scatter_node_outputs(pg, y))

    y1 = run((1, 1, 1), NONE, FUSED)
    per_rank = {}
    build.reset_launch_counts()
    y4 = run(CONS_GRID, NEIGHBOR, FUSED, packed=True, sync_fn=halo_sync_stacked,
             per_rank=per_rank)
    launches = dict(build.launch_counts)
    check_launches("3 consistency", "the R=4 packed neighbor forward", launches,
                   {"nmp_fwd": 16, "halo_pack": 4, "halo_unpack_add": 48})
    cases = {
        "R=4 packed neighbor (pack/unpack kernels)": y4,
        "R=4 a2a oracle": run(CONS_GRID, A2A, FUSED),
        "R=4 a2a, per-rank order": run(CONS_GRID, A2A, FUSED, sync_fn=halo_sync_stacked,
                                       per_rank=per_rank),
        "R=1 plain backend": run((1, 1, 1), NONE, XLA),
    }
    if not bool(torch.isfinite(y1).all()) or tuple(y1.shape) != (sem.n_nodes, cfg.node_out):
        raise RuntimeError(f"R=1 output not finite / wrong shape {tuple(y1.shape)}")
    for name, y in cases.items():
        err, ok = within_band(y, y1)
        say("3 consistency", f"{CONS_ELEMS} p={ORDER} ({sem.n_nodes} nodes), large "
            f"config, fused R=1 vs {name}: max|err| {err:.3g} "
            f"(rtol {RTOL} atol {ATOL}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"consistency failed: R=1 vs {name}")
    return launches, per_rank


def phase_grad_consistency(cfg):
    import torch
    from repro_torch.core.gnn import init_gnn
    from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
    from repro_torch.core.halo import NEIGHBOR, NONE, halo_sync_stacked
    from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
    from repro_torch.core.partition import gather_node_features, partition_mesh
    from repro_torch.core.reference import loss_and_grad_stacked
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    sem = box_mesh(CONS_ELEMS, p=ORDER)
    x = taylor_green_velocity(sem.coords)
    y = taylor_green_velocity(sem.coords, t=DT)

    def prepare(grid, mode, backend, packed=False):
        pg = partition_mesh(sem, grid)
        plan = NMPPlan.build(pg, mode, packed=packed, backend=backend)
        g = ShardedGraph.build(pg, sem.coords, plan, device=dev)
        xs, ys = (torch.from_numpy(gather_node_features(pg, f)).to(dev) for f in (x, y))
        return xs, ys, g, plan

    def grad(prepared, sync_fn=None):
        xs, ys, g, plan = prepared
        return loss_and_grad_stacked(params, xs, ys, g, plan, cfg.node_out,
                                     sync_fn=sync_fn)

    l1, _, g1 = grad(prepare((1, 1, 1), NONE, FUSED))
    r4 = prepare(CONS_GRID, NEIGHBOR, FUSED, packed=True)
    build.reset_launch_counts()
    l4, _, g4 = grad(r4, halo_sync_stacked)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    check_launches("3b gradients", "the R=4 packed neighbor gradient run", launches,
                   {"nmp_fwd": 16, "nmp_bwd": 16, "halo_pack": 4 + 4,
                    "halo_unpack_add": 48 + 48})
    lx, _, gx = grad(prepare(CONS_GRID, NEIGHBOR, XLA, packed=True), halo_sync_stacked)
    for name, (la, ga), (lb, gb) in (
            ("fused R=1 vs R=4 packed neighbor", (l4, g4), (l1, g1)),
            ("R=4 packed neighbor, fused vs plain backend", (l4, g4), (lx, gx))):
        rel = abs(float(la) - float(lb)) / abs(float(lb))
        err, by_norm, ok = grads_close(ga, gb)
        say("3b gradients", f"{CONS_ELEMS} p={ORDER}, large config, {name}: loss "
            f"{float(la):.6g} vs {float(lb):.6g} (rel {rel:.2e}, band {LOSS_REL}) | "
            f"grads max|err| {err:.3g} (rtol {G_RTOL} atol {G_ATOL})"
            + (f"; held by rel L2 (elements cancel): {by_norm}" if by_norm else "")
            + f" -> {'ok' if ok and rel <= LOSS_REL else 'FAIL'}")
        if not (ok and rel <= LOSS_REL):
            raise RuntimeError(f"gradient consistency failed: {name}")
    return launches, (float(l1), g1)


DIST_FWD = {"nmp_fwd": 4, "halo_pack": 4, "halo_unpack_add": 12}
DIST_GRAD = {"nmp_fwd": 4, "nmp_bwd": 4, "halo_pack": 8, "halo_unpack_add": 24}
DIST_TIMING, DIST_TRAIN_STEPS = 5, 3


def phase_distributed(cfg, stacked, r1, smi):
    """4 gloo processes sharing the card (``launch/consistency.py``): (a)
    the (2,2,1) split, packed neighbor and a2a, each rank's prediction
    bitwise equal to its slice of phase 3's stacked forward, loss and
    gradients within the bands of phase 3b's R=1, launches per process
    exactly DIST_FWD / DIST_GRAD; (b) 3 training steps at (2,1,1) x 2,
    batch 2, whose step 0 matches an R=1 run's and whose parameters end
    bitwise equal on every process.  Returns the summed launches of the
    forward and of the gradient run."""
    import torch
    from repro_torch.core.graph_state import FUSED, NMPPlan
    from repro_torch.core.halo import HaloSpec
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh
    from repro_torch.launch import consistency as cons
    from repro_torch.train.loop import TrainConfig, train_consistent_gnn

    t0 = time.perf_counter()
    job = cons.Job(elements=CONS_ELEMS, order=ORDER, cfg=cfg, device="cuda",
                   backends=(FUSED,), modes=("packed", "a2a", "none"),
                   cases=((CONS_GRID, 1),), timing=DIST_TIMING,
                   train_steps=DIST_TRAIN_STEPS)
    procs = cons.run_world(job, 4)
    wall = time.perf_counter() - t0
    case = cons.case_name(CONS_GRID, 1)
    l1 = r1[0]
    base = (l1, [t.cpu().numpy() for t in _leaves(r1[1])])
    loss = {}
    for mode, stacked_mode in (("packed", "neighbor"), ("a2a", "a2a"), ("none", None)):
        recs = [p[case]["steps"][(FUSED, mode)] for p in procs]
        loss[mode] = float(recs[0]["loss"])
        line = cons.check_step(recs, base, mode, w_rel=W_REL)
        if stacked_mode is not None:
            bitwise = all(np.array_equal(r["pred"][0, 0],
                                         stacked[stacked_mode][p[case]["rank"]])
                          for r, p in zip(recs, procs))
            line = (f"every rank's prediction bitwise equal to its stacked slice: "
                    f"{bitwise} | {line}")
        say("3c distributed", f"4 gloo processes on one card, {CONS_ELEMS} p={ORDER}, "
            f"{CONS_GRID} split, large config, fused, R=1 loss {l1:.8g}: {line}")
        if stacked_mode is not None and not bitwise:
            raise RuntimeError(f"distributed {mode} forward != the stacked forward")
    say("3c distributed", cons.check_agree(loss) + " -> ok")
    sums = {}
    for key, run, want in (("fwd_launches", "forward", DIST_FWD),
                           ("grad_launches", "gradient run", DIST_GRAD)):
        total = {}
        for w, p in enumerate(procs):
            got = p[case]["steps"][(FUSED, "packed")][key]
            check_launches("3c distributed", f"process {w}'s packed {run}", got, want)
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        say("3c distributed", f"launches summed over the 4 processes, packed {run}: "
            f"{total}")
        sums[key] = total
    t = procs[0][case]["steps"][(FUSED, "packed")]
    say("3c distributed", f"{smi} | 4 processes share one card (gloo through the host: "
        f"a check of the path, not a scaling number); rank 0 by CUDA events, median of "
        f"{DIST_TIMING}: forward {t['fwd_ms']:.3f} ms, gradient step {t['grad_ms']:.3f} "
        f"ms; per exchange (host) staging copies {t['stage_ms_per_exchange']:.3f} ms, "
        f"gloo transfer {t['wire_ms_per_exchange']:.3f} ms; staged "
        f"{t['staged_bytes_per_layer']:.0f} B per layer; spawn + all of (a), (b) "
        f"{wall:.1f} s")

    # (b) against one rank's first step on the same batch
    train = [p["train"] for p in procs]
    sem = box_mesh(CONS_ELEMS, p=ORDER)
    tcfg = TrainConfig(n_steps=1, batch=cons.TRAIN_BATCH, lr=1e-3, seed=cons.SEED,
                       plan=NMPPlan(halo=HaloSpec(mode="neighbor", packed=True),
                                    backend=FUSED))
    one = train_consistent_gnn(partition_mesh(sem, (1, 1, 1)), sem, cfg, tcfg,
                               device="cuda")["losses"][0]
    rel = abs(train[0]["losses"][0] - one) / abs(one)
    same = all(r["losses"] == train[0]["losses"] for r in train)
    sums_equal = len(set(train[0]["checksums"])) == 1
    step_ms = [1e3 * s for s in train[0]["step_s"][1:]]
    good = rel <= LOSS_REL and same and sums_equal and np.all(np.isfinite(train[0]["losses"]))
    say("3c distributed", f"{smi} | training (2, 1, 1) x 2 replicas, batch 2, large "
        f"config, fused, packed neighbor, {DIST_TRAIN_STEPS} steps: losses "
        f"{[round(v, 6) for v in train[0]['losses']]} on every process: {same}; step 0 vs "
        f"R=1 {one:.8g} (rel {rel:.2e}, band {LOSS_REL}); parameter checksums "
        f"gathered to rank 0 equal: {sums_equal}; ms per step after step 0 (rank 0, "
        f"host) {[round(v, 1) for v in step_ms]} -> {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("distributed training disagrees across processes or with R=1")
    torch.cuda.empty_cache()
    return sums["fwd_launches"], sums["grad_launches"]


def _leaves(tree):
    from repro_torch.nn import tree_leaves
    return tree_leaves(tree)


def phase_serve(cfg, sem, pg, smi):
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core.gnn import init_gnn
    from repro_torch.core.graph_state import FUSED, NMPPlan
    from repro_torch.core.mesh_gen import taylor_green_velocity
    from repro_torch.kernels import build
    from repro_torch.runtime.engine import EngineConfig, InferenceEngine
    from repro_torch.train.loop import TrainConfig, run_fingerprint

    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    fp = run_fingerprint(sem, pg, cfg, TrainConfig(), NMPPlan(backend=FUSED))
    ckpt.save(ckdir, 0, {"params": params}, extra={"fingerprint": fp})

    engine = InferenceEngine(
        ckdir, cfg, EngineConfig(batch_slots=BATCH_SLOTS, rollout_steps=ROLLOUT_K),
        plan=NMPPlan(backend=FUSED), device="cuda")
    mesh_hash = engine.register_mesh(sem)
    build_s = engine.entry(mesh_hash).build_s
    engine.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def snapshot(step):
        return taylor_green_velocity(sem.coords, t=(step * DT) % 2.0).astype(np.float32)

    with engine:
        build.reset_launch_counts()
        t0 = time.perf_counter()
        results = dict(engine.stream(mesh_hash, snapshot, N_REQUESTS, n_producers=2))
        wall = time.perf_counter() - t0
        launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    if len(results) != N_REQUESTS:
        raise RuntimeError(f"served {len(results)} of {N_REQUESTS} requests")
    for step, res in results.items():
        if res.preds.shape != (ROLLOUT_K, sem.n_nodes, cfg.node_out) \
                or not np.isfinite(res.preds).all():
            raise RuntimeError(f"request {step}: bad prediction {res.preds.shape}")
        if not np.array_equal(res.preds, engine.offline_reference(mesh_hash,
                                                                  snapshot(step))):
            raise RuntimeError(f"request {step}: streamed != offline reference")
    lat = np.array([r.latency_s for r in results.values()]) * 1e3
    st = engine.stats
    say("4 serve", f"large config on {SERVE_ELEMS} p={ORDER} ({sem.n_nodes} nodes): "
        f"{N_REQUESTS} requests, K={ROLLOUT_K}, {BATCH_SLOTS} slots, "
        f"{st['batches']} batches: streamed == offline bitwise for all | "
        f"launches on the stream: {launches}")
    say("4 serve", f"latency p50 {np.percentile(lat, 50):.1f} ms, p95 "
        f"{np.percentile(lat, 95):.1f} ms, {N_REQUESTS / wall:.2f} req/s | peak "
        f"device memory {peak / 2**30:.2f} GiB | host graph build {build_s:.1f} s | "
        f"{smi}")
    shutil.rmtree(ckdir, ignore_errors=True)
    return engine, mesh_hash, launches


def phase_profile(engine, mesh_hash, sem):
    import torch
    from repro_torch import nn
    from repro_torch.core.consistent_mp import nmp_layer
    from repro_torch.core.gnn import build_edge_inputs, gnn_forward
    from repro_torch.core.graph_state import XLA
    from repro_torch.core.mesh_gen import taylor_green_velocity
    from repro_torch.core.partition import gather_node_features, scatter_node_outputs

    entry = engine.entry(mesh_hash)
    pg, plan, g, params = entry.pg, entry.plan, entry.gs.rank(0), engine.params
    x_glob = taylor_green_velocity(sem.coords).astype(np.float32)
    x = torch.from_numpy(gather_node_features(pg, x_glob)[0]).to("cuda")

    def stage_ms(fn, iters=5):
        return cuda_ms(fn, iters, warmup=1)

    with torch.no_grad():
        mask, emask = g["node_mask"][:, None], g["edge_mask"][:, None]
        h = nn.mlp(params["node_enc"], x) * mask
        e = nn.mlp(params["edge_enc"], build_edge_inputs(x, g)) * emask
        t_enc = stage_ms(lambda: (nn.mlp(params["node_enc"], x) * mask,
                                  nn.mlp(params["edge_enc"], build_edge_inputs(x, g))
                                  * emask))
        layer_ms = []
        for lp in params["mp"]:
            layer_ms.append(stage_ms(lambda: nmp_layer(lp, h, e, g, plan)))
            h, e = nmp_layer(lp, h, e, g, plan)
        t_dec = stage_ms(lambda: nn.mlp(params["node_dec"], h) * mask)
        t_fwd = stage_ms(lambda: gnn_forward(params, x, g, plan))
        xla = dataclasses.replace(plan, backend=XLA)
        t_xla = stage_ms(lambda: gnn_forward(params, x, g, xla))
        say("5 profile", f"one served forward ({plan.backend} backend), CUDA events: "
            f"edge inputs + encoders {t_enc:.3f} ms | NMP layers "
            f"{', '.join(f'{t:.3f}' for t in layer_ms)} ms | decoder {t_dec:.3f} ms"
            f" | whole forward {t_fwd:.3f} ms ({XLA} backend {t_xla:.3f} ms)")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            gnn_forward(params, x, g, plan)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(prof)
    dev_ms = sum(t for t, _ in kern)
    say("5 profile", f"under torch.profiler: wall {wall:.3f} ms, device kernel time "
        f"{dev_ms:.3f} ms, busy share {dev_ms / wall:.3f}; top kernels: "
        + "; ".join(f"{t:.3f} ms {k[:60]}" for t, k in kern[:6]))

    t0 = time.perf_counter()
    xs = gather_node_features(pg, x_glob)
    t1 = time.perf_counter()
    xd = torch.from_numpy(xs).to("cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    y = xd.cpu().numpy()
    t3 = time.perf_counter()
    scatter_node_outputs(pg, y)
    t4 = time.perf_counter()
    say("5 profile", f"engine host work per request and rollout step: gather "
        f"{1e3 * (t1 - t0):.3f} ms, H2D {1e3 * (t2 - t1):.3f} ms, D2H "
        f"{1e3 * (t3 - t2):.3f} ms, scatter {1e3 * (t4 - t3):.3f} ms")


def phase_train(cfg, sem, pg, smi):
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core.distributed import make_gnn_step_fns
    from repro_torch.core.gnn import init_gnn
    from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh
    from repro_torch.kernels import build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.nn import tree_leaves
    from repro_torch.train.loop import (
        TrainConfig, make_tgv_batch_fn, train_consistent_gnn)
    from repro_torch.train.optimizer import (
        AdamWConfig, adamw_update_, constant_lr, init_adamw)

    start = init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")

    def train(n_steps, backend=FUSED, mesh=(sem, pg), **kw):
        tcfg = TrainConfig(n_steps=n_steps, batch=1, lr=TRAIN_LR, halo_mode="none",
                           plan=NMPPlan(backend=backend), **kw)
        return train_consistent_gnn(mesh[1], mesh[0], cfg, tcfg, params=start,
                                    device="cuda")

    # --- the main path: 10 steps through the training loop ---
    ckdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    hist = train(TRAIN_STEPS, ckpt_dir=str(ckdir), ckpt_every=5)
    launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    losses = hist["losses"]
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"training losses not finite: {losses}")
    if ckpt.committed_steps(ckdir) != [0, 5, TRAIN_STEPS - 1]:
        raise RuntimeError(f"checkpoints: {ckpt.committed_steps(ckdir)}")
    step_ms = [1e3 * t for t in hist["step_s"]]
    say("6 train", f"large config on {SERVE_ELEMS} p={ORDER} ({sem.n_nodes} nodes), "
        f"fused, K=1, batch 1, lr {TRAIN_LR}: losses "
        + ", ".join(f"{v:.6g}" for v in losses)
        + f" | launches on the {TRAIN_STEPS} steps: {launches} (expected nmp_fwd = "
        f"nmp_bwd = {TRAIN_STEPS * cfg.n_mp_layers})")
    say("6 train", f"step time median after step 0 {np.median(step_ms[1:]):.1f} ms "
        f"(min {min(step_ms[1:]):.1f}, max {max(step_ms[1:]):.1f}, step 0 "
        f"{step_ms[0]:.1f}) | host batch build median "
        f"{1e3 * np.median(hist['batch_s'][1:]):.1f} ms | peak device memory "
        f"{peak / 2**30:.2f} GiB | checkpoints {ckpt.committed_steps(ckdir)} | {smi}")

    # --- where one step's time goes, on the trained params ---
    plan = NMPPlan(backend=FUSED)
    g = ShardedGraph.build(pg, sem.coords, plan, device="cuda")
    _, loss_step, grad_step, _ = make_gnn_step_fns(cfg, plan)
    xb = torch.from_numpy(make_tgv_batch_fn(pg, sem, 1)(1)).to("cuda")
    params = hist["params"]
    opt_cfg = AdamWConfig(schedule=constant_lr(TRAIN_LR), weight_decay=0.0)
    opt = init_adamw(params, opt_cfg)
    del hist

    def step():
        loss, grads = grad_step(params, xb, xb, g)
        adamw_update_(grads, opt, params, opt_cfg)
        return loss

    def grads_only():
        return grad_step(params, xb, xb, g)

    t_fwd = cuda_ms(lambda: loss_step(params, xb, xb, g), 3, warmup=1)
    t_grad = cuda_ms(grads_only, 3, warmup=1)
    t_step = cuda_ms(step, 3, warmup=1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(prof)
    dev_ms = sum(t for t, _ in kern)
    say("6 train", f"one step, CUDA events: forward + loss {t_fwd:.3f} ms | forward + "
        f"backward {t_grad:.3f} ms | whole step incl. AdamW {t_step:.3f} ms")
    say("6 train", f"one step under torch.profiler: wall {wall:.3f} ms, device "
        f"kernel time {dev_ms:.3f} ms, busy share {dev_ms / wall:.3f}; top kernels: "
        + "; ".join(f"{t:.3f} ms {k[:60]}" for t, k in kern[:8]))
    del params, opt, g, xb
    torch.cuda.empty_cache()

    # --- 3 steps twice: bitwise; 3 steps of the plain backend ---
    a, b = train(3), train(3)
    same = a["losses"] == b["losses"] and all(
        torch.equal(u, v) for u, v in zip(tree_leaves(a["params"]),
                                          tree_leaves(b["params"])))
    del b
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = train(3, backend=XLA)
    xla_peak = torch.cuda.max_memory_allocated()
    rels = [abs(u - v) / abs(v) for u, v in zip(a["losses"], c["losses"])]
    say("6 train", f"3 steps twice from the same params: losses and params bitwise "
        f"equal: {same} | plain ({XLA}) backend losses "
        + ", ".join(f"{v!r}" for v in c["losses"]) + " vs fused "
        + ", ".join(f"{v!r}" for v in a["losses"])
        + f": max rel {max(rels):.2e} (band 1e-4); plain step "
        f"{1e3 * np.median(c['step_s'][1:]):.1f} ms, peak {xla_peak / 2**30:.2f} GiB")
    if not same or max(rels) > 1e-4:
        raise RuntimeError("training is not bitwise repeatable or fused != plain")
    del a, c
    torch.cuda.empty_cache()

    # --- K=2 rollout training on the consistency mesh ---
    csem = box_mesh(CONS_ELEMS, p=ORDER)
    cpg = partition_mesh(csem, (1, 1, 1))
    build.reset_launch_counts()
    r = train(2, mesh=(csem, cpg), rollout_steps=2, pushforward_noise=0.01)
    roll_launches = dict(build.launch_counts)
    if not np.all(np.isfinite(r["losses"])) or r["rollout_k"] != [2, 2]:
        raise RuntimeError(f"rollout training: {r['losses']} K {r['rollout_k']}")
    say("6 train", f"K=2 rollout training on {CONS_ELEMS} p={ORDER} ({csem.n_nodes} "
        f"nodes), 2 steps: losses " + ", ".join(f"{v:.6g}" for v in r["losses"])
        + f" | launches {roll_launches} (expected nmp_fwd = nmp_bwd = "
        f"{2 * 2 * cfg.n_mp_layers})")

    # --- launch/serve.py --bootstrap-steps: train a checkpoint, serve from it ---
    boot = ROOT / "build" / "chip_smoke_boot"
    shutil.rmtree(boot, ignore_errors=True)
    serve_cli.main(["--ckpt-dir", str(boot), "--bootstrap-steps", "2",
                    "--requests", "2", "--batch-slots", "2", "--device", "cuda"])
    if ckpt.committed_steps(boot) != [0, 1]:
        raise RuntimeError(f"bootstrap checkpoints: {ckpt.committed_steps(boot)}")
    say("6 train", "launch/serve.py --bootstrap-steps 2: trained a fingerprinted "
        "checkpoint (steps [0, 1]) and served 2 requests from it")
    shutil.rmtree(boot, ignore_errors=True)
    shutil.rmtree(ckdir, ignore_errors=True)
    return launches, roll_launches


def checksum(t):
    """Position-weighted sum of a tensor's 32-bit words, on the device."""
    import torch
    words = t.detach().reshape(-1).view(torch.int32)
    total, step = 0, 1 << 26
    for lo in range(0, words.numel(), step):
        w = words[lo:lo + step].to(torch.int64)
        pos = torch.arange(lo, lo + w.numel(), device=w.device) % 65521 + 1
        total += int((w * pos).sum())     # int64 wraps the same way every run
    return total


def profile_line(fn):
    """(wall ms, device kernel ms, busy share, top kernels) of one call."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(prof)
    dev_ms = sum(t for t, _ in kern)
    return (f"under torch.profiler: wall {wall:.3f} ms, device kernel time "
            f"{dev_ms:.3f} ms, busy share {dev_ms / wall:.3f}; top kernels: "
            + "; ".join(f"{t:.3f} ms {k[:60]}" for t, k in kern[:6]))


def phase_dlrm(smi):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.graph.datasets import criteo_like
    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.models.dlrm import _mlp_stack, dlrm_forward, dlrm_interact
    from repro_torch.nn import tree_leaves, tree_map, tree_unflatten
    from repro_torch.train.optimizer import AdamWConfig, adamw_update_

    rm2, family = get_arch("dlrm-rm2")
    cfg = rm2.config()
    F_, H, D = cfg.n_sparse, cfg.multi_hot, cfg.embed_dim
    dev = torch.device("cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if any(tf32):
        raise RuntimeError(f"TF32 must be off (matmul, cuDNN): {tf32}")
    say("7 dlrm", f"{rm2.ARCH_ID} ({family}): table {sum(cfg.vocab_sizes)} x {D} fp32, "
        f"bot {cfg.n_dense}-{'-'.join(map(str, cfg.bot_mlp))}, top "
        f"{cfg.n_interactions + cfg.bot_mlp[-1]}-{'-'.join(map(str, cfg.top_mlp))}, "
        f"{F_} fields x {H}; weights from torch.Generator(cuda).manual_seed({DLRM_SEED}); "
        f"TF32 off (matmul {tf32[0]}, cuDNN {tf32[1]}) | {smi}")
    by_path = {}

    def plain_vs_kernel(params, dense, sparse):
        with torch.no_grad():
            got = dlrm_forward(params, dense, sparse, cfg)
            B = dense.shape[0]
            emb = eb.embedding_bag_plain(params["tables"], sparse.reshape(B * F_, H))
            same = torch.equal(got, dlrm_interact(params, dense, emb.reshape(B, F_, D), cfg))
        if not same:
            raise RuntimeError("DLRM forward: plain lookup != kernel lookup")
        return "forward through the plain lookup == kernel lookup bitwise"

    def expect_launches(path, n):
        launches = dict(build.launch_counts)
        by_path[path] = launches
        if launches.get(eb.KERNEL, 0) != n:
            raise RuntimeError(f"{path}: embedding_bag launched "
                               f"{launches.get(eb.KERNEL, 0)} times, expected {n}")
        return launches

    # --- serve_p99: batches of 512 from the host ---
    step, (params, dense, sparse), meta = rm2.build_cell("serve_p99", dev, DLRM_SEED)
    B = meta["batch"]
    host = [torch.from_numpy(a) for a in criteo_like(B * P99_BATCHES, cfg, DLRM_SEED + 1)[:2]]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for i in range(5):
        step(params, host[0][:B].to(dev), host[1][:B].to(dev))
    torch.cuda.synchronize()
    wall, h2d, fwd = [], [], []
    build.reset_launch_counts()
    for i in range(P99_BATCHES):
        t0 = time.perf_counter()
        ev[0].record()
        d, s = (h[i * B:(i + 1) * B].to(dev) for h in host)
        ev[1].record()
        out = step(params, d, s)
        ev[2].record()
        ev[2].synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        h2d.append(ev[0].elapsed_time(ev[1]))
        fwd.append(ev[1].elapsed_time(ev[2]))
        if i == 0 and (out.shape != (B, 1) or not bool(torch.isfinite(out).all())):
            raise RuntimeError(f"serve_p99: bad logits {tuple(out.shape)}")
    launches = expect_launches("dlrm_serve_p99", P99_BATCHES)
    pct = lambda a, q: float(np.percentile(a, q))  # noqa: E731
    say("7 dlrm", f"serve_p99: {P99_BATCHES} batches of {B}: latency per batch host "
        f"wall p50 {pct(wall, 50):.3f} ms p99 {pct(wall, 99):.3f} ms | forward by CUDA "
        f"events p50 {pct(fwd, 50):.3f} ms p99 {pct(fwd, 99):.3f} ms | H2D p50 "
        f"{pct(h2d, 50):.3f} ms p99 {pct(h2d, 99):.3f} ms | launches {launches} | {smi}")
    say("7 dlrm", f"serve_p99: {plain_vs_kernel(params, d, s)} | "
        + profile_line(lambda: step(params, d, s)))
    del step, params, dense, sparse, host, d, s, out
    torch.cuda.empty_cache()

    # --- serve_bulk: batches of 262,144 ---
    step, (params, dense, sparse), meta = rm2.build_cell("serve_bulk", dev, DLRM_SEED)
    B = meta["batch"]
    hosts = [[torch.from_numpy(a) for a in criteo_like(B, cfg, DLRM_SEED + k)[:2]]
             for k in (1, 2)]
    step(params, dense, sparse)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(BULK_BATCHES):
        out = step(params, *(h.to(dev) for h in hosts[i % 2]))
    ev[1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = expect_launches("dlrm_serve_bulk", BULK_BATCHES)
    if out.shape != (B, 1) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"serve_bulk: bad logits {tuple(out.shape)}")
    fwd_ms = cuda_ms(lambda: step(params, dense, sparse), 5, warmup=1)
    say("7 dlrm", f"serve_bulk: {BULK_BATCHES} batches of {B} with H2D: "
        f"{BULK_BATCHES * B / wall_s:.0f} samples/s by host clock "
        f"({ev[0].elapsed_time(ev[1]) / BULK_BATCHES:.3f} ms per batch by CUDA events) "
        f"| device-resident batch {fwd_ms:.3f} ms = {B / fwd_ms * 1e3:.0f} samples/s "
        f"({meta['model_flops'] / fwd_ms / 1e9:.1f} TFLOP/s of MLP + interaction) | "
        f"launches {launches} | {smi}")
    say("7 dlrm", f"serve_bulk: {plain_vs_kernel(params, dense, sparse)} | "
        + profile_line(lambda: step(params, dense, sparse)))
    del step, params, dense, sparse, hosts, out
    torch.cuda.empty_cache()

    # --- retrieval_cand: one query against 1M candidates ---
    step, args, meta = rm2.build_cell("retrieval_cand", dev, DLRM_SEED)
    build.reset_launch_counts()
    vals, ids = step(*args)
    torch.cuda.synchronize()
    launches = expect_launches("dlrm_retrieval", 0)
    user = _mlp_stack(args[0]["bot"], args[1])
    scores = args[3] @ user[0]
    if vals.shape != (100,) or not bool(torch.isfinite(vals).all()) \
            or not torch.equal(scores[ids], vals) or bool((vals[:-1] < vals[1:]).any()) \
            or float(vals[-1]) < float(torch.kthvalue(scores.cpu(), scores.numel() - 99)[0]):
        raise RuntimeError("retrieval_cand: top-100 is not the top 100 of the scores")
    r_ms = cuda_ms(lambda: step(*args), 20)
    say("7 dlrm", f"retrieval_cand: {args[3].shape[0]} candidates -> top 100 (sorted, "
        f"== the top of a recomputed score vector) in {r_ms:.4f} ms by CUDA events | "
        f"launches {launches} (no lookup on this path) | "
        + profile_line(lambda: step(*args)))
    del step, args, vals, ids, scores, user
    torch.cuda.empty_cache()

    # --- train_batch: 5 steps, then where one step's time goes ---
    torch.cuda.reset_peak_memory_stats()
    step, args, meta = rm2.build_cell("train_batch", dev, DLRM_SEED)
    state, dense, sparse, labels = args
    B = meta["batch"]
    build.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(DLRM_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(*args)[1]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = expect_launches("dlrm_train", DLRM_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"train_batch losses not finite: {losses}")
    say("7 dlrm", f"train_batch: {DLRM_TRAIN_STEPS} steps of {B}, AdamW in place in "
        f"row chunks: losses " + ", ".join(f"{v:.6g}" for v in losses)
        + f" | step time median after step 0 {np.median(step_ms[1:]):.1f} ms (step 0 "
        f"{step_ms[0]:.1f}) | peak device memory {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.2f} GB) | launches {launches} | {smi}")
    params, opt_cfg = state["params"], AdamWConfig()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = rm2.bce_loss(p, dense, sparse, labels, cfg)
        ev[1].record()
        grads = torch.autograd.grad(loss, tree_leaves(p))
    ev[2].record()
    adamw_update_(tree_unflatten(p, grads), state["opt"], params, opt_cfg)
    ev[3].record()
    torch.cuda.synchronize()
    del p, loss, grads
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    say("7 dlrm", f"train_batch, one step by CUDA events: forward + loss {split[0]:.3f} ms "
        f"| backward {split[1]:.3f} ms | AdamW (norm, clip, chunked update) "
        f"{split[2]:.3f} ms")
    say("7 dlrm", f"train_batch: {plain_vs_kernel(params, dense, sparse)} | one step "
        + profile_line(lambda: step(*args)))
    del step, args, state, dense, sparse, labels, params
    torch.cuda.empty_cache()

    # --- a 3-step run repeated from the same seed: bitwise ---
    runs = []
    for _ in range(2):
        step, args, _ = rm2.build_cell("train_batch", dev, DLRM_SEED)
        run_losses = [float(step(*args)[1]) for _ in range(3)]
        leaves = tree_leaves(args[0]["params"])
        runs.append((run_losses, [checksum(t) for t in leaves]))
        del step, args, leaves
        torch.cuda.empty_cache()
    same = runs[0] == runs[1]
    say("7 dlrm", f"train_batch: 3 steps twice from seed {DLRM_SEED}: losses "
        + ", ".join(repr(v) for v in runs[0][0]) + " vs "
        + ", ".join(repr(v) for v in runs[1][0])
        + f"; every parameter's device checksum equal: {runs[0][1] == runs[1][1]}")
    if not same:
        raise RuntimeError("DLRM training is not bitwise repeatable")
    return by_path


def served_logits(params, tokens, cfg):
    """Logits of the serving path: tokens[:, :CHECK_PROMPT] prefilled
    through the cell's entry points, then CHECK_STEPS decode steps ->
    ([1, CHECK_STEPS + 1, V] fp32, launches of the prefill and decode)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models.transformer.steps import make_decode_step, make_prefill_step

    P = CHECK_PROMPT
    build.reset_launch_counts()
    last, cache = make_prefill_step(cfg, capacity=P + CHECK_STEPS)(params, tokens[:, :P])
    decode = make_decode_step(cfg)
    got = [last]
    for i in range(P, P + CHECK_STEPS):
        logits, cache = decode(params, cache, tokens[:, i:i + 1], i)
        got.append(logits[:, 0])
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    got = torch.stack(got, 1).float()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("LM check: served logits not finite")
    return got, launches


def forward_logits(params, tokens, cfg, plain):
    """Logits of one forward over all the tokens at the served positions
    [CHECK_PROMPT - 1, ...), [1, CHECK_STEPS + 1, V] fp32; through the
    plain attention in row chunks if ``plain``, else through the kernel."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_plain
    from repro_torch.models.transformer import model as lm
    kw = {}
    if plain:
        kw["attention"] = lambda q, k, v, scale: attention_plain(
            q, k, v, scale=scale, causal=True, chunk=512)
    with torch.no_grad():
        full = lm.forward(params, tokens, cfg, **kw)
    return full[:, CHECK_PROMPT - 1:].float()


def per_position_rel(got, want):
    return [float((got[:, j] - want[:, j]).norm() / want[:, j].norm())
            for j in range(got.shape[1])]


def band_reading(got, want):
    """(max abs error, its ratio to the rtol = atol = LM_BAND band)."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff / (LM_BAND + LM_BAND * want.abs())).max())


def upcast_(params):
    """Every leaf of a parameter tree to fp32 in place of the tree, largest
    leaves first so that one leaf at a time exists in both types."""
    import torch
    slots = []

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            else:
                slots.append((val.numel(), tree, key))
    walk(params)
    for _, tree, key in sorted(slots, key=lambda t: -t[0]):
        tree[key] = tree[key].float()
        torch.cuda.empty_cache()
    return params


def phase_lm(smi):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.transformer.steps import greedy_generate

    granite, family = get_arch("granite-34b")
    dev = torch.device("cuda")
    by_path = {}

    def expect_launches(path, n):
        launches = dict(build.launch_counts)
        by_path[path] = launches
        if launches.get(fa.KERNEL, 0) != n:
            raise RuntimeError(f"{path}: flash_attention launched "
                               f"{launches.get(fa.KERNEL, 0)} times, expected {n}")
        return launches

    # --- prefill_32k: all 88 layers, B=1 ---
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, (params, tokens), meta = granite.build_cell("prefill_32k", dev, LM_SEED)
    torch.cuda.synchronize()
    cfg = meta["cfg"]
    L = cfg.n_layers
    say("8 lm", f"{granite.ARCH_ID} ({family}): d {cfg.d_model}, {cfg.n_q} query heads "
        f"over {cfg.n_kv} KV head of dim {cfg.head_dim}, MLP {cfg.d_ff} (tanh GELU), vocab "
        f"{cfg.vocab}, tied; prefill_32k at {L} layers ({meta['n_params'] / 1e9:.3f} B "
        f"params, {cfg.param_dtype}), drawn on the card from seed {LM_SEED} in "
        f"{time.perf_counter() - t0:.1f} s | cut (reference, here): {meta['reduced']} | {smi}")
    B, S = meta["batch"], meta["seq"]
    build.reset_launch_counts()
    prefill_s = []
    for _ in range(PREFILL_RUNS):
        t0 = time.perf_counter()
        logits, cache = step(params, tokens)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        del cache
    launches = expect_launches("lm_prefill", PREFILL_RUNS * L)
    if logits.shape != (B, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill_32k: bad logits {tuple(logits.shape)}")
    peak = torch.cuda.max_memory_allocated()
    t = float(np.median(prefill_s))
    say("8 lm", f"prefill_32k: B={B} S={S}, {L} layers: "
        + ", ".join(f"{1e3 * x:.1f}" for x in prefill_s)
        + f" ms per prefill (median {1e3 * t:.1f} ms = {B * S / t:.0f} tokens/s, "
        f"{meta['model_flops'] / t / 1e12:.1f} TFLOP/s of dense model FLOPs) | peak device "
        f"memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) | launches {launches} "
        f"({L} per prefill) | {smi}")
    say("8 lm", "prefill_32k: one prefill " + profile_line(lambda: step(params, tokens)))

    # --- the serving loop at the same depth: prefill prompts, greedy decode ---
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (SERVE_PROMPTS, SERVE_PROMPT_LEN), generator=gen,
                            device=dev)
    greedy_generate(params, prompts[:, :64], cfg, 2)        # warm-up at a small size
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = greedy_generate(params, prompts, cfg, SERVE_GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = expect_launches("lm_serve", L)
    if out.shape != (SERVE_PROMPTS, SERVE_GEN) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab:
        raise RuntimeError(f"serving loop: bad tokens {tuple(out.shape)}")
    say("8 lm", f"serving loop, {L} layers: {SERVE_PROMPTS} prompts of {SERVE_PROMPT_LEN} "
        f"tokens -> {SERVE_GEN} greedy tokens each (capacity "
        f"{SERVE_PROMPT_LEN + SERVE_GEN}) in {wall:.3f} s ({SERVE_PROMPTS * SERVE_GEN / wall:.1f}"
        f" generated tokens/s with the prefill) | first tokens {out[0, :8].tolist()} | "
        f"launches {launches} (one prefill)")
    ck = torch.randint(0, cfg.vocab, (1, CHECK_PROMPT + CHECK_STEPS), generator=gen, device=dev)
    del step, params, tokens, logits, prompts, out
    torch.cuda.empty_cache()

    # --- decode_32k: 44 layers, B=32 over a cache filled to 32,767 ---
    torch.cuda.reset_peak_memory_stats()
    step, (params, cache, tokens, cache_len), meta = granite.build_cell("decode_32k", dev,
                                                                         LM_SEED)
    cfg = meta["cfg"]
    L = cfg.n_layers
    B = meta["batch"]
    step(params, cache, tokens, cache_len)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    for _ in range(DECODE_STEPS):
        logits, cache = step(params, cache, tokens, cache_len)
    ev[1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / DECODE_STEPS
    launches = expect_launches("lm_decode", 0)
    peak = torch.cuda.max_memory_allocated()
    if logits.shape != (B, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"decode_32k: bad logits {tuple(logits.shape)}")
    dev_ms = ev[0].elapsed_time(ev[1]) / DECODE_STEPS
    moved = sum(nbytes(x) for x in (params["embed"], *params["layers"]["attn"].values(),
                                    *params["layers"]["ffn"].values(), cache["k"], cache["v"]))
    b_ms, b_by = bound_ms(moved, meta["model_flops"], PEAK_BF16_FLOPS)
    say("8 lm", f"decode_32k: B={B}, {L} layers, cache_len {cache_len} of {meta['seq']}: "
        f"{dev_ms:.3f} ms per step by CUDA events, {1e3 * wall:.3f} ms by host clock "
        f"({B / wall:.1f} tokens/s) | bound {b_ms:.3f} ms ({b_by}: "
        f"{moved / 1e9:.2f} GB of weights and cache) | peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) | cut (reference, here): "
        f"{meta['reduced']} | launches {launches} | {smi}")
    say("8 lm", "decode_32k: one step " + profile_line(lambda: step(params, cache, tokens,
                                                                     cache_len)))
    del step, cache, tokens, logits
    torch.cuda.empty_cache()

    # --- the check at full width and 44 layers (decode_32k's weights):
    # prefill + decode against the full forward through the plain attention,
    # in bf16 (the served precision) and in fp32 on the same weights upcast
    # (bf16 values are exact in fp32), which is also the witness: each bf16
    # path's drift from the fp32 forward ---
    served_b, launches = served_logits(params, ck, cfg)
    by_path["lm_check_bf16"] = launches
    if launches.get(fa.KERNEL, 0) != L:
        raise RuntimeError(f"LM check: flash_attention launched {launches} times, expected {L}")
    plain_b = forward_logits(params, ck, cfg, plain=True)
    kernel_b = forward_logits(params, ck, cfg, plain=False)
    # the served path once more with torch's default for the bf16 GEMMs
    # (split-K partial sums reduced in bf16), as a fresh process serves
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        served_default, _ = served_logits(params, ck, cfg)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # the witness at shallower depths: the first n layers of the same weights
    bf16_by_depth = {}
    for n in WITNESS_DEPTHS:
        cfg_n = cfg.with_(n_layers=n)
        served_n, launches_n = served_logits(params, ck, cfg_n)
        if launches_n.get(fa.KERNEL, 0) != n:
            raise RuntimeError(f"LM check at {n} layers: flash_attention launched "
                               f"{launches_n} times, expected {n}")
        bf16_by_depth[n] = {"served": served_n,
                            "plain forward": forward_logits(params, ck, cfg_n, plain=True),
                            "kernel forward": forward_logits(params, ck, cfg_n, plain=False)}
    bf16_by_depth[L] = {"served": served_b, "plain forward": plain_b,
                        "kernel forward": kernel_b}
    cfg32 = cfg.with_(param_dtype=torch.float32, cache_dtype=torch.float32)
    params = upcast_(params)
    torch.cuda.empty_cache()
    want = forward_logits(params, ck, cfg32, plain=True)
    want_by_depth = {n: forward_logits(params, ck, cfg32.with_(n_layers=n), plain=True)
                     for n in WITNESS_DEPTHS}
    want_by_depth[L] = want
    served_32, launches = served_logits(params, ck, cfg32)
    by_path["lm_check_fp32"] = launches
    del params
    torch.cuda.empty_cache()
    err, viol = band_reading(served_b, plain_b)
    say("8 lm", f"check, bf16 (the served precision), {L} layers: prompt {CHECK_PROMPT} "
        f"prefilled + {CHECK_STEPS} decode steps vs the forward over "
        f"{CHECK_PROMPT + CHECK_STEPS} tokens through the plain attention: max|err| "
        f"{err:.4g} = {viol:.2f} x the {LM_BAND} band (reported); rel L2 per position "
        + ", ".join(f"{r:.2e}" for r in per_position_rel(served_b, plain_b))
        + f" | launches {by_path['lm_check_bf16']}")
    drift = {name: per_position_rel(got, want) for name, got in
             (("served", served_b), ("plain forward", plain_b),
              ("kernel forward", kernel_b))}
    ratio = max(a / b for a, b in zip(drift["served"], drift["plain forward"]))
    witness_ok = ratio <= DRIFT_FACTOR
    say("8 lm", "witness, rel L2 per position of each bf16 path against the fp32 forward "
        "(plain attention) on the same weights: " + "; ".join(
            f"{name} " + ", ".join(f"{r:.2e}" for r in rels) for name, rels in drift.items())
        + f" | served / plain forward at most {ratio:.3f} (limit {DRIFT_FACTOR}) -> "
        + ("ok" if witness_ok else "FAIL"))
    default = per_position_rel(served_default, want)
    say("8 lm", f"witness, the served bf16 path with torch's default "
        f"allow_bf16_reduced_precision_reduction = True, {L} layers, rel L2 per position "
        "against the fp32 forward: " + ", ".join(f"{r:.2e}" for r in default)
        + f" | max {max(default):.4g} beside {max(drift['served']):.4g} with the flag off, "
        f"{max(drift['plain forward']):.4g} for the plain forward; logits bitwise equal to "
        f"the flag-off run: {torch.equal(served_default, served_b)} (reported)")
    by_depth = []
    for n in sorted(bf16_by_depth):
        rels = {name: per_position_rel(got, want_by_depth[n])
                for name, got in bf16_by_depth[n].items()}
        worst = max(a / b for a, b in zip(rels["served"], rels["plain forward"]))
        by_depth.append(f"{n} layers: " + ", ".join(
            f"{name} {max(r):.4g}" for name, r in rels.items())
            + f" (served / plain forward at most {worst:.3f})")
    say("8 lm", "witness by depth, largest rel L2 per position of each bf16 path against "
        "the fp32 forward on the same first layers (reported; the limit holds at "
        f"{L}): " + "; ".join(by_depth))
    err, viol = band_reading(served_32, want)
    ok = viol <= 1.0 and launches.get(fa.KERNEL, 0) == L
    say("8 lm", f"check, fp32 (the same weights upcast, {cfg32.n_params() * 4 / 1e9:.1f} GB), "
        f"full width, {L} layers: max|err| {err:.4g} = {viol:.3f} x the band (rtol = atol = "
        f"{LM_BAND}) -> {'ok' if ok else 'FAIL'}; rel L2 per position "
        + ", ".join(f"{r:.2e}" for r in per_position_rel(served_32, want))
        + f" | launches {launches}")
    if not (ok and witness_ok):
        raise RuntimeError("Granite: prefill + decode disagree with the full forward, or "
                           "the served bf16 path drifts further than the plain one")
    return by_path


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core.gnn import GNNConfig
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.halo_pack import ops as hp
    from repro_torch.kernels.segment_agg import ops as sa

    start = time.perf_counter()

    def lap(phase):
        say(phase, f"done at {time.perf_counter() - start:.1f} s")

    cfg = GNNConfig.large()
    smi, ptxas = phase_device()
    lap("1 device")
    sem, pg, records = phase_kernels(ptxas, cfg)
    seg_record, seg_counts = phase_segment_agg(sem, ptxas)
    records.append(seg_record)
    records.append(phase_embedding_bag(ptxas))
    records.append(phase_flash_attention(ptxas))
    lap("2 kernels")
    by_path = {"segment_agg_op": seg_counts}
    by_path["consistency_r4_packed"], stacked = phase_consistency(cfg)
    by_path["grad_r4_packed"], r1 = phase_grad_consistency(cfg)
    lap("3b gradients")
    by_path["dist_r4_packed"], by_path["dist_r4_grad"] = phase_distributed(
        cfg, stacked, r1, smi)
    lap("3c distributed")
    engine, mesh_hash, by_path["serve"] = phase_serve(cfg, sem, pg, smi)
    phase_profile(engine, mesh_hash, sem)
    del engine
    lap("5 profile")
    by_path["train"], by_path["rollout_k2"] = phase_train(cfg, sem, pg, smi)
    torch.cuda.empty_cache()
    lap("6 train")
    by_path.update(phase_dlrm(smi))
    torch.cuda.empty_cache()
    lap("7 dlrm")
    by_path.update(phase_lm(smi))
    lap("8 lm")
    # each kernel's own path first, then every other path that must use it:
    # training for the fused NMP pair, the R=4 packed-neighbor gradient run
    # for the halo kernels (training and serving are R=1), serve_bulk for
    # the embedding bag, the prefill for flash attention (phases 7 and 8
    # check their exact counts on every path), the op's one call for the
    # dst-aligned edge MLP (phase 2 checks that it launched exactly once)
    own = {sa.KERNEL: ("train", "serve", "consistency_r4_packed", "grad_r4_packed",
                       "rollout_k2", "dist_r4_packed", "dist_r4_grad"),
           sa.KERNEL_BWD: ("train", "grad_r4_packed", "rollout_k2", "dist_r4_grad"),
           hp.PACK: ("grad_r4_packed", "consistency_r4_packed", "dist_r4_packed",
                     "dist_r4_grad"),
           hp.UNPACK: ("grad_r4_packed", "consistency_r4_packed", "dist_r4_packed",
                       "dist_r4_grad"),
           eb.KERNEL: ("dlrm_serve_bulk", "dlrm_serve_p99", "dlrm_train"),
           fa.KERNEL: ("lm_prefill", "lm_serve", "lm_check_bf16", "lm_check_fp32"),
           sa.KERNEL_MLP_AGG: ("segment_agg_op",)}
    for rec in records:
        counts = {path: int(by_path[path].get(rec["name"], 0)) for path in by_path}
        rec["launches"] = counts[own[rec["name"]][0]]
        rec["launches_by_path"] = counts
        for path in own[rec["name"]]:
            if counts[path] == 0:
                raise RuntimeError(f"kernel {rec['name']} never launched on the "
                                   f"{path} path")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
