#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written CUDA kernels from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version at the shapes the main paths
give it, checks the paper's 1-rank == R-rank consistency on the card for
values and gradients, serves the paper's large GNN (N_H=32, M=4, 5 MLP
hidden layers) on a p=7 spectral-element box mesh through the resident
inference engine, and trains it on that mesh through the training loop.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (one line each, prefixed ``[n name]``):
  1 device       nvidia-smi name / power limit, TF32 off, kernel build
  2 kernels      fused NMP forward and backward on the serving mesh's
                 edges, pack and unpack-add at the 2x2 partition's halo
                 round widths: error vs the plain version, repeatability,
                 CUDA-event times
  3 consistency  stacked forward, large config, fused backend: R=1 vs R=4
                 (2x2 grid) under the packed neighbor exchange and the A2A
                 oracle, and fused vs the plain backend at R=1
  3b gradients   stacked loss and parameter gradients, same mesh: R=1 vs
                 R=4 packed neighbor (fused), and fused vs plain at R=4
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
The script reads each main path's launch counters on its own: zeroed just
before the path and read right after it — the R=4 packed-neighbor forward
(phase 3), the R=4 packed-neighbor gradient run (3b), the serve stream
after warm-up (4), the 10 training steps (6) and the K=2 rollout run (6).
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
LOSS_REL = 2e-6                  # the reference's loss band
TRAIN_STEPS, TRAIN_LR = 10, 1e-3
# published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 on CUDA cores
# and HBM3 bandwidth
PEAK_FP32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12


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


def bound_ms(n_bytes, flops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
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
    from repro_torch.nn import tree_leaves
    err, by_norm, ok = 0.0, {}, True
    for name, a, b in zip(leaf_names(want), tree_leaves(got), tree_leaves(want)):
        e, within = within_band(a, b, G_RTOL, G_ATOL)
        err = max(err, e)
        if not within:
            by_norm[name] = rel_norm(a, b)
            ok = ok and by_norm[name] <= W_REL
    return err, by_norm, ok


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


def phase_device():
    import torch
    from repro_torch.kernels import build
    smi = smi_line()
    say("1 device", f"nvidia-smi: {smi} | torch.cuda: {torch.cuda.get_device_name(0)}"
        f" x{torch.cuda.device_count()} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reports = build.build(["nmp_fwd", "halo_pack", "nmp_bwd"])
    regs = {k: sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in v.splitlines() if "Used " in ln})
            for k, v in reports.items()}
    say("1 device", f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, sm_90a, in parallel); ptxas: {regs}")
    ptxas = {name: ptxas_summary(reports.get(name, ""), needle) for name, needle in
             (("nmp_fwd", "nmp_fwd_kernelILi32E"), ("nmp_bwd", "nmp_bwd_edge_kernelILi32E"))}
    say("1 device", f"ptxas at H=32: {ptxas}")
    return smi, ptxas


def phase_kernels(cfg, ptxas):
    import torch
    from repro_torch.core.gnn import init_gnn
    from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
    from repro_torch.core.halo import NEIGHBOR
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh
    from repro_torch.kernels.halo_pack import ops as hp
    from repro_torch.kernels.segment_agg import ops as sa

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

    # --- fused NMP forward at the serving mesh's shapes ---
    gen = torch.Generator().manual_seed(11)
    edge = init_gnn(gen, cfg, device=dev)["mp"][0]["edge"]
    H, Lp = cfg.hidden, cfg.mlp_hidden_layers
    x = torch.randn(pg.n_pad, H, generator=gen).to(dev)
    e = torch.randn(pg.e_pad, H, generator=gen).to(dev)
    args = (x, e, edge, g["seg_perm"], g["seg_src"], g["seg_rowptr"],
            g["edge_mask"], g["edge_inv_mult"])
    e_k, a_k = sa.fused_nmp_edge_agg(*args)
    e_p, a_p = sa.fused_nmp_edge_agg_plain(*args)
    torch.cuda.synchronize()
    err_e, ok_e = within_band(e_k, e_p)
    err_a, ok_a = within_band(a_k, a_p)
    ms = cuda_ms(lambda: sa.fused_nmp_edge_agg(*args), iters=20)
    plain = cuda_ms(lambda: sa.fused_nmp_edge_agg_plain(*args), iters=5, warmup=1)
    weights = [t for l in edge["layers"] for t in l.values()] + list(edge["ln"].values())
    moved = nbytes(x, e, g["seg_perm"], g["seg_src"], g["seg_rowptr"], g["edge_mask"],
                   g["edge_inv_mult"], *weights, e_k, a_k)
    # the dense layers' FMAs: per edge the x_src and e slices of layer 0 and
    # the Lp hidden layers; the x_dst slice once per node that has edges
    n_dst = int((g["seg_rowptr"].diff() > 0).sum())
    flops = n_real * 2 * (2 * H * H + Lp * H * H) + n_dst * 2 * H * H
    b_ms, b_by = bound_ms(moved, flops)
    say("2 kernels", f"nmp_fwd H={H} Lp={Lp} E={n_real} N={pg.n_pad}: max|err| "
        f"e_new {err_e:.3g} agg {err_a:.3g} (rtol {RTOL} atol {ATOL}) | kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    if not (ok_e and ok_a):
        raise RuntimeError("fused NMP kernel disagrees with its plain version")
    records.append(dict(name=sa.KERNEL, route="cuda",
                        source="src/repro_torch/csrc/nmp_fwd.cu",
                        replaces="src/repro/kernels/segment_agg/kernel.py:215",
                        max_abs_err=max(err_e, err_a), ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del e_k, a_k, e_p, a_p

    # --- fused NMP backward at the serving mesh's shapes ---
    g_enew = torch.randn(pg.e_pad, H, generator=gen).to(dev)
    g_agg = torch.randn(pg.n_pad, H, generator=gen).to(dev)
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
    del want
    ms = cuda_ms(bwd, iters=10, warmup=1)
    plain = cuda_ms(bwd_plain, iters=3, warmup=1)
    moved = nbytes(x, e, *lay, *src_lay, *rest, *weights, *got)
    # recompute, input gradients and weight gradients: 3x the forward's FMAs
    flops = 3 * (n_real * 2 * (2 * H * H + Lp * H * H) + n_dst * 2 * H * H)
    b_ms, b_by = bound_ms(moved, flops)
    say("2 kernels", f"nmp_bwd H={H} Lp={Lp} E={n_real} N={pg.n_pad}: max|err| "
        f"g_x {err_x:.3g} g_e {err_g:.3g} (rtol {G_RTOL} atol {G_ATOL}); weight "
        f"grads rel L2 " + ", ".join(f"{k} {v:.2e}" for k, v in wrel.items())
        + f" (<= {W_REL}: sums over {n_real} edges, so an elementwise atol says "
        f"nothing there) | two launches bitwise equal: {repeat} | kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}, "
        f"{flops / 1e9:.1f} GFLOP, {moved / 1e9:.2f} GB) | ptxas {ptxas['nmp_bwd']}")
    if not (ok_x and ok_g and all(v <= W_REL for v in wrel.values()) and repeat):
        raise RuntimeError("fused NMP backward kernel disagrees with its plain "
                           "version or is not repeatable")
    records.append(dict(name=sa.KERNEL_BWD, route="cuda",
                        source="src/repro_torch/csrc/nmp_bwd.cu",
                        replaces="src/repro/kernels/segment_agg/kernel.py:357",
                        max_abs_err=max(err_x, err_g), ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del got, x, e, g, g_enew, g_agg, rest
    torch.cuda.empty_cache()

    # --- pack / unpack-add at the 2x2 partition's round widths ---
    csem = box_mesh(CONS_ELEMS, p=ORDER)
    cpg = partition_mesh(csem, CONS_GRID)
    plan = NMPPlan.build(cpg, NEIGHBOR, packed=True)
    cg = ShardedGraph.build(cpg, csem.coords, plan, device=dev)
    widths = [int(cg[f"pk{k}_send_idx"].shape[1]) for k in range(len(plan.halo.perms))]
    F = cfg.hidden
    src = torch.randn(cpg.n_pad, F, generator=gen).to(dev)
    seed = torch.randn(cpg.n_pad, F, generator=gen).to(dev)
    pack_err = unpack_err = 0.0
    for k in range(len(widths)):
        for r in range(cpg.R):
            idx, mask = cg[f"pk{k}_send_idx"][r], cg[f"pk{k}_send_mask"][r]
            got, want = hp.halo_pack(src, idx, mask), hp.halo_pack_plain(src, idx, mask)
            if not torch.equal(got, want):
                raise RuntimeError(f"pack kernel != plain (round {k}, rank {r})")
            pack_err = max(pack_err, float((got - want).abs().max()))
            ridx, rmask = cg[f"pk{k}_recv_idx"][r], cg[f"pk{k}_recv_mask"][r]
            got = hp.halo_unpack_add(seed, want, ridx, rmask)
            ref = hp.halo_unpack_add_plain(seed, want, ridx, rmask)
            if not torch.equal(got, ref):
                raise RuntimeError(f"unpack kernel != plain (round {k}, rank {r})")
            unpack_err = max(unpack_err, float((got - ref).abs().max()))
    kw = int(np.argmax(widths))
    idx, mask = cg[f"pk{kw}_send_idx"][0], cg[f"pk{kw}_send_mask"][0]
    ridx, rmask = cg[f"pk{kw}_recv_idx"][0], cg[f"pk{kw}_recv_mask"][0]
    buf = hp.halo_pack_plain(src, idx, mask)
    W = widths[kw]
    timings = {
        hp.PACK: (cuda_ms(lambda: hp.halo_pack(src, idx, mask), 200),
                  cuda_ms(lambda: hp.halo_pack_plain(src, idx, mask), 200), None),
        hp.UNPACK: (cuda_ms(lambda: hp.halo_unpack_add(seed, buf, ridx, rmask), 200),
                    cuda_ms(lambda: hp.halo_unpack_add_plain(seed, buf, ridx, rmask), 200),
                    # one library call on the pre-masked buffer
                    cuda_ms(lambda: torch.index_add(seed, 0, ridx, buf), 200)),
    }
    moved = {hp.PACK: nbytes(idx, mask, buf, buf),   # rows gathered + buffer written
             hp.UNPACK: nbytes(seed, seed, buf, ridx, rmask)}
    for name, err in ((hp.PACK, pack_err), (hp.UNPACK, unpack_err)):
        ms, plain, lib = timings[name]
        b_ms, b_by = bound_ms(moved[name], 0)
        say("2 kernels", f"{name} widths {widths} (timed W={W}, F={F}, "
            f"N={cpg.n_pad}): bitwise equal to plain over all rounds and ranks | "
            f"kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us"
            + (f", torch.index_add {lib * 1e3:.2f} us" if lib is not None else "")
            + f", bound {b_ms * 1e3:.3f} us ({b_by})")
        records.append(dict(name=name, route="cuda",
                            source="src/repro_torch/csrc/halo_pack.cu",
                            replaces=("src/repro/kernels/halo_pack/kernel.py:44"
                                      if name == hp.PACK else
                                      "src/repro/kernels/halo_pack/kernel.py:91"),
                            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib))
    return sem, pg, records


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

    def run(grid, mode, backend, packed=False, sync_fn=None):
        pg = partition_mesh(sem, grid)
        plan = NMPPlan.build(pg, mode, packed=packed, backend=backend)
        g = ShardedGraph.build(pg, sem.coords, plan, device=dev)
        xs = torch.from_numpy(gather_node_features(pg, x)).to(dev)
        y = gnn_forward_stacked(params, xs, g, plan, sync_fn=sync_fn)
        return torch.from_numpy(scatter_node_outputs(pg, y.cpu().numpy()))

    y1 = run((1, 1, 1), NONE, FUSED)
    build.reset_launch_counts()
    y4 = run(CONS_GRID, NEIGHBOR, FUSED, packed=True, sync_fn=halo_sync_stacked)
    launches = dict(build.launch_counts)
    say("3 consistency", f"launches on the R=4 packed neighbor forward: {launches}")
    cases = {
        "R=4 packed neighbor (pack/unpack kernels)": y4,
        "R=4 a2a oracle": run(CONS_GRID, A2A, FUSED),
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
    return launches


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
    say("3b gradients", f"launches on the R=4 packed neighbor gradient run: {launches} "
        "(expected nmp_fwd = nmp_bwd = 16, pack = unpack-add = 48 + 48 = 96)")
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
    return launches


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
        AdamWConfig, adamw_update, constant_lr, init_adamw)

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
        adamw_update(grads, opt, params, opt_cfg)
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core.gnn import GNNConfig
    from repro_torch.kernels.halo_pack import ops as hp
    from repro_torch.kernels.segment_agg import ops as sa

    cfg = GNNConfig.large()
    smi, ptxas = phase_device()
    sem, pg, records = phase_kernels(cfg, ptxas)
    by_path = {"consistency_r4_packed": phase_consistency(cfg),
               "grad_r4_packed": phase_grad_consistency(cfg)}
    engine, mesh_hash, by_path["serve"] = phase_serve(cfg, sem, pg, smi)
    phase_profile(engine, mesh_hash, sem)
    del engine
    by_path["train"], by_path["rollout_k2"] = phase_train(cfg, sem, pg, smi)
    # each kernel's own path first, then every other path that must use it:
    # training for the fused NMP pair, the R=4 packed-neighbor gradient run
    # for the halo kernels (training and serving are R=1)
    own = {sa.KERNEL: ("train", "serve", "consistency_r4_packed", "grad_r4_packed",
                       "rollout_k2"),
           sa.KERNEL_BWD: ("train", "grad_r4_packed", "rollout_k2"),
           hp.PACK: ("grad_r4_packed", "consistency_r4_packed"),
           hp.UNPACK: ("grad_r4_packed", "consistency_r4_packed")}
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
