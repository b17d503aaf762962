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
loop, serves GraphCast's weather configuration at its published widths
(d512, 16 layers) through kernel 1's generic-width entry, trains GraphCast
through the reference's cell functions on one rank and over a (graph x
model) mesh of processes with edge-parallel sharding, trains GAT, NequIP
and MACE at their published widths in the reference's cells on one rank,
over 4 processes and on a sampled minibatch block, and runs the paper's
smoke config (N_H=4) through the ``paper-gnn`` registry entry.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (one line each, prefixed ``[n name]``):
  1 device       nvidia-smi name / power limit, TF32 off, kernel build
  2 kernels      fused NMP forward and backward on the serving mesh's
                 edges (each also held to a float64 forward or VJP, with
                 its launch plan and ptxas registers), the same in bf16
                 (precision="bf16", csrc/nmp_bf16.cu, in the same run as
                 the fp32 pair: against the plain bf16 version by
                 relative L2, by its ratio to the distance from the fp32
                 kernel's output, max |err| and, for the gradients, the
                 reference's per-leaf bf16 band; times, bound and the
                 fraction of it reached, launch plan with the ring's
                 stages, ptxas registers and spills, one call's kernels
                 under torch.profiler), pack and unpack-add on
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
                 against plain (time and bound), one launch-counted
                 call of fused_edge_mlp_agg (phase_segment_agg runs alone),
                 and its time at each (block_n, block_e) of BLOCK_PAIRS
                 beside pick_block_sizes' CUDA row; kernels 1 and 2's
                 generic-width entries (csrc/nmp_any.cu) at H 4, 12, 64,
                 100 (a (4, 4, 4) box, p=7), 512 and 1024 (a (2, 2, 2)
                 box) x 1, 2, 7 hidden layers against plain and a float64
                 forward / VJP (times, launch plan with its route, ptxas),
                 each on ops.any_route's route (held to its bands) and on
                 the other route where H % 4 == 0 (timed and checked, a
                 miss only reported: the crossover), and the dispatch:
                 H=32 launches only the tuned pair, H=4 only the generic
                 one (phase_kernels_any)
  3 consistency  stacked forward, large config, fused backend: R=1 vs R=4
                 (2x2 grid) under the packed neighbor exchange (blocking and
                 overlap schedules) and the A2A oracle, overlap vs blocking
                 (bitwise reported), and fused vs the plain backend at R=1;
                 each R=4 packed forward's launches checked exactly; the
                 same R=1 vs R=4 packed forward in bf16 (both schedules),
                 held to the bf16 bands, launches exact (bf16 kernel only)
  3b gradients   stacked loss and parameter gradients, same mesh: R=1 vs
                 R=4 packed neighbor (fused, both schedules), and fused vs
                 plain at R=4; each R=4 gradient run's launches checked
                 exactly; in bf16 (both schedules) the loss within 2e-6 and
                 every gradient within 1e-2 of its leaf's largest magnitude
                 of R=1's, launches exact
  3c distributed 4 gloo processes sharing the card
                 (``repro_torch.launch.consistency``): the 2x2 split through
                 the real torch.distributed exchange (packed neighbor, a2a,
                 none) under the blocking and the overlap schedule, each
                 rank's prediction bitwise equal to its slice of phase 3's
                 stacked forward of the same schedule, loss and gradients
                 within the bands of 3b's R=1, every process's launches and
                 exchanges (posted forward, blocking gradient) checked
                 exactly, rank 0's CUDA-event times and host ms per
                 exchange (stream sync, staging copies, gloo calls, wait)
                 under each schedule; then 3 training steps at (2,1,1) x 2
                 replicas, batch 2, step 0 against an R=1 run and the
                 parameters bitwise equal everywhere
  3d plan        the exchange's remaining forms and the plan's choice, on
                 the consistency mesh (not the serving mesh: spectral
                 bisection is seconds of host power iteration per level):
                 the spectral split's partition_quality beside the block
                 split's; its stacked R=4 forward and gradient (large
                 config, fused, packed neighbor) against R=1 in the bands
                 of phases 3 and 3b; kernels 1 and 2 against plain on its
                 rank 0 (vertex-cut) layout; the bf16 wire on the packed
                 forward within 2e-2 of the fp32 wire; rounds2d on a (2, 2)
                 grid, packed against R=1 and bitwise the dense form; then
                 4 gloo processes sharing the card: the spectral packed
                 forward under both wires bitwise each rank's stacked
                 slice, bytes staged exactly half under bf16, every
                 exchange form (a2a, neighbor, packed, rounds2d, packed
                 rounds2d x fp32 / bf16 wire x sum / max) bitwise the
                 stacked emulator with no pack under max, the tuner's 12
                 (schedule x halo mode x wire) candidates at hidden 32 in
                 ms, its pick the argmin and the same on every process, a
                 second call launching nothing; and 3 training steps of
                 ``launch/train.py --mp-schedule auto --partitioner
                 spectral --ranks 2 2 1 --model large``, step 0 against
                 an R=1 run
  4 serve        fingerprinted checkpoint of seeded random large params,
                 InferenceEngine(batch_slots=4, rollout_steps=2), >=16
                 streamed Taylor-Green requests, each bitwise equal to the
                 engine's offline batch-1 reference; then a second engine
                 on a bf16 plan: 8 streamed requests, each bitwise equal to
                 its offline reference, launches exactly batches x slots x
                 K x M of the bf16 kernel and none of the fp32 one
  4b serve R=4   the same checkpoint and mesh served by the engine over 4
                 gloo processes sharing the card (``launch/serve.py``),
                 split (2,2,1), packed neighbor, under the overlap and the
                 blocking schedule: 16 requests from 2 producers, each
                 bitwise equal to the offline reference, two against phase
                 4's R=1 (the first rollout step within the reference
                 serving check's band 3e-4 / 1e-5, the second within twice the
                 R=1 plain backend's drift from it), one
                 request's rows of every rank bitwise equal to the stacked
                 overlap rollout, a mismatched mesh refused by name, a dying
                 producer ending every process, launches per process exact;
                 latency, req/s, build time, peak memory per process and
                 rank 0's host ms per exchange (four processes share the
                 card: a check of the path, not a scaling number); then
                 ``launch/serve.py --ranks 2`` on a small mesh
  5 profile      where one served forward's time goes, on the engine's own
                 graph and params: CUDA-event times per stage, device busy
                 share and the top kernels under torch.profiler, and the
                 engine's host work per request and rollout step
  6 train        train_consistent_gnn on the serving mesh, large config,
                 fused backend, K=1, batch 1: 10 steps (losses, step time,
                 peak memory, host batch time, checkpoints), one step's
                 breakdown, a 3-step run repeated bitwise, 3 steps of the
                 plain backend, 3 steps on the bf16 plan (``--mp-precision
                 bf16``) repeated bitwise with their step time and
                 CUDA-event forward / backward, a 2-step K=2 rollout run on
                 the consistency mesh, and ``launch/serve.py
                 --bootstrap-steps 2``
  6c resilience  checkpoint resilience on the serving mesh, large config,
                 R=1, fused, fp32, K=1, batch 1, 8 steps, a checkpoint every
                 3, from phase 6's start params: one uninterrupted resilient
                 run, then (a) an injected crash before step 5, (b) the
                 save of step 3 dying before its COMMIT, (c) the newest
                 committed shard corrupted and a resume that falls back,
                 (d) a process that os._exits at step 5 and a fresh process
                 (kernels loaded cold) that resumes: each bitwise the
                 uninterrupted run (losses and params), kernels 1 and 2
                 launched once per layer of every step executed, replays
                 included; the state's checkpoint save (sync, async) and
                 restore times; then an elastic resume: 4 gloo processes on
                 the consistency mesh (2x2 block split, packed neighbor, 6
                 steps, a checkpoint every 2) killed at step 4 (every
                 process exits, none is left), 2 processes resume at
                 (2,1,1): the restored losses bitwise the R=4 run's, every
                 step within 1e-4 of an uninterrupted R=1 run, the elastic
                 record 4 -> 2, kernels 1, 2, 4, 5 launches exact per process
  6b multilevel  the multilevel V-cycle (``--levels 3 --coarse-mp-layers 2``,
                 large config, 727,833 -> 2,048 -> 256 nodes): one forward,
                 kernel 1 against the plain backend, launches exact per
                 level, CUDA-event forward with and without the V-cycle;
                 one loss and gradient, kernels 1 and 2 against the plain
                 backend in the gradient band; the engine with ``register_mesh(hierarchy=)``, 8 streamed
                 requests bitwise equal to the offline reference; the
                 training CLI, 3 steps twice, bitwise, with its step, its
                 CUDA-event forward + backward and the transfers' device
                 time; the consistency mesh split 2x2 through the stacked
                 emulator (packed neighbor, both schedules) against R=1 in
                 repro's multilevel bands, launches exact per level; the
                 same split through 4 gloo processes, each rank bitwise its
                 stacked slice, launches and exchanges per process exact
  9 graphcast    GraphCast ``weather_config(5)`` through
                 ``repro_torch.configs.get_arch("graphcast")``: d512, 16
                 processor layers of one MLP hidden layer, 227 variables,
                 on a refinement-5 icosphere (10,242 mesh nodes) and a 2
                 deg grid (16,380 nodes), 180,180 directed edges (the cuts
                 from refinement 6 and 0.25 deg are the host kNN's time,
                 printed as ``reduced``): 4 served states (CUDA-event ms
                 per forward, busy share, peak memory), one forward fused
                 vs the plain backend (and both vs float64), one loss
                 gradient at 2 layers through kernel 2 at H=512 vs plain,
                 and kernels 1 and 2 alone at the cell's shapes on the
                 tensor-core route (their records in the kernel line),
                 beside the FMA route on the same inputs, and the route's
                 per-node pass x w0_dst (nmp_dst_any) against its plain
                 version and torch.mm
  9c graphcast   GraphCast's training cells (``configs/graphcast.py``'s
     train       factories through ``configs/gnn_common.py``'s step
                 builder, fused): graphcast-cora-train, config(full_graph_sm)
                 (d512, 16 layers, 1,433 in, 7 classes, cross entropy) on
                 cora_like, R=1, the eval forward, step 0's loss and
                 gradients against the plain backend, 3 AdamW steps;
                 graphcast-weather-r5-train, phase 9's graph and weights,
                 the consistent MSE to a seeded next state, step 0 against
                 the plain backend (per-layer remat; float64 where the
                 band is left), 2 steps; graphcast-cora-2x2-ep, 4 gloo
                 processes sharing the card at (graph 2 x model 2), packed
                 neighbor and a2a, the eval forward, step 0 and 2 steps
                 against R=1, every process's losses and parameters equal
                 (step ms by CUDA events and peak memory for each)
  9d gnn zoo     the rest of the GNN zoo at its published widths in the
                 reference's cells (``configs/{gat_cora,nequip,mace}.py``
                 through ``gnn_common.make_gnn_train_step``, fp32, TF32
                 off), each held to the same port code on the CPU:
                 gat-cora-train (config(full_graph_sm): 1,433 in, 8 heads
                 x 8, 7 classes, on cora_like(0), R=1, 3 AdamW steps);
                 nequip- and mace-molecule-train (5 x 32 and 2 x 128
                 channels with correlation 3, l <= 2, 8 RBF, on
                 molecules(batch=128, n_atoms=30) batched at e_pad_per=64:
                 3,840 atoms, 8,192 edge slots; 3 steps; energies and
                 forces -dE/dpos under one rotation in the reference's
                 bands); zoo-cora-r4 (each arch on cora over 4 gloo
                 processes sharing the card, packed neighbor and a2a at
                 graph 4, NequIP and MACE also at graph 2 x model 2 with
                 edge_parallel: the eval forward and step 0's gradient
                 against R=1 on the card); gat-minibatch (config
                 (minibatch_lg): 602 in, 41 classes, one step on a
                 SampledBlock of 64 seeds, fanouts (15, 10), drawn from
                 powerlaw_graph(232,965, avg_deg=492), which a host thread
                 builds meanwhile, its time printed)
  9b paper-gnn   the paper's smoke config (N_H=4, M=2) through the
                 ``paper-gnn`` registry entry as tests/test_arch_smoke.py
                 runs it (box (2, 2, 1) p=2 split (2, 1, 1), a2a, the
                 stacked loss and gradient), fused vs plain
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
unpack-adds; 32 / 4 / 48 under the overlap schedule, kernel 1 once per
side), the R=4 packed-neighbor gradient run (3b; 16 forwards, 16
backwards, 8 packs, 96 unpack-adds; overlap 32 / 32 / 8 / 96), the
distributed R=4 forward and gradient run (3c; per process 4 forwards, 4
packs, 12 unpack-adds, and 4 forwards, 4 backwards, 8 packs, 24
unpack-adds; overlap 8 / 4 / 12 and 8 / 8 / 8 / 24; the paths' counts are
the sums over the 4 processes), the bf16 R=4 forward and gradient runs (3,
3b; the same counts on the bf16 kernels, none on the fp32 ones), the serve
stream after warm-up (4) and the bf16 engine's stream (4), the
R=4 serve streams (4b; the lead's launches, every process's checked
against its batches), the 10 training steps (6), the 3 bf16 training steps
(6; exactly 12 bf16 forwards and backwards), the K=2 rollout run (6),
phase 6c's resilient runs (kernels 1 and 2 M times per step executed,
replays included: 32, 36, 56, 36, 20 + 16; per process per step of the
killed R=4 world and the R=2 resume M forwards, M backwards, 2M packs and
2M unpack-adds per round received), the
phase 3d's paths (the spectral R=4 forward, gradient and bf16-wire
forward, the rounds2d forward: 16 forwards, 4 packs, 4 x pairs
unpack-adds, twice with the gradient and 16 backwards; per process of
the distributed spectral forward 4 forwards, 4 packs, 4 unpack-adds per
round it receives in; per exchange form one pack and one unpack-add per
round received under sum with the packed wire, none otherwise; the
tuner's measurement, whatever it launched, and nothing on its second
call), the multilevel paths (6b; kernel 1 M + (L-1) C = 8 times per forward and rank,
twice under overlap, 12 exchanges per forward, each level's launches
counted apart) and each DLRM path (7; the embedding bag must launch exactly once per
forward on serve_p99, serve_bulk and train_batch) and each LM path (8;
flash attention exactly once per layer per prefill, never in a decode
step), GraphCast's served states (9; kernel 1's generic entry exactly 16
times a forward, nothing else) and its gradient (2 + 2 generic launches),
GraphCast's training steps (9c; kernels 1c, 1d, 2c exactly 16, 32, 16 a
step on cora and on the weather graph; per process of the edge-parallel
run the same, and 16 / 32 packs and unpack-adds per round received a
forward / step under the packed exchange), the zoo's paths (9d; nothing at
one rank or under a2a; per process of a packed run one pack and one
unpack-add per round received for each sum exchange, twice with the
gradient: GAT 4 / 8 packs an eval forward / gradient, its max exchanges
none, NequIP 5 / 10, MACE 2 / 4), and the paper's smoke run (9b; 4 + 4
generic launches: M layers x R ranks).
Every kernel must have launched on the paths that use it.  The two lines
before the last are a JSON record of the kernels (``launches`` on the
kernel's own path, ``launches_by_path`` on all) and the card's nvidia-smi
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
Any failure raises (exit code != 0); without a CUDA device the script
exits 1 before printing any result.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
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
GNN_CASES = ("nmp_fwd", "nmp_bwd", "nmp_fwd_bf16", "nmp_bwd_bf16", "halo")
HALO_ROUNDS = 5
MLP_AGG_E_TOL, MLP_AGG_TOL, MLP_AGG_BF16_TOL = 3e-5, 1e-4, 2e-2
# published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 on CUDA cores,
# bf16 dense on tensor cores, HBM3 bandwidth
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_S = 67e12, 989e12, 3.35e12
PEAK_TF32_FLOPS = 495e12         # tensor cores, dense
# seconds per flop of an fp32 x bf16-valued product at fp32 precision on the
# tensor cores: the cheaper of 3 bf16 products (fp32 split 8+8+8 bits) and
# 2 TF32 products (2xTF32)
COT_ROUTE_S_PER_FLOP = min(3 / PEAK_BF16_FLOPS, 2 / PEAK_TF32_FLOPS)
# bf16 (precision="bf16"): two correct paths differ where a pre-activation
# one fp32 bit apart rounds to the neighbouring bf16 value, a 2^-8 step
# that the layers carry on; so a forward is held by its relative L2
# distance from the plain bf16 version (BF_REL) and by that distance's
# ratio to its distance from the fp32 result (BF_RATIO: the rounding
# happened), max |err| BF_MAX (tests/test_kernels.py's bf16 band);
# gradients per leaf within rtol / atol BF_G x max(1, max|ref|), the band
# the reference holds its own bf16 pair to; R=1 vs R=4 gradients within
# BF_LEAF of each leaf's largest magnitude
BF_REL, BF_RATIO, BF_MAX, BF_G, BF_LEAF = 1e-3, 0.2, 5e-2, 1e-2, 1e-2
BF16 = "bf16"
BF_REQUESTS = 8                  # phase 4's bf16 engine stream
SERVE_RATES = {}                 # phase 4's req/s by plan, for the bf16 line
BF_TRAIN_STEPS = 3               # phase 6's bf16 training run, run twice


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


def worst_element(got, want, exact, rtol, atol):
    """Where ``got`` leaves the band of ``want`` furthest: the element's
    index and its kernel, plain and float64 values, and each one's distance
    from float64 (which of the two fp32 paths is off there)."""
    import torch
    over = ((got - want).abs() - (atol + rtol * want.abs())).reshape(-1)
    i = int(torch.argmax(over))
    k, p, f = float(got.reshape(-1)[i]), float(want.reshape(-1)[i]), float(exact.reshape(-1)[i])
    return (f"worst element {i}: kernel {k:.6e}, plain {p:.6e}, float64 {f:.6e} "
            f"(|kernel - f64| {abs(k - f):.2e}, |plain - f64| {abs(p - f):.2e})")


def rel_norm(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def row_rel_err(got, want):
    """Largest relative L2 error of one row (last axis) of ``got``."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())


def bf16_reading(got, want, want_fp32):
    """(rel L2 from the plain bf16 ``want``, rel L2 from the fp32
    ``want_fp32``, max |err|, within the bf16 forward bands)."""
    rel, rel32 = rel_norm(got, want), rel_norm(got, want_fp32)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    return rel, rel32, err, rel <= BF_REL and rel <= BF_RATIO * rel32 and err <= BF_MAX


def bf16_leaf_ok(got, want):
    """Within rtol / atol BF_G x max(1, max|want|) elementwise."""
    import torch
    atol = BF_G * max(1.0, float(want.abs().max()) if want.numel() else 0.0)
    return bool(torch.all((got - want).abs() <= atol + BF_G * want.abs()))


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
                           "flash_attention", "edge_mlp_agg", "nmp_any", "nmp_bf16"])
    regs = {k: sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in v.splitlines() if "Used " in ln})
            for k, v in reports.items()}
    say("1 device", f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, sm_90a, in parallel); ptxas: {regs}")
    # {key: (source, mangled-name needle)}
    kernels = {"nmp_fwd": ("nmp_fwd", "nmp_fwd_tile_kernelILi32EE"),
               "nmp_bwd": ("nmp_bwd", "nmp_bwd_edge_kernelILi32EE"),
               "nmp_fwd_bf16": ("nmp_bf16", "nmp_bf16_fwd_kernelILi32EE"),
               "nmp_bwd_bf16": ("nmp_bf16", "nmp_bf16_bwd_kernelILi32EE"),
               "embedding_bag": ("embedding_bag", "embedding_bag_kernelIfLi4E"),
               "flash_attention": ("flash_attention", "flash_fwd_bf16_kernelILi128E"),
               "edge_mlp_agg": ("edge_mlp_agg", "edge_mlp_agg_kernelIfLi2E"),
               "edge_mlp_agg_bf16": ("edge_mlp_agg", "edge_mlp_agg_kernelI13__nv_bfloat16Li2E"),
               "halo_pack": ("halo_pack", "11pack_kernelILi4E"),
               "halo_unpack_add": ("halo_pack", "unpack_add_kernelILi4E")}
    # the generic-width pair: one instance per n-tile count (16 NT columns a
    # product chunk; NT 8 from H = 65 on, GraphCast's d512 among them)
    for nt in (1, 2, 4, 8):
        kernels[f"nmp_fwd_any_nt{nt}"] = ("nmp_any", f"nmp_any_fwd_kernelILi{nt}E")
        kernels[f"nmp_bwd_any_nt{nt}"] = ("nmp_any", f"nmp_any_bwd_kernelILi{nt}E")
    # its tensor-core route: the forward and backward edge passes, the rows
    # kernel (x_dst w0_dst per node, the backward's g_x) and the split-K
    # weight gradients
    for key in ("nmp_tc_fwd", "nmp_tc_bwd", "nmp_tc_rows", "nmp_wgrad"):
        kernels[key] = ("nmp_any", f"{key}_kernel")
    ptxas = {key: ptxas_summary(reports.get(src, ""), needle)
             for key, (src, needle) in kernels.items()}
    say("1 device", f"ptxas at H=32 (NMP pair: fp32 and bf16; embedding bag: fp32, 16-byte loads; flash "
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


def any_spec(kind, H, Lp, n_slots, ptxas, n_nodes=0, route=None):
    """The generic-width entry of kernel 1 or 2 (``kind`` "fwd" / "bwd",
    ``csrc/nmp_any.cu``) for :func:`nmp_fwd_case` / :func:`nmp_bwd_case` on
    ``route`` (``ops.any_route``'s unless given; a given route runs through
    the wrappers' internal route argument): its counter, the launches a
    call makes (the tensor-core route's per-node pass too), source, launch
    plan and ptxas line (the FMA route's template instance of H's n-tiles,
    or the tensor-core route's kernels)."""
    from repro_torch.kernels.segment_agg import ops as sa
    route = sa.any_route(H, Lp) if route is None else route
    name = sa.KERNEL_ANY if kind == "fwd" else sa.KERNEL_BWD_ANY
    if route == sa.TC:
        keys = (("nmp_tc_fwd", "nmp_tc_rows") if kind == "fwd"
                else ("nmp_tc_bwd", "nmp_tc_rows", "nmp_wgrad"))
        regs = "; ".join(f"{k} {ptxas.get(k, 'not built here')}" for k in keys)
        launches = {name: 2, sa.KERNEL_DST: 2}
    else:
        nt = 1 if H <= 16 else 2 if H <= 32 else 4 if H <= 64 else 8
        regs = ptxas.get(f"nmp_{kind}_any_nt{nt}", "not built here")
        launches = {name: 2}
    if kind == "fwd":
        plan = sa.fwd_any_launch_plan(H, Lp, n_slots, route)

        def call(x, e, edge, *rest):
            *ops, n_h, has_ln = sa._stack_edge_mlp(edge)
            return sa._fwd(x, e, tuple(ops), n_h, has_ln, *rest, sa.FP32, route=route)
    else:
        plan = sa.bwd_any_launch_plan(H, Lp, n_slots, n_nodes, route)

        def call(x, e, edge, *rest):
            *ops, n_h, has_ln = sa._stack_edge_mlp(edge)
            return sa._bwd(x, e, tuple(ops), n_h, has_ln, *rest, sa.FP32, route=route)
    return dict(name=name, source="src/repro_torch/csrc/nmp_any.cu", plan=plan, ptxas=regs,
                launches=launches, call=call, route=route)


def nmp_fwd_case(x, e, edge, g, n_real, n_pad, flops, weights, ptxas, spec=None,
                 detail=True, iters=(20, 5)):
    """Kernel 1 against its plain version: e' and agg within the forward
    band, each one's distance from a float64 plain forward within
    F64_FACTOR of plain fp32's, two launches bitwise equal (each one launch
    of the entry's own counter), times (``iters``: kernel, plain), the bound
    (3xTF32 on tensor cores, the kernel's arithmetic; the fp32 CUDA-core one
    beside it), the launch as the card plans it and ptxas's registers and
    spills; with ``detail`` one call's device kernels under torch.profiler.
    ``spec`` (:func:`any_spec`) names the generic-width entry; default the
    tuned one.  The generic entry's outputs hold the forward band around
    plain's or, element by element where two fp32 paths part by more
    (high in-degrees, wide rows), the same band around the float64
    forward; the worst element's three values are printed."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as sa
    H, Lp = x.shape[1], len(edge["layers"]) - 1
    lay = (g["seg_perm"], g["seg_src"], g["seg_rowptr"])
    rest = (g["edge_mask"], g["edge_inv_mult"])
    generic = spec is not None
    if spec is None:
        plan = sa.fwd_launch_plan(H, Lp, g["seg_perm"].numel())
        spec = dict(name=sa.KERNEL, source="src/repro_torch/csrc/nmp_fwd.cu",
                    ptxas=ptxas["nmp_fwd"],
                    plan_line=(f"edge pass: grid {plan['grid']}, {plan['smem_bytes']} B shared "
                               f"memory per block, {plan['blocks_per_sm']} block(s) per SM, "
                               f"{plan['smem_layers']} hidden layer(s) in shared memory, "
                               f"{plan['tiles']} tiles"))
    plan_line = spec.get("plan_line") or "edge pass: " + ", ".join(
        f"{k} {v}" for k, v in spec["plan"].items())

    def fwd():
        if "call" in spec:
            return spec["call"](x, e, edge, *lay, *rest)
        return sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)

    def fwd_plain():
        return sa.fused_nmp_edge_agg_plain(x, e, edge, *lay, *rest)

    before = dict(build.launch_counts)
    got, again = fwd(), fwd()
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in build.launch_counts.items()
                if v != before.get(k, 0)}
    counted = launched == spec.get("launches", {spec["name"]: 2})
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = fwd_plain()
    err_e, ok_e = within_band(got[0], want[0])
    err_a, ok_a = within_band(got[1], want[1])
    # both against the same forward in float64
    exact = sa.fused_nmp_edge_agg_plain(*double(x, e, edge), *lay, *double(*rest))
    vs64 = {n: (rel_norm(a.double(), r), rel_norm(b.double(), r))
            for n, a, b, r in zip(("e_new", "agg"), got, want, exact)}
    worst = [f"{n} " + worst_element(a, b, r, RTOL, ATOL)
             for n, a, b, r, ok in zip(("e_new", "agg"), got, want, exact, (ok_e, ok_a))
             if not ok]
    if generic:
        # the generic entry may instead hold the band around the float64
        # forward: where high in-degrees or wide rows leave two fp32 paths
        # further apart than the band, plain is one of them
        ok_e = ok_e or within_band(got[0].double(), exact[0])[1]
        ok_a = ok_a or within_band(got[1].double(), exact[1])[1]
    del want, exact
    f64_ok = all(a <= F64_FACTOR * b for a, b in vs64.values())
    ms = cuda_ms(fwd, iters=iters[0])
    plain = cuda_ms(fwd_plain, iters=iters[1], warmup=1)
    moved = nbytes(x, e, *lay, *rest, *weights, *got)
    # the products' FMAs, each three TF32 products in the kernel's 3xTF32
    # (the lower bound), beside the fp32 CUDA-core bound
    fp32_ms, fp32_by = bound_ms(moved, flops)
    b_ms, b_by = min((fp32_ms, fp32_by), bound_ms(moved, 3 * flops, PEAK_TF32_FLOPS))
    name = spec["name"]
    say("2 kernels", f"{name} H={H} Lp={Lp} E={n_real} N={n_pad}: max|err| e_new "
        f"{err_e:.3g} agg {err_a:.3g} (rtol {RTOL} atol {ATOL}) | two launches bitwise "
        f"equal: {repeat}, launched {launched} | kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}: 3 x {flops / 1e9:.1f} GFLOP in 3xTF32 on tensor cores, "
        f"{moved / 1e9:.2f} GB; fp32 on CUDA cores {fp32_ms:.3f} ms) | {plan_line} | ptxas "
        f"{spec['ptxas']}")
    line = (f"{name} rel L2 against the float64 forward, kernel / plain fp32 "
            f"(kernel <= {F64_FACTOR:g}x plain: {f64_ok}): "
            + ", ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in vs64.items())
            + "".join(f" | {w}" for w in worst))
    if detail:
        _, dev_ops = host_device_split(fwd, 3)      # the kernels of one call
        line += (" | one call's device kernels under torch.profiler: "
                 + "; ".join(f"{n[:40]} {t:.3f} ms" for n, t in dev_ops.items()))
    say("2 kernels", line)
    if not (ok_e and ok_a and f64_ok and repeat and counted):
        raise RuntimeError(f"fused NMP kernel {name} disagrees with its plain version or the "
                           "float64 forward, is not repeatable or did not launch once a call")
    return dict(name=name, route="cuda", source=spec["source"],
                replaces="src/repro/kernels/segment_agg/kernel.py:215",
                max_abs_err=max(err_e, err_a), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, fp32_bound_ms=fp32_ms)


def nmp_bwd_case(x, e, edge, g, n_real, n_pad, flops, weights, ptxas, gen, spec=None,
                 detail=True, iters=(10, 3)):
    """Kernel 2 against its plain version: g_x / g_e within the gradient
    band, weight gradients by relative L2, every output's distance from the
    float64 VJP within F64_FACTOR of plain fp32's, two launches bitwise
    equal (each one launch of the entry's own counter), times (``iters``:
    kernel, plain), the bound (3xTF32 on tensor cores, the kernel's
    arithmetic; the fp32 CUDA-core one beside it), the launch as the card
    plans it and ptxas's registers and spills; with ``detail`` one call's
    device kernels under torch.profiler.  ``spec`` and the generic entry's
    bands as in :func:`nmp_fwd_case`."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as sa
    H, Lp = x.shape[1], len(edge["layers"]) - 1
    generic = spec is not None
    if spec is None:
        plan = sa.bwd_launch_plan(H, Lp, g["seg_perm"].numel())
        spec = dict(name=sa.KERNEL_BWD, source="src/repro_torch/csrc/nmp_bwd.cu",
                    ptxas=ptxas["nmp_bwd"],
                    plan_line=(f"edge pass: grid {plan['grid']}, {plan['smem_bytes']} B shared "
                               f"memory per block, {plan['blocks_per_sm']} block(s) per SM"))
    plan_line = spec.get("plan_line") or "edge pass: " + ", ".join(
        f"{k} {v}" for k, v in spec["plan"].items())
    dev = x.device
    g_enew = torch.randn(e.shape[0], H, generator=gen).to(dev)
    g_agg = torch.randn(n_pad, H, generator=gen).to(dev)
    lay = (g["seg_perm"], g["seg_src"], g["seg_rowptr"])
    src_lay = (g["seg_src_slots"], g["seg_src_rowptr"])
    rest = (g["edge_mask"], g["edge_inv_mult"], g_enew, g_agg)

    def bwd():
        if "call" in spec:
            return spec["call"](x, e, edge, *lay, *src_lay, *rest)
        return sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest)

    def bwd_plain():
        return sa.fused_nmp_edge_agg_bwd_plain(x, e, edge, *lay, *rest)

    before = dict(build.launch_counts)
    got, again = bwd(), bwd()
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in build.launch_counts.items()
                if v != before.get(k, 0)}
    counted = launched == spec.get("launches", {spec["name"]: 2})
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
    worst = [f"{n} " + worst_element(a, b, r, G_RTOL, G_ATOL)
             for n, a, b, r, ok in zip(("g_x", "g_e"), got, want, exact, (ok_x, ok_g))
             if not ok]
    if generic:                                 # as in nmp_fwd_case
        ok_x = ok_x or within_band(got[0].double(), exact[0], G_RTOL, G_ATOL)[1]
        ok_g = ok_g or within_band(got[1].double(), exact[1], G_RTOL, G_ATOL)[1]
    del want, exact
    ms = cuda_ms(bwd, iters=iters[0], warmup=1)
    plain = cuda_ms(bwd_plain, iters=iters[1], warmup=1)
    moved = nbytes(x, e, *lay, *src_lay, *rest, *weights, *got)
    # recompute, input gradients and weight gradients: 3x the forward's
    # FMAs, each three TF32 products in the kernel's 3xTF32 (the lower bound)
    fp32_ms, fp32_by = bound_ms(moved, flops)
    b_ms, b_by = min((fp32_ms, fp32_by), bound_ms(moved, 3 * flops, PEAK_TF32_FLOPS))
    f64_ok = all(a <= F64_FACTOR * b for a, b in vs64.values())
    name = spec["name"]
    say("2 kernels", f"{name} H={H} Lp={Lp} E={n_real} N={n_pad}: max|err| "
        f"g_x {err_x:.3g} g_e {err_g:.3g} (rtol {G_RTOL} atol {G_ATOL}); weight "
        f"grads rel L2 " + ", ".join(f"{k} {v:.2e}" for k, v in wrel.items())
        + f" (<= {W_REL}: sums over {n_real} edges, so an elementwise atol says "
        f"nothing there) | two launches bitwise equal: {repeat}, launched {launched} | "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}: 3 x "
        f"{flops / 1e9:.1f} GFLOP in 3xTF32 on tensor cores, {moved / 1e9:.2f} GB; "
        f"fp32 on CUDA cores {fp32_ms:.3f} ms) | {plan_line} | ptxas {spec['ptxas']}")
    line = (f"{name} rel L2 against the float64 VJP, kernel / plain fp32 "
            f"(kernel <= {F64_FACTOR:g}x plain: {f64_ok}): "
            + ", ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in vs64.items())
            + "".join(f" | {w}" for w in worst))
    if detail:
        _, dev_ops = host_device_split(bwd, 3)      # the kernels of one call
        line += (" | one call's device kernels under torch.profiler: "
                 + "; ".join(f"{n[:40]} {t:.3f} ms" for n, t in dev_ops.items()))
    say("2 kernels", line)
    if not (ok_x and ok_g and all(v <= W_REL for v in wrel.values()) and f64_ok
            and repeat and counted):
        raise RuntimeError(f"fused NMP backward kernel {name} disagrees with its plain "
                           "version or the float64 VJP, is not repeatable or did not "
                           "launch once a call")
    return dict(name=name, route="cuda", source=spec["source"],
                replaces="src/repro/kernels/segment_agg/kernel.py:357",
                max_abs_err=max(err_x, err_g), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, fp32_bound_ms=fp32_ms)


def nmp_fwd_bf16_case(x, e, edge, g, n_real, n_pad, flops, weights, ptxas):
    """Kernel 1's bf16 entry against its plain bf16 version: e' and agg
    within the bf16 bands (relative L2, its ratio to the distance from the
    fp32 kernel's output on the same inputs, max |err|), two launches
    bitwise equal, times, the bound (bf16 products on tensor cores against
    the same bytes as fp32: bytes), the launch as the card plans it and
    ptxas's registers and spills."""
    import torch
    from repro_torch.kernels.segment_agg import ops as sa
    H, Lp = x.shape[1], len(edge["layers"]) - 1
    lay = (g["seg_perm"], g["seg_src"], g["seg_rowptr"])
    rest = (g["edge_mask"], g["edge_inv_mult"])

    def fwd():
        return sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest, precision=BF16)

    def fwd_plain():
        return sa.fused_nmp_edge_agg_plain(x, e, edge, *lay, *rest, precision=BF16)

    got, again = fwd(), fwd()
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want, k32 = fwd_plain(), sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)
    readings = {n: bf16_reading(a, b, c)
                for n, a, b, c in zip(("e_new", "agg"), got, want, k32)}
    del want, k32
    ok = all(r[3] for r in readings.values())
    ms = cuda_ms(fwd, iters=20)
    plain = cuda_ms(fwd_plain, iters=5, warmup=1)
    _, dev_ops = host_device_split(fwd, 3)      # the kernels of one call
    moved = nbytes(x, e, *lay, *rest, *weights, *got)
    b_ms, b_by = bound_ms(moved, flops, PEAK_BF16_FLOPS)
    plan = sa.fwd_launch_plan(H, Lp, g["seg_perm"].numel(), BF16)
    say("2 kernels", f"nmp_fwd_bf16 H={H} Lp={Lp} E={n_real} N={n_pad}: vs plain bf16 "
        + ", ".join(f"{k} rel L2 {r:.2e} (vs the fp32 kernel {r32:.2e}, ratio "
                    f"{r32 / max(r, 1e-30):.1f}) max|err| {m:.3g}"
                    for k, (r, r32, m, _) in readings.items())
        + f" (bands: rel <= {BF_REL}, <= {BF_RATIO} x the fp32 distance, max <= "
        f"{BF_MAX}) | two launches bitwise equal: {repeat} | kernel {ms:.3f} ms, plain "
        f"bf16 {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}: {moved / 1e9:.2f} GB; "
        f"{flops / 1e9:.1f} GFLOP bf16 on tensor cores "
        f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms), {b_ms / ms:.1%} of the bound | edge "
        f"pass: grid {plan['grid']}, {plan['smem_bytes']} B shared memory per block, "
        f"{plan['blocks_per_sm']} block(s) per SM, a ring of {plan['stages']} staged "
        f"tiles, {plan['smem_layers']} hidden layer(s) in shared memory, "
        f"{plan['tiles']} tiles | ptxas {ptxas['nmp_fwd_bf16']} | one call's device "
        "kernels under torch.profiler: "
        + "; ".join(f"{n[:40]} {t:.3f} ms" for n, t in dev_ops.items()))
    if not (ok and repeat):
        raise RuntimeError("bf16 NMP kernel outside the bands of its plain version, or "
                           "not repeatable")
    return dict(name=sa.KERNEL_BF16, route="cuda", source="src/repro_torch/csrc/nmp_bf16.cu",
                replaces="src/repro/kernels/segment_agg/kernel.py:215",
                max_abs_err=max(r[2] for r in readings.values()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                rel_l2={k: r[0] for k, r in readings.items()},
                rel_l2_vs_fp32={k: r[1] for k, r in readings.items()})


def nmp_bwd_bf16_case(x, e, edge, g, n_real, n_pad, fwd_flops, weights, ptxas, gen):
    """Kernel 2's bf16 entry against its plain bf16 version: every output
    within the reference's per-leaf bf16 band, its relative L2 distance
    from plain at most BF_RATIO of its distance from the fp32 kernel's
    output (but ln_b's, which no product touches), two launches bitwise
    equal, times, the bound (by operations:
    the recompute's bf16 products at the bf16 peak, the products with the
    fp32 cotangent as three bf16 products at the bf16 peak), launch plan
    and ptxas."""
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
        return sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest, precision=BF16)

    def bwd_plain():
        return sa.fused_nmp_edge_agg_bwd_plain(x, e, edge, *lay, *rest, precision=BF16)

    got, again = bwd(), bwd()
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = bwd_plain()
    k32 = sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest)
    names = ("g_x", "g_e", "w0", "b0", "wrest", "brest", "ln_g", "ln_b")
    readings = {n: (rel_norm(a, b), rel_norm(a, c), float((a - b).abs().max()),
                    bf16_leaf_ok(a, b))
                for n, a, b, c in zip(names, got, want, k32)}
    rounded = all(torch.equal(w, w.to(torch.bfloat16).float()) for w in (got[2], got[4]))
    del want, k32
    # ln_b's gradient is the column sum of the incoming cotangent, which no
    # product touches: the bf16 and fp32 kernels give it alike (distance 0),
    # so it is held by the leaf band alone
    ok = all(leaf and (k == "ln_b" or r <= BF_RATIO * r32)
             for k, (r, r32, _, leaf) in readings.items())
    ms = cuda_ms(bwd, iters=10, warmup=1)
    plain = cuda_ms(bwd_plain, iters=3, warmup=1)
    _, dev_ops = host_device_split(bwd, 3)      # the kernels of one call
    moved = nbytes(x, e, *lay, *src_lay, *rest, *weights, *got)
    # products with the fp32 cotangent, FMAs per edge: the input gradients
    # of the Lp hidden layers and layer 0's e slice, the per-slot x_src and
    # x_dst slices (rounded per slot, so not factored per node), and every
    # weight gradient.  The other operand is bf16-valued, so the cheapest
    # tensor-core route that keeps the cotangent's 24 bits is three bf16
    # products (the cotangent split 8+8+8 bits, exact) at the bf16 peak,
    # cheaper than two TF32 products (2xTF32, which keeps ~22 bits)
    cot_flops = n_real * 2 * ((Lp + 1) * H * H + 2 * H * H + (3 + Lp) * H * H)
    t_ops = fwd_flops / PEAK_BF16_FLOPS + cot_flops * COT_ROUTE_S_PER_FLOP
    t_bytes = moved / PEAK_BYTES_S
    b_ms, b_by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
    plan = sa.bwd_launch_plan(H, Lp, g["seg_perm"].numel(), BF16)
    say("2 kernels", f"nmp_bwd_bf16 H={H} Lp={Lp} E={n_real} N={n_pad}: vs plain bf16 "
        + ", ".join(f"{k} rel L2 {r:.2e} (vs the fp32 kernel {r32:.2e}) max|err| {m:.3g}"
                    f"{'' if leaf else ' OUTSIDE the leaf band'}"
                    for k, (r, r32, m, leaf) in readings.items())
        + f" (per-leaf band rtol / atol {BF_G} x max(1, max|ref|), rel <= {BF_RATIO} x "
        f"the fp32 distance) | weight gradients bf16-valued: {rounded} | two launches "
        f"bitwise equal: {repeat} | kernel {ms:.3f} ms, plain bf16 {plain:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}: recompute {fwd_flops / 1e9:.1f} GFLOP bf16 + 3 x "
        f"{cot_flops / 1e9:.1f} GFLOP bf16 (the fp32 cotangent in three bf16 parts); "
        f"{moved / 1e9:.2f} GB), {b_ms / ms:.1%} of the bound | edge pass: grid "
        f"{plan['grid']}, {plan['smem_bytes']} B shared memory per block, "
        f"{plan['blocks_per_sm']} block(s) per SM, a ring of {plan['stages']} staged tiles "
        f"| ptxas {ptxas['nmp_bwd_bf16']} | one "
        "call's device kernels under torch.profiler: "
        + "; ".join(f"{n[:40]} {t:.3f} ms" for n, t in dev_ops.items()))
    if not (ok and rounded and repeat):
        raise RuntimeError("bf16 NMP backward kernel outside the bands of its plain "
                           "version, or not repeatable")
    return dict(name=sa.KERNEL_BWD_BF16, route="cuda",
                source="src/repro_torch/csrc/nmp_bf16.cu",
                replaces="src/repro/kernels/segment_agg/kernel.py:357",
                max_abs_err=max(r[2] for r in readings.values()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                rel_l2={k: r[0] for k, r in readings.items()},
                rel_l2_vs_fp32={k: r[1] for k, r in readings.items()})


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
    # each bare call's own output: the exchange's rows, the N rows of the
    # unpack-add
    out = torch.empty(R, W_ex, F, device=dev)
    out_rows = torch.empty(cpg.n_pad, F, device=dev)
    pack_args = (stacked.data_ptr(), sidx.data_ptr(), smask.data_ptr(), out.data_ptr(),
                 W_ex, F, cpg.n_pad, R, stream)
    unpack_args = (seed.data_ptr(), buf.data_ptr(), rinv.data_ptr(), rmask.data_ptr(),
                   out_rows.data_ptr(), cpg.n_pad, F, stream)
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
    in fp32 and in bf16, pack / unpack-add on the 2x2 partition's rounds).  A subset runs those
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
    if "nmp_fwd_bf16" in cases:
        records.append(nmp_fwd_bf16_case(x, e, edge, g, n_real, pg.n_pad, fwd_flops,
                                         weights, ptxas))
    if "nmp_bwd_bf16" in cases:
        records.append(nmp_bwd_bf16_case(x, e, edge, g, n_real, pg.n_pad, fwd_flops,
                                         weights, ptxas, gen))
    del x, e, g
    torch.cuda.empty_cache()
    if "halo" in cases:
        records.extend(halo_cases(cfg.hidden, gen))
    return sem, pg, records


# phase 2's generic-width cases of kernels 1 and 2 (csrc/nmp_any.cu): each
# width x hidden layers, on a box of ANY_MID_ELEMS elements below ANY_WIDE
# and of ANY_SMALL_ELEMS from there on (the float64 VJP at H=1024 with 7
# hidden layers holds ~10.5 M weights per edge MLP), both at p=ORDER
ANY_WIDTHS, ANY_DEPTHS, ANY_WIDE = (4, 12, 64, 100, 512, 1024), (1, 2, 7), 512
ANY_MID_ELEMS, ANY_SMALL_ELEMS = (4, 4, 4), (2, 2, 2)


def _any_graph(elems):
    import torch
    from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh
    sem = box_mesh(elems, p=ORDER)
    pg = partition_mesh(sem, (1, 1, 1))
    g = ShardedGraph.build(pg, sem.coords, NMPPlan(backend=FUSED),
                           device=torch.device("cuda")).rank(0)
    return pg, g


def phase_kernels_any(ptxas, widths=ANY_WIDTHS, depths=ANY_DEPTHS):
    """Kernels 1 and 2 at the widths and depths the tuned pair does not
    take: each (H, hidden layers) through :func:`nmp_fwd_case` /
    :func:`nmp_bwd_case` with the generic entries' specs (plain version,
    float64 forward / VJP, bitwise rerun, one launch of the entry's own
    counter per call, CUDA-event times, bound, launch plan, ptxas); then
    the dispatch: at H=4 and H=32 with 2 hidden layers on the same graph,
    one forward and one backward each, H=32 moves only the tuned counters
    and H=4 only the generic ones.  Each case runs on ``ops.any_route``'s
    route (held to its bands) and, where H % 4 == 0, on the other route
    too (timed and checked, a failure reported only): the crossover.
    Returns {(H, Lp): {(kind, route): ms}}."""
    import torch
    from repro_torch.core.gnn import GNNConfig, init_gnn
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as sa
    t0 = time.perf_counter()
    graphs = {False: _any_graph(ANY_MID_ELEMS), True: _any_graph(ANY_SMALL_ELEMS)}
    for wide, (pg, _) in graphs.items():
        say("2 kernels", f"generic-width cases {'H >= ' if wide else 'H < '}{ANY_WIDE}: "
            f"box {ANY_SMALL_ELEMS if wide else ANY_MID_ELEMS} p={ORDER}, {pg.n_global} nodes, "
            f"{int(pg.edge_mask.sum())} directed edges")
    gen = torch.Generator().manual_seed(27)
    dev = torch.device("cuda")
    times = {}

    def case_inputs(H, Lp, wide):
        pg, g = graphs[wide]
        edge = init_gnn(gen, GNNConfig(hidden=H, n_mp_layers=1, mlp_hidden_layers=Lp),
                        device=dev)["mp"][0]["edge"]
        for lp in edge["layers"]:                  # non-trivial biases
            lp["b"] = 0.1 * torch.randn(lp["b"].shape, generator=gen).to(dev)
        x = torch.randn(pg.n_pad, H, generator=gen).to(dev)
        e = torch.randn(pg.e_pad, H, generator=gen).to(dev)
        return pg, g, edge, x, e

    failed = []
    for H in widths:
        for Lp in depths:
            pg, g, edge, x, e = case_inputs(H, Lp, H >= ANY_WIDE)
            n_real = int(pg.edge_mask.sum())
            n_dst = int((g["seg_rowptr"].diff() > 0).sum())
            flops = n_real * 2 * (2 * H * H + Lp * H * H) + n_dst * 2 * H * H
            weights = [t for l in edge["layers"] for t in l.values()] + list(edge["ln"].values())
            slots = g["seg_perm"].numel()
            # the rule's route, held to its bands; then the other route on
            # the same inputs through the internal route argument (the
            # crossover's other side: printed, its failures only reported)
            rule = sa.any_route(H, Lp)
            routes = (rule,) + tuple(r for r in sa.ROUTES if r != rule and (r == sa.FMA or H % 4 == 0))
            ms = {}
            for kind, case, fl, extra, iters in (("fwd", nmp_fwd_case, flops, (), (5, 2)),
                                                 ("bwd", nmp_bwd_case, 3 * flops, (gen,), (3, 1))):
                for route in routes:
                    try:
                        rec = case(x, e, edge, g, n_real, pg.n_pad, fl, weights, ptxas, *extra,
                                   spec=any_spec(kind, H, Lp, slots, ptxas, pg.n_pad, route),
                                   detail=False, iters=iters)
                        ms[kind, route] = rec["ms"]
                    except RuntimeError as err:     # every case runs; the phase fails below
                        if route == rule:
                            failed.append(f"{kind} H={H} Lp={Lp}: {err}")
                        else:
                            say("2 kernels", f"{kind} H={H} Lp={Lp} on the {route} route, which "
                                f"the rule does not take here: {err}")
                        ms[kind, route] = None
            say("2 kernels", f"routes at H={H} Lp={Lp}: the rule's {rule}; " + ", ".join(
                f"{k} {r} {'failed' if v is None else f'{v:.3f} ms'}"
                for (k, r), v in ms.items()))
            times[H, Lp] = ms
            del x, e, edge
    # the dispatch: the tuned widths keep the tuned kernels
    moved = {}
    for H in (32, 4):
        pg, g, edge, x, e = case_inputs(H, 2, False)
        lay = (g["seg_perm"], g["seg_src"], g["seg_rowptr"])
        src_lay = (g["seg_src_slots"], g["seg_src_rowptr"])
        rest = (g["edge_mask"], g["edge_inv_mult"])
        before = dict(build.launch_counts)
        sa.fused_nmp_edge_agg(x, e, edge, *lay, *rest)
        sa.fused_nmp_edge_agg_bwd(x, e, edge, *lay, *src_lay, *rest, torch.ones_like(e),
                                  torch.ones_like(x))
        torch.cuda.synchronize()
        moved[H] = {k: v - before.get(k, 0) for k, v in build.launch_counts.items()
                    if v != before.get(k, 0)}
    want = {32: {sa.KERNEL: 1, sa.KERNEL_BWD: 1}, 4: {sa.KERNEL_ANY: 1, sa.KERNEL_BWD_ANY: 1}}
    say("2 kernels", f"dispatch on the {ANY_MID_ELEMS} box, 2 hidden layers: launches at H=32 "
        f"{moved[32]}, at H=4 {moved[4]} (expected {want}) -> "
        f"{'ok' if moved == want else 'FAIL'} | generic cases {time.perf_counter() - t0:.1f} s")
    if moved != want:
        raise RuntimeError(f"kernels 1 and 2 dispatched wrongly by width: {moved}")
    if failed:
        raise RuntimeError("generic-width cases failed: " + "; ".join(failed))
    torch.cuda.empty_cache()
    return times


# the (block_n, block_e) pairs whose kernel-3 times at full width pick the
# CUDA row of kernels/segment_agg/ops.py::pick_block_sizes
BLOCK_PAIRS = ((64, 128), (128, 256), (256, 256))


def block_pairs_ms(dst, n, feats, wgt, mlp):
    """Kernel 3 at full width under each of BLOCK_PAIRS (its layout built
    for the pair): CUDA-event ms each, printed beside the table's row and
    the pick; returns {"bn/be": ms}."""
    import torch
    from repro_torch.kernels.segment_agg import ops as sa
    out = {}
    for bn, be in BLOCK_PAIRS:
        layout = sa.dst_aligned_layout(dst, n, bn, be)
        perm = torch.from_numpy(layout["perm"]).to(feats.device)
        valid, safe = perm >= 0, perm.clamp(min=0)
        tiles = (torch.where(valid[..., None], feats[safe], 0),
                 torch.from_numpy(layout["dstl"]).to(feats.device),
                 torch.where(valid, wgt[safe], 0))
        kw = dict(n_node_blocks=layout["n_node_blocks"], block_n=bn, block_e=be)
        out[f"{bn}/{be}"] = cuda_ms(lambda: sa.edge_mlp_agg(*tiles, *mlp, **kw), iters=10)
        del perm, valid, safe, tiles
    row = sa.pick_block_sizes(mlp[2].shape[1], torch.float32, backend="cuda")
    say("2 kernels", f"edge_mlp_agg full width by (block_n, block_e): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
        + f" | fastest {min(out, key=out.get)}; pick_block_sizes' CUDA row {row[0]}/{row[1]}")
    return out


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
            record["block_pairs_ms"] = block_pairs_ms(dst, n, feats, wgt, mlp)
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


# exact launches of the stacked R=4 packed-neighbor paths on the 2x2 split,
# M=4 layers: kernel 1 once per rank and layer (twice under the overlap
# schedule: the boundary side, then the interior side), kernel 4 once per
# exchange, kernel 5 once per round and receiver (3 x 4); the gradient run
# adds the reversed exchanges and kernel 2 per kernel 1
CONS_FWD = {"nmp_fwd": 16, "halo_pack": 4, "halo_unpack_add": 48}
CONS_FWD_OVERLAP = {"nmp_fwd": 32, "halo_pack": 4, "halo_unpack_add": 48}
CONS_GRAD = {"nmp_fwd": 16, "nmp_bwd": 16, "halo_pack": 8, "halo_unpack_add": 96}
CONS_GRAD_OVERLAP = {"nmp_fwd": 32, "nmp_bwd": 32, "halo_pack": 8, "halo_unpack_add": 96}


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

    def run(grid, mode, backend, packed=False, sync_fn=None, per_rank=None, key=None,
            schedule="blocking"):
        pg = partition_mesh(sem, grid)
        plan = NMPPlan.build(pg, mode, packed=packed, backend=backend, schedule=schedule)
        g = ShardedGraph.build(pg, sem.coords, plan, device=dev)
        xs = torch.from_numpy(gather_node_features(pg, x)).to(dev)
        y = gnn_forward_stacked(params, xs, g, plan, sync_fn=sync_fn).cpu().numpy()
        if per_rank is not None:
            per_rank[key or mode] = y
        return torch.from_numpy(scatter_node_outputs(pg, y))

    y1 = run((1, 1, 1), NONE, FUSED)
    per_rank, launches, y4 = {}, {}, {}
    for schedule, want in (("blocking", CONS_FWD), ("overlap", CONS_FWD_OVERLAP)):
        build.reset_launch_counts()
        y4[schedule] = run(CONS_GRID, NEIGHBOR, FUSED, packed=True,
                           sync_fn=halo_sync_stacked, per_rank=per_rank,
                           key="neighbor" if schedule == "blocking" else schedule,
                           schedule=schedule)
        launches[schedule] = dict(build.launch_counts)
        check_launches("3 consistency", f"the R=4 packed neighbor forward, {schedule}",
                       launches[schedule], want)
    cases = {
        "R=4 packed neighbor (pack/unpack kernels)": y4["blocking"],
        "R=4 packed neighbor, overlap schedule": y4["overlap"],
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
    yo, yb = per_rank["overlap"], per_rank["neighbor"]
    err, ok = within_band(torch.from_numpy(yo), torch.from_numpy(yb))
    say("3 consistency", f"R=4 packed neighbor, overlap vs blocking schedule (every "
        f"rank's padded rows): max|err| {err:.3g} (rtol {RTOL} atol {ATOL}), bitwise "
        f"{np.array_equal(yo, yb)} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("consistency failed: overlap vs blocking at R=4")
    return launches["blocking"], launches["overlap"], per_rank


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

    def prepare(grid, mode, backend, packed=False, schedule="blocking"):
        pg = partition_mesh(sem, grid)
        plan = NMPPlan.build(pg, mode, packed=packed, backend=backend, schedule=schedule)
        g = ShardedGraph.build(pg, sem.coords, plan, device=dev)
        xs, ys = (torch.from_numpy(gather_node_features(pg, f)).to(dev) for f in (x, y))
        return xs, ys, g, plan

    def grad(prepared, sync_fn=None):
        xs, ys, g, plan = prepared
        return loss_and_grad_stacked(params, xs, ys, g, plan, cfg.node_out,
                                     sync_fn=sync_fn)

    l1, _, g1 = grad(prepare((1, 1, 1), NONE, FUSED))
    launches, runs = {}, {}
    for schedule, want in (("blocking", CONS_GRAD), ("overlap", CONS_GRAD_OVERLAP)):
        r4 = prepare(CONS_GRID, NEIGHBOR, FUSED, packed=True, schedule=schedule)
        build.reset_launch_counts()
        l4, _, g4 = grad(r4, halo_sync_stacked)
        torch.cuda.synchronize()
        launches[schedule] = dict(build.launch_counts)
        check_launches("3b gradients", f"the R=4 packed neighbor gradient run, {schedule}",
                       launches[schedule], want)
        runs[schedule] = (l4, g4)
        del r4
    lx, _, gx = grad(prepare(CONS_GRID, NEIGHBOR, XLA, packed=True), halo_sync_stacked)
    l4, g4 = runs["blocking"]
    for name, (la, ga), (lb, gb) in (
            ("fused R=1 vs R=4 packed neighbor", (l4, g4), (l1, g1)),
            ("fused R=1 vs R=4 packed neighbor, overlap schedule", runs["overlap"],
             (l1, g1)),
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
    return launches["blocking"], launches["overlap"], (float(l1), g1)


# the same R=4 paths on a bf16 plan: the bf16 kernels' counts, none of the
# fp32 ones (check_launches holds every kernel it is not given to 0)
CONS_FWD_BF16 = {"nmp_fwd_bf16": 16, "halo_pack": 4, "halo_unpack_add": 48}
CONS_FWD_BF16_OVERLAP = {"nmp_fwd_bf16": 32, "halo_pack": 4, "halo_unpack_add": 48}
CONS_GRAD_BF16 = {"nmp_fwd_bf16": 16, "nmp_bwd_bf16": 16, "halo_pack": 8,
                  "halo_unpack_add": 96}
CONS_GRAD_BF16_OVERLAP = {"nmp_fwd_bf16": 32, "nmp_bwd_bf16": 32, "halo_pack": 8,
                          "halo_unpack_add": 96}


def phase_consistency_bf16(cfg):
    """Phases 3 and 3b on a bf16 plan (``NMPPlan(precision="bf16")``): the
    stacked R=4 packed-neighbor forward and gradient run under both
    schedules against R=1 in bf16, launches exact.  R=1 and R=4 are two
    bf16 paths that sum in other orders, so predictions are held to the
    bf16 forward bands (relative L2 from R=1 bf16, its ratio to the
    distance from R=1 on the fp32 plan, max |err|; the reading against the
    fp32 band, rtol 1e-4 / atol 1e-5, is reported), the loss within
    LOSS_REL of R=1 bf16's and within BF_RATIO of its distance from the
    fp32 plan's, and every gradient within BF_LEAF of its leaf's largest
    magnitude.  Returns {path: launches}."""
    import torch
    from repro_torch.core.gnn import init_gnn
    from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
    from repro_torch.core.halo import NEIGHBOR, NONE, halo_sync_stacked
    from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
    from repro_torch.core.partition import (
        gather_node_features, partition_mesh, scatter_node_outputs)
    from repro_torch.core.reference import gnn_forward_stacked, loss_and_grad_stacked
    from repro_torch.kernels import build
    from repro_torch.nn import tree_leaves

    dev = torch.device("cuda")
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    sem = box_mesh(CONS_ELEMS, p=ORDER)
    x = taylor_green_velocity(sem.coords)
    y = taylor_green_velocity(sem.coords, t=DT)

    def prepare(grid, mode, precision, schedule="blocking"):
        pg = partition_mesh(sem, grid)
        plan = NMPPlan.build(pg, mode, packed=mode == NEIGHBOR, backend=FUSED,
                             schedule=schedule, precision=precision)
        g = ShardedGraph.build(pg, sem.coords, plan, device=dev)
        xs, ys = (torch.from_numpy(gather_node_features(pg, f)).to(dev) for f in (x, y))
        return pg, g, plan, xs, ys

    def forward(prep):
        pg, g, plan, xs, _ = prep
        with torch.no_grad():
            out = gnn_forward_stacked(params, xs, g, plan, sync_fn=halo_sync_stacked)
        return torch.from_numpy(scatter_node_outputs(pg, out.cpu().numpy()))

    def grad(prep):
        _, g, plan, xs, ys = prep
        loss, _, grads = loss_and_grad_stacked(params, xs, ys, g, plan, cfg.node_out,
                                               sync_fn=halo_sync_stacked)
        return float(loss), tree_leaves(grads)

    r1, r1_fp32 = prepare((1, 1, 1), NONE, BF16), prepare((1, 1, 1), NONE, "fp32")
    y1, y1_fp32 = forward(r1), forward(r1_fp32)
    (l1, g1), (l1_fp32, _) = grad(r1), grad(r1_fp32)
    del r1, r1_fp32
    if not bool(torch.isfinite(y1).all()) or tuple(y1.shape) != (sem.n_nodes, cfg.node_out):
        raise RuntimeError(f"bf16 R=1 output not finite / wrong shape {tuple(y1.shape)}")
    launches = {}
    for schedule, want_f, want_g in (("blocking", CONS_FWD_BF16, CONS_GRAD_BF16),
                                     ("overlap", CONS_FWD_BF16_OVERLAP,
                                      CONS_GRAD_BF16_OVERLAP)):
        r4 = prepare(CONS_GRID, NEIGHBOR, BF16, schedule)
        build.reset_launch_counts()
        y4 = forward(r4)
        torch.cuda.synchronize()
        launches[f"consistency_r4_bf16_{schedule}"] = dict(build.launch_counts)
        check_launches("3 consistency", f"the R=4 packed neighbor forward, bf16, {schedule}",
                       launches[f"consistency_r4_bf16_{schedule}"], want_f)
        build.reset_launch_counts()
        l4, g4 = grad(r4)
        torch.cuda.synchronize()
        launches[f"grad_r4_bf16_{schedule}"] = dict(build.launch_counts)
        check_launches("3b gradients", f"the R=4 packed neighbor gradient run, bf16, "
                       f"{schedule}", launches[f"grad_r4_bf16_{schedule}"], want_g)
        del r4
        rel, rel32, err, ok_f = bf16_reading(y4, y1, y1_fp32)
        _, fp32_band = within_band(y4, y1)
        say("3 consistency", f"{CONS_ELEMS} p={ORDER}, large config, bf16 plan, R=1 vs R=4 "
            f"packed neighbor, {schedule}: rel L2 {rel:.2e} (R=4 bf16 vs R=1 fp32 "
            f"{rel32:.2e}), max|err| {err:.3g} (bf16 bands: rel <= {BF_REL}, <= {BF_RATIO} "
            f"x the fp32 distance, max <= {BF_MAX}); within the fp32 band rtol {RTOL} "
            f"atol {ATOL}: {fp32_band} -> {'ok' if ok_f else 'FAIL'}")
        loss_rel, loss_rel32 = abs(l4 - l1) / abs(l1), abs(l4 - l1_fp32) / abs(l1_fp32)
        leaf = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(g4, g1)]
        ok_g = (loss_rel <= LOSS_REL and loss_rel <= BF_RATIO * loss_rel32
                and max(leaf) <= BF_LEAF)
        say("3b gradients", f"{CONS_ELEMS} p={ORDER}, large config, bf16 plan, R=1 vs R=4 "
            f"packed neighbor, {schedule}: loss {l4!r} vs {l1!r} (rel {loss_rel:.2e}, band "
            f"{LOSS_REL}; vs the fp32 plan's {l1_fp32!r} {loss_rel32:.2e}, band "
            f"{BF_RATIO} x that) | gradients max |err| / leaf max "
            f"{max(leaf):.2e} (band {BF_LEAF}) -> {'ok' if ok_g else 'FAIL'}")
        if not (ok_f and ok_g):
            raise RuntimeError(f"bf16 consistency failed: R=1 vs R=4 {schedule}")
    return launches


# per process of phase 3c (one rank of the 2x2 split): the stacked counts
# over 4; the forward's exchanges posted, the gradient run's blocking
DIST_FWD = {"nmp_fwd": 4, "halo_pack": 4, "halo_unpack_add": 12}
DIST_GRAD = {"nmp_fwd": 4, "nmp_bwd": 4, "halo_pack": 8, "halo_unpack_add": 24}
DIST_FWD_OVERLAP = {"nmp_fwd": 8, "halo_pack": 4, "halo_unpack_add": 12}
DIST_GRAD_OVERLAP = {"nmp_fwd": 8, "nmp_bwd": 8, "halo_pack": 8, "halo_unpack_add": 24}
DIST_TIMING, DIST_TRAIN_STEPS = 5, 3


def phase_distributed(cfg, stacked, r1, smi):
    """4 gloo processes sharing the card (``launch/consistency.py``): (a)
    the (2,2,1) split, packed neighbor and a2a, under the blocking and the
    overlap schedule, each rank's prediction bitwise equal to its slice of
    phase 3's stacked forward of the same schedule, loss and gradients
    within the bands of phase 3b's R=1, launches per process exactly
    DIST_* and the exchanges each run took (the forward posts, the
    overlap's after queueing the interior side; the gradient run finishes
    each at once);
    (b) 3 training steps at (2,1,1) x 2, batch 2, whose step 0 matches an
    R=1 run's and whose parameters end bitwise equal on every process.
    Returns the summed launches of each path."""
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
                   schedules=("blocking", "overlap"), cases=((CONS_GRID, 1),),
                   timing=DIST_TIMING, train_steps=DIST_TRAIN_STEPS)
    procs = cons.run_world(job, 4)
    wall = time.perf_counter() - t0
    case = cons.case_name(CONS_GRID, 1)
    l1 = r1[0]
    base = (l1, [t.cpu().numpy() for t in _leaves(r1[1])])
    layers = cfg.n_mp_layers
    sem = box_mesh(CONS_ELEMS, p=ORDER)
    sums = {}
    for schedule in ("blocking", "overlap"):
        key = cons.steps_key(schedule)
        loss = {}
        for mode, stacked_mode in (("packed", "neighbor"), ("a2a", "a2a"), ("none", None)):
            if schedule == "overlap" and stacked_mode is not None:
                stacked_mode = "overlap" if mode == "packed" else None
            recs = [p[case][key][(FUSED, mode)] for p in procs]
            loss[mode] = float(recs[0]["loss"])
            line = cons.check_step(recs, base, mode, w_rel=W_REL)
            if stacked_mode is not None:
                bitwise = all(np.array_equal(r["pred"][0, 0],
                                             stacked[stacked_mode][p[case]["rank"]])
                              for r, p in zip(recs, procs))
                line = (f"every rank's prediction bitwise equal to its stacked slice: "
                        f"{bitwise} | {line}")
            say("3c distributed", f"4 gloo processes on one card, {CONS_ELEMS} p={ORDER}, "
                f"{CONS_GRID} split, large config, fused, {schedule}, R=1 loss {l1:.8g}: "
                f"{line}")
            if stacked_mode is not None and not bitwise:
                raise RuntimeError(f"distributed {mode} {schedule} forward != the "
                                   "stacked forward")
        say("3c distributed", f"{schedule}: " + cons.check_agree(loss) + " -> ok")
        fwd, grad = ((DIST_FWD, DIST_GRAD) if schedule == "blocking"
                     else (DIST_FWD_OVERLAP, DIST_GRAD_OVERLAP))
        for name, run, want, exchanges in (
                ("fwd_launches", "forward", fwd,
                 {"posted": layers, "overlapped": layers if schedule == "overlap" else 0}),
                ("grad_launches", "gradient run", grad,
                 {"posted": 2 * layers, "overlapped": 0})):
            total = {}
            for w, p in enumerate(procs):
                rec = p[case][key][(FUSED, "packed")]
                check_launches("3c distributed", f"process {w}'s packed {schedule} {run}",
                               rec[name], want)
                got = rec[name.replace("launches", "exchanges")]
                if got != exchanges:
                    raise RuntimeError(f"process {w}'s packed {schedule} {run} took "
                                       f"exchanges {got}, expected {exchanges}")
                for k, v in rec[name].items():
                    total[k] = total.get(k, 0) + v
            say("3c distributed", f"launches summed over the 4 processes, packed "
                f"{schedule} {run}: {total}; exchanges per process {exchanges} "
                "(posted: every round issued at once, then waited; overlapped: "
                "finished after the interior side was queued)")
            sums[(schedule, name)] = total
    times = {sch: procs[0][case][cons.steps_key(sch)][(FUSED, "packed")]
             for sch in ("blocking", "overlap")}
    say("3c distributed", f"{smi} | 4 processes share one card (gloo through the host: "
        f"a check of the path, not a scaling number); rank 0 by CUDA events, median of "
        f"{DIST_TIMING}: " + "; ".join(
            f"{sch}: forward {t['fwd_ms']:.3f} ms, gradient step {t['grad_ms']:.3f} ms, "
            f"per exchange (host) stream sync {t['sync_ms_per_exchange']:.3f} ms, staging "
            f"copies {t['stage_ms_per_exchange']:.3f} ms, gloo calls "
            f"{t['wire_ms_per_exchange']:.3f} ms, blocked in the wait "
            f"{t['wait_ms_per_exchange']:.3f} ms" for sch, t in times.items())
        + f"; staged {times['blocking']['staged_bytes_per_layer']:.0f} B per layer; "
        f"spawn + all of (a), (b) {wall:.1f} s")

    # (b) against one rank's first step on the same batch
    train = [p["train"] for p in procs]
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
    return {"dist_r4_packed": sums[("blocking", "fwd_launches")],
            "dist_r4_grad": sums[("blocking", "grad_launches")],
            "dist_r4_overlap": sums[("overlap", "fwd_launches")],
            "dist_r4_overlap_grad": sums[("overlap", "grad_launches")]}


# phase 3d: the exchange's remaining forms and the plan's choice, on the
# consistency mesh (the spectral bisection of the 727,833-node serving mesh
# is many seconds of host power iteration per level): the spectral split,
# the bf16 wire, rounds2d, combine="max" and the measured tuner
WIRE_BAND = 2e-2                 # tests/test_extras.py:49, the bf16 wire's band
PLAN_TRAIN_STEPS = 3


def _pairs_into(perms, rank):
    """Rounds of ``perms`` whose flat pairs deliver to ``rank``."""
    return sum(any(d == rank for _, d in p) for p in perms)


def _sum_counts(counts):
    total = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_plan(cfg, r1, smi):
    """Phase 3d (module docstring): spectral R=4 beside block (quality, the
    stacked forward and gradient at full width against R=1, kernels 1 and
    2 against plain on a vertex-cut layout), the bf16 wire on the packed
    forward (stacked and over 4 gloo processes: within 2e-2 of fp32, half
    the bytes, the same launches), rounds2d on a (2, 2) grid (dense and
    packed, stacked and over gloo), max over gloo (bitwise stacked, no pack
    launch), the 12-candidate tuner table at hidden 32 over the 4
    processes (one triple everywhere, its argmin, a second call launching
    nothing), and 3 training steps of the CLI with ``--mp-schedule auto
    --partitioner spectral --ranks 2 2 1 --model large``.  Returns the
    launches of each path."""
    import torch
    from repro_torch.core.gnn import init_gnn
    from repro_torch.core.graph_state import FUSED, NMPPlan, ShardedGraph
    from repro_torch.core.halo import NEIGHBOR, NONE, halo_sync_stacked
    from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
    from repro_torch.core.partition import (
        gather_node_features, partition_mesh, partition_mesh_2d, scatter_node_outputs)
    from repro_torch.core.partition_quality import partition_quality
    from repro_torch.core.reference import gnn_forward_stacked, loss_and_grad_stacked
    from repro_torch.kernels import build
    from repro_torch.kernels.halo_pack import ops as hp
    from repro_torch.kernels.segment_agg import ops as sa
    from repro_torch.launch import consistency as cons
    from repro_torch.launch import train as train_cli
    from repro_torch.train.loop import TrainConfig, train_consistent_gnn

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    sem = box_mesh(CONS_ELEMS, p=ORDER)
    x = taylor_green_velocity(sem.coords)
    y = taylor_green_velocity(sem.coords, t=DT)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    t0 = time.perf_counter()
    pg_s = partition_mesh(sem, CONS_GRID, method="spectral")
    spectral_s = time.perf_counter() - t0
    pg_b, pg_1 = partition_mesh(sem, CONS_GRID), partition_mesh(sem, (1, 1, 1))
    pg_2d = partition_mesh_2d(sem, (2, 2))
    q_s, q_b = partition_quality(pg_s), partition_quality(pg_b)
    wb = {name: pg.wire_bytes("neighbor", True, cfg.hidden, w)["max"]
          for name, pg, w in (("spectral fp32", pg_s, None),
                              ("spectral bf16", pg_s, "bfloat16"),
                              ("block fp32", pg_b, None))}
    keys = ("halo_volume", "edge_cut", "boundary_frac_max", "imbalance", "max_rank_nodes")
    say("3d plan", f"{CONS_ELEMS} p={ORDER} ({sem.n_nodes} nodes; the spectral and "
        f"rounds2d paths run on the consistency mesh, not the 727,833-node serving mesh) "
        f"split {CONS_GRID}: spectral bisection {spectral_s:.1f} s on the host | "
        f"partition_quality spectral {({k: q_s[k] for k in keys})}, block "
        f"{({k: q_b[k] for k in keys})} | packed neighbor bytes of one exchange at "
        f"H={cfg.hidden}, largest rank: {wb}")

    def prepare(pg, plan):
        g = ShardedGraph.build(pg, sem.coords, plan, device=dev)
        xs, ys = (torch.from_numpy(gather_node_features(pg, f)).to(dev) for f in (x, y))
        return g, xs, ys

    def forward(pg, plan, sync=halo_sync_stacked):
        g, xs, _ = prepare(pg, plan)
        build.reset_launch_counts()
        with torch.no_grad():
            yr = gnn_forward_stacked(params, xs, g, plan, sync_fn=sync)
        torch.cuda.synchronize()
        counts = dict(build.launch_counts)
        yr = yr.cpu().numpy()
        return torch.from_numpy(scatter_node_outputs(pg, yr)), yr, counts

    def grad(pg, plan):
        g, xs, ys = prepare(pg, plan)
        build.reset_launch_counts()
        loss, _, grads = loss_and_grad_stacked(params, xs, ys, g, plan, cfg.node_out,
                                               sync_fn=halo_sync_stacked)
        torch.cuda.synchronize()
        return float(loss), grads, dict(build.launch_counts)

    def packed(pg, wire=None):
        return NMPPlan.build(pg, NEIGHBOR, packed=True, wire_dtype=wire, backend=FUSED)

    by_path = {}
    y1 = forward(pg_1, NMPPlan.build(pg_1, NONE, backend=FUSED))[0]
    pairs_s = sum(len(p) for p in packed(pg_s).halo.perms)
    layers = cfg.n_mp_layers
    fwd_want = {sa.KERNEL: 4 * layers, hp.PACK: layers, hp.UNPACK: layers * pairs_s}
    grad_want = {sa.KERNEL: 4 * layers, sa.KERNEL_BWD: 4 * layers, hp.PACK: 2 * layers,
                 hp.UNPACK: 2 * layers * pairs_s}
    # (a) the spectral split, stacked, at full width
    ys4, ys4_rank, by_path["plan_spectral_r4_fwd"] = forward(pg_s, packed(pg_s))
    check_launches("3d plan", "the spectral R=4 packed forward", by_path["plan_spectral_r4_fwd"],
                   fwd_want)
    err, ok = within_band(ys4, y1)
    l4, g4, by_path["plan_spectral_r4_grad"] = grad(pg_s, packed(pg_s))
    check_launches("3d plan", "the spectral R=4 packed gradient run",
                   by_path["plan_spectral_r4_grad"], grad_want)
    l1, g1 = r1
    rel = abs(l4 - l1) / abs(l1)
    gerr, by_norm, gok = grads_close(g4, g1)
    good = ok and gok and rel <= LOSS_REL
    say("3d plan", f"spectral R=4 (vertex cut, {pairs_s} neighbor pairs in "
        f"{len(packed(pg_s).halo.perms)} rounds), large config, fused, packed neighbor: "
        f"forward vs fused R=1 max|err| {err:.3g} (rtol {RTOL} atol {ATOL}) | loss "
        f"{l4:.8g} vs R=1 {l1:.8g} (rel {rel:.2e}, band {LOSS_REL}) | grads max|err| "
        f"{gerr:.3g} (rtol {G_RTOL} atol {G_ATOL})"
        + (f"; held by rel L2 (<= {W_REL}): {by_norm}" if by_norm else "")
        + f" -> {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("spectral R=4 disagrees with R=1")
    del g4

    # kernels 1 and 2 against plain on one vertex-cut layout (rank 0)
    g0 = ShardedGraph.build(pg_s, sem.coords, packed(pg_s), device=dev).rank(0)
    gen = torch.Generator(device=dev).manual_seed(23)
    n, n_e = g0["node_mask"].shape[0], g0["edge_mask"].shape[0]
    xk, ek = (torch.randn(s, cfg.hidden, generator=gen, device=dev) for s in (n, n_e))
    ge, gx = (torch.randn(s, cfg.hidden, generator=gen, device=dev) for s in (n_e, n))
    edge = params["mp"][0]["edge"]
    lay = (g0["seg_perm"], g0["seg_src"], g0["seg_rowptr"])
    rest = (g0["edge_mask"], g0["edge_inv_mult"])
    e_k, a_k = sa.fused_nmp_edge_agg(xk, ek, edge, *lay, *rest)
    e_p, a_p = sa.fused_nmp_edge_agg_plain(xk, ek, edge, *lay, *rest)
    bk = sa.fused_nmp_edge_agg_bwd(xk, ek, edge, *lay, g0["seg_src_slots"],
                                   g0["seg_src_rowptr"], *rest, ge, gx)
    bp = sa.fused_nmp_edge_agg_bwd_plain(xk, ek, edge, *lay, *rest, ge, gx)
    torch.cuda.synchronize()
    k_err = max(within_band(e_k, e_p)[0], within_band(a_k, a_p)[0])
    k_ok = within_band(e_k, e_p)[1] and within_band(a_k, a_p)[1]
    b_err = max(within_band(a, b, G_RTOL, G_ATOL)[0] for a, b in zip(bk[:2], bp[:2]))
    b_ok = all(within_band(a, b, G_RTOL, G_ATOL)[1] for a, b in zip(bk[:2], bp[:2]))
    w_rel = max(rel_norm(a, b) for a, b in zip(bk[2:], bp[2:]))
    good = k_ok and b_ok and w_rel <= W_REL
    say("3d plan", f"kernels 1 and 2 on the spectral split's rank 0 layout (N={n}, "
        f"{int(rest[0].sum())} edges, d_ij = 1): forward vs plain max|err| {k_err:.3g} "
        f"(rtol {RTOL} atol {ATOL}), backward x/e max|err| {b_err:.3g} (rtol {G_RTOL} "
        f"atol {G_ATOL}), weights rel L2 {w_rel:.2e} (<= {W_REL}) -> "
        f"{'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("kernels 1/2 disagree with plain on the vertex-cut layout")
    del g0, xk, ek, ge, gx, bk, bp

    # (b) the bf16 wire on the packed forward, stacked
    bf = torch.bfloat16
    ysw, ysw_rank, by_path["plan_spectral_r4_bf16_wire"] = forward(pg_s, packed(pg_s, bf))
    check_launches("3d plan", "the spectral R=4 packed forward, bf16 wire",
                   by_path["plan_spectral_r4_bf16_wire"], fwd_want)
    err_w, ok_w = within_band(ysw, ys4, WIRE_BAND, WIRE_BAND)
    moved = float((ysw - ys4).abs().max())
    err_1, ok_1 = within_band(ysw, y1, WIRE_BAND, WIRE_BAND)
    good = ok_w and ok_1 and moved > 0
    say("3d plan", f"bf16 wire, spectral R=4 packed forward (stacked): vs the fp32 wire "
        f"max|err| {err_w:.3g}, vs R=1 {err_1:.3g} (band {WIRE_BAND}; rounding happened: "
        f"{moved > 0}); launches as under fp32 -> {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("the bf16 wire leaves its band")

    # (c) rounds2d on a (2, 2) grid, dense and packed, stacked
    plan_2d = NMPPlan.build(pg_2d, NEIGHBOR, packed=True, backend=FUSED)
    pairs_2d = sum(len(p) for p in plan_2d.halo.perms)
    y2p, y2p_rank, by_path["plan_rounds2d_r4"] = forward(pg_2d, plan_2d)
    check_launches("3d plan", "the rounds2d R=4 packed forward", by_path["plan_rounds2d_r4"],
                   {sa.KERNEL: 4 * layers, hp.PACK: layers, hp.UNPACK: layers * pairs_2d})
    y2d, y2d_rank, c2d = forward(pg_2d, NMPPlan.build(pg_2d, NEIGHBOR, backend=FUSED))
    check_launches("3d plan", "the rounds2d R=4 dense forward", c2d, {sa.KERNEL: 4 * layers})
    err_2, ok_2 = within_band(y2p, y1)
    same_2 = np.array_equal(y2p_rank, y2d_rank)
    say("3d plan", f"rounds2d, (2, 2) grid ({len(plan_2d.halo.rounds2d)} rounds, "
        f"{pairs_2d} flat pairs, diagonals in two hops), stacked: packed vs fused R=1 "
        f"max|err| {err_2:.3g} (rtol {RTOL} atol {ATOL}); packed == dense bitwise: "
        f"{same_2} -> {'ok' if ok_2 and same_2 else 'FAIL'}")
    if not (ok_2 and same_2):
        raise RuntimeError("rounds2d disagrees with R=1 or dense with packed")

    # (b-e) over 4 gloo processes sharing the card
    t0 = time.perf_counter()
    job = cons.Job(elements=CONS_ELEMS, order=ORDER, cfg=cfg, device="cuda",
                   backends=(FUSED,), modes=("packed", "packed_bf16"),
                   cases=((CONS_GRID, 1),), forms=True, tune=cfg.hidden,
                   partitioner="spectral")
    procs = cons.run_world(job, 4)
    wall = time.perf_counter() - t0
    case = cons.case_name(CONS_GRID, 1)
    recs = [p[case] for p in procs]
    perms_s = packed(pg_s).halo.perms
    bitwise, sums = {}, {}
    for mode, want_rank in (("packed", ys4_rank), ("packed_bf16", ysw_rank)):
        steps = [r["steps"][(FUSED, mode)] for r in recs]
        bitwise[mode] = all(np.array_equal(s["pred"][0, 0], want_rank[r["rank"]])
                            for s, r in zip(steps, recs))
        for r, s in zip(recs, steps):
            into = _pairs_into(perms_s, r["rank"])
            check_launches("3d plan", f"process {r['rank']}'s {mode} forward",
                           s["fwd_launches"], {sa.KERNEL: layers, hp.PACK: layers,
                                               hp.UNPACK: layers * into})
            check_launches("3d plan", f"process {r['rank']}'s {mode} gradient run",
                           s["grad_launches"], {sa.KERNEL: layers, sa.KERNEL_BWD: layers,
                                                hp.PACK: 2 * layers,
                                                hp.UNPACK: 2 * layers * into})
        sums[mode] = _sum_counts(s["fwd_launches"] for s in steps)
    step_fp = [r["steps"][(FUSED, "packed")] for r in recs]
    step_bf = [r["steps"][(FUSED, "packed_bf16")] for r in recs]
    line = cons.check_step(step_fp, (l1, [t.cpu().numpy() for t in _leaves(g1)]),
                           "packed", w_rel=W_REL)
    half = all(2 * b["fwd_staged_bytes"] == f["fwd_staged_bytes"]
               and 2 * b["fwd_sent_bytes"] == f["fwd_sent_bytes"] > 0
               for f, b in zip(step_fp, step_bf))
    bf_rel = abs(float(step_bf[0]["loss"]) - l1) / abs(l1)
    good = all(bitwise.values()) and half
    say("3d plan", f"4 gloo processes on one card, spectral {CONS_GRID}: each rank's "
        f"packed forward bitwise its stacked slice, fp32 wire {bitwise['packed']}, bf16 "
        f"wire {bitwise['packed_bf16']} | {line} | bf16 wire: loss rel to R=1 {bf_rel:.2e}, "
        f"bytes staged per forward (rank 0) fp32 {step_fp[0]['fwd_staged_bytes']} / bf16 "
        f"{step_bf[0]['fwd_staged_bytes']}, handed to gloo {step_fp[0]['fwd_sent_bytes']} / "
        f"{step_bf[0]['fwd_sent_bytes']} (exactly half on every process: {half}); "
        f"launches per process exact, bf16 as fp32 -> {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("the distributed spectral / bf16-wire forward disagrees")
    by_path["plan_dist_spectral"], by_path["plan_dist_bf16_wire"] = \
        sums["packed"], sums["packed_bf16"]

    # every exchange form over gloo against the stacked emulator on the card
    parts = cons.form_partitions(sem)
    graphs = {k: ShardedGraph.build(pg, sem.coords, NMPPlan.build(pg, NEIGHBOR, packed=True),
                                    device=dev) for k, pg in parts.items()}
    form_ok, max_counts, r2d_counts = [], [], []
    for name, (part, _, is_packed, _, combine) in cons.FORMS.items():
        pg = parts[part]
        spec = cons.form_spec(pg, name)
        a = torch.from_numpy(cons.seeded(6, (4, pg.n_pad, cfg.hidden))
                             * pg.node_mask[..., None]).to(dev)
        with torch.no_grad():
            want = halo_sync_stacked(a, graphs[part], spec, combine=combine).cpu().numpy()
        same = all(np.array_equal(r["forms"][name]["out"], want[r["rank"]]) for r in recs)
        for r in recs:
            got = r["forms"][name]["launches"]
            exp = ({hp.PACK: 1, hp.UNPACK: _pairs_into(spec.perms, r["rank"])}
                   if is_packed and combine == "sum" else {})
            check_launches("3d plan", f"process {r['rank']}'s {name} exchange", got, exp)
        if combine == "max":
            max_counts += [r["forms"][name]["launches"] for r in recs]
        if part == "2d" and is_packed and combine == "sum":
            r2d_counts += [r["forms"][name]["launches"] for r in recs]
        form_ok.append((name, same))
    bad = [n for n, s in form_ok if not s]
    say("3d plan", f"every exchange form over the 4 processes (a2a, neighbor, packed, "
        f"rounds2d, packed rounds2d; fp32 / bf16 wire; sum / max; H={cfg.hidden}) bitwise "
        f"the stacked emulator's rank slice: {len(form_ok) - len(bad)}/{len(form_ok)}; "
        f"max: no pack / unpack-add launch; packed sum: one pack and one unpack-add per "
        f"round received -> {'ok' if not bad else 'FAIL ' + str(bad)}")
    if bad:
        raise RuntimeError(f"exchange forms disagree with the stacked emulator: {bad}")
    by_path["plan_dist_forms_max"] = _sum_counts(max_counts)
    by_path["plan_dist_forms_rounds2d"] = _sum_counts(r2d_counts)

    # the measured tuner over the processes
    tunes = [r["tune"] for r in recs]
    table = tunes[0]["table"]
    picks = {t["pick"] for t in tunes} | {t["pick_again"] for t in tunes}
    argmin = min(table, key=table.get)
    again = [t["launches_again"] for t in tunes]
    # 2 schedules x 3 mode labels (2 without the kernels) x 2 wires
    n_cands = 2 * (3 if torch.cuda.is_available() else 2) * 2
    good = (len(picks) == 1 and tunes[0]["pick"] == argmin and len(table) == n_cands
            and not any(again) and all("table" not in t for t in tunes[1:]))
    rows = sorted(table.items(), key=lambda kv: kv[1])
    say("3d plan", f"{smi} | tuner at hidden {cfg.hidden} on the spectral R=4 split "
        f"(the lead measures one stacked NMP layer per candidate, min of 20 after a "
        f"warm-up, and broadcasts): " + ", ".join(
            f"{s}/{m}/{w or 'fp32'} {1e3 * t:.3f} ms" for (s, m, w), t in rows)
        + f" | pick {tunes[0]['pick']} (argmin: {tunes[0]['pick'] == argmin}), the same "
        f"on all 4 processes: {len(picks) == 1}; the lead's tune {tunes[0]['seconds']:.1f} "
        f"s; a second autotune launched {again} -> {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("the multi-process tuner did not resolve one argmin triple")
    by_path["plan_tuner"] = tunes[0]["launches"]
    say("3d plan", f"spawn + all of the gloo checks {wall:.1f} s")

    # (f) the training CLI: auto schedule, spectral split, 4 processes
    t0 = time.perf_counter()
    argv = ["--elements", *map(str, CONS_ELEMS), "--order", str(ORDER), "--ranks", "2",
            "2", "1", "--model", "large", "--mp-schedule", "auto", "--partitioner",
            "spectral", "--halo", "neighbor", "--steps", str(PLAN_TRAIN_STEPS),
            "--batch", "1", "--device", "cuda"]
    hist = train_cli.main(argv)
    cli_s = time.perf_counter() - t0
    tcfg = TrainConfig(n_steps=1, batch=1, lr=2e-3, halo_mode="neighbor",
                       plan=NMPPlan(backend=FUSED))
    one = train_consistent_gnn(pg_1, sem, cfg, tcfg, device="cuda")["losses"][0]
    rel = abs(hist["losses"][0] - one) / abs(one)
    good = (rel <= LOSS_REL and np.all(np.isfinite(hist["losses"]))
            and hist["schedule"] in ("blocking", "overlap"))
    say("3d plan", f"{smi} | python -m repro_torch.launch.train {' '.join(argv)}: losses "
        f"{[round(v, 6) for v in hist['losses']]}, schedule auto resolved to "
        f"{hist['schedule']}, step 0 vs an R=1 block run {one:.8g} (rel {rel:.2e}, band "
        f"{LOSS_REL}); {cli_s:.1f} s with the spawn, the 4 spectral bisections and the "
        f"tune -> {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("the auto / spectral training CLI disagrees with R=1")
    torch.cuda.empty_cache()
    say("3d plan", f"phase 3d {time.perf_counter() - t_phase:.1f} s")
    return by_path


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
    SERVE_RATES["fp32"] = N_REQUESTS / wall
    say("4 serve", f"large config on {SERVE_ELEMS} p={ORDER} ({sem.n_nodes} nodes): "
        f"{N_REQUESTS} requests, K={ROLLOUT_K}, {BATCH_SLOTS} slots, "
        f"{st['batches']} batches: streamed == offline bitwise for all | "
        f"launches on the stream: {launches}")
    say("4 serve", f"latency p50 {np.percentile(lat, 50):.1f} ms, p95 "
        f"{np.percentile(lat, 95):.1f} ms, {N_REQUESTS / wall:.2f} req/s | peak "
        f"device memory {peak / 2**30:.2f} GiB | host graph build {build_s:.1f} s | "
        f"{smi}")
    return engine, mesh_hash, launches, ckdir


def phase_serve_bf16(cfg, sem, engine, mesh_hash, ckdir, smi):
    """Phase 4 on a bf16 plan: a second engine over the same checkpoint
    and mesh with ``NMPPlan(backend="fused", precision="bf16")``,
    BF_REQUESTS streamed requests, each bitwise equal to its offline
    reference; launches exactly batches x slots x K x M of the bf16
    kernel and none of the fp32 one; the first rollout step's distance
    from the fp32 engine's reported, and the fp32 engine's rate from
    phase_serve's stream beside the bf16 one's.  Returns the stream's
    launches."""
    import torch
    from repro_torch.core.graph_state import FUSED, NMPPlan
    from repro_torch.core.mesh_gen import taylor_green_velocity
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as sa
    from repro_torch.runtime.engine import EngineConfig, InferenceEngine

    bf = InferenceEngine(
        ckdir, cfg, EngineConfig(batch_slots=BATCH_SLOTS, rollout_steps=ROLLOUT_K),
        plan=NMPPlan(backend=FUSED, precision=BF16), device="cuda")
    h = bf.register_mesh(sem)
    if h != mesh_hash or bf.entry(h).plan.precision != BF16:
        raise RuntimeError("the bf16 engine's mesh or plan")
    bf.warmup()
    torch.cuda.synchronize()

    def snapshot(step):
        return taylor_green_velocity(sem.coords, t=(step * DT) % 2.0).astype(np.float32)

    with bf:
        build.reset_launch_counts()
        t0 = time.perf_counter()
        results = dict(bf.stream(h, snapshot, BF_REQUESTS, n_producers=2))
        wall = time.perf_counter() - t0
        launches = dict(build.launch_counts)
    st = bf.stats
    want = {sa.KERNEL_BF16: st["batches"] * BATCH_SLOTS * ROLLOUT_K * cfg.n_mp_layers}
    check_launches("4 serve", "the bf16 engine's stream", launches, want)
    if len(results) != BF_REQUESTS:
        raise RuntimeError(f"bf16 engine served {len(results)} of {BF_REQUESTS} requests")
    for step, res in results.items():
        if res.preds.shape != (ROLLOUT_K, sem.n_nodes, cfg.node_out) \
                or not np.isfinite(res.preds).all():
            raise RuntimeError(f"bf16 request {step}: bad prediction {res.preds.shape}")
        if not np.array_equal(res.preds, bf.offline_reference(h, snapshot(step))):
            raise RuntimeError(f"bf16 request {step}: streamed != offline reference")
    step = min(results)
    got = torch.from_numpy(results[step].preds[0])
    fp32 = torch.from_numpy(engine.offline_reference(mesh_hash, snapshot(step))[0])
    lat = np.array([r.latency_s for r in results.values()]) * 1e3
    say("4 serve", f"bf16 plan, large config on {SERVE_ELEMS} p={ORDER}: {BF_REQUESTS} "
        f"requests, K={ROLLOUT_K}, {BATCH_SLOTS} slots, {st['batches']} batches: streamed "
        f"== offline bitwise for all | rollout step 0 vs the fp32 engine: rel L2 "
        f"{rel_norm(got, fp32):.2e}, max|err| {float((got - fp32).abs().max()):.3g} | "
        f"latency p50 {np.percentile(lat, 50):.1f} ms, {BF_REQUESTS / wall:.2f} req/s "
        f"(the fp32 engine's stream above: "
        + (f"{SERVE_RATES['fp32']:.2f} req/s" if "fp32" in SERVE_RATES else "not run here")
        + f") | {smi}")
    del bf
    torch.cuda.empty_cache()
    return launches


# phase 4b: the serving mesh split (2,2,1) over 4 gloo processes sharing
# the card, packed neighbor, fused; both schedules (overlap first)
SERVE_GRID, SERVE_SCHEDULES = (2, 2, 1), ("overlap", "blocking")
SERVE_BAND = (3e-4, 1e-5)            # tests/drivers/serve_driver.py:125
# at later rollout steps the large config's random weights amplify fp32
# noise past that band between any two correct paths (R=1 plain vs fused:
# 63,923 elements outside at step 1): a later step outside the band is held
# to at most this multiple of the plain backend's distance (max |err| and
# rel L2) from the fused one at R=1
SERVE_DRIFT_FACTOR = 2.0
FOLLOWER_EXIT_S = 60.0               # a follower's return after the lead's stop


def phase_serve_dist(cfg, sem, engine, mesh_hash, ckdir, smi):
    """4b: the engine over 4 gloo processes sharing the card
    (``launch/serve_checks.py`` through ``launch/serve.py::run_world``),
    phase 4's checkpoint and mesh split SERVE_GRID, under each schedule:
    every request bitwise equal to the engine's offline reference, two
    against phase 4's R=1 engine (the first rollout step within
    SERVE_BAND, every step within SERVE_DRIFT_FACTOR of the R=1 plain
    backend's drift), one request's rows of every rank bitwise equal to
    the stacked overlap rollout (``halo_sync_stacked``), a mismatched mesh
    refused by name, a dying producer ending every process, launches per
    process exactly batches x slots x K x M x sides kernel-1 launches (one
    kernel-4 and one kernel-5 per round received per exchange); one
    overlap layer's device time against a blocking one's, by part
    (:func:`overlap_breakdown`); then the serve CLI at ``--ranks 2``.
    Returns the lead's stream launches per schedule."""
    import torch
    from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
    from repro_torch.core.halo import NEIGHBOR, halo_sync_stacked
    from repro_torch.core.partition import (
        gather_node_features, partition_mesh, scatter_node_outputs)
    from repro_torch.core.reference import rollout_stacked
    from repro_torch.launch import serve, serve_checks

    pg = partition_mesh(sem, SERVE_GRID)
    plan = NMPPlan.build(pg, NEIGHBOR, packed=True, backend=FUSED, schedule="overlap")
    pg1 = partition_mesh(sem, (1, 1, 1))
    plain = NMPPlan(backend=XLA)
    g1 = ShardedGraph.build(pg1, sem.coords, plain, device="cuda")
    r1_plain = {}                        # step -> the R=1 plain rollout, scattered

    def plain_rollout(step):
        if step not in r1_plain:
            x = torch.from_numpy(gather_node_features(pg1, serve.snapshot(sem, step)))
            with torch.no_grad():
                _, y = rollout_stacked(engine.params, x.cuda(),
                                       torch.zeros((ROLLOUT_K,) + tuple(x.shape),
                                                   device="cuda"),
                                       g1, plain, cfg.node_out)
            r1_plain[step] = np.stack([scatter_node_outputs(pg1, y[k].cpu().numpy())
                                       for k in range(ROLLOUT_K)])
        return r1_plain[step]
    received = [sum(any(d == r for _, d in perm) for perm in plan.halo.perms)
                for r in range(pg.R)]
    jobs = [serve_checks.CheckJob(ckpt_dir=str(ckdir), elements=SERVE_ELEMS, order=ORDER,
                                  rank_grid=SERVE_GRID, requests=N_REQUESTS,
                                  batch_slots=BATCH_SLOTS, rollout_steps=ROLLOUT_K,
                                  producers=2, backend=FUSED, schedule=sch,
                                  halo_mode=NEIGHBOR, packed=True, device="cuda", keep=2,
                                  rank_preds=1 if sch == "overlap" else 0)
            for sch in SERVE_SCHEDULES]
    say("4b serve R=4", f"4 gloo processes share one card: these times check the "
        f"path and are not a scaling number | {SERVE_ELEMS} p={ORDER} ({sem.n_nodes} "
        f"nodes) split {SERVE_GRID} ({pg.n_pad} padded nodes per rank), large config, "
        f"fused, packed neighbor, {BATCH_SLOTS} slots, K={ROLLOUT_K}, {N_REQUESTS} "
        f"requests from 2 producers, schedules {SERVE_SCHEDULES}")
    t0 = time.perf_counter()
    procs = serve_checks.run_checks(*jobs)
    wall = time.perf_counter() - t0
    launches, M = {}, cfg.n_mp_layers
    for i, sch in enumerate(SERVE_SCHEDULES):
        recs = [p[i] for p in procs]
        lead = recs[0]
        if lead["n"] != N_REQUESTS or not lead["bitwise_offline"]:
            raise RuntimeError(f"{sch}: served {lead['n']} of {N_REQUESTS}, bitwise "
                               f"offline {lead['bitwise_offline']}")
        bands, failed = [], []
        for step, got in lead["preds"].items():
            want = engine.offline_reference(mesh_hash, serve.snapshot(sem, step))
            if got.shape != want.shape or not np.isfinite(got).all():
                raise RuntimeError(f"{sch}: request {step} bad prediction {got.shape}")
            ref = plain_rollout(step)
            for k in range(ROLLOUT_K):
                w = torch.from_numpy(want[k])
                reading = {}
                for name, y in (("R=4", got[k]), ("R=1 plain", ref[k])):
                    y = torch.from_numpy(y)
                    over = (y - w).abs() - SERVE_BAND[1] - SERVE_BAND[0] * w.abs()
                    reading[name] = (float((y - w).abs().max()), rel_norm(y, w),
                                     int((over > 0).sum()))
                (e4, r4, n4), (ep, rp, np_) = reading["R=4"], reading["R=1 plain"]
                ok = n4 == 0 or (k > 0 and e4 <= SERVE_DRIFT_FACTOR * ep
                                 and r4 <= SERVE_DRIFT_FACTOR * rp)
                bands.append(f"request {step} step {k}: R=4 max|err| {e4:.3g}, rel L2 "
                             f"{r4:.3g}, {n4} of {w.numel()} elements outside the band; "
                             f"R=1 plain backend {ep:.3g}, {rp:.3g}, {np_} outside")
                if not ok:
                    failed.append((step, k))
        say("4b serve R=4", f"{sch}: against phase 4's R=1 (fused) engine, band "
            f"{SERVE_BAND} at step 0, later steps in it or within {SERVE_DRIFT_FACTOR}x "
            f"the R=1 plain backend's drift: {'; '.join(bands)} -> "
            f"{'ok' if not failed else 'FAIL'}")
        if failed:
            raise RuntimeError(f"{sch}: requests and steps {failed} outside the band "
                               "or past the plain backend's drift")
        fp_hash, other = engine.fingerprint["mesh_hash"], lead["other_hash"]
        refused = all(fp_hash in r["refused_registration"]
                      and other in r["refused_registration"] for r in recs) \
            and other in lead["refused_submit"] and fp_hash in lead["refused_submit"]
        exits = [r["followed_until"] - lead["died_at"] for r in recs[1:]]
        died = ("producer" in lead["producer_error"] and lead["closed"]
                and lead["drained"] == list(range(serve_checks.DIE_AT))
                and bool(lead["submit_after_close"])
                and max(exits) < FOLLOWER_EXIT_S)
        if not (refused and died):
            raise RuntimeError(f"{sch}: mismatch refused {refused}, dying producer "
                               f"handled {died} (follower exits {exits})")
        sides = 2 if sch == "overlap" else 1
        for w, r in enumerate(recs):
            calls = r["stats"]["batches"] * BATCH_SLOTS * ROLLOUT_K * M
            want = {"nmp_fwd": calls * sides, "halo_pack": calls,
                    "halo_unpack_add": calls * received[w]}
            check_launches("4b serve R=4", f"process {w}'s {sch} batches "
                           f"({r['stats']['batches']})", r["launches"].get("batch", {}),
                           want)
        launches[sch] = lead["stream_launches"]
        tr = lead["transport"]
        lat = lead["latency_ms"]
        say("4b serve R=4", f"{sch}: {N_REQUESTS} requests, {lead['stream_stats']['batches']} "
            f"batches: streamed == offline bitwise for all; mismatched mesh refused by "
            f"name on every process "
            f"and at submit; dying producer: drained {lead['drained']}, engine closed, "
            f"followers returned {max(exits):.2f} s after; lead's stream launches "
            f"{launches[sch]}; exchanges: posted {tr['posted']}, overlapped "
            f"{tr['overlapped']}")
        per_ex = max(tr["posted"], 1)
        say("4b serve R=4", f"{sch}: latency p50 {np.percentile(lat, 50):.1f} ms, p95 "
            f"{np.percentile(lat, 95):.1f} ms, {N_REQUESTS / lead['wall_s']:.2f} req/s | "
            f"host graph build per process {[round(r['build_s'], 2) for r in recs]} s | "
            f"peak device memory per process "
            f"{[round(r['peak_bytes'] / 2**30, 2) for r in recs]} GiB | rank 0 per "
            f"exchange (host): stream sync {1e3 * tr['sync_s'] / per_ex:.3f} ms, staging "
            f"{1e3 * tr['stage_s'] / per_ex:.3f} ms, gloo calls "
            f"{1e3 * tr['wire_s'] / per_ex:.3f} ms, wait_s {1e3 * tr['wait_s'] / per_ex:.3f}"
            f" ms | {smi}")

    # one request's rows of every rank against the stacked overlap rollout
    lead = procs[0][SERVE_SCHEDULES.index("overlap")]
    g = ShardedGraph.build(pg, sem.coords, plan, device="cuda")
    for step, got in lead["rank_preds"].items():
        x = torch.from_numpy(gather_node_features(pg, serve.snapshot(sem, step))).cuda()
        with torch.no_grad():
            _, want = rollout_stacked(engine.params, x,
                                      torch.zeros((ROLLOUT_K,) + tuple(x.shape),
                                                  device="cuda"),
                                      g, plan, cfg.node_out, sync_fn=halo_sync_stacked)
        want = want.cpu().numpy()
        same = [bool(np.array_equal(got[:, r], want[:, r])) for r in range(pg.R)]
        say("4b serve R=4", f"overlap request {step}: each process's rows bitwise equal "
            f"to its rank's slice of the stacked overlap rollout (packed, "
            f"halo_sync_stacked, on the card): {same}")
        if not all(same):
            raise RuntimeError("the served ranks differ from the stacked overlap rollout")
    overlap_breakdown(engine.params, g.rank(0), plan, pg,
                      serve.snapshot(sem, 0), smi)
    del g, g1
    torch.cuda.empty_cache()
    shutil.rmtree(ckdir, ignore_errors=True)

    # the CLI at --ranks 2 on a small mesh, from a bootstrapped checkpoint
    boot = ROOT / "build" / "chip_smoke_boot_r2"
    shutil.rmtree(boot, ignore_errors=True)
    rec = serve.main(["--ckpt-dir", str(boot), "--mesh", "4,4,2", "--p", "2",
                      "--bootstrap-steps", "2", "--requests", "4", "--batch-slots", "2",
                      "--device", "cuda", "--ranks", "2", "--schedule", "overlap",
                      "--halo-mode", "neighbor", "--packed"])
    shutil.rmtree(boot, ignore_errors=True)
    if rec["n"] != 4 or rec["transport"]["overlapped"] != rec["transport"]["posted"]:
        raise RuntimeError(f"serve CLI at --ranks 2: {rec['n']} requests, exchanges "
                           f"{rec['transport']}")
    say("4b serve R=4", f"launch/serve.py --ranks 2 --schedule overlap --packed: "
        f"streamed 4 requests over 2 processes, every exchange overlapped "
        f"({rec['transport']['overlapped']}) | phase wall {time.perf_counter() - t0:.1f} s "
        f"(the 4-process spawn and both schedules {wall:.1f} s)")
    return launches


BREAKDOWN_ITERS = 10
BREAKDOWN_SPIN_MS = 50.0             # the spin kernel the timed calls queue behind


def overlap_breakdown(params, g, plan, pg, snapshot, smi):
    """One NMP layer on one rank's graph ``g`` of the split, without the
    exchange (the sync is the identity): the blocking layer and its kernel
    1 on the full layout, against the overlap layer and its parts (kernel
    1 on each side's layout, the edge join, the aggregate add), and the
    full-size edge add that the join replaced.  Each part's device ms per
    call: BREAKDOWN_ITERS calls queued behind a spin kernel, so they run
    back to back on the card and the events around them hold device time
    alone (the host's enqueue is checked to end inside the spin); beside
    it, ms per call issued back to back without the spin (CUDA events:
    the host's issue time where that is longer)."""
    import dataclasses
    import torch
    from repro_torch import nn
    from repro_torch.core.consistent_mp import (
        edge_update_aggregate, edge_update_aggregate_part, join_sides, nmp_layer)
    from repro_torch.core.gnn import build_edge_inputs
    from repro_torch.core.graph_state import BLOCKING
    from repro_torch.core.partition import gather_node_features

    blocking = dataclasses.replace(plan, schedule=BLOCKING)
    x = torch.from_numpy(gather_node_features(pg, snapshot)[0]).cuda()
    lp = params["mp"][0]
    spin0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    probe = torch.cuda.Event(enable_timing=True)
    probe.record()
    torch.cuda._sleep(1 << 20)
    end.record()
    end.synchronize()
    cycles_per_ms = (1 << 20) / probe.elapsed_time(end)

    def ident(a):
        return a

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        spin0.record()
        torch.cuda._sleep(int(BREAKDOWN_SPIN_MS * cycles_per_ms))
        t0 = time.perf_counter()
        start.record()
        for _ in range(BREAKDOWN_ITERS):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if enqueue_ms >= spin0.elapsed_time(start):
            raise RuntimeError(f"the host took {enqueue_ms:.1f} ms to queue the calls, "
                               "longer than the spin: raise BREAKDOWN_SPIN_MS")
        return start.elapsed_time(end) / BREAKDOWN_ITERS

    def worst_tile(suffix):
        """The most nodes one 128-slot tile of the layout walks."""
        rowptr = g["seg_rowptr" + suffix].cpu().numpy()
        tiles = max(1, -(-int(rowptr[-1]) // 128))
        starts = np.searchsorted(rowptr, np.arange(tiles) * 128)
        return tiles, int(np.diff(np.append(starts, len(rowptr) - 1)).max())
    with torch.no_grad():
        h = nn.mlp(params["node_enc"], x) * g["node_mask"][:, None]
        e = nn.mlp(params["edge_enc"], build_edge_inputs(x, g)) * g["edge_mask"][:, None]
        e_bnd, agg_bnd = edge_update_aggregate_part(lp, h, e, g, "bnd", plan)
        e_int, agg_int = edge_update_aggregate_part(lp, h, e, g, "int", plan)
        scratch = e_int.clone()
        parts = {
            "blocking layer": lambda: nmp_layer(lp, h, e, g, blocking, sync_fn=ident),
            "kernel 1 full layout": lambda: edge_update_aggregate(lp, h, e, g, blocking),
            "overlap layer": lambda: nmp_layer(lp, h, e, g, plan, sync_fn=ident),
            "kernel 1 boundary side": lambda: edge_update_aggregate_part(
                lp, h, e, g, "bnd", plan),
            "kernel 1 interior side": lambda: edge_update_aggregate_part(
                lp, h, e, g, "int", plan),
            "edge join": lambda: join_sides(e_bnd, scratch, g),
            "aggregate add": lambda: agg_bnd + agg_int,
            "full-size edge add (replaced by the join)": lambda: e_bnd + e_int}
        t = {k: (device_ms(fn), cuda_ms(fn, BREAKDOWN_ITERS)) for k, fn in parts.items()}
    n_bnd = int(g["edge_bnd_valid"].sum())
    tiles = {part: worst_tile(suffix) for part, suffix in
             (("full", ""), ("boundary", "_bnd"), ("interior", "_int"))}
    say("4b serve R=4", f"one NMP layer on rank 0 ({g['edge_mask'].shape[0]} edge slots, "
        f"{n_bnd} boundary edges), no exchange, {BREAKDOWN_ITERS} calls each: device "
        "ms per call, queued behind a spin (ms per call issued back to back): "
        + "; ".join(f"{k} {d:.4f} ({c:.4f})" for k, (d, c) in t.items())
        + " | kernel 1's layouts, tiles and the most nodes one tile walks: "
        + ", ".join(f"{k} {n} / {w}" for k, (n, w) in tiles.items()) + f" | {smi}")
    return t


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

    from repro_torch.kernels.segment_agg import ops as sa

    start = init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")

    def train(n_steps, backend=FUSED, mesh=(sem, pg), precision="fp32", **kw):
        tcfg = TrainConfig(n_steps=n_steps, batch=1, lr=TRAIN_LR, halo_mode="none",
                           plan=NMPPlan(backend=backend, precision=precision), **kw)
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

    # --- the bf16 plan (``--mp-precision bf16``): BF_TRAIN_STEPS steps
    #     twice, bitwise, on the bf16 kernels only; the step's CUDA-event
    #     forward and backward ---
    build.reset_launch_counts()
    a = train(BF_TRAIN_STEPS, precision=BF16)
    bf_launches = dict(build.launch_counts)
    check_launches("6 train", f"the {BF_TRAIN_STEPS} bf16 training steps", bf_launches,
                   {sa.KERNEL_BF16: BF_TRAIN_STEPS * cfg.n_mp_layers,
                    sa.KERNEL_BWD_BF16: BF_TRAIN_STEPS * cfg.n_mp_layers})
    b = train(BF_TRAIN_STEPS, precision=BF16)
    same = a["losses"] == b["losses"] and all(
        torch.equal(u, v) for u, v in zip(tree_leaves(a["params"]),
                                          tree_leaves(b["params"])))
    if not same or not np.all(np.isfinite(a["losses"])):
        raise RuntimeError(f"bf16 training not bitwise repeatable or not finite: "
                           f"{a['losses']} vs {b['losses']}")
    bf_step = [1e3 * t for t in a["step_s"]]
    del b
    plan = NMPPlan(backend=FUSED, precision=BF16)
    g = ShardedGraph.build(pg, sem.coords, plan, device="cuda")
    _, loss_step, grad_step, _ = make_gnn_step_fns(cfg, plan)
    xb = torch.from_numpy(make_tgv_batch_fn(pg, sem, 1)(1)).to("cuda")
    params = a["params"]
    t_fwd_bf = cuda_ms(lambda: loss_step(params, xb, xb, g), 3, warmup=1)
    t_grad_bf = cuda_ms(lambda: grad_step(params, xb, xb, g), 3, warmup=1)
    say("6 train", f"bf16 plan, {BF_TRAIN_STEPS} steps twice from the same params: "
        f"losses and params bitwise equal: {same} | losses "
        + ", ".join(f"{v!r}" for v in a["losses"])
        + f" | step time median after step 0 {np.median(bf_step[1:]):.1f} ms (step 0 "
        f"{bf_step[0]:.1f}) | CUDA events: forward + loss {t_fwd_bf:.3f} ms, forward + "
        f"backward {t_grad_bf:.3f} ms (fp32 plan: {t_fwd:.3f} / {t_grad:.3f}) | launches "
        f"{bf_launches}")
    del a, params, g, xb
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
    return launches, roll_launches, bf_launches


# --- phase 6c: checkpoint resilience (crash, save failure, corruption, kill,
#     elastic resume), through kernels 1 and 2 (and 4, 5 at R>1) ---
RES_STEPS, RES_EVERY = 8, 3
RES_CRASH_AT, RES_SAVE_FAIL_AT, RES_KILL_AT = 5, 3, 5
EL_STEPS, EL_EVERY, EL_KILL_AT, EL_GRID = 6, 2, 4, (2, 1, 1)
ELASTIC_RTOL = 1e-4               # tests/drivers/resilience_driver.py:44
CKPT_TIMINGS = 3                  # save / restore timings, median of


def _per_step(cfg, perms=None, rank=0):
    """One training step's launches on one rank: kernels 1 and 2 once per
    layer; under the packed exchange one pack per exchange (forward and
    reversed) and one unpack-add per exchange and round received."""
    from repro_torch.kernels.halo_pack import ops as hp
    from repro_torch.kernels.segment_agg import ops as sa
    M = cfg.n_mp_layers
    want = {sa.KERNEL: M, sa.KERNEL_BWD: M}
    if perms:
        want.update({hp.PACK: 2 * M, hp.UNPACK: 2 * M * _pairs_into(perms, rank)})
    return want


def _times(counts, n):
    return {k: v * n for k, v in counts.items()}


def _np_params(tree):
    from repro_torch.launch.mesh import to_host
    from repro_torch.nn import tree_leaves
    return [np.asarray(a) for a in tree_leaves(to_host(tree))]


def phase_resilience(cfg, sem, pg, smi):
    """Phase 6c (module docstring): resilient training at R=1 on the serving
    mesh against one uninterrupted resilient run, bitwise, through (a) an
    injected crash, (b) a save dying before its COMMIT, (c) a corrupted
    newest shard and (d) a killed process resumed by a fresh one; then an
    elastic resume of a killed 4-process world on 2 processes."""
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core.gnn import init_gnn
    from repro_torch.core.graph_state import FUSED, NMPPlan
    from repro_torch.core.mesh_gen import box_mesh
    from repro_torch.core.partition import partition_mesh
    from repro_torch.kernels import build
    from repro_torch.launch import resilience_checks as rc
    from repro_torch.launch.mesh import to_host
    from repro_torch.runtime.fault_tolerance import FaultPlan, ResilientConfig
    from repro_torch.train.loop import TrainConfig, _init_state, train_consistent_gnn
    from repro_torch.train.optimizer import AdamWConfig, constant_lr

    t_phase = time.perf_counter()
    phase = "6c resilience"
    # phase 6's start params (the same seed)
    start = init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    root = ROOT / "build" / "chip_smoke_resilience"
    shutil.rmtree(root, ignore_errors=True)
    one = _per_step(cfg)
    by_path = {}

    # the elastic case's two gloo worlds (4 processes on the card, 2x2
    # block split, packed neighbor, killed at step EL_KILL_AT; 2 resume at
    # EL_GRID) run in their own processes beside the R=1 cases below: a
    # thread here only spawns them and reads their files
    ejob = rc.ResJob(root=str(root / "elastic"), elements=CONS_ELEMS, order=ORDER,
                     cfg=cfg, grid=CONS_GRID, steps=EL_STEPS,
                     ckpt_every=EL_EVERY, device="cuda",
                     params=to_host(start), kill_at=EL_KILL_AT)
    worlds = {}

    def elastic_worlds():
        try:
            t0 = time.perf_counter()
            worlds["code"] = rc.run_kill(ejob, 4)
            worlds["alive"] = []
            for pid in rc.pids(ejob, 4):
                try:
                    os.kill(pid, 0)
                    worlds["alive"].append(pid)
                except ProcessLookupError:
                    pass
            worlds["ref4"] = rc.read_ref(ejob)
            worlds["killed"] = rc.killed_launches(ejob, 4)
            worlds["recs"] = [p["resume"] for p in rc.run_resume(
                dataclasses.replace(ejob, grid=EL_GRID), 2, cases=("resume",))]
            worlds["seconds"] = time.perf_counter() - t0
        except BaseException as err:  # raised in the phase's own thread below
            worlds["error"] = err

    beside = threading.Thread(target=elastic_worlds, daemon=True)
    beside.start()

    def train(name, fault=None, n_steps=RES_STEPS):
        tcfg = TrainConfig(n_steps=n_steps, batch=1, lr=rc.LR, halo_mode="none",
                           plan=NMPPlan(backend=FUSED),
                           resilience=ResilientConfig(ckpt_dir=str(root / name),
                                                      ckpt_every=RES_EVERY,
                                                      backoff_base=0.001))
        build.reset_launch_counts()
        hist = train_consistent_gnn(pg, sem, cfg, tcfg, params=start, device="cuda",
                                    fault=fault)
        return hist, dict(build.launch_counts)

    t0 = time.perf_counter()
    ref, by_path["res_uninterrupted"] = train("ref")
    t_ref = time.perf_counter() - t0
    check_launches(phase, "the uninterrupted resilient run", by_path["res_uninterrupted"],
                   _times(one, RES_STEPS))
    want_p = _np_params(ref["params"])
    losses = ref["losses"]
    if ref["restarts"] or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"uninterrupted resilient run: {ref['restarts']} restarts, "
                           f"losses {losses}")
    say(phase, f"uninterrupted: large config on {SERVE_ELEMS} p={ORDER} ({sem.n_nodes} "
        f"nodes), R=1, fused, fp32, K=1, batch 1, {RES_STEPS} steps, a checkpoint every "
        f"{RES_EVERY}: {t_ref:.1f} s; losses " + ", ".join(f"{v!r}" for v in losses)
        + f" | checkpoints {ckpt.committed_steps(root / 'ref')}")

    def verdict(case, hist, launches, executed, extra=""):
        same = hist["losses"] == losses and all(
            np.array_equal(a, b) for a, b in zip(_np_params(hist["params"]), want_p))
        say(phase, f"({case}) restarts {hist['restarts']}, restart steps "
            f"{hist['restart_steps']}, resume steps {hist['resume_steps']}{extra} | losses "
            f"and params bitwise the uninterrupted run's: {same} | {executed} steps "
            f"executed, replays included")
        if not same:
            raise RuntimeError(f"({case}) not bitwise: {hist['losses']} vs {losses}")
        check_launches(phase, f"({case})", launches, _times(one, executed))

    # (a) an injected crash before step RES_CRASH_AT: the saver's wait puts
    # step 3 on disk, so steps 0-4 run, then 4-7 again from its restore
    hist, by_path["res_crash"] = train("a", FaultPlan(crash_at_step=RES_CRASH_AT))
    if hist["resume_steps"] != [3]:
        raise RuntimeError(f"(a) resumed from {hist['resume_steps']}, expected [3]")
    verdict("a crash", hist, by_path["res_crash"],
            RES_CRASH_AT + RES_STEPS - (hist["resume_steps"][0] + 1))

    # (b) the save of step RES_SAVE_FAIL_AT dies before its COMMIT; the
    # error surfaces at the next save (after step 6 ran), restore falls back
    hist, by_path["res_save_fail"] = train("b", FaultPlan(
        crash_save_at_step=RES_SAVE_FAIL_AT, save_stage="pre_commit"))
    if hist["restarts"] != 1 or hist["resume_steps"][0] >= RES_SAVE_FAIL_AT:
        raise RuntimeError(f"(b) did not fall back past step {RES_SAVE_FAIL_AT}: {hist}")
    verdict("b save dies at pre_commit", hist, by_path["res_save_fail"],
            hist["restart_steps"][0] + 1 + RES_STEPS - (hist["resume_steps"][0] + 1))

    # (c) 5 steps, the newest committed shard corrupted, then a resume that
    # falls back to the step before it
    first, c1 = train("c", n_steps=5)
    newest = ckpt.latest_step(root / "c")
    FaultPlan.corrupt_shard(root / "c", newest)
    hist, c2 = train("c")
    by_path["res_corrupt"] = _sum_counts([c1, c2])
    if hist["resume_steps"][0] >= newest:
        raise RuntimeError(f"(c) resumed from the corrupted step {newest}")
    verdict("c corrupted shard", hist, by_path["res_corrupt"],
            5 + RES_STEPS - (hist["resume_steps"][0] + 1),
            f" (step {newest} corrupted)")

    # (d) one process os._exits at step RES_KILL_AT; a fresh one (kernels
    # loaded cold, TF32 off) resumes from disk
    job = rc.ResJob(root=str(root / "d"), elements=SERVE_ELEMS, order=ORDER, cfg=cfg,
                    grid=(1, 1, 1), halo_mode="none", packed=False,
                    steps=RES_STEPS, ckpt_every=RES_EVERY, device="cuda",
                    params=to_host(start), kill_ref=False, kill_at=RES_KILL_AT)
    t0 = time.perf_counter()
    code = rc.run_kill(job, 1)
    killed = rc.killed_launches(job, 1)[0]
    rec = rc.run_resume(job, 1, cases=("resume",))[0]["resume"]
    t_d = time.perf_counter() - t0
    if code != rc.KILL_EXIT:
        raise RuntimeError(f"(d) the killed process exited {code}, not {rc.KILL_EXIT}")
    check_launches(phase, "(d) the killed process", killed, _times(one, RES_KILL_AT))
    by_path["res_kill"] = _sum_counts([killed, rec["launches"]])
    verdict("d killed process, fresh process resumes", rec, by_path["res_kill"],
            RES_KILL_AT + RES_STEPS - (rec["resume_steps"][0] + 1),
            f" (exit {code}; both processes {t_d:.1f} s)")

    beside.join()
    if "error" in worlds:
        raise RuntimeError("the elastic case's gloo worlds failed") from worlds["error"]

    # checkpoint save (sync, async) and restore of the large config's state
    opt_cfg = AdamWConfig(schedule=constant_lr(rc.LR), weight_decay=0.0)
    tcfg = TrainConfig(n_steps=RES_STEPS, batch=1, lr=rc.LR)
    state = _init_state(cfg, tcfg, opt_cfg, params=ref["params"], device="cuda")
    n_bytes = sum(a.nbytes for a in ckpt._flatten(to_host(state)).values())
    sync_ms, async_ms, async_total_ms, restore_ms = [], [], [], []
    for i in range(CKPT_TIMINGS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(root / "timing_sync", i, state)
        sync_ms.append(1e3 * (time.perf_counter() - t0))
        saver = ckpt.AsyncCheckpointer(root / "timing_async")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(i, state)
        async_ms.append(1e3 * (time.perf_counter() - t0))
        saver.wait()
        async_total_ms.append(1e3 * (time.perf_counter() - t0))
        template = _init_state(cfg, tcfg, opt_cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = ckpt.restore(root / "timing_sync", template, step=i)
        torch.cuda.synchronize()
        restore_ms.append(1e3 * (time.perf_counter() - t0))
    if not all(np.array_equal(a, b) for a, b in zip(_np_params(got["params"]), want_p)):
        raise RuntimeError("the timed restore is not the saved state")
    say(phase, f"checkpoint of the large config's state ({n_bytes} B: params, AdamW "
        f"moments, step, key), host clock, median of {CKPT_TIMINGS}: sync save "
        f"{np.median(sync_ms):.3f} ms | async save returns after {np.median(async_ms):.3f} "
        f"ms (the owned host snapshot), written after {np.median(async_total_ms):.3f} ms | "
        f"restore onto the card {np.median(restore_ms):.3f} ms | {smi}")

    # elastic: the worlds' records against an uninterrupted R=1 run here
    code, alive, ref4, killed, recs = (worlds[k] for k in ("code", "alive", "ref4",
                                                            "killed", "recs"))
    if code != rc.KILL_EXIT or alive:
        raise RuntimeError(f"the killed world exited {code}; processes left: {alive}")
    csem = box_mesh(CONS_ELEMS, p=ORDER)
    r1 = rc.train(dataclasses.replace(ejob, grid=(1, 1, 1), halo_mode="none",
                                      packed=False),
                  csem, partition_mesh(csem, (1, 1, 1)), root / "elastic_r1")
    el = recs[0]["elastic"]
    s = el["step"] if el else None
    if not el or el["from_ranks"] != 4 or el["to_ranks"] != 2:
        raise RuntimeError(f"elastic record: {el}")
    plan4 = NMPPlan.build(partition_mesh(csem, CONS_GRID), "neighbor", packed=True)
    plan2 = NMPPlan.build(partition_mesh(csem, EL_GRID), "neighbor", packed=True)
    for r in range(4):
        check_launches(phase, f"the killed R=4 run, process {r}", killed[r],
                       _times(_per_step(cfg, plan4.halo.perms, r), EL_KILL_AT))
    check_launches(phase, "the uninterrupted R=4 run, process 0", ref4["launches"],
                   _times(_per_step(cfg, plan4.halo.perms, 0), EL_STEPS))
    for r, rec in enumerate(recs):
        check_launches(phase, f"the R=2 resume, process {r}", rec["launches"],
                       _times(_per_step(cfg, plan2.halo.perms, r), EL_STEPS - s))
    by_path["res_elastic_r4"] = _sum_counts(killed)
    by_path["res_elastic_r2"] = _sum_counts([rec["launches"] for rec in recs])
    got = recs[0]["losses"]
    prefix = got[:s] == ref4["losses"][:s] and all(rec["losses"] == got for rec in recs)
    dev = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(got, r1["losses"])]
    same = all(np.array_equal(a, b) for a, b in zip(_np_params(recs[0]["params"]),
                                                     _np_params(recs[1]["params"])))
    say(phase, f"elastic: {CONS_ELEMS} p={ORDER} ({csem.n_nodes} nodes), {EL_STEPS} "
        f"steps, a checkpoint every {EL_EVERY}, 4 gloo processes (2x2, packed neighbor) "
        f"killed at step {EL_KILL_AT} (exit {code}, none left), 2 resume at {EL_GRID} "
        f"from step {s}: elastic {el['from_ranks']} -> {el['to_ranks']} | restored "
        f"prefix bitwise the R=4 run's: {prefix} | every step within "
        f"{ELASTIC_RTOL} of an uninterrupted R=1 run: max {max(dev):.2e} | params "
        f"bitwise on both processes: {same} | R=4 losses "
        + ", ".join(f"{v!r}" for v in ref4["losses"]) + " | resumed "
        + ", ".join(f"{v!r}" for v in got) + f" | both worlds {worlds['seconds']:.1f} s "
        "(beside cases a-d)")
    if not prefix or max(dev) > ELASTIC_RTOL or not same:
        raise RuntimeError("the elastic resume failed its checks")
    shutil.rmtree(root, ignore_errors=True)
    say(phase, f"phase {time.perf_counter() - t_phase:.1f} s")
    return by_path


# --- phase 6b: the multilevel V-cycle (``--levels``), at full width ---
ML_LEVELS, ML_COARSE_LAYERS = 3, 2       # box_mesh((16,16,8), p=7): 727,833 -> 2,048 -> 256
ML_REQUESTS, ML_TRAIN_STEPS = 8, 3
# repro's multilevel bands (tests/test_multilevel.py:184-188): loss,
# predictions, gradients (a weight gradient summed over every edge is held
# to W_REL by its relative L2 norm where its elements cancel, as in 3b)
ML_LOSS, ML_RTOL, ML_ATOL, ML_G_RTOL, ML_G_ATOL = 2e-6, 3e-5, 5e-6, 2e-3, 2e-5
# fused against plain at full width: the loss in PERF.md section 2's
# fused-vs-plain band (phase 6's training losses); gradients in G_RTOL /
# G_ATOL, or W_REL by relative L2 (grads_close), as in phase 3b
ML_FUSED_LOSS_REL = 1e-4


def ml_config(cfg):
    """``cfg`` with the V-cycle: 3 levels, 2 NMP layers per coarse level,
    4 coarse edge features (the training CLI's ``--levels 3``)."""
    return dataclasses.replace(cfg, n_levels=ML_LEVELS, coarse_mp_layers=ML_COARSE_LAYERS,
                               coarse_edge_in=4)


class LevelLaunches:
    """Kernel launches of each level of a multilevel graph over a run.

    Wraps functions that run one level's work, each given that level's
    graph at argument ``pos`` (an NMP layer, an exchange): the launch
    counters' growth inside the outermost wrapped call goes to the level
    whose padded node count the graph has (levels are told apart by it).
    ``targets``: (module, attribute, pos) to patch while the context is
    open; :meth:`wrap` wraps a function passed by hand.  Backward launches
    (autograd, after the forward) are outside every call and not counted."""

    def __init__(self, graph, targets=()):
        self.n_pads = [int(l["node_mask"].shape[-1]) for l in graph.levels]
        if len(set(self.n_pads)) != len(self.n_pads):
            raise RuntimeError(f"levels share a padded node count: {self.n_pads}")
        self.targets, self.tally, self.depth = targets, [{} for _ in self.n_pads], 0

    def wrap(self, fn, pos):
        from repro_torch.kernels import build

        def inner(*a, **k):
            lvl = self.n_pads.index(int(a[pos]["node_mask"].shape[-1]))
            before, self.depth = dict(build.launch_counts), self.depth + 1
            try:
                return fn(*a, **k)
            finally:
                self.depth -= 1
                if self.depth == 0:
                    for key, v in build.launch_counts.items():
                        if v != before.get(key, 0):
                            t = self.tally[lvl]
                            t[key] = t.get(key, 0) + v - before.get(key, 0)
        return inner

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.targets]
        for m, n, pos in self.targets:
            setattr(m, n, self.wrap(getattr(m, n), pos))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)
        return False


def ml_expected(plan, cfg, R, overlap=False, times=1):
    """Each level's exact launches of ``times`` forwards over R stacked
    ranks (or one rank's, R=1 with its plan): kernel 1 once per rank and
    layer (twice under overlap), and per exchange of a packed plan one pack
    and one unpack-add per round and receiver.  Level 0 runs the M layers'
    exchanges and level 1's prolongation; level l >= 1 its restriction, its
    C layers' and (below the top) level l+1's prolongation."""
    L, M, C = cfg.n_levels, cfg.n_mp_layers, cfg.coarse_mp_layers
    out = []
    for lvl, spec in enumerate(plan.halos(L)):
        layers = M if lvl == 0 else C
        n_ex = M + 1 if lvl == 0 else 1 + C + (1 if lvl < L - 1 else 0)
        want = {"nmp_fwd": times * R * layers * (2 if overlap else 1)}
        if spec.packed and spec.mode != "none" and spec.perms:
            want["halo_pack"] = times * n_ex
            want["halo_unpack_add"] = times * n_ex * sum(len(p) for p in spec.perms)
        out.append(want)
    return out


def ml_process_expected(plan, cfg, rank, overlap):
    """One process's launches of a forward and of a gradient run: kernel 1
    per layer (per side under overlap), kernel 2 as often in the gradient
    run, one pack per exchange (each reversal too), one unpack-add per
    round this rank receives in."""
    L, M, C = cfg.n_levels, cfg.n_mp_layers, cfg.coarse_mp_layers
    layers = (M + (L - 1) * C) * (2 if overlap else 1)
    packs = unpacks = 0
    for lvl, spec in enumerate(plan.halos(L)):
        n_ex = M + 1 if lvl == 0 else 1 + C + (1 if lvl < L - 1 else 0)
        packs += n_ex
        unpacks += n_ex * sum(1 for p in spec.perms if any(d == rank for _, d in p))
    fwd = {"nmp_fwd": layers, "halo_pack": packs, "halo_unpack_add": unpacks}
    grad = {"nmp_fwd": layers, "nmp_bwd": layers, "halo_pack": 2 * packs,
            "halo_unpack_add": 2 * unpacks}
    return fwd, grad


def check_level_launches(phase, path, tally, want):
    for lvl, (got, w) in enumerate(zip(tally, want)):
        check_launches(phase, f"{path}, level {lvl}", got, w)


def phase_multilevel(cfg, smi):
    """The multilevel V-cycle (``GNNConfig(n_levels=3, coarse_mp_layers=2)``
    on the large config) on the card:
    (a) one forward on the serving mesh (727,833 -> 2,048 -> 256 nodes),
        kernel 1 against the plain backend in the forward band, launches
        exact per level; CUDA-event forward with and without the V-cycle;
        one loss and gradient, kernels 1 and 2 against the plain backend
        in the gradient band, launches exact (kernel 1 per level);
    (b) the engine with ``register_mesh(hierarchy=)``: ML_REQUESTS streamed
        Taylor-Green requests, 4 slots, K=2, each bitwise equal to its
        offline reference; launches exact per level;
    (c) ML_TRAIN_STEPS steps of ``launch/train.py --levels 3
        --coarse-mp-layers 2 --model large`` at R=1, run twice, bitwise;
        median step, CUDA-event forward + backward, the transfers' device
        time, one step under torch.profiler;
    (d) the consistency mesh split 2x2 (R=4) through the stacked emulator,
        packed neighbor, both schedules: values and gradients against R=1
        within repro's multilevel bands, launches of kernels 1, 4, 5 exact
        per level (forward) and of 1, 2, 4, 5 in total (gradient run);
    (e) the same split through 4 gloo processes on the card, every rank's
        prediction bitwise its slice of (d)'s stacked forward, loss and
        gradients within the bands of (d)'s R=1, launches and exchanges
        per process exact.
    Returns each path's launches."""
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core import consistent_mp, gnn, reference
    from repro_torch.core.coarsen import build_hierarchy
    from repro_torch.core.distributed import make_gnn_step_fns
    from repro_torch.core.gnn import gnn_forward, init_gnn
    from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
    from repro_torch.core.halo import NEIGHBOR, NONE, halo_sync_stacked
    from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
    from repro_torch.core.partition import gather_node_features, scatter_node_outputs
    from repro_torch.core.reference import gnn_forward_stacked, loss_and_grad_stacked
    from repro_torch.kernels import build
    from repro_torch.launch import consistency as cons
    from repro_torch.launch import train as train_cli
    from repro_torch.nn import tree_leaves
    from repro_torch.runtime.engine import EngineConfig, InferenceEngine
    from repro_torch.train.loop import TrainConfig, make_tgv_batch_fn, run_fingerprint

    P = "6b multilevel"
    mcfg = ml_config(cfg)
    dev = torch.device("cuda")
    paths = {}
    sem = box_mesh(SERVE_ELEMS, p=ORDER)
    t0 = time.perf_counter()
    ml = build_hierarchy(sem, (1, 1, 1), ML_LEVELS)
    host_s = time.perf_counter() - t0
    pg = ml.levels[0]
    params = init_gnn(torch.Generator().manual_seed(0), mcfg, device=dev)
    layer_patches = ((gnn, "nmp_layer", 3), (consistent_mp, "nmp_layer", 3))

    # --- (a) one forward, fused against plain; the V-cycle's share ---
    plan, plain = NMPPlan(backend=FUSED), NMPPlan(backend=XLA)
    t0 = time.perf_counter()
    gs = ShardedGraph.build(pg, sem.coords, plan, device=dev, hierarchy=ml)
    build_s = time.perf_counter() - t0
    g = gs.rank(0)
    x, xt = (torch.from_numpy(gather_node_features(
        pg, taylor_green_velocity(sem.coords, t=t))[0]).to(dev) for t in (0.0, DT))
    slots = [int(l["node_mask"].shape[0]) for l in g.levels]
    edges = [int(l["edge_mask"].sum()) for l in g.levels]
    m_pad = [t.m_pad for t in ml.transfers]
    with torch.no_grad():
        build.reset_launch_counts()
        with LevelLaunches(g, layer_patches) as lv:
            y = gnn_forward(params, x, g, plan)
            torch.cuda.synchronize()
        paths["ml_fwd"] = dict(build.launch_counts)
        check_level_launches(P, "(a) the R=1 forward", lv.tally,
                             ml_expected(plan, mcfg, 1))
        gxs = ShardedGraph.build(pg, sem.coords, plain, device=dev, hierarchy=ml)
        gx = gxs.rank(0)
        yx = gnn_forward(params, x, gx, plain)
        err, ok = within_band(y, yx)
        flat = {k: v for k, v in params.items() if k != "coarse"}
        t_ml = cuda_ms(lambda: gnn_forward(params, x, g, plan), 5)
        t_flat = cuda_ms(lambda: gnn_forward(flat, x, g, plan), 5)
        t_plain = cuda_ms(lambda: gnn_forward(params, x, gx, plain), 2, 1)
        prof_ml = profile_line(lambda: gnn_forward(params, x, g, plan))
        prof_flat = profile_line(lambda: gnn_forward(flat, x, g, plan))
    finite = bool(torch.isfinite(y).all()) and tuple(y.shape) == (pg.n_pad, cfg.node_out)
    say(P, f"large config, {ML_LEVELS} levels, {ML_COARSE_LAYERS} NMP layers per coarse "
        f"level, on {SERVE_ELEMS} p={ORDER}: nodes per level {ml.level_sizes()} (padded "
        f"{slots}), edges {edges}, transfer slots {m_pad}; host hierarchy {host_s:.1f} s, "
        f"graph {build_s:.1f} s")
    say(P, f"(a) R=1 forward, fused vs plain backend: max|err| {err:.3g} (rtol {RTOL} "
        f"atol {ATOL}), finite, shape {tuple(y.shape)} -> "
        f"{'ok' if ok and finite else 'FAIL'} | CUDA events: forward {t_ml:.3f} ms, the "
        f"same without the V-cycle {t_flat:.3f} ms (V-cycle {t_ml - t_flat:.3f} ms), plain "
        f"backend {t_plain:.3f} ms | {smi}")
    say(P, f"(a) the forward {prof_ml}")
    say(P, f"(a) without the V-cycle {prof_flat}")
    if not (ok and finite):
        raise RuntimeError("multilevel forward: fused != plain, or not finite")
    del gx, yx
    torch.cuda.empty_cache()

    # --- (a) the gradient, fused against plain: kernel 2 on every level ---
    layers = mcfg.n_mp_layers + (ML_LEVELS - 1) * ML_COARSE_LAYERS
    build.reset_launch_counts()
    with LevelLaunches(g, ((reference, "_smooth_stacked", 3),)) as lv:
        lf, _, gf = loss_and_grad_stacked(params, x[None], xt[None], gs, plan,
                                          cfg.node_out)
        torch.cuda.synchronize()
    paths["ml_grad"] = dict(build.launch_counts)
    check_level_launches(P, "(a) the R=1 gradient run's forward", lv.tally,
                         ml_expected(plan, mcfg, 1))
    check_launches(P, "(a) the R=1 gradient run", paths["ml_grad"],
                   {"nmp_fwd": layers, "nmp_bwd": layers})
    lp, _, gp = loss_and_grad_stacked(params, x[None], xt[None], gxs, plain, cfg.node_out)
    rel = abs(float(lf) - float(lp)) / abs(float(lp))
    g_err, by_norm, g_ok = grads_close(gf, gp)
    ok = g_ok and rel <= ML_FUSED_LOSS_REL and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(gf))
    say(P, f"(a) R=1 gradient, fused vs plain backend: loss {float(lf):.8g} vs "
        f"{float(lp):.8g} (rel {rel:.3g}, band {ML_FUSED_LOSS_REL}) | grads max|err| "
        f"{g_err:.3g} (rtol {G_RTOL} atol {G_ATOL})"
        + (f"; held by rel L2 <= {W_REL}: {by_norm}" if by_norm else "")
        + f" | launches {paths['ml_grad']} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("multilevel gradient: fused != plain, or not finite")
    del gs, gxs, gf, gp, xt
    torch.cuda.empty_cache()

    # --- (b) serving through register_mesh(hierarchy=) ---
    ckdir = ROOT / "build" / "chip_smoke_ml_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    fp = run_fingerprint(sem, pg, mcfg, TrainConfig(), NMPPlan(backend=FUSED))
    ckpt.save(ckdir, 0, {"params": params}, extra={"fingerprint": fp})
    engine = InferenceEngine(
        ckdir, mcfg, EngineConfig(batch_slots=BATCH_SLOTS, rollout_steps=ROLLOUT_K),
        plan=NMPPlan(backend=FUSED), device="cuda")
    mesh_hash = engine.register_mesh(sem, hierarchy=ml)
    reg_s = engine.entry(mesh_hash).build_s
    engine.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def snapshot(step):
        return taylor_green_velocity(sem.coords, t=(step * DT) % 2.0).astype(np.float32)

    with engine, LevelLaunches(g, layer_patches) as lv:
        build.reset_launch_counts()
        t0 = time.perf_counter()
        results = dict(engine.stream(mesh_hash, snapshot, ML_REQUESTS, n_producers=2))
        wall = time.perf_counter() - t0
        paths["ml_serve"] = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    if len(results) != ML_REQUESTS:
        raise RuntimeError(f"served {len(results)} of {ML_REQUESTS} requests")
    for step, res in results.items():
        if res.preds.shape != (ROLLOUT_K, sem.n_nodes, cfg.node_out) \
                or not np.isfinite(res.preds).all():
            raise RuntimeError(f"request {step}: bad prediction {res.preds.shape}")
        if not np.array_equal(res.preds, engine.offline_reference(mesh_hash,
                                                                  snapshot(step))):
            raise RuntimeError(f"request {step}: streamed != offline reference")
    n_fwd = engine.stats["batches"] * BATCH_SLOTS * ROLLOUT_K
    check_level_launches(P, "(b) the served stream", lv.tally,
                         ml_expected(engine.entry(mesh_hash).plan, mcfg, 1, times=n_fwd))
    lat = np.array([r.latency_s for r in results.values()]) * 1e3
    say(P, f"(b) engine, register_mesh(hierarchy=): {ML_REQUESTS} requests, K={ROLLOUT_K}, "
        f"{BATCH_SLOTS} slots, {engine.stats['batches']} batches: streamed == offline "
        f"bitwise for all | latency p50 {np.percentile(lat, 50):.1f} ms, p95 "
        f"{np.percentile(lat, 95):.1f} ms, {ML_REQUESTS / wall:.2f} req/s | peak device "
        f"memory {peak / 2**30:.2f} GiB | host graph build {reg_s:.1f} s | launches "
        f"{paths['ml_serve']} | {smi}")
    del engine
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # --- (c) the training CLI, twice, bitwise; where a step's time goes ---
    argv = ["--device", "cuda", "--elements", *map(str, SERVE_ELEMS), "--order", str(ORDER),
            "--model", "large", "--levels", str(ML_LEVELS), "--coarse-mp-layers",
            str(ML_COARSE_LAYERS), "--steps", str(ML_TRAIN_STEPS), "--batch", "1",
            "--halo", "none"]
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    with LevelLaunches(g, layer_patches) as lv:
        a = train_cli.main(argv)
    paths["ml_train"] = dict(build.launch_counts)
    train_peak = torch.cuda.max_memory_allocated()
    check_level_launches(P, "(c) the training run's forwards", lv.tally,
                         ml_expected(plan, mcfg, 1, times=ML_TRAIN_STEPS))
    layers = ML_TRAIN_STEPS * (mcfg.n_mp_layers + (ML_LEVELS - 1) * ML_COARSE_LAYERS)
    check_launches(P, "(c) the training run", paths["ml_train"],
                   {"nmp_fwd": layers, "nmp_bwd": layers})
    b = train_cli.main(argv)
    same = a["losses"] == b["losses"] and all(
        torch.equal(u, v) for u, v in zip(tree_leaves(a["params"]), tree_leaves(b["params"])))
    if not same or not np.all(np.isfinite(a["losses"])):
        raise RuntimeError(f"multilevel training not bitwise repeatable or not finite: "
                           f"{a['losses']} vs {b['losses']}")
    step_ms = [1e3 * s for s in a["step_s"]]
    del b
    gt = ShardedGraph.build(pg, sem.coords, plan, device=dev, hierarchy=ml)
    _, loss_step, grad_step, _ = make_gnn_step_fns(mcfg, plan)
    xb = torch.from_numpy(make_tgv_batch_fn(pg, sem, 1)(1)).to(dev)
    tp = a["params"]
    t_fwd = cuda_ms(lambda: loss_step(tp, xb, xb, gt), 3, warmup=1)
    t_grad = cuda_ms(lambda: grad_step(tp, xb, xb, gt), 3, warmup=1)
    g1 = g.level(1)
    h = torch.randn(pg.n_pad, cfg.hidden, generator=torch.Generator().manual_seed(1)).to(dev)
    c = consistent_mp.restrict_aggregate(h, g1)
    t_restrict = cuda_ms(lambda: consistent_mp.restrict_aggregate(h, g1), 10)
    t_prolong = cuda_ms(lambda: consistent_mp.prolong_aggregate(c, g1), 10)
    hr, cr = h.clone().requires_grad_(True), c.clone().requires_grad_(True)
    t_restrict_fb = cuda_ms(lambda: torch.autograd.grad(
        consistent_mp.restrict_aggregate(hr, g1), hr, c), 10)
    t_prolong_fb = cuda_ms(lambda: torch.autograd.grad(
        consistent_mp.prolong_aggregate(cr, g1), cr, h), 10)
    prof = profile_line(lambda: grad_step(tp, xb, xb, gt))
    say(P, f"(c) launch/train.py --levels {ML_LEVELS} --coarse-mp-layers "
        f"{ML_COARSE_LAYERS} --model large, R=1, {ML_TRAIN_STEPS} steps, run twice: "
        f"losses {[float(v) for v in a['losses']]}, losses and params bitwise equal: "
        f"{same} | step time median after step 0 {np.median(step_ms[1:]):.1f} ms (step 0 "
        f"{step_ms[0]:.1f}) | peak device memory {train_peak / 2**30:.2f} GiB | "
        f"launches {paths['ml_train']} | {smi}")
    say(P, f"(c) CUDA events: forward + loss {t_fwd:.3f} ms, forward + backward "
        f"{t_grad:.3f} ms | fine-level transfers (level 0 <-> 1, {m_pad[0]} slots, "
        f"H={cfg.hidden}): restriction {t_restrict:.3f} ms, prolongation "
        f"{t_prolong:.3f} ms forward; with their backward {t_restrict_fb:.3f} / "
        f"{t_prolong_fb:.3f} ms | one gradient step {prof}")
    del a, tp, gt, xb, h, c, hr, cr
    torch.cuda.empty_cache()

    # --- (d) R=4 against R=1, stacked, packed neighbor, both schedules ---
    csem = box_mesh(CONS_ELEMS, p=ORDER)
    xg, yg = (taylor_green_velocity(csem.coords, t=t) for t in (0.0, DT))
    ml1 = build_hierarchy(csem, (1, 1, 1), ML_LEVELS)
    ml4 = build_hierarchy(csem, CONS_GRID, ML_LEVELS)

    def prepare(h_, mode, schedule):
        p_ = NMPPlan.build(h_, mode, packed=mode == NEIGHBOR, backend=FUSED,
                           schedule=schedule)
        g_ = ShardedGraph.build(h_.levels[0], csem.coords, p_, device=dev, hierarchy=h_)
        xs, ys = (torch.from_numpy(gather_node_features(h_.levels[0], f)).to(dev)
                  for f in (xg, yg))
        return p_, g_, xs, ys

    p1, g1s, x1, y1 = prepare(ml1, NONE, "blocking")
    l1, yy1, gr1 = loss_and_grad_stacked(params, x1, y1, g1s, p1, cfg.node_out)
    yy1 = scatter_node_outputs(ml1.levels[0], yy1.cpu().numpy())
    base = (float(l1), [t.cpu().numpy() for t in tree_leaves(gr1)])
    del g1s, x1, y1, gr1
    stacked = {}
    for schedule in ("blocking", "overlap"):
        p4, g4, x4, y4 = prepare(ml4, NEIGHBOR, schedule)
        with torch.no_grad():
            build.reset_launch_counts()
            # the layers, and the exchanges the V-cycle runs outside them
            with LevelLaunches(g4, ((reference, "_smooth_stacked", 3),)) as lv:
                yf = gnn_forward_stacked(params, x4, g4, p4,
                                         sync_fn=lv.wrap(halo_sync_stacked, 1))
                torch.cuda.synchronize()
            paths[f"ml_r4_fwd_{schedule}"] = dict(build.launch_counts)
        check_level_launches(P, f"(d) the R=4 packed forward, {schedule}", lv.tally,
                             ml_expected(p4, mcfg, 4, overlap=schedule == "overlap"))
        stacked[schedule] = yf.cpu().numpy()
        build.reset_launch_counts()
        l4, yy4, gr4 = loss_and_grad_stacked(params, x4, y4, g4, p4, cfg.node_out,
                                             sync_fn=halo_sync_stacked)
        torch.cuda.synchronize()
        paths[f"ml_r4_grad_{schedule}"] = got = dict(build.launch_counts)
        # kernel 2 once per kernel 1; every exchange reversed once
        want = {}
        for lvl in ml_expected(p4, mcfg, 4, overlap=schedule == "overlap"):
            for k, v in lvl.items():
                want[k] = want.get(k, 0) + (v if k == "nmp_fwd" else 2 * v)
        want["nmp_bwd"] = want["nmp_fwd"]
        check_launches(P, f"(d) the R=4 packed gradient run, {schedule}", got, want)
        yy4 = scatter_node_outputs(ml4.levels[0], yy4.cpu().numpy())
        dl = abs(float(l4) - base[0])
        y_ok = bool(np.all(np.abs(yy4 - yy1) <= ML_ATOL + ML_RTOL * np.abs(yy1)))
        g_err, by_norm, g_ok = cons.grads_close(
            [t.cpu().numpy() for t in tree_leaves(gr4)], base[1], ML_G_RTOL, ML_G_ATOL,
            W_REL)
        ok = dl <= ML_LOSS * max(1.0, abs(base[0])) and y_ok and g_ok
        say(P, f"(d) {CONS_ELEMS} p={ORDER} ({csem.n_nodes} nodes; levels "
            f"{ml4.level_sizes()}), R=1 vs R=4 {CONS_GRID} packed neighbor, {schedule}: "
            f"loss {float(l4):.8g} vs {base[0]:.8g} (|diff| {dl:.3g}, band {ML_LOSS} x "
            f"max(1, |l|)) | predictions max|err| {np.abs(yy4 - yy1).max():.3g} (rtol "
            f"{ML_RTOL} atol {ML_ATOL}) | grads max|err| {g_err:.3g} (rtol {ML_G_RTOL} atol "
            f"{ML_G_ATOL})" + (f"; held by rel L2 <= {W_REL}: {by_norm}" if by_norm else "")
            + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"multilevel R=1 vs R=4 ({schedule}) outside the bands")
        del g4, x4, y4, gr4
    torch.cuda.empty_cache()

    # --- (e) the same split through 4 gloo processes on the card ---
    t0 = time.perf_counter()
    job = cons.Job(elements=CONS_ELEMS, order=ORDER, cfg=mcfg, device="cuda",
                   backends=(FUSED,), modes=("packed",), schedules=("blocking", "overlap"),
                   cases=((CONS_GRID, 1),))
    procs = cons.run_world(job, 4)
    wall = time.perf_counter() - t0
    case = cons.case_name(CONS_GRID, 1)
    layers = mcfg.n_mp_layers + (ML_LEVELS - 1) * ML_COARSE_LAYERS
    for schedule in ("blocking", "overlap"):
        key = cons.steps_key(schedule)
        recs = [p[case][key][(FUSED, "packed")] for p in procs]
        line = cons.check_step(recs, base, "packed", w_rel=W_REL, g_rtol=ML_G_RTOL)
        bitwise = all(np.array_equal(r["pred"][0, 0], stacked[schedule][p[case]["rank"]])
                      for r, p in zip(recs, procs))
        p4 = NMPPlan.build(ml4, NEIGHBOR, packed=True, backend=FUSED, schedule=schedule)
        total = {"fwd_launches": {}, "grad_launches": {}}
        for p, r in zip(procs, recs):
            fwd, grad = ml_process_expected(p4, mcfg, p[case]["rank"], schedule == "overlap")
            check_launches(P, f"(e) process {p[case]['rank']}'s {schedule} forward",
                           r["fwd_launches"], fwd)
            check_launches(P, f"(e) process {p[case]['rank']}'s {schedule} gradient run",
                           r["grad_launches"], grad)
            n_ex = cons.exchanges_per_forward(mcfg)
            want_ex = ({"posted": n_ex, "overlapped": layers if schedule == "overlap" else 0},
                       {"posted": 2 * n_ex, "overlapped": 0})
            if (r["fwd_exchanges"], r["grad_exchanges"]) != want_ex:
                raise RuntimeError(f"exchanges {r['fwd_exchanges']}, {r['grad_exchanges']}"
                                   f", expected {want_ex}")
            for name in ("fwd_launches", "grad_launches"):
                for k, v in r[name].items():
                    total[name][k] = total[name].get(k, 0) + v
        paths[f"ml_dist_{schedule}"] = total["fwd_launches"]
        paths[f"ml_dist_{schedule}_grad"] = total["grad_launches"]
        say(P, f"(e) 4 gloo processes on one card, {CONS_GRID} split, packed neighbor, "
            f"{schedule}: every rank's prediction bitwise equal to its stacked slice: "
            f"{bitwise} | {line} | launches summed {total} | exchanges per process "
            f"as counted | spawn and run {wall:.1f} s")
        if not bitwise:
            raise RuntimeError(f"distributed multilevel {schedule} forward != stacked")
    torch.cuda.empty_cache()
    return paths


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


# phase 9: GraphCast's weather configuration (repro's configs/graphcast.py
# weather_config) at its published widths: d512, 16 processor layers of one
# MLP hidden layer, 227 variables in and out, 4 geometric edge features,
# on an icosphere of GC_REFINEMENT and a GC_GRID lat-lon grid, each grid
# point joined to its GC_K nearest mesh vertices; GC_REQUESTS served
# states, then one loss gradient at GC_GRAD_LAYERS processor layers
GC_REFINEMENT, GC_GRID, GC_K = 5, (91, 180), 3
GC_REQUESTS, GC_GRAD_LAYERS, GC_SEED = 4, 2, 0
GC_REDUCED = {"mesh refinement": "6 -> 5 (40,962 -> 10,242 mesh nodes)",
              "grid": "0.25 deg 721 x 1440 -> 2 deg 91 x 180",
              "why": "the host's brute-force kNN (grid2mesh_edges) grows as grid x mesh"}


def phase_graphcast(ptxas, smi):
    """GraphCast weather_config(5) through ``repro_torch.configs``'s
    ``graphcast`` entry and the fused backend: every processor layer runs
    kernel 1's generic entry at H=512.  Serves GC_REQUESTS seeded
    227-variable states (CUDA-event ms per forward, the device's busy
    share under torch.profiler, peak memory; kernel 1 launched exactly 16
    times a forward, nothing else), holds one forward to the plain backend
    (rtol 1e-4 / atol 1e-5 elementwise, or, where the 16 layers' fp32
    noise leaves that band, its relative L2 distance from a float64
    forward within F64_FACTOR of the plain backend's), and one loss
    gradient at GC_GRAD_LAYERS layers (kernel 2's generic entry at H=512,
    launches exact) to the plain backend's in the gradient band; then
    kernels 1 and 2 alone at this cell's shapes against their plain
    versions (the records of the kernel line).  Returns ({path: launch
    counts}, [kernel records], the cell: its config, plan, partition,
    rank-local graph, edge features, grid size and parameters, which
    phase 9c trains)."""
    import torch
    from repro_torch import nn
    from repro_torch.configs import get_arch
    from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
    from repro_torch.core.halo import NONE, HaloSpec
    from repro_torch.core.partition import partition_graph
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as sa
    from repro_torch.models.gnn_zoo import graphcast as gcm
    phase = "9 graphcast"
    arch, family = get_arch("graphcast")
    cfg = arch.weather_config(GC_REFINEMENT)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    edges, xyz, n_grid, counts = gcm.weather_graph(GC_REFINEMENT, *GC_GRID, k=GC_K)
    t_knn = time.perf_counter() - t0
    n_total = xyz.shape[0]
    plan = NMPPlan(halo=HaloSpec(mode=NONE), backend=FUSED)
    pg = partition_graph(n_total, edges, 1)
    g = ShardedGraph.build(pg, xyz, plan, device=dev).rank(0)
    n_real = int(pg.edge_mask.sum())
    say(phase, f"{cfg.name} ({family}): in {cfg.in_dim}, hidden {cfg.hidden}, {cfg.n_layers} "
        f"layers of {cfg.mlp_hidden_layers} MLP hidden layer, out {cfg.out_dim}, edge_in "
        f"{cfg.edge_in} | {n_total - n_grid} mesh + {n_grid} grid = {n_total} nodes, "
        f"{n_real} directed edges {counts} | host kNN {t_knn:.1f} s, graph build "
        f"{time.perf_counter() - t0 - t_knn:.1f} s | reduced: {GC_REDUCED}")
    params = gcm.init_graphcast(torch.Generator().manual_seed(GC_SEED), cfg, device=dev)
    ef = torch.from_numpy(gcm.weather_edge_feats(
        xyz, pg.edge_src[0], pg.edge_dst[0], pg.edge_mask[0], cfg.edge_in)).to(dev)

    def state(i):
        x = np.zeros((pg.n_pad, cfg.in_dim), np.float32)
        x[:n_grid] = np.random.default_rng(GC_SEED + 1 + i).normal(size=(n_grid, cfg.in_dim))
        return torch.from_numpy(x).to(dev)

    def forward(x, p=params, c=cfg, pl=plan):
        with torch.no_grad():
            return gcm.graphcast_forward(p, x, ef, g, pl, c)

    x0 = state(0)
    forward(x0)                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    ms, ok_out = [], True
    t1 = time.perf_counter()
    for i in range(GC_REQUESTS):
        x = state(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = forward(x)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        ok_out &= tuple(y.shape) == (pg.n_pad, cfg.out_dim) and bool(torch.isfinite(y).all())
    wall = time.perf_counter() - t1
    by_path = {"graphcast_serve": dict(build.launch_counts)}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the tensor-core route adds its per-node pass, once per layer and call
    tc = sa.any_route(cfg.hidden, cfg.mlp_hidden_layers) == sa.TC
    check_launches(phase, "graphcast_serve", by_path["graphcast_serve"],
                   {sa.KERNEL_ANY: GC_REQUESTS * cfg.n_layers}
                   | ({sa.KERNEL_DST: GC_REQUESTS * cfg.n_layers} if tc else {}))
    say(phase, f"served {GC_REQUESTS} states: forward {', '.join(f'{m:.3f}' for m in ms)} ms "
        f"(CUDA events; median {float(np.median(ms)):.3f}), {GC_REQUESTS / wall:.2f} req/s "
        f"with the host's state build and copy, outputs [{pg.n_pad}, {cfg.out_dim}] finite: "
        f"{ok_out} | peak memory {peak:.2f} GiB | one forward {profile_line(lambda: forward(x0))}")
    if not ok_out:
        raise RuntimeError("GraphCast's served output is not finite or has the wrong shape")

    # one forward against the plain backend, and both against float64
    y_f, y_p = forward(x0), forward(x0, pl=plan.replace(backend=XLA))
    err, ok = within_band(y_f, y_p)
    p64 = nn.tree_map(lambda t: t.double(), params)
    c64 = dataclasses.replace(cfg, act_dtype=torch.float64)
    with torch.no_grad():
        y64 = gcm.graphcast_forward(p64, x0.double(), ef.double(), g,
                                    plan.replace(backend=XLA), c64)
    rel_f, rel_p = rel_norm(y_f.double(), y64), rel_norm(y_p.double(), y64)
    f64_ok = rel_f <= F64_FACTOR * rel_p
    del p64, y64
    say(phase, f"fused vs plain backend, one forward at full width: max|err| {err:.3g} "
        f"(rtol {RTOL} atol {ATOL}: {ok}); rel L2 from a float64 forward: fused {rel_f:.3e}, "
        f"plain {rel_p:.3e} (fused <= {F64_FACTOR:g}x plain: {f64_ok})")
    if not (ok or f64_ok):
        raise RuntimeError("GraphCast's fused forward disagrees with the plain backend")

    # one loss gradient at GC_GRAD_LAYERS layers: kernel 2 at H=512
    cfg2 = dataclasses.replace(cfg, n_layers=GC_GRAD_LAYERS)
    p2 = dict(params, proc=params["proc"][:GC_GRAD_LAYERS])
    target = torch.randn(pg.n_pad, cfg.out_dim, generator=torch.Generator().manual_seed(
        GC_SEED)).to(dev) * g["node_mask"][:, None]

    def loss(p, pl):
        y = gcm.graphcast_forward(p, x0, ef, g, pl, cfg2)
        return ((y - target) ** 2).mean()
    build.reset_launch_counts()
    t2 = time.perf_counter()
    lf, gf = nn.value_and_grad(lambda p: loss(p, plan), p2)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t2
    by_path["graphcast_grad"] = dict(build.launch_counts)
    check_launches(phase, "graphcast_grad", by_path["graphcast_grad"],
                   {sa.KERNEL_ANY: GC_GRAD_LAYERS, sa.KERNEL_BWD_ANY: GC_GRAD_LAYERS}
                   | ({sa.KERNEL_DST: 2 * GC_GRAD_LAYERS} if tc else {}))
    lp, gp = nn.value_and_grad(lambda p: loss(p, plan.replace(backend=XLA)), p2)
    l_err, l_ok = within_band(lf, lp)
    g_err, by_norm, g_ok = grads_close(gf, gp)
    say(phase, f"loss gradient at {GC_GRAD_LAYERS} layers, full width ({grad_s:.2f} s with "
        f"the first launches): loss fused {float(lf):.6e} plain {float(lp):.6e} ({l_ok}); "
        f"gradients max|err| {g_err:.3g} (rtol {G_RTOL} atol {G_ATOL}; by rel L2 <= {W_REL}: "
        f"{by_norm}) -> {'ok' if g_ok else 'FAIL'}")
    if not (l_ok and g_ok):
        raise RuntimeError("GraphCast's fused gradient disagrees with the plain backend")
    del gf, gp, p2
    torch.cuda.empty_cache()

    # kernels 1 and 2 alone at this cell's shapes: one processor layer's
    # edge MLP on random node and edge rows of the width
    gen = torch.Generator().manual_seed(GC_SEED + 9)
    H, Lp = cfg.hidden, cfg.mlp_hidden_layers
    edge = params["proc"][0]["edge"]
    x = torch.randn(pg.n_pad, H, generator=gen).to(dev)
    e = torch.randn(pg.e_pad, H, generator=gen).to(dev)
    weights = [t for l in edge["layers"] for t in l.values()] + list(edge["ln"].values())
    n_dst = int((g["seg_rowptr"].diff() > 0).sum())
    flops = n_real * 2 * (2 * H * H + Lp * H * H) + n_dst * 2 * H * H
    slots = g["seg_perm"].numel()
    records = [
        nmp_fwd_case(x, e, edge, g, n_real, pg.n_pad, flops, weights, ptxas,
                     spec=any_spec("fwd", H, Lp, slots, ptxas), iters=(10, 3)),
        nmp_bwd_case(x, e, edge, g, n_real, pg.n_pad, 3 * flops, weights, ptxas, gen,
                     spec=any_spec("bwd", H, Lp, slots, ptxas, pg.n_pad), iters=(5, 2))]
    # the FMA route at this cell, on the same inputs, in the same run: the
    # generic pair's first design beside the rule's route
    if tc:
        fma = [
            nmp_fwd_case(x, e, edge, g, n_real, pg.n_pad, flops, weights, ptxas,
                         spec=any_spec("fwd", H, Lp, slots, ptxas, route=sa.FMA), detail=False,
                         iters=(5, 1)),
            nmp_bwd_case(x, e, edge, g, n_real, pg.n_pad, 3 * flops, weights, ptxas, gen,
                         spec=any_spec("bwd", H, Lp, slots, ptxas, pg.n_pad, sa.FMA),
                         detail=False, iters=(3, 1))]
        for rec, old in zip(records, fma):
            rec["fma_route_ms"] = old["ms"]
        say(phase, f"at this layer, tensor-core route against the FMA route: forward "
            f"{records[0]['ms']:.3f} / {fma[0]['ms']:.3f} ms, backward {records[1]['ms']:.3f} / "
            f"{fma[1]['ms']:.3f} ms")
        records.append(node_dst_case(x, edge["layers"][0]["w"], ptxas))
    for rec in records:
        rec["shape"] = f"GraphCast weather_config({GC_REFINEMENT}) layer: H={H}, Lp={Lp}, " \
                       f"E={n_real}, N={pg.n_pad}"
    del x, e
    torch.cuda.empty_cache()
    cell = dict(cfg=cfg, plan=plan, pg=pg, g=g, ef=ef, n_grid=n_grid, params=params)
    return by_path, records, cell


def node_dst_case(x, w0, ptxas):
    """The tensor-core route's per-node pass (x w0_dst, ``csrc/nmp_any.cu``
    ``nmp_node_dst_f32``) against its plain version: within the forward
    band of plain or of a float64 product, two launches bitwise equal (one
    count each), times, the bound (3xTF32 on tensor cores; fp32 CUDA cores
    beside it) and ``torch.mm``'s time."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as sa
    N, H = x.shape
    before = build.launch_counts.get(sa.KERNEL_DST, 0)
    got, again = sa.node_dst_product(x, w0), sa.node_dst_product(x, w0)
    torch.cuda.synchronize()
    counted = build.launch_counts.get(sa.KERNEL_DST, 0) - before == 2
    repeat = torch.equal(got, again)
    want = sa.node_dst_plain(x, w0)
    exact = sa.node_dst_plain(x.double(), w0.double())
    err, ok = within_band(got, want)
    ok = ok or within_band(got.double(), exact)[1]
    w_dst = w0[H:2 * H]
    ms = cuda_ms(lambda: sa.node_dst_product(x, w0), iters=20)
    plain = cuda_ms(lambda: sa.node_dst_plain(x, w0), iters=20)
    library = cuda_ms(lambda: torch.mm(x, w_dst), iters=20)
    flops = 2 * N * H * H
    moved = nbytes(x, w_dst, got)
    fp32_ms, fp32_by = bound_ms(moved, flops)
    b_ms, b_by = min((fp32_ms, fp32_by), bound_ms(moved, 3 * flops, PEAK_TF32_FLOPS))
    plan = sa._tc_plan(2, H, 0, 0, N)
    say("2 kernels", f"{sa.KERNEL_DST} N={N} H={H}: max|err| {err:.3g} (rtol {RTOL} atol {ATOL}, "
        f"or around a float64 product) | two launches bitwise equal: {repeat}, counted: "
        f"{counted} | kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.mm {library:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: 3 x {flops / 1e9:.2f} GFLOP in 3xTF32; fp32 on CUDA cores "
        f"{fp32_ms:.4f}) | grid {plan['grid']}, {plan['smem_bytes']} B shared memory, "
        f"{plan['blocks_per_sm']} block(s) per SM | ptxas rows kernel "
        f"{ptxas.get('nmp_tc_rows', 'not built here')}")
    if not (ok and repeat and counted):
        raise RuntimeError(f"{sa.KERNEL_DST} disagrees with its plain version, is not "
                           "repeatable or did not launch once a call")
    return dict(name=sa.KERNEL_DST, route="cuda", source="src/repro_torch/csrc/nmp_any.cu",
                replaces="src/repro/kernels/segment_agg/kernel.py:215", max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=library,
                fp32_bound_ms=fp32_ms)


# phase 9c: GraphCast's training cells, repro's configs/graphcast.py
# (_inputs_factory, _loss_local_factory) through configs/gnn_common.py's
# step builder, on the fused plan: the published config (d512, 16 layers,
# cross entropy) on cora_like at R=1, GC_TRAIN_STEPS AdamW steps; phase 9's
# weather_config(5) cell, GC_WEATHER_STEPS steps with the consistent MSE to
# a seeded next state; and cora over a (graph 2 x model 2) mesh of 4 gloo
# processes sharing the card, under each exchange of GC_EP_MODES,
# GC_EP_STEPS steps and one eval-step forward
GC_TRAIN_SEED, GC_TRAIN_STEPS, GC_WEATHER_STEPS, GC_EP_STEPS = 0, 3, 2, 2
GC_EP_MODES = ("packed", "a2a")
TRAIN_REL = 1e-4                 # a later step's loss against R=1 (phase 6's curve)


def _gc_launches(cfg, grad=True, halo=None):
    """Exact launches of one pass of GraphCast's processor on the
    tensor-core route: kernel 1c and its per-node pass 1d per layer, with
    the gradient kernel 2c and 1d once more per layer; ``halo`` (packs,
    unpack-adds) per exchange of the packed neighbor exchange, twice per
    layer with the gradient (the reversed exchange)."""
    from repro_torch.kernels.halo_pack import ops as hp
    from repro_torch.kernels.segment_agg import ops as sa
    L = cfg.n_layers
    want = ({sa.KERNEL_ANY: L, sa.KERNEL_DST: 2 * L, sa.KERNEL_BWD_ANY: L} if grad
            else {sa.KERNEL_ANY: L, sa.KERNEL_DST: L})
    if halo is not None:
        times = 2 * L if grad else L
        want |= {hp.PACK: halo[0] * times, hp.UNPACK: halo[1] * times}
    return want


def _forward_reading(got, plain, exact):
    """(max |got - plain|, within the forward band of plain, rel L2 of got
    and of plain from the float64 forward ``exact``, ok): the band, or,
    where 16 random layers part two fp32 paths further, got's rel L2 from
    float64 within F64_FACTOR of plain's (phase 9's rule)."""
    d = np.abs(got - plain)
    band = bool(np.all(d <= ATOL + RTOL * np.abs(plain)))
    rel = lambda a_: float(np.linalg.norm(a_ - exact) / max(np.linalg.norm(exact), 1e-30))  # noqa: E731
    r_got, r_plain = rel(got), rel(plain)
    return float(d.max()), band, r_got, r_plain, band or r_got <= F64_FACTOR * r_plain


def _step_parts(loss_local, state, inputs, graph, opt):
    """One more training step in its parts by CUDA events: (forward and
    loss ms, backward ms, AdamW ms).  Updates ``state`` as a step does."""
    import torch
    from repro_torch import nn
    from repro_torch.train.optimizer import adamw_update_
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    p = nn.tree_map(lambda t: t.detach().requires_grad_(True), state["params"])
    ev[0].record()
    with torch.enable_grad():
        loss = loss_local(p, inputs, graph)
        ev[1].record()
        grads = torch.autograd.grad(loss, nn.tree_leaves(p))
    ev[2].record()
    adamw_update_(nn.tree_unflatten(p, list(grads)), state["opt"], state["params"], opt)
    ev[3].record()
    ev[3].synchronize()
    return tuple(ev[i].elapsed_time(ev[i + 1]) for i in range(3))


def _median_after_first(ms):
    return float(np.median(ms[1:] if len(ms) > 1 else ms))


def _sum_into(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_graphcast_train(cell, smi):
    """GraphCast's training cells on the card (the comment above): (a)
    cora_like at the published config through ``graphcast_checks.
    run_case``: the eval-step forward, step 0's loss and gradients fused
    vs the plain backend (forward band, loss rel 2e-6, gradient band),
    GC_TRAIN_STEPS steps with kernels 1c / 1d / 2c launched exactly 16 /
    32 / 16 times a step and nothing else; (b) ``cell``, phase 9's
    weather_config(5) graph, weights and edge features: step 0's loss and
    gradients fused vs plain (the plain one with per-layer remat) in the
    bands, or, where 16 layers of fp32 noise leave them, each leaf's rel
    L2 from a float64 gradient within F64_FACTOR of plain's, then
    GC_WEATHER_STEPS steps, launches exact; (c) 4 gloo processes at
    (graph 2 x model 2), each exchange of GC_EP_MODES: every process's
    forward rows, loss and gradients against (a)'s R=1 in the bands, the
    second step's loss within TRAIN_REL, every process's losses and
    parameters after GC_EP_STEPS steps equal, launches exact per process.
    Step ms by CUDA events (median after step 0) and peak memory per case.
    Returns the launches of each path."""
    import torch
    from repro_torch import nn
    from repro_torch.configs import get_arch
    from repro_torch.configs import gnn_common as G
    from repro_torch.core.distributed import local_graph_of
    from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, pad_edges
    from repro_torch.core.partition import partition_graph
    from repro_torch.graph.datasets import cora_like
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as sa
    from repro_torch.launch import graphcast_checks as gcx
    from repro_torch.launch.consistency import grads_close as close
    from repro_torch.launch.mesh import to_host
    from repro_torch.models.gnn_zoo.graphcast import graphcast_forward
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    phase = "9c graphcast train"
    arch, _ = get_arch("graphcast")
    dev = torch.device("cuda")
    by_path = {}

    # (a) the published config on cora_like, one rank
    shape = G.GNN_SHAPES["full_graph_sm"]
    cfg = arch.config(shape)
    if sa.any_route(cfg.hidden, cfg.mlp_hidden_layers) != sa.TC:
        raise RuntimeError("GraphCast's d512 layer is not on the tensor-core route")
    job = gcx.Job(cases=(), cfg=dataclasses.asdict(cfg),
                  graph=dict(seed=GC_TRAIN_SEED, n=shape["n_nodes"],
                             m_und=shape["n_edges"] // 2, d=shape["d_feat"],
                             n_classes=shape["n_classes"]),
                  seed=GC_TRAIN_SEED, backend=FUSED, device="cuda", steps=GC_TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = to_host(gcx.run_case(job, gcx.Case("r1")))
    wall = time.perf_counter() - t0
    plain = to_host(gcx.run_case(dataclasses.replace(job, backend=XLA, steps=0),
                                 gcx.Case("r1")))
    torch.cuda.empty_cache()
    check_launches(phase, "cora eval forward", a["launches_eval"],
                   _gc_launches(cfg, grad=False))
    check_launches(phase, "cora step-0 gradient", a["launches_grad"], _gc_launches(cfg))
    for i, counts in enumerate(a["launches_step"]):
        check_launches(phase, f"cora training step {i}", counts, _gc_launches(cfg))
    check_launches(phase, "cora plain backend", _sum_into(
        dict(plain["launches_eval"]), plain["launches_grad"]), {})
    by_path["gc_train_cora"] = {}
    for counts in a["launches_step"]:
        _sum_into(by_path["gc_train_cora"], counts)
    # the eval forward in float64 (the plain backend), for phase 9's rule
    edges, feats, labels = cora_like(**job.graph)
    pg1 = pad_edges(partition_graph(job.graph["n"], edges, 1))
    xla = NMPPlan(backend=XLA)
    stacked = gcx.cell_inputs(pg1, feats, labels)
    p64 = nn.tree_map(lambda t: t.double(), gcx.params_of(job, cfg, dev))
    with torch.no_grad():
        y64 = graphcast_forward(
            p64, torch.from_numpy(stacked["x"][0]).to(dev).double(),
            torch.from_numpy(stacked["edge_feats"][0]).to(dev).double(),
            local_graph_of(pg1, None, xla, device=dev), xla,
            dataclasses.replace(cfg, act_dtype=torch.float64)).cpu().numpy()
    del p64
    pred_err, pred_band, rel_f, rel_p, pred_ok = _forward_reading(a["pred"], plain["pred"], y64)
    l_rel = abs(a["loss0"] - plain["loss0"]) / abs(plain["loss0"])
    g_err, by_norm, g_ok = close(a["grads0"], plain["grads0"], G_RTOL, G_ATOL, W_REL)
    finite = bool(np.all(np.isfinite(a["losses"])) and np.all(np.isfinite(a["pred"])))
    good = pred_ok and l_rel <= LOSS_REL and g_ok and finite
    say(phase, f"graphcast-cora-train: {cfg.name} config(full_graph_sm) in {cfg.in_dim}, "
        f"hidden {cfg.hidden}, {cfg.n_layers} layers of {cfg.mlp_hidden_layers} MLP hidden "
        f"layer, {cfg.out_dim} classes, cross entropy, on cora_like({GC_TRAIN_SEED}): "
        f"{shape['n_nodes']} nodes, {int(a['edges_local'])} directed edges, R=1, fused | "
        f"eval forward vs plain max|err| {pred_err:.3g} (rtol {RTOL} atol {ATOL}: {pred_band}; "
        f"rel L2 from a float64 forward: fused {rel_f:.3e}, plain {rel_p:.3e}, fused <= "
        f"{F64_FACTOR:g}x plain: {rel_f <= F64_FACTOR * rel_p}); "
        f"step-0 loss fused {a['loss0']:.8g} plain {plain['loss0']:.8g} (rel {l_rel:.2e}, "
        f"band {LOSS_REL}); gradients max|err| {g_err:.3g} (rtol {G_RTOL} atol {G_ATOL}; "
        f"by rel L2 <= {W_REL}: {by_norm}) | {GC_TRAIN_STEPS} AdamW steps: losses "
        f"{[round(v, 6) for v in a['losses']]}, step {', '.join(f'{m:.3f}' for m in a['step_ms'])} "
        f"ms (CUDA events; median after step 0 {_median_after_first(a['step_ms']):.3f} ms), "
        f"peak memory {a['peak_gib']:.2f} GiB, the case {wall:.1f} s with the first "
        f"launches | {smi} -> {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("GraphCast's cora training step disagrees with the plain backend")
    # where a cora step's time goes: one more step in its parts, and one
    # under torch.profiler (the same params and inputs as the case's)
    opt = AdamWConfig()
    cora_loss = arch._loss_local_factory(shape, xla.halo, cfg=cfg,
                                         plan=NMPPlan(backend=FUSED))
    g_cora = local_graph_of(pg1, None, NMPPlan(backend=FUSED), device=dev)
    _, specs = arch._inputs_factory(shape, 1, pg1.n_pad, pg1.e_pad)
    in_cora = G.shard_by_specs(stacked, specs, None, dev)
    params = gcx.params_of(job, cfg, dev)
    cstate = {"params": params, "opt": init_adamw(params, opt)}
    cora_parts = _step_parts(cora_loss, cstate, in_cora, g_cora, opt)
    cstep = G.make_gnn_train_step(cora_loss, opt)
    cora_prof = profile_line(lambda: cstep(cstate, in_cora, g_cora))
    say(phase, "graphcast-cora-train, one step in parts (CUDA events): forward and loss "
        f"{cora_parts[0]:.3f} ms, backward {cora_parts[1]:.3f} ms, AdamW {cora_parts[2]:.3f} "
        f"ms; one step {cora_prof}")
    del cstate, params, in_cora, g_cora
    plain_rows = dict(zip(a["global_ids"][a["node_mask"] > 0].tolist(),
                          plain["pred"][a["node_mask"] > 0]))
    f64_rows = dict(zip(a["global_ids"][a["node_mask"] > 0].tolist(), y64[a["node_mask"] > 0]))
    del plain

    # (b) phase 9's weather_config(5) cell, its 16 layers in training
    wcfg, plan, pg, g, ef = (cell[k] for k in ("cfg", "plan", "pg", "g", "ef"))
    params = cell["params"]
    n_grid, n_vars = cell["n_grid"], wcfg.out_dim
    rng = np.random.default_rng(GC_SEED + 100)
    x = np.zeros((1, pg.n_pad, wcfg.in_dim), np.float32)
    x[0, :n_grid] = rng.normal(size=(n_grid, wcfg.in_dim))
    nxt = np.zeros((1, pg.n_pad, n_vars), np.float32)
    nxt[0, :n_grid] = x[0, :n_grid, :n_vars] + 0.1 * rng.normal(size=(n_grid, n_vars))
    inputs = {"x": torch.from_numpy(x).to(dev), "edge_feats": ef[None],
              "target": torch.from_numpy(nxt).to(dev)}
    # the state lives on the grid: the loss weighs grid nodes alone
    weight = g["node_inv_mult"] * (torch.arange(pg.n_pad, device=dev) < n_grid)

    def weather_loss(c, pl):
        def loss_local(p, i, gr):
            out = graphcast_forward(p, i["x"][0], i["edge_feats"][0], gr, pl, c)
            return G.consistent_mse_loss(out, i["target"][0], weight)
        return loss_local

    build.reset_launch_counts()
    lf, gf = G.gnn_loss_and_grads(weather_loss(wcfg, plan), params, inputs, g)
    torch.cuda.synchronize()
    check_launches(phase, "weather step-0 gradient", dict(build.launch_counts),
                   _gc_launches(wcfg))
    remat = dataclasses.replace(wcfg, remat=True)
    lp, gp = G.gnn_loss_and_grads(weather_loss(remat, plan.replace(backend=XLA)), params,
                                  inputs, g)
    gf_np = [t.cpu().numpy() for t in nn.tree_leaves(gf)]
    gp_np = [t.cpu().numpy() for t in nn.tree_leaves(gp)]
    del gf, gp
    torch.cuda.empty_cache()
    l_rel = abs(float(lf) - float(lp)) / abs(float(lp))
    g_err, by_norm, g_ok = close(gf_np, gp_np, G_RTOL, G_ATOL, W_REL)
    f64_line = ""
    if not (g_ok and l_rel <= LOSS_REL):
        # 16 layers of fp32 noise: each leaf against a float64 gradient
        p64 = nn.tree_map(lambda t: t.double(), params)
        in64 = {k: v.double() for k, v in inputs.items()}
        c64 = dataclasses.replace(remat, act_dtype=torch.float64)
        w64 = weight.double()

        def loss64(p, i, gr):
            out = graphcast_forward(p, i["x"][0], i["edge_feats"][0], gr,
                                    plan.replace(backend=XLA), c64)
            return G.consistent_mse_loss(out, i["target"][0], w64)
        l64, g64 = G.gnn_loss_and_grads(loss64, p64, in64, g)
        g64_np = [t.cpu().numpy() for t in nn.tree_leaves(g64)]
        del p64, in64, g64
        torch.cuda.empty_cache()
        rel = lambda a_, b_: float(np.linalg.norm(a_ - b_) / max(np.linalg.norm(b_), 1e-30))  # noqa: E731
        worst = max(rel(f, e) / max(rel(p_, e), 1e-30)
                    for f, p_, e in zip(gf_np, gp_np, g64_np))
        loss64_ok = abs(float(lf) - float(l64)) <= F64_FACTOR * max(
            abs(float(lp) - float(l64)), 1e-12 * abs(float(l64)))
        g_ok = worst <= F64_FACTOR and (l_rel <= LOSS_REL or loss64_ok)
        f64_line = (f"; outside the band, against a float64 gradient: the largest leaf's "
                    f"rel L2 fused / plain {worst:.3g} (<= {F64_FACTOR:g}), loss float64 "
                    f"{float(l64):.10g}")
        l_ok = True
    else:
        l_ok = l_rel <= LOSS_REL
    del gf_np, gp_np
    step = G.make_gnn_train_step(weather_loss(wcfg, plan), opt)
    state = {"params": params, "opt": init_adamw(params, opt)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    by_path["gc_train_weather"] = {}
    for i in range(GC_WEATHER_STEPS):
        build.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, inputs, g)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        counts = dict(build.launch_counts)
        check_launches(phase, f"weather training step {i}", counts, _gc_launches(wcfg))
        _sum_into(by_path["gc_train_weather"], counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    parts = _step_parts(weather_loss(wcfg, plan), state, inputs, g, opt)
    prof = profile_line(lambda: step(state, inputs, g))
    good = g_ok and l_ok and bool(np.all(np.isfinite(losses)))
    say(phase, f"graphcast-weather-r5-train: {wcfg.name}, {pg.n_pad} padded nodes, "
        f"{int(pg.edge_mask.sum())} directed edges, {wcfg.n_layers} layers, consistent MSE "
        f"to a seeded next state on the grid | step-0 loss fused {float(lf):.10g} plain "
        f"(per-layer remat) {float(lp):.10g} (rel {l_rel:.2e}, band {LOSS_REL}); gradients "
        f"max|err| {g_err:.3g} (rtol {G_RTOL} atol {G_ATOL}; by rel L2 <= {W_REL}: "
        f"{by_norm}){f64_line} | {GC_WEATHER_STEPS} AdamW steps: losses {losses}, step "
        f"{', '.join(f'{m:.3f}' for m in ms)} ms (CUDA events; median after step 0 "
        f"{_median_after_first(ms):.3f} ms), peak memory {peak:.2f} GiB | one more step in "
        f"parts (CUDA events): forward and loss {parts[0]:.3f} ms, backward {parts[1]:.3f} "
        f"ms, AdamW {parts[2]:.3f} ms; one step {prof} | {smi} -> {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("GraphCast's weather training step disagrees with the plain backend")
    del state, inputs, weight
    torch.cuda.empty_cache()

    # (c) cora over (graph 2 x model 2): 4 gloo processes sharing the card
    edges, _, _ = cora_like(**job.graph)
    pg2 = pad_edges(partition_graph(job.graph["n"], edges, 2))
    cases = tuple(gcx.Case(f"g2m2_{mode}", graph=2, model=2, mode=mode)
                  for mode in GC_EP_MODES)
    t0 = time.perf_counter()
    procs = gcx.run_world(dataclasses.replace(job, cases=cases, steps=GC_EP_STEPS), 4)
    wall = time.perf_counter() - t0
    want_rows = dict(zip(a["global_ids"][a["node_mask"] > 0].tolist(),
                         a["pred"][a["node_mask"] > 0]))
    for case in cases:
        perms = gcx.plan_of(pg2, case, FUSED).halo.perms
        recs = [p[case.name] for p in procs]
        total, lines, good = {}, [], True
        for w, r in enumerate(recs):
            recv = sum(any(dst == r["rank"] for _, dst in perm) for perm in perms)
            halo = (1, recv) if case.mode == "packed" else None
            check_launches(phase, f"{case.name} process {w} eval forward",
                           r["launches_eval"], _gc_launches(cfg, grad=False, halo=halo))
            check_launches(phase, f"{case.name} process {w} step-0 gradient",
                           r["launches_grad"], _gc_launches(cfg, halo=halo))
            for i, counts in enumerate(r["launches_step"]):
                check_launches(phase, f"{case.name} process {w} step {i}", counts,
                               _gc_launches(cfg, halo=halo))
            for counts in (r["launches_eval"], r["launches_grad"], *r["launches_step"]):
                _sum_into(total, counts)
            m = r["node_mask"] > 0
            ids = r["global_ids"][m].tolist()
            rows = np.stack([want_rows[i] for i in ids])
            d = np.abs(r["pred"][m] - rows)
            # the band of (a)'s R=1 rows, or phase 9's float64 rule against
            # the plain backend's rows
            p_ok = bool(np.all(d <= ATOL + RTOL * np.abs(rows))) or _forward_reading(
                r["pred"][m], np.stack([plain_rows[i] for i in ids]),
                np.stack([f64_rows[i] for i in ids]))[4]
            rel0 = abs(r["loss0"] - a["loss0"]) / abs(a["loss0"])
            err, nrm, gr_ok = close(r["grads0"], a["grads0"], G_RTOL, G_ATOL, W_REL)
            rel1 = abs(r["losses"][1] - a["losses"][1]) / abs(a["losses"][1])
            ok = p_ok and rel0 <= LOSS_REL and gr_ok and rel1 <= TRAIN_REL
            good &= ok
            lines.append(f"process {w} (rank {r['rank']}, shard {r['shard']}, "
                         f"{int(r['edges_local'])} of its rank's edges): forward max|err| "
                         f"{float(d.max()):.3g} ({p_ok}), loss rel {rel0:.2e}, gradients "
                         f"max|err| {err:.3g} (by norm {nrm}), step 1 loss rel {rel1:.2e}")
        same = all(r["losses"] == recs[0]["losses"] for r in recs) and \
            len({r["params_sum"] for r in recs}) == 1
        good &= same
        by_path[f"gc_ep_{case.mode}"] = total
        r0 = recs[0]
        say(phase, f"graphcast-cora-2x2-ep {case.mode}: 4 gloo processes on one card, mesh "
            f"(data 1, graph 2, model 2), config(full_graph_sm), fused, against (a)'s R=1 "
            f"(forward rtol {RTOL} atol {ATOL}, loss {LOSS_REL}, gradients rtol {G_RTOL} atol "
            f"{G_ATOL}, step 1 loss {TRAIN_REL}): " + "; ".join(lines)
            + f" | losses {r0['losses']} and parameters after {GC_EP_STEPS} steps equal on "
            f"every process: {same} | launches summed over the processes {total} | rank 0 "
            f"step {', '.join(f'{v:.3f}' for v in r0['step_ms'])} ms (CUDA events; 4 "
            f"processes share the card and exchange through the host: a check of the path, "
            f"not a scaling number), peak memory {r0['peak_gib']:.2f} GiB | spawn and both "
            f"cases {wall:.1f} s -> {'ok' if good else 'FAIL'}")
        if not good:
            raise RuntimeError(f"GraphCast's edge-parallel {case.mode} run disagrees with R=1 "
                               "or across processes")
    return by_path


# phase 9d: the rest of the GNN zoo (GAT, NequIP, MACE) at their published
# widths in the reference's cells: gat-cora-train (config(full_graph_sm) on
# cora_like, ZOO_STEPS AdamW steps), nequip- and mace-molecule-train (the
# molecule cell: molecules(batch=128, n_atoms=30, n_species=8) batched with
# e_pad_per=64, ZOO_STEPS steps; forces rotating with the positions),
# zoo-cora-r4 (4 gloo processes sharing the card, the packed neighbor
# exchange and a2a at graph 4; NequIP and MACE also at graph 2 x model 2
# with edge_parallel) and gat-minibatch (config(minibatch_lg), one step on a
# SampledBlock of MB_SEEDS seeds drawn from powerlaw_graph at the cell's
# node count and degree)
ZOO_SEED, ZOO_STEPS = 0, 3
ZOO_R4_MODES = ("packed", "a2a")
ZOO_MOLECULES = dict(batch=128, n_atoms=30, n_species=8)
ZOO_E_PAD_PER = 64
# the sum exchanges per layer: GAT's denominator and aggregate (its max
# exchange of the softmax shift launches neither kernel), NequIP's and
# MACE's aggregate
ZOO_SUMS = {"gat-cora": 2, "nequip": 1, "mace": 1}
# the reference's bands for rotated energies and forces (tests/test_gnn_zoo.py)
ROT_E_BAND, ROT_F_BAND = (5e-4, 1e-5), (2e-3, 1e-5)
MB_SEEDS, MB_AVG_DEG, MB_HOST_LIMIT_S = 64, 492, 60.0


def _zoo_launches(arch, cfg, recv, grad):
    """Exact launches of one pass of a zoo model over the packed neighbor
    exchange: one pack and one unpack-add per round received for each sum
    exchange, twice with the gradient (the reversed exchange); ``recv``
    None (one rank, a2a): none."""
    from repro_torch.kernels.halo_pack import ops as hp
    if recv is None:
        return {}
    times = ZOO_SUMS[arch] * cfg.n_layers * (2 if grad else 1)
    return {hp.PACK: times, hp.UNPACK: times * recv}


def _hold_forward(got, plain, exact_fn):
    """(max |got - plain|, ok, the line's words): the forward band around
    ``plain``, or, where that misses, phase 9's float64 rule with the
    float64 result ``exact_fn()``."""
    d = np.abs(got - plain)
    if np.all(d <= ATOL + RTOL * np.abs(plain)):
        return float(d.max()), True, f"max|err| {float(d.max()):.3g} (band)"
    _, _, r_got, r_plain, ok = _forward_reading(got, plain, exact_fn())
    return float(d.max()), ok, (f"max|err| {float(d.max()):.3g} outside the band; rel L2 "
                                f"from float64 {r_got:.3e} vs {r_plain:.3e} (<= "
                                f"{F64_FACTOR:g}x: {ok})")


def _f64_forward(fwd_local, params, inputs, graph, cfg, arch):
    """The same port code in float64: weights, float inputs and the carry."""
    import torch
    from repro_torch import nn
    p64 = nn.tree_map(lambda t: t.double(), params)
    i64 = {k: v.double() if v.is_floating_point() else v for k, v in inputs.items()}
    with torch.no_grad():
        if arch == "gat-cora":
            return fwd_local(p64, i64, graph).cpu().numpy()
        c64 = dataclasses.replace(cfg, act_dtype=torch.float64)
        return fwd_local(p64, i64, graph, c64).cpu().numpy()


def phase_gnn_zoo(smi):
    """The rest of the GNN zoo on the card (the comment above): every cell
    held to the same port code on the CPU (forwards in the forward band or
    by phase 9's float64 rule, losses within 2e-6, gradients in the
    gradient band or per leaf by rel L2 5e-4); the R>1 runs held to R=1 on
    the card, every process's launches exact (kernels 4 and 5 in each
    packed sum exchange, none in a max exchange, a2a or one rank); the
    molecules' energies and forces under a rotation in the reference's
    bands.  Step ms by CUDA events, busy share under torch.profiler, peak
    memory per cell.  Returns the launches of each path."""
    import torch
    from repro_torch import nn
    from repro_torch.configs import get_arch
    from repro_torch.configs import gnn_common as G
    from repro_torch.core.graph_state import XLA, pad_edges
    from repro_torch.core.halo import NONE, HaloSpec
    from repro_torch.core.partition import partition_graph
    from repro_torch.graph.datasets import (
        batch_molecules, cora_like, molecules, powerlaw_graph)
    from repro_torch.graph.sampler import CSRGraph, block_meta, sample_block
    from repro_torch.kernels import build
    from repro_torch.launch import graphcast_checks as gcx
    from repro_torch.launch.consistency import grads_close as close
    from repro_torch.launch.mesh import to_host
    from repro_torch.models.gnn_zoo.irreps import _rand_rotations
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    phase = "9d gnn zoo"
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    by_path = {}
    t_phase = time.perf_counter()

    # the minibatch cell's graph: built on a host thread while the cards run
    mb_shape = G.GNN_SHAPES["minibatch_lg"]
    host = {}

    def build_graph():
        try:
            t0 = time.perf_counter()
            edges = powerlaw_graph(mb_shape["n_nodes"], MB_AVG_DEG, seed=ZOO_SEED)
            t1 = time.perf_counter()
            host["csr"] = CSRGraph.from_edges(mb_shape["n_nodes"], edges)
            host.update(n_edges=int(edges.shape[0]), graph_s=t1 - t0,
                        csr_s=time.perf_counter() - t1)
        except BaseException as exc:      # re-raised on the main thread
            host["error"] = exc
    builder = threading.Thread(target=build_graph, daemon=True)
    builder.start()

    def step_reading(loss_local, params, inputs, graph, steps):
        """``steps`` AdamW steps from ``params`` (a copy): their losses, CUDA
        ms, launches per step, peak memory, and one more under the
        profiler."""
        opt = AdamWConfig()
        p = nn.tree_map(lambda t: t.clone(), params)
        state = {"params": p, "opt": init_adamw(p, opt)}
        step = G.make_gnn_train_step(loss_local, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, counts = [], [], []
        for _ in range(steps):
            build.reset_launch_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, loss = step(state, inputs, graph)
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(loss))
            counts.append({k: v for k, v in build.launch_counts.items() if v})
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = profile_line(lambda: step(state, inputs, graph))
        return losses, ms, counts, peak, prof

    def steps_words(losses, ms, peak, prof):
        return (f"{len(ms)} AdamW steps: losses {[round(v, 6) for v in losses]}, step "
                f"{', '.join(f'{m:.3f}' for m in ms)} ms (CUDA events; median after step 0 "
                f"{_median_after_first(ms):.3f} ms), peak memory {peak:.2f} GiB; one more "
                f"step {prof}")

    # (a) gat-cora-train: the published config on cora_like(0), one rank
    shape = G.GNN_SHAPES["full_graph_sm"]
    cora = dict(seed=ZOO_SEED, n=shape["n_nodes"], m_und=shape["n_edges"] // 2,
                d=shape["d_feat"], n_classes=shape["n_classes"])
    gat_mod, _ = get_arch("gat-cora")
    gcfg = gat_mod.config(shape)
    gjob = gcx.Job(cases=(), cfg=dataclasses.asdict(gcfg), graph=cora, seed=ZOO_SEED,
                   device="cuda", steps=0, arch="gat-cora")
    cell = gcx.build_cell(gjob, gcx.Case("r1"))
    a = to_host(gcx.run_case(gjob, gcx.Case("r1")))
    c = to_host(gcx.run_case(dataclasses.replace(gjob, device="cpu"), gcx.Case("r1")))
    for part in ("launches_eval", "launches_grad"):
        check_launches(phase, f"gat-cora-train {part}", a[part], {})
    _, f_ok, f_words = _hold_forward(a["pred"], c["pred"], lambda: _f64_forward(
        cell.fwd_local, cell.params, cell.inputs, cell.graph, gcfg, "gat-cora"))
    l_rel = abs(a["loss0"] - c["loss0"]) / abs(c["loss0"])
    g_err, by_norm, g_ok = close(a["grads0"], c["grads0"], G_RTOL, G_ATOL, W_REL)
    losses, ms, counts, peak, prof = step_reading(cell.loss_local, cell.params, cell.inputs,
                                                  cell.graph, ZOO_STEPS)
    for i, cnt in enumerate(counts):
        check_launches(phase, f"gat-cora-train step {i}", cnt, {})
    by_path["zoo_gat_cora_train"] = {}
    good = f_ok and l_rel <= LOSS_REL and g_ok and bool(np.all(np.isfinite(losses)))
    say(phase, f"gat-cora-train: config(full_graph_sm) in {gcfg.in_dim}, {gcfg.heads} heads x "
        f"{gcfg.hidden}, {gcfg.n_classes} classes, {gcfg.n_layers} layers, cross entropy, on "
        f"cora_like({ZOO_SEED}): {cora['n']} nodes, {int(a['edges_local'])} directed edges, "
        f"R=1 | card vs the CPU: forward {f_words}; step-0 loss {a['loss0']:.8g} vs "
        f"{c['loss0']:.8g} (rel {l_rel:.2e}); gradients max|err| {g_err:.3g} (by rel L2: "
        f"{by_norm}) | {steps_words(losses, ms, peak, prof)} | {smi} -> "
        f"{'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("GAT's cora cell on the card disagrees with the CPU")
    gat_r1 = a
    del cell, c
    torch.cuda.empty_cache()

    # (b) nequip- and mace-molecule-train: the molecule cell at full width
    mol_shape = G.GNN_SHAPES["molecule"]
    species, pos, edge_lists = molecules(seed=ZOO_SEED, **ZOO_MOLECULES)
    sp, ps, meta = batch_molecules(species, pos, edge_lists, e_pad_per=ZOO_E_PAD_PER)
    target = np.random.default_rng(ZOO_SEED + 1).normal(size=sp.shape).astype(np.float32)
    stacked = {"species": sp[None].astype(np.int32), "pos": ps[None], "target": target[None]}
    rot = _rand_rotations(1, seed=9)[0].astype(np.float32)
    for arch in ("nequip", "mace"):
        mod, _ = get_arch(arch)
        cfg = mod.config(mol_shape)
        init, forward = gcx.ARCHS[arch][1], gcx.ARCHS[arch][2]
        on = {}
        for side, d in (("card", dev), ("cpu", cpu)):
            params = init(torch.Generator().manual_seed(ZOO_SEED), cfg, device=d)
            graph = {k: torch.from_numpy(v).to(d) for k, v in meta.items()}
            inputs = {k: torch.from_numpy(v).to(d) for k, v in stacked.items()}
            loss_local = mod._loss_local_factory(mol_shape, HaloSpec(mode=NONE), cfg=cfg)
            build.reset_launch_counts()
            loss0, grads = G.gnn_loss_and_grads(loss_local, params, inputs, graph)
            on[side] = dict(loss0=float(loss0), grads=[t.cpu().numpy() for t in
                                                       nn.tree_leaves(grads)],
                            counts={k: v for k, v in build.launch_counts.items() if v})
            del grads

            def energy_forces(x, params=params, graph=graph, d=d):
                with torch.enable_grad():
                    xt = torch.from_numpy(np.ascontiguousarray(x)).to(d).requires_grad_(True)
                    e = forward(params, inputs["species"][0], xt, graph, cfg)
                    f = -torch.autograd.grad(e.sum(), xt)[0]
                return e.detach().cpu().numpy(), f.cpu().numpy()
            on[side]["ef"] = energy_forces(ps)
            if side == "card":
                on["rot"] = energy_forces(ps @ rot.T)
                on["run"] = (loss_local, params, inputs, graph)
                on["f64"] = lambda params=params, inputs=inputs, graph=graph: \
                    _f64_forward(lambda p, i, g, c: forward(p, i["species"][0], i["pos"][0],
                                                            g, c),
                                 params, inputs, graph, cfg, arch)
        check_launches(phase, f"{arch}-molecule-train step-0 gradient", on["card"]["counts"],
                       {})
        (e_d, f_d), (e_c, f_c), (e_r, f_r) = on["card"]["ef"], on["cpu"]["ef"], on["rot"]
        _, f_ok, f_words = _hold_forward(e_d, e_c, on["f64"])
        l_rel = abs(on["card"]["loss0"] - on["cpu"]["loss0"]) / abs(on["cpu"]["loss0"])
        g_err, by_norm, g_ok = close(on["card"]["grads"], on["cpu"]["grads"], G_RTOL, G_ATOL,
                                     W_REL)
        fc_err, _, fc_ok = close([f_d], [f_c], G_RTOL, G_ATOL, W_REL)
        rot_e = float(np.max(np.abs(e_r - e_d) / (ROT_E_BAND[1] + ROT_E_BAND[0] * np.abs(e_d))))
        rot_f = float(np.max(np.abs(f_r - f_d @ rot.T)
                             / (ROT_F_BAND[1] + ROT_F_BAND[0] * np.abs(f_d @ rot.T))))
        losses, ms, counts, peak, prof = step_reading(*on["run"], ZOO_STEPS)
        for i, cnt in enumerate(counts):
            check_launches(phase, f"{arch}-molecule-train step {i}", cnt, {})
        by_path[f"zoo_{arch}_molecule_train"] = {}
        good = (f_ok and l_rel <= LOSS_REL and g_ok and fc_ok and rot_e <= 1 and rot_f <= 1
                and bool(np.all(np.isfinite(losses))))
        say(phase, f"{arch}-molecule-train: config() {cfg.n_layers} layers x {cfg.hidden_mul} "
            f"channels, l_max {cfg.l_max}, {cfg.n_rbf} RBF"
            + (f", correlation {cfg.correlation}" if arch == "mace" else "")
            + f", on molecules(batch={ZOO_MOLECULES['batch']}, n_atoms="
            f"{ZOO_MOLECULES['n_atoms']}) batched at e_pad_per={ZOO_E_PAD_PER}: {sp.size} atoms, "
            f"{meta['edge_mask'].size} edge slots ({int(meta['edge_mask'].sum())} real), "
            f"consistent MSE to a seeded per-atom target | card vs the CPU: energies "
            f"{f_words}; step-0 loss {on['card']['loss0']:.8g} vs {on['cpu']['loss0']:.8g} "
            f"(rel {l_rel:.2e}); gradients max|err| {g_err:.3g} (by rel L2: {by_norm}); "
            f"forces max|err| {fc_err:.3g} | one rotation: energies at {rot_e:.3f} of the band "
            f"(rtol {ROT_E_BAND[0]} atol {ROT_E_BAND[1]}), forces at {rot_f:.3f} of theirs "
            f"(rtol {ROT_F_BAND[0]} atol {ROT_F_BAND[1]}) | "
            f"{steps_words(losses, ms, peak, prof)} | {smi} -> {'ok' if good else 'FAIL'}")
        if not good:
            raise RuntimeError(f"{arch}'s molecule cell on the card disagrees with the CPU or "
                               "breaks its symmetry")
        del on
        torch.cuda.empty_cache()

    # (c) zoo-cora-r4: each arch on cora over 4 gloo processes sharing the card
    jobs, r1 = [], {"gat-cora": gat_r1}
    for arch in ("gat-cora", "nequip", "mace"):
        mod, _ = get_arch(arch)
        tag = arch.split("-")[0]
        cases = tuple(gcx.Case(f"zoo_{tag}_{mode}", graph=4, mode=mode)
                      for mode in ZOO_R4_MODES)
        if arch != "gat-cora":
            cases += (gcx.Case(f"zoo_{tag}_g2m2", graph=2, model=2, mode="packed"),)
        job = gcx.Job(cases=cases, cfg=dataclasses.asdict(mod.config(shape)), graph=cora,
                      seed=ZOO_SEED, device="cuda", steps=0, arch=arch)
        jobs.append(job)
        if arch != "gat-cora":
            r1[arch] = to_host(gcx.run_case(dataclasses.replace(job, cases=()),
                                            gcx.Case("r1")))
            check_launches(phase, f"{arch} R=1 on cora", _sum_into(
                dict(r1[arch]["launches_eval"]), r1[arch]["launches_grad"]), {})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = gcx.run_world(jobs, 4)
    wall = time.perf_counter() - t0
    edges, _, _ = cora_like(**cora)
    for job in jobs:
        arch = job.arch
        base = r1[arch]
        m1 = base["node_mask"] > 0
        want = dict(zip(base["global_ids"][m1].tolist(), base["pred"][m1]))
        f64_rows = {}

        def exact_rows(ids, job=job):
            if not f64_rows:
                cell = gcx.build_cell(job, gcx.Case("r1"))
                if arch == "gat-cora":
                    y64 = _f64_forward(cell.fwd_local, cell.params, cell.inputs, cell.graph,
                                       cell.cfg, arch)
                else:
                    fwd = gcx.ARCHS[arch][2]
                    y64 = _f64_forward(lambda p, i, g, c: fwd(p, i["species"][0],
                                                              i["pos"][0], g, c),
                                       cell.params, cell.inputs, cell.graph, cell.cfg, arch)
                f64_rows.update(zip(base["global_ids"][m1].tolist(), y64[m1]))
            return np.stack([f64_rows[i] for i in ids])
        cfg = gcx.config_of(job)
        for case in job.cases:
            pg = pad_edges(partition_graph(cora["n"], edges, case.graph))
            perms = gcx.plan_of(pg, case, XLA).halo.perms
            recs = [p[case.name] for p in procs]
            total, lines, good = {}, [], True
            for w, r in enumerate(recs):
                recv = sum(any(dst == r["rank"] for _, dst in perm) for perm in perms)
                halo = recv if case.mode == "packed" else None
                check_launches(phase, f"{case.name} process {w} eval forward",
                               r["launches_eval"], _zoo_launches(arch, cfg, halo, False))
                check_launches(phase, f"{case.name} process {w} step-0 gradient",
                               r["launches_grad"], _zoo_launches(arch, cfg, halo, True))
                _sum_into(_sum_into(total, r["launches_eval"]), r["launches_grad"])
                m = r["node_mask"] > 0
                ids = r["global_ids"][m].tolist()
                rows = np.stack([want[i] for i in ids])
                _, p_ok, p_words = _hold_forward(r["pred"][m], rows,
                                                 lambda ids=ids: exact_rows(ids))
                rel0 = abs(r["loss0"] - base["loss0"]) / abs(base["loss0"])
                err, nrm, gr_ok = close(r["grads0"], base["grads0"], G_RTOL, G_ATOL, W_REL)
                ok = p_ok and rel0 <= LOSS_REL and gr_ok
                good &= ok
                lines.append(f"process {w} (rank {r['rank']}, shard {r['shard']}): forward "
                             f"{p_words}, loss rel {rel0:.2e}, gradients max|err| {err:.3g} "
                             f"(by rel L2 {nrm})")
            by_path[case.name] = total
            r0 = recs[0]
            say(phase, f"zoo-cora-r4 {case.name}: {arch} config(full_graph_sm) on cora_like"
                f"({ZOO_SEED}), 4 gloo processes on one card, mesh (graph {case.graph}, model "
                f"{case.model}), {case.mode}" + (", edge_parallel" if case.model > 1 else "")
                + f", eval forward and step-0 gradient against the card's R=1 (forward rtol "
                f"{RTOL} atol {ATOL} or the float64 rule, loss {LOSS_REL}, gradients rtol "
                f"{G_RTOL} atol {G_ATOL}): " + "; ".join(lines)
                + f" | launches summed over the processes {total} | rank 0 peak memory "
                f"{r0['peak_gib']:.2f} GiB | spawn and every case {wall:.1f} s -> "
                f"{'ok' if good else 'FAIL'}")
            if not good:
                raise RuntimeError(f"{case.name} disagrees with R=1")
    del procs
    torch.cuda.empty_cache()

    # (d) gat-minibatch: one step on a sampled block of the minibatch_lg cell
    builder.join()
    if "error" in host:
        raise host["error"]
    csr = host["csr"]
    rng = np.random.default_rng(ZOO_SEED)
    seeds = rng.choice(mb_shape["n_nodes"], MB_SEEDS, replace=False)
    t0 = time.perf_counter()
    block = sample_block(csr, seeds, mb_shape["fanouts"], rng)
    sample_s = time.perf_counter() - t0
    n_pad, e_pad = G._minibatch_pads(mb_shape)
    bm = block_meta(block)
    n_real = int(block.node_mask.sum())
    arrays = {}
    for k, v in bm.items():
        size = e_pad if k.startswith("edge") else n_pad
        arrays[k] = np.concatenate([v, np.zeros(size - v.shape[0], v.dtype)])
    mcfg = gat_mod.config(mb_shape)
    x = np.zeros((1, n_pad, mcfg.in_dim), np.float32)
    x[0, :n_real] = rng.normal(size=(n_real, mcfg.in_dim))
    labels = np.zeros((1, n_pad), np.int32)
    labels[0, :n_real] = rng.integers(0, mcfg.n_classes, n_real)
    on = {}
    for side, d in (("card", dev), ("cpu", cpu)):
        params = gcx.ARCHS["gat-cora"][1](torch.Generator().manual_seed(ZOO_SEED), mcfg,
                                          device=d)
        graph = {k: torch.from_numpy(v).to(d) for k, v in arrays.items()}
        inputs = {"x": torch.from_numpy(x).to(d), "labels": torch.from_numpy(labels).to(d)}
        loss_local = gat_mod._loss_local_factory(mb_shape, HaloSpec(mode=NONE), cfg=mcfg)
        build.reset_launch_counts()
        loss0, grads = G.gnn_loss_and_grads(loss_local, params, inputs, graph)
        on[side] = (float(loss0), [t.cpu().numpy() for t in nn.tree_leaves(grads)],
                    {k: v for k, v in build.launch_counts.items() if v})
        if side == "card":
            run = (loss_local, params, inputs, graph)
    check_launches(phase, "gat-minibatch step-0 gradient", on["card"][2], {})
    l_rel = abs(on["card"][0] - on["cpu"][0]) / abs(on["cpu"][0])
    g_err, by_norm, g_ok = close(on["card"][1], on["cpu"][1], G_RTOL, G_ATOL, W_REL)
    losses, ms, counts, peak, prof = step_reading(*run, 1)
    check_launches(phase, "gat-minibatch step", counts[0], {})
    by_path["zoo_gat_minibatch"] = {}
    host_s = host["graph_s"] + host["csr_s"]
    cell_deg = round(mb_shape["n_edges"] / mb_shape["n_nodes"])
    reduced = "none" if MB_AVG_DEG == cell_deg else f"avg_deg {cell_deg} -> {MB_AVG_DEG}"
    good = l_rel <= LOSS_REL and g_ok and bool(np.all(np.isfinite(losses)))
    say(phase, f"gat-minibatch: config(minibatch_lg) in {mcfg.in_dim}, {mcfg.n_classes} "
        f"classes; powerlaw_graph({mb_shape['n_nodes']}, avg_deg={MB_AVG_DEG}) "
        f"{host['n_edges']} directed edges, its CSR: host {host['graph_s']:.1f} + "
        f"{host['csr_s']:.1f} s (on a thread beside (a)-(c); within {MB_HOST_LIMIT_S:g} s: "
        f"{host_s <= MB_HOST_LIMIT_S}; reduced: {reduced}); a block of {MB_SEEDS} seeds, fanouts {mb_shape['fanouts']}: "
        f"{n_real} nodes, {int(block.edge_mask.sum())} edges, padded to the cell's "
        f"({n_pad}, {e_pad}), sampled in {sample_s:.3f} s | card vs the CPU: step-0 loss "
        f"{on['card'][0]:.8g} vs {on['cpu'][0]:.8g} (rel {l_rel:.2e}); gradients max|err| "
        f"{g_err:.3g} (by rel L2: {by_norm}) | {steps_words(losses, ms, peak, prof)} | "
        f"phase {time.perf_counter() - t_phase:.1f} s | {smi} -> {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("GAT's minibatch cell on the card disagrees with the CPU")
    return by_path


def phase_paper_smoke():
    """The paper's smoke config (N_H=4, M=2, one MLP hidden layer) through
    the ``paper-gnn`` registry entry, as ``tests/test_arch_smoke.py::
    test_paper_gnn_smoke`` runs it: ``box_mesh((2, 2, 1), p=2)`` split
    (2, 1, 1), the A2A exchange, the fused backend, the stacked loss and
    gradient (kernels 1 and 2's generic entries at H=4, launches exact: M
    layers x R ranks each), held to the plain backend: loss and
    predictions in the forward band, gradients in the gradient band."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.gnn import init_gnn
    from repro_torch.core.graph_state import FUSED, XLA, NMPPlan, ShardedGraph
    from repro_torch.core.halo import A2A, HaloSpec
    from repro_torch.core.mesh_gen import box_mesh, taylor_green_velocity
    from repro_torch.core.partition import gather_node_features, partition_mesh
    from repro_torch.core.reference import loss_and_grad_stacked
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as sa
    phase = "9b paper-gnn"
    arch, family = get_arch("paper-gnn")
    cfg = arch.smoke_config()
    dev = torch.device("cuda")
    mesh = box_mesh((2, 2, 1), p=2)
    pg = partition_mesh(mesh, (2, 1, 1))
    plan = NMPPlan(halo=HaloSpec(mode=A2A), backend=FUSED)
    graph = ShardedGraph.build(pg, mesh.coords, plan, device=dev)
    x = torch.from_numpy(np.asarray(gather_node_features(
        pg, taylor_green_velocity(mesh.coords)), dtype=np.float32)).to(dev)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    build.reset_launch_counts()
    loss, y, grads = loss_and_grad_stacked(params, x, x, graph, plan, cfg.node_out)
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    n = cfg.n_mp_layers * pg.R
    check_launches(phase, "paper_smoke", counts, {sa.KERNEL_ANY: n, sa.KERNEL_BWD_ANY: n})
    lp, yp, gp = loss_and_grad_stacked(params, x, x, graph, plan.replace(backend=XLA),
                                       cfg.node_out)
    l_err, l_ok = within_band(loss, lp)
    y_err, y_ok = within_band(y, yp)
    g_err, by_norm, g_ok = grads_close(grads, gp)
    say(phase, f"{arch.ARCH_ID} ({family}) smoke_config: N_H={cfg.hidden}, M={cfg.n_mp_layers}, "
        f"{cfg.mlp_hidden_layers} MLP hidden layer on box (2, 2, 1) p=2 split (2, 1, 1), a2a, "
        f"fused: loss {float(loss):.6e} vs plain {float(lp):.6e} ({l_ok}), predictions max|err| "
        f"{y_err:.3g} ({y_ok}), gradients max|err| {g_err:.3g} (by rel L2: {by_norm}; {g_ok})")
    if not (l_ok and y_ok and g_ok and torch.isfinite(y).all()):
        raise RuntimeError("the paper's smoke config disagrees with the plain backend on the card")
    return {"paper_smoke": counts}


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
    phase_kernels_any(ptxas)
    seg_record, seg_counts = phase_segment_agg(sem, ptxas)
    records.append(seg_record)
    records.append(phase_embedding_bag(ptxas))
    records.append(phase_flash_attention(ptxas))
    lap("2 kernels")
    by_path = {"segment_agg_op": seg_counts}
    (by_path["consistency_r4_packed"], by_path["consistency_r4_overlap"],
     stacked) = phase_consistency(cfg)
    by_path["grad_r4_packed"], by_path["grad_r4_overlap"], r1 = \
        phase_grad_consistency(cfg)
    by_path.update(phase_consistency_bf16(cfg))
    lap("3b gradients")
    by_path.update(phase_distributed(cfg, stacked, r1, smi))
    lap("3c distributed")
    by_path.update(phase_plan(cfg, r1, smi))
    lap("3d plan")
    engine, mesh_hash, by_path["serve"], ckdir = phase_serve(cfg, sem, pg, smi)
    by_path["serve_bf16"] = phase_serve_bf16(cfg, sem, engine, mesh_hash, ckdir, smi)
    phase_profile(engine, mesh_hash, sem)
    lap("5 profile")
    served = phase_serve_dist(cfg, sem, engine, mesh_hash, ckdir, smi)
    by_path["serve_r4_overlap"], by_path["serve_r4_blocking"] = \
        served["overlap"], served["blocking"]
    del engine
    torch.cuda.empty_cache()
    lap("4b serve R=4")
    by_path["train"], by_path["rollout_k2"], by_path["train_bf16"] = \
        phase_train(cfg, sem, pg, smi)
    torch.cuda.empty_cache()
    lap("6 train")
    by_path.update(phase_resilience(cfg, sem, pg, smi))
    torch.cuda.empty_cache()
    lap("6c resilience")
    by_path.update(phase_multilevel(cfg, smi))
    torch.cuda.empty_cache()
    lap("6b multilevel")
    gc_paths, gc_records, gc_cell = phase_graphcast(ptxas, smi)
    by_path.update(gc_paths)
    records.extend(gc_records)
    torch.cuda.empty_cache()
    lap("9 graphcast")
    by_path.update(phase_graphcast_train(gc_cell, smi))
    del gc_cell
    torch.cuda.empty_cache()
    lap("9c graphcast train")
    by_path.update(phase_gnn_zoo(smi))
    torch.cuda.empty_cache()
    lap("9d gnn zoo")
    by_path.update(phase_paper_smoke())
    lap("9b paper-gnn")
    by_path.update(phase_dlrm(smi))
    torch.cuda.empty_cache()
    lap("7 dlrm")
    by_path.update(phase_lm(smi))
    lap("8 lm")
    # each kernel's own path first, then every other path that must use it:
    # training for the fused NMP pair (its bf16 entries: the bf16 training
    # steps, then the bf16 engine and R=4 runs), the R=4 packed-neighbor gradient run
    # for the halo kernels (training and serving are R=1), serve_bulk for
    # the embedding bag, the prefill for flash attention (phases 7 and 8
    # check their exact counts on every path), the op's one call for the
    # dst-aligned edge MLP (phase 2 checks that it launched exactly once)
    r4 = ("consistency_r4_overlap", "grad_r4_overlap", "dist_r4_overlap",
          "dist_r4_overlap_grad", "serve_r4_overlap", "serve_r4_blocking")
    # the multilevel V-cycle's paths (phase 6b): kernels 1 and 2 on every
    # level, kernels 4 and 5 in every level's exchange
    ml_grad = ("ml_r4_grad_blocking", "ml_r4_grad_overlap", "ml_dist_blocking_grad",
               "ml_dist_overlap_grad")
    ml_r4 = ("ml_r4_fwd_blocking", "ml_r4_fwd_overlap", "ml_dist_blocking",
             "ml_dist_overlap") + ml_grad
    # phase 3d's paths: kernels 1 and 2 on the spectral (vertex-cut) split,
    # kernels 4 and 5 under the bf16 wire, on rounds2d rounds and in the
    # tuner's packed candidates (the max forms hold 4 and 5 to 0)
    plan_fwd = ("plan_spectral_r4_fwd", "plan_spectral_r4_grad",
                "plan_spectral_r4_bf16_wire", "plan_rounds2d_r4", "plan_dist_spectral",
                "plan_dist_bf16_wire", "plan_tuner")
    plan_halo = plan_fwd + ("plan_dist_forms_rounds2d",)
    # phase 6c's resilient paths: kernels 1 and 2 on every case, replays
    # included; kernels 4 and 5 in the killed R=4 world and the R=2 resume
    res = ("res_uninterrupted", "res_crash", "res_save_fail", "res_corrupt", "res_kill",
           "res_elastic_r4", "res_elastic_r2")
    res_halo = ("res_elastic_r4", "res_elastic_r2")
    # phase 9c's GraphCast training paths: kernels 1c, 1d and 2c on each,
    # kernels 4 and 5 in the edge-parallel run's packed exchange
    gc_train = ("gc_train_cora", "gc_train_weather", "gc_ep_packed", "gc_ep_a2a")
    # phase 9d's zoo paths over processes: kernels 4 and 5 in the packed sum
    # exchanges of GAT, NequIP and MACE (GAT's max exchanges hold them to
    # the sums' exact counts)
    zoo_halo = ("zoo_gat_packed", "zoo_nequip_packed", "zoo_mace_packed",
                "zoo_nequip_g2m2", "zoo_mace_g2m2")
    own = {sa.KERNEL: ("train", "serve", "consistency_r4_packed", "grad_r4_packed",
                       "rollout_k2", "dist_r4_packed", "dist_r4_grad") + r4
           + ("ml_fwd", "ml_grad", "ml_serve", "ml_train") + ml_r4 + plan_fwd + res,
           sa.KERNEL_BWD: ("train", "grad_r4_packed", "rollout_k2", "dist_r4_grad",
                           "grad_r4_overlap", "dist_r4_overlap_grad", "ml_grad",
                           "ml_train") + ml_grad + ("plan_spectral_r4_grad",) + res,
           hp.PACK: ("grad_r4_packed", "consistency_r4_packed", "dist_r4_packed",
                     "dist_r4_grad") + r4 + ml_r4 + plan_halo + res_halo + ("gc_ep_packed",)
           + zoo_halo,
           hp.UNPACK: ("grad_r4_packed", "consistency_r4_packed", "dist_r4_packed",
                       "dist_r4_grad") + r4 + ml_r4 + plan_halo + res_halo
           + ("gc_ep_packed",) + zoo_halo,
           eb.KERNEL: ("dlrm_serve_bulk", "dlrm_serve_p99", "dlrm_train"),
           fa.KERNEL: ("lm_prefill", "lm_serve", "lm_check_bf16", "lm_check_fp32"),
           sa.KERNEL_MLP_AGG: ("segment_agg_op",),
           sa.KERNEL_BF16: ("train_bf16", "serve_bf16", "consistency_r4_bf16_blocking",
                            "consistency_r4_bf16_overlap", "grad_r4_bf16_blocking",
                            "grad_r4_bf16_overlap"),
           sa.KERNEL_BWD_BF16: ("train_bf16", "grad_r4_bf16_blocking",
                                "grad_r4_bf16_overlap"),
           # the generic-width entries: GraphCast's d512 (phase 9) and the
           # paper's smoke config at H=4 (9b)
           sa.KERNEL_ANY: ("graphcast_serve", "graphcast_grad", "paper_smoke") + gc_train,
           sa.KERNEL_BWD_ANY: ("graphcast_grad", "paper_smoke") + gc_train,
           # the tensor-core route's per-node pass (GraphCast's d512)
           sa.KERNEL_DST: ("graphcast_serve", "graphcast_grad") + gc_train}
    # no path of the fp32 plan ran a bf16 kernel (the bf16 paths' fp32
    # counts are held to 0 where they are checked)
    for path, counts in by_path.items():
        if "bf16" not in path and (counts.get(sa.KERNEL_BF16) or
                                   counts.get(sa.KERNEL_BWD_BF16)):
            raise RuntimeError(f"the fp32 path {path} launched a bf16 kernel: {counts}")
    for k in (hp.PACK, hp.UNPACK):
        if by_path["plan_dist_forms_max"].get(k):
            raise RuntimeError(f"a combine='max' exchange launched {k}")
    for rec in records:
        counts = {path: int(by_path[path].get(rec["name"], 0)) for path in by_path}
        rec["launches"] = counts[own[rec["name"]][0]]
        rec["launches_by_path"] = counts
        for path in own[rec["name"]]:
            if counts[path] == 0:
                raise RuntimeError(f"kernel {rec['name']} never launched on the "
                                   f"{path} path")
    say("end", f"whole script {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
