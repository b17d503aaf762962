// Fused NMP forward and backward (Eq. 4a + 4b and its VJP) under the
// reference's precision="bf16" policy, for NVIDIA Hopper (sm_90a), at
// H in {8, 16, 32} (the backward at most 5 hidden layers).
//
// Replaces, with precision="bf16", the Pallas TPU kernels
//   src/repro/kernels/segment_agg/kernel.py::nmp_edge_mlp_agg_fwd (:215)
//   src/repro/kernels/segment_agg/kernel.py::nmp_edge_mlp_agg_bwd (:357)
// whose products go through kernel.py::_dot (:59): both operands of every
// edge-MLP product rounded to bf16 (nearest even), fp32 accumulation;
// biases, ELU, LayerNorm, residual, mask and the aggregate fp32; x, e and
// the weights fp32 in memory.  For every real edge (i <- j) of one rank:
//   z_0 = [x_j_src, x_i_dst, e_ij] w0 + b0,  z_{l+1} = ELU(z_l) wrest_l + brest_l,
//   e'_ij = (e_ij + LN(z_Lp)) * mask_ij   (LN optional: biased variance, eps 1e-5)
//   agg_i = sum_j e'_ij * (1 / d_ij)
// The backward is the VJP as JAX takes it (autograd through
// ``t.to(bfloat16).float()`` in the plain version): each bf16-cast
// operand's cotangent is the fp32 product rounded to bf16,
//   g_a_l = rb(g_z_{l+1} rb(W_l)^T) (then times ELU'),
//   g_W_l = rb(sum over every edge of rb(a_l)^T g_z_{l+1}),
// per element for inputs and activations, once for a weight gradient
// (after the fixed-order sum of the blocks' partial rows); biases and
// LayerNorm stay fp32.  Layer 0's x slices cannot factor through per-node
// sums of g_z0: each slot's rb(g_z0 w0_src^T) and rb(g_z0 w0_dst^T) is
// rounded before the sum.
//
// What bounds them on the H100 SXM (published peaks at its 700 W limit),
// at H=32, Lp=5 on the serving mesh (4.3 M slots):
//   forward: bytes, 1.36 GB (x rows gathered, e, e', agg) at 3.35 TB/s,
//     0.407 ms, against 63.4 GFLOP of bf16 products at 989 TFLOP/s (0.064).
//   backward: bytes, 2.03 GB, 0.606 ms; its operations (the recompute's
//     bf16 products and the products with the fp32 cotangent as three bf16
//     parts, 3 x 141 GFLOP) take 0.493.
// Neither is bound by its products: each needs bytes in flight and few
// instructions per row, and that is what the design is for.
//
// Design.  Both kernels walk tiles of kRows = 128 consecutive dst-sorted
// slots (tile b, b + grid, ...: one persistent block per SM) and share:
//   - a ring of staged tiles: producer warps (the block's last) take a
//     tile's slot fields (perm, src, read a tile ahead into registers; each
//     slot's destination from the nodes' runs, rowptr, from tile_lo) into
//     a stage and gather its [x_src | x_dst | e] rows and each slot's mask
//     and 1/d by 16-byte cp.async (zero fill on padding), counted on the
//     stage's full mbarrier; consumer warps (16 rows each) compute on a
//     landed stage and release it on its empty mbarrier.  3 stages in the
//     forward, 2 in the backward.  Each producer thread reads the fields of
//     the rows it copies once, before its copies: with a read of the fields
//     before each copy the copies, not the products, set the forward's pace
//     (tools/nmp_bf16_phases.py: 2.6x as long a tile; 128-byte bulk copies
//     from one warp, cp.async.bulk, 2.5x as long again).
//   - weights in shared memory as bf16, row-major [rows][H + 8] (rows
//     padded to 16 with zeros), read as B fragments by ldmatrix.trans
//     (w as stored) or by 4-byte loads (w^T): a quarter of the fp32 tuned
//     kernels' pre-split weights.
//   - a register-chained MLP on mma.sync.m16n8k16.bf16: the fp32
//     accumulator of n-tiles 2k and 2k + 1 is laid out exactly as the A
//     fragment of k-step k of the next product (rows g and g + 8, columns
//     2t, 2t + 1, 2t + 8, 2t + 9), so ELU, the bf16 rounding and the next
//     product stay in registers: no activation slab between layers.  ELU's
//     exp is ex2.approx.ftz (elu_ftz): the instructions of ELU are most of
//     the MLP's.
//   - the aggregate (forward) and the x_dst gradient's per-node sum
//     (backward) as csrc/nmp_fwd.cu's node walk: per node the tile's rows
//     summed in slot order, one writer per row; a node cut by a tile edge
//     goes to the tile's two partial rows, summed by the fix-up pass in
//     tile order.  e' (g_e) outside the layout is zeroed after the edge
//     pass by a byte map of the edges it wrote.
//   - a ring whose phases fall out of step traps (ring_wait) rather than
//     hangs the card.
// Forward: two groups of 8 consumer warps take the block's tiles in turn
// (16 warps to hide the MLP's latency).  Per tile each warp runs layer 0
// from its staged rows and the hidden layers chained, the LayerNorm in
// registers (a row's H features on the 4 lanes of one mma row group),
// writes e' = (e + h) * mask to the edge's row and into its stage rows,
// and after one barrier of the group the tile's nodes are summed.  Layers
// whose weights do not fit in shared memory are read from global memory
// and rounded per fragment, so any depth runs.  The k order and every
// rounding are those of the slab-based forward this one replaced
// (csrc/nmp_fwd.cu's bf16 entry before it was split out).
// Backward: 8 consumer warps.  Per tile each warp recomputes its rows'
// forward: rb(ELU(z_l)) to the activation slab, the rounding's remainder
// (bf16) kept in registers for ELU'; its staged rows then rounded to bf16
// in place (the operand of w0's gradient).  g_h = (g_e' + g_agg[dst] / d) *
// mask and the LayerNorm's backward in registers, then the layers walked
// down with G_l's three bf16 parts (split3) in one of two part buffers
// (G_{l+1} read while G_l is written: one barrier a layer).  The
// activation and part slabs are K-major (Kmaj): the warps write their rows
// by stmatrix.trans, every warp's weight-gradient products read all rows
// by ldmatrix.  The weight gradient act_l^T G over the tile's 128 rows (K =
// rows; output tiles split among the warps by n-tile and m-tile; one
// product per part into fresh fragments, added per tile to register
// accumulators); each warp's input gradient G W^T from its rows' parts
// (ldmatrix.trans); the bias gradients as column sums of G in registers
// (shuffles, then each warp's sums in shared memory), the LayerNorm's
// likewise.  At layer 0: g_e = g_h + rb(g_z0 w0_e^T) to the edge,
// rb(g_z0 w0_src^T) per slot as bf16 to scratch (summed per node in
// src_slots order by the node pass), rb(g_z0 w0_dst^T) to the free part
// buffer, summed by the node walk into g_x (no per-slot x_dst row).  The
// weight products run on mma.sync: a weight gradient's M (its input
// features) is H <= 32 but for w0, below wgmma's 64 rows, and the hidden
// layers' on wgmma (M padded to 64, N = 16 a warpgroup, both operands read
// from shared memory for each part) ran slower: 5.88 ms a call against
// 5.05 for mma.sync in the call before (NVIDIA H100 80GB HBM3, 700 W).
// Every sum has one writer and a fixed order and there are no float
// atomics: two launches are bitwise equal, for any grid.
//
// Scratch the wrapper allocates: forward tile_lo (tiles + 1 int32), the
// partial rows (tiles x 2 x H fp32), a byte per edge; backward the same
// three, the x_src gradient per slot (slots x H bf16) and one row of
// partial weight gradients per block.  C entry points return
// cudaGetLastError(); the *_plan entries report the launches.
#include "hopper_async.cuh"  // mbarriers, cp.async with zero fill counted on an mbarrier
#include "nmp_bf16.cuh"      // bf16 rounding, split3, mma.sync bf16, ldmatrix

namespace {

constexpr int kCWarps = 8;                 // consumer warps: 16 rows each
constexpr int kRows = 16 * kCWarps;        // slots per tile
constexpr int kCThreads = 32 * kCWarps;
constexpr int kRunCache = 32;              // nodes whose runs a stage caches (~23 a tile)
constexpr int kMaxHidden = 5;              // hidden layers the backward's accumulators hold
constexpr int kCotParts = 3;               // bf16 parts of an fp32 cotangent in a product
constexpr int kWgradUnroll = 4;            // k-steps of a weight-gradient loop unrolled
constexpr int kFwdStages = 3, kBwdStages = 2;   // the rings' staged tiles
constexpr int kFwdGroups = 2;              // the forward's consumer groups, on alternate tiles
constexpr int kFwdProducers = 128, kBwdProducers = 64;   // producer threads
constexpr int kFwdThreads = kFwdGroups * kCThreads + kFwdProducers;
constexpr int kBwdThreads = kCThreads + kBwdProducers;

// row strides of 8 mod 32 floats: 8-byte fragment loads of A (row g,
// columns 2t, 2t + 1) hit 32 distinct banks per half warp
__host__ __device__ constexpr int pad8(int w) { return w + ((8 - w) % 32 + 32) % 32; }
__host__ __device__ constexpr int ceil16(int k) { return (k + 15) / 16 * 16; }

template <int H>
struct Cfg {
  static constexpr int NT = H / 8;          // n-tiles of 8 output features
  static constexpr int KS = (H + 15) / 16;  // k-steps of a hidden layer
  static constexpr int SX = pad8(3 * H);    // staged-row stride (floats)
  static constexpr int SW = H + 8;          // bf16 weight row stride
  static constexpr int SA = H + 4;          // fp32 gradient slab stride
  static constexpr int W0B = ceil16(3 * H) * SW * 2;  // bytes of w0
  static constexpr int LB = ceil16(H) * SW * 2;       // bytes of a hidden layer
};

// 4-byte words of a stage: the rows, 5 per-slot fields (eid, src, dst,
// mask, 1/d), the runs of the tile's first kRunCache nodes and its node
// range (tile_lo of this tile and the next)
__host__ __device__ constexpr int stage_words(int h) {
  return kRows * pad8(3 * h) + 5 * kRows + 2 * kRunCache + 4;
}

__host__ __device__ constexpr int weight_bytes(int h, int layers) {
  return (ceil16(3 * h) + layers * ceil16(h)) * (h + 8) * 2;
}

// shared memory: weights, biases and LayerNorm ((3 + layers) H floats),
// the stages, then (backward) the activation and gradient slabs, and the
// mbarriers
__host__ __device__ constexpr int fwd_smem(int h, int lps) {
  return weight_bytes(h, lps) + 4 * (3 + lps) * h + kFwdStages * 4 * stage_words(h) +
         16 * kFwdStages;
}
// the backward's slabs start 128-byte aligned: the activations (a K-major
// layout, Kmaj below: 256 lp H bytes), two buffers of G's three parts
// (Kmaj::PART each), each warp's column sums (lp + 3 rows of H floats)
__host__ __device__ constexpr int bwd_slabs_at(int h, int lp) {
  return (weight_bytes(h, lp) + 4 * (3 + lp) * h + kBwdStages * 4 * stage_words(h) + 127) / 128 *
         128;
}
__host__ __device__ constexpr int bwd_smem(int h, int lp) {
  return bwd_slabs_at(h, lp) + 256 * lp * h + 2 * 768 * h + kCWarps * (lp + 3) * h * 4 +
         16 * kBwdStages;
}

__host__ __device__ inline int wgrad_size(int h, int lp) {
  return 3 * h * h + h + lp * h * h + lp * h + 2 * h;
}

struct Stage {
  float* rows;
  int *eid, *src, *dst;
  float *m, *inv;
  int *run, *lohi;
};

template <int H>
__device__ __forceinline__ Stage stage_at(float* base) {
  Stage s;
  s.rows = base;
  s.eid = reinterpret_cast<int*>(base + kRows * Cfg<H>::SX);
  s.src = s.eid + kRows;
  s.dst = s.src + kRows;
  s.m = reinterpret_cast<float*>(s.dst + kRows);
  s.inv = s.m + kRows;
  s.run = reinterpret_cast<int*>(s.inv + kRows);
  s.lohi = s.run + 2 * kRunCache;
  return s;
}

// 4 bytes global -> shared (cached at all levels: the per-slot fields are
// gathered); src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// mbar_wait that traps (a launch error) instead of spinning for ever when
// a ring's phases fall out of step: a landed stage or a freed one takes
// microseconds, 2^22 polls take well over a second
__device__ __forceinline__ void ring_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 22)) __trap();
  } while (!done);
}

// Probe points of tools/nmp_bf16_phases.py, which defines NMP_BF16_PHASES
// in its copy of this file (no code otherwise): each thread sums the
// cycles between two points per phase, and lane 0 of each warp adds its
// sums to g_phase[role] (roles: 0 / 1 the forward's producer / consumer
// warps, 2 / 3 the backward's; [role][8] counts the warps).
#ifdef NMP_BF16_PHASES
__device__ unsigned long long g_phase[4][9];
__device__ __forceinline__ void phase_flush(const unsigned long long (&ph)[8], int role) {
  if ((threadIdx.x & 31) != 0) return;
  for (int i = 0; i < 8; ++i) atomicAdd(&g_phase[role][i], ph[i]);
  atomicAdd(&g_phase[role][8], 1ull);
}
#define PHASE_BEGIN unsigned long long ph_[8] = {}, t0_ = clock64()
#define PHASE(i)                                 \
  do {                                           \
    const unsigned long long t1_ = clock64();    \
    ph_[i] += t1_ - t0_;                         \
    t0_ = t1_;                                   \
  } while (0)
#define PHASE_END(role) phase_flush(ph_, role)
#else
#define PHASE_BEGIN
#define PHASE(i)
#define PHASE_END(role)
#endif

// named barriers: 1 + grp the consumer warps of group grp, 1 + kFwdGroups
// the producer warps
__device__ __forceinline__ void consumer_sync(int grp = 0) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(kCThreads) : "memory");
}
template <int NP>
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(1 + kFwdGroups), "n"(NP) : "memory");
}

// w [rows][H] fp32 -> [ceil16(rows)][H + 8] bf16 words (rounded to nearest
// even), zero past `rows` and past column H
template <int H>
__device__ void load_weights(uint32_t* dst, const float* __restrict__ w, int rows) {
  constexpr int WPR = Cfg<H>::SW / 2;
  const int n = ceil16(rows) * WPR;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / WPR, c = 2 * (i - r * WPR);
    dst[i] = r < rows && c < H ? bf16x2(w[r * H + c], w[r * H + c + 1]) : 0u;
  }
}

// the weights (w0, then `layers` hidden layers), biases and LayerNorm into
// shared memory; returns the first byte past them
template <int H>
__device__ unsigned char* load_params(unsigned char* smem, const float* __restrict__ w0,
                                      const float* __restrict__ b0,
                                      const float* __restrict__ wrest,
                                      const float* __restrict__ brest,
                                      const float* __restrict__ lng,
                                      const float* __restrict__ lnb, int layers) {
  using C = Cfg<H>;
  load_weights<H>(reinterpret_cast<uint32_t*>(smem), w0, 3 * H);
  for (int l = 0; l < layers; ++l)
    load_weights<H>(reinterpret_cast<uint32_t*>(smem + C::W0B + l * C::LB),
                    wrest + (size_t)l * H * H, H);
  float* s_b = reinterpret_cast<float*>(smem + weight_bytes(H, layers));   // b0, brest, lng, lnb
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    s_b[i] = b0[i];
    s_b[(1 + layers) * H + i] = lng[i];
    s_b[(2 + layers) * H + i] = lnb[i];
  }
  for (int i = threadIdx.x; i < layers * H; i += blockDim.x) s_b[H + i] = brest[i];
  return reinterpret_cast<unsigned char*>(s_b + (3 + layers) * H);
}

// ---------------------------------------------------------------------------
// the ring: producer side
// ---------------------------------------------------------------------------

// The producer warps (NP threads, the block's last) fill stage it % S for
// the block's it-th tile once its empty barrier has completed the phase
// before: the fields by plain stores and one arrival per thread (release),
// the rows, mask and 1/d by cp.async (zero fill on padding), one arrival
// per thread when its copies land (full barrier count 2 NP).  16-byte
// copies from several warps: 128-byte bulk copies (cp.async.bulk) issued
// by one warp took 2.4x as long a tile (tools/nmp_bf16_phases.py).
template <int H, int NP, int S>
__device__ void produce(float* stages, uint32_t full0, uint32_t empty0,
                        const float* __restrict__ x, const float* __restrict__ e,
                        const int* __restrict__ perm, const int* __restrict__ src,
                        const int* __restrict__ rowptr, const int* __restrict__ tile_lo,
                        const float* __restrict__ emask, const float* __restrict__ einv,
                        int n_real, int n_tiles, int first, int stride) {
  constexpr int SX = Cfg<H>::SX, CH = H / 4, SPT = (kRows + NP - 1) / NP;
  const int tid = threadIdx.x % NP;
  int pf_eid[SPT], pf_src[SPT], pf_lo = 0, pf_hi = 0;
  // the tile's slots and node range, a tile ahead, into registers
  auto prefetch = [&](int tile) {
    if (tile >= n_tiles) return;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int slot = tile * kRows + tid + j * NP;
      pf_eid[j] = slot < n_real ? perm[slot] : -1;
      pf_src[j] = slot < n_real ? src[slot] : 0;
    }
    pf_lo = tile_lo[tile];
    pf_hi = tile_lo[tile + 1];
  };
  prefetch(first);
  PHASE_BEGIN;
  uint32_t it = 0;
  for (int tile = first; tile < n_tiles; tile += stride, ++it) {
    const int s = it % S;
    ring_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
    PHASE(0);                               // wait for a free stage
    const Stage st = stage_at<H>(stages + s * stage_words(H));
    const int base = tile * kRows, end = min(base + kRows, n_real);
    const int lo = pf_lo, hi = pf_hi, n0 = max(lo - 1, 0);
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int r = tid + j * NP;
      if (r < kRows) {
        st.eid[r] = pf_eid[j];
        st.src[r] = pf_src[j];
        if (base + r >= end) st.dst[r] = 0;
      }
    }
    if (tid == 0) {
      st.lohi[0] = lo;
      st.lohi[1] = hi;
    }
    prefetch(tile + stride);
    // the slots' destinations: the nodes from the one holding slot `base`
    // (at most lo - 1) to the last one starting before `end` (hi - 1)
    for (int n = n0 + tid; n < hi; n += NP) {
      const int rs0 = rowptr[n], re0 = rowptr[n + 1];
      if (n - n0 < kRunCache) {
        st.run[2 * (n - n0)] = rs0;
        st.run[2 * (n - n0) + 1] = re0;
      }
      for (int q = max(rs0, base); q < min(re0, end); ++q) st.dst[q - base] = n;
    }
    producer_sync<NP>();
    PHASE(1);                               // fields and destinations
    const uint32_t full = full0 + 8 * s;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int r = tid + j * NP;
      if (r >= kRows) continue;
      const int eid = st.eid[r], ok = eid >= 0 ? 4 : 0;
      cp_async4_zfill(smem_u32(st.m + r), emask + max(eid, 0), ok);
      cp_async4_zfill(smem_u32(st.inv + r), einv + max(eid, 0), ok);
    }
    // the rows: CH threads per 4H-byte row slice, the slices part-major
    // (x_src of every row, then x_dst, then e); this thread's chunk c of the
    // rows r1 + RPI j.  Its rows' fields are read first, all at once: with a
    // read of the fields before each copy the copies waited on those reads
    {
      constexpr int RPI = NP / CH, IPP = kRows / RPI;   // slices a pass; passes a part
      const int r1 = tid / CH, c = (tid % CH) * 4;
      int f_src[IPP], f_dst[IPP], f_eid[IPP];
#pragma unroll
      for (int j = 0; j < IPP; ++j) {
        f_src[j] = st.src[r1 + RPI * j];
        f_dst[j] = st.dst[r1 + RPI * j];
        f_eid[j] = st.eid[r1 + RPI * j];
      }
#pragma unroll
      for (int k = 0; k < 3 * IPP; ++k) {
        const int part = k / IPP, j = k % IPP, r = r1 + RPI * j;
        const float* row = part == 0 ? x + (size_t)f_src[j] * H
                         : part == 1 ? x + (size_t)f_dst[j] * H
                                     : e + (size_t)max(f_eid[j], 0) * H;
        cp_async16_zfill(smem_u32(st.rows + r * SX + part * H + c), row + c,
                         f_eid[j] >= 0 ? 16 : 0);
      }
    }
    mbar_arrive(full);
    cp_async_mbar_arrive(full);
    PHASE(2);                               // copies issued
  }
  PHASE_END(S == kFwdStages ? 0 : 2);
}

// ---------------------------------------------------------------------------
// consumer side: the warp's products
// ---------------------------------------------------------------------------

// this lane's byte offset in an ldmatrix.x4.trans of B = w [k][n] (bf16,
// row stride SW): matrices (k0.., n0), (k0 + 8.., n0), (k0.., n0 + 8),
// (k0 + 8.., n0 + 8), i.e. b0, b1 of n-tile n0 and of n-tile n0 + 8
template <int H>
__device__ __forceinline__ uint32_t b_lane_offset(int lane) {
  return ((((lane >> 3) & 1) * 8 + (lane & 7)) * Cfg<H>::SW + (lane >> 4) * 8) * 2;
}
// z[nt] += A B for one k-step of 16: B the k-step's 16 rows of a weight
// matrix in shared memory (wk: the byte address of its row k0), by
// ldmatrix.trans, two n-tiles a load
template <int H>
__device__ __forceinline__ void mma_w(float (&z)[H / 8][4], const uint32_t (&af)[4], uint32_t wk,
                                      uint32_t lofs) {
  constexpr int NT = H / 8;
  if (NT == 1) {
    uint32_t b0, b1;
    ldsm_x2_trans(b0, b1, wk + lofs);
    mma_bf16(z[0], af, b0, b1);
  } else {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t b[4];
      ldsm_x4_trans(b, wk + lofs + p * 32);
      mma_bf16(z[2 * p], af, b[0], b[1]);
      mma_bf16(z[2 * p + 1], af, b[2], b[3]);
    }
  }
}

// layer 0 of the warp's 16 rows: z += rb([x_src | x_dst | e]) rb(w0), A
// from the staged fp32 rows (8-byte loads of the k pairs 2t, 2t + 1 and
// 2t + 8, 2t + 9, rounded into the fragment) of rows r0 + g, r0 + g + 8
template <int H>
__device__ __forceinline__ void layer0(float (&z)[H / 8][4], const Stage& st, int r0,
                                       uint32_t w0s, uint32_t lofs, int g, int t) {
  constexpr int SX = Cfg<H>::SX, SW = Cfg<H>::SW;
  const float* own[2] = {st.rows + (r0 + g) * SX, st.rows + (r0 + g + 8) * SX};
  auto pair = [&](int h2, int kb) {         // rb of (row g + 8 h2, columns kb + 2t, + 1)
    const float2 u = *reinterpret_cast<const float2*>(own[h2] + kb + 2 * t);
    return bf16x2(u.x, u.y);
  };
#pragma unroll
  for (int ks = 0; ks < (3 * H + 15) / 16; ++ks) {
    const bool upper = ks * 16 + 8 < 3 * H;   // compile-time: a last half k-step
    uint32_t af[4] = {pair(0, ks * 16), pair(1, ks * 16), 0u, 0u};
    if (upper) {
      af[2] = pair(0, ks * 16 + 8);
      af[3] = pair(1, ks * 16 + 8);
    }
    mma_w<H>(z, af, w0s + ks * 16 * SW * 2, lofs);
  }
}

// the A fragments of the next product from packed bf16 activations h[nt]
// (h[nt][0]: row g, columns 8 nt + 2t, + 1; h[nt][1]: row g + 8): k-step
// k takes n-tiles 2k and 2k + 1
template <int H>
__device__ __forceinline__ void chain(uint32_t (&af)[Cfg<H>::KS][4], const uint32_t (&h)[H / 8][2]) {
  constexpr int NT = H / 8;
#pragma unroll
  for (int ks = 0; ks < Cfg<H>::KS; ++ks) {
    const int hi = 2 * ks + 1 < NT ? 2 * ks + 1 : NT - 1;
    af[ks][0] = h[2 * ks][0];
    af[ks][1] = h[2 * ks][1];
    af[ks][2] = 2 * ks + 1 < NT ? h[hi][0] : 0u;
    af[ks][3] = 2 * ks + 1 < NT ? h[hi][1] : 0u;
  }
}

template <int H>
__device__ __forceinline__ void pack_rows(uint32_t (&h)[H / 8][2], const float (&z)[H / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    h[nt][0] = bf16x2(z[nt][0], z[nt][1]);
    h[nt][1] = bf16x2(z[nt][2], z[nt][3]);
  }
}

// LayerNorm over each row's H features, in the C fragments (biased
// variance, eps 1e-5)
template <int H>
__device__ __forceinline__ void layer_norm(float (&z)[H / 8][4], const float* s_lg,
                                           const float* s_lb, int t) {
  constexpr int NT = H / 8;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float s = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s += z[nt][2 * h2] + z[nt][2 * h2 + 1];
    const float mu = row_sum(s) * (1.f / H);
    float v = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float d0 = z[nt][2 * h2] - mu, d1 = z[nt][2 * h2 + 1] - mu;
      v += d0 * d0 + d1 * d1;
    }
    const float rstd = rsqrtf(row_sum(v) * (1.f / H) + 1e-5f);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = nt * 8 + 2 * t + q;
        z[nt][2 * h2 + q] = (z[nt][2 * h2 + q] - mu) * rstd * s_lg[col] + s_lb[col];
      }
  }
}

// The per-node sums of a tile (consumer threads): per node, the rows of its
// slots in this tile (slab, row stride ss) in slot order, weighted by 1/d
// (WEIGHTED) or not, four features a thread; a node whose run lies inside
// the tile gets its row of `out` from this one writer, the parts of a node
// cut by a tile edge go to the tile's partial rows (0: the node running in
// from the tile before, 1: the node starting here and running past the
// tile's end)
template <int H, bool WEIGHTED>
__device__ void node_walk(const float* slab, int ss, const Stage& st,
                          const int* __restrict__ rowptr, int base, int end, int tile,
                          float* __restrict__ out, float* __restrict__ partials, int tid) {
  constexpr int CH = H / 4;
  const int lo = st.lohi[0], hi = st.lohi[1], n0 = max(lo - 1, 0);
  const int j = (tid % CH) * 4;
  for (int n = n0 + tid / CH; n < hi; n += kCThreads / CH) {
    const bool cached = n - n0 < kRunCache;
    const int rs0 = cached ? st.run[2 * (n - n0)] : rowptr[n];
    const int re0 = cached ? st.run[2 * (n - n0) + 1] : rowptr[n + 1];
    if (rs0 < base && re0 <= base) continue;   // ended before this tile
    const int rs = max(rs0, base), re = min(re0, end);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = rs; s < re; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(slab + (s - base) * ss + j);
      if (WEIGHTED) {
        const float w = st.inv[s - base];
        acc.x = fmaf(a.x, w, acc.x);
        acc.y = fmaf(a.y, w, acc.y);
        acc.z = fmaf(a.z, w, acc.z);
        acc.w = fmaf(a.w, w, acc.w);
      } else {
        acc.x += a.x;
        acc.y += a.y;
        acc.z += a.z;
        acc.w += a.w;
      }
    }
    float* o = rs0 < base  ? partials + (size_t)tile * 2 * H
               : re0 > end ? partials + ((size_t)tile * 2 + 1) * H
                           : out + (size_t)n * H;
    *reinterpret_cast<float4*>(o + j) = acc;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float *x, *e;
  const int *perm, *src, *rowptr, *tile_lo;
  const float *emask, *einv, *w0, *b0, *wrest, *brest, *lng, *lnb;
  float *e_new, *agg, *partials;
  uint8_t* covered;
  int n_nodes, n_hidden, lps, has_ln;
};

// One consumer group (8 warps, 16 rows each) of the forward: the block's
// tiles it = grp, grp + kFwdGroups, ... of its sequence
template <int H>
__device__ void fwd_consume(const FwdArgs& p, float* stages, uint32_t full0, uint32_t empty0,
                            uint32_t w_s, const float* s_b, int n_real, int n_tiles, int first,
                            int stride) {
  using C = Cfg<H>;
  constexpr int NT = C::NT, SX = C::SX, SW = C::SW, KS = C::KS;
  const int grp = threadIdx.x / kCThreads, tid = threadIdx.x % kCThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const uint32_t lofs = b_lane_offset<H>(lane);
  const float* s_br = s_b + H;
  const float* s_lg = s_b + (1 + p.lps) * H;
  const float* s_lb = s_lg + H;
  PHASE_BEGIN;
  uint32_t it = grp;
  for (int tile = first + grp * stride; tile < n_tiles;
       tile += kFwdGroups * stride, it += kFwdGroups) {
    const int s = it % kFwdStages;
    ring_wait(full0 + 8 * s, (it / kFwdStages) & 1);
    __syncwarp();
    PHASE(0);                               // wait for a landed stage
    const Stage st = stage_at<H>(stages + s * stage_words(H));
    const int base = tile * kRows, end = min(base + kRows, n_real);
    float* xw = st.rows + r0 * SX;

    // --- the MLP on the warp's 16 rows, chained in registers ---
    float z[NT][4];
    init_bias<NT>(z, s_b, t);
    layer0<H>(z, st, r0, w_s, lofs, g, t);
    for (int l = 0; l < p.n_hidden; ++l) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[nt][j] = elu_ftz(z[nt][j]);
      uint32_t h[NT][2], af[KS][4];
      pack_rows<H>(h, z);
      chain<H>(af, h);
      if (l < p.lps) {
        init_bias<NT>(z, s_br + l * H, t);
        const uint32_t wl = w_s + C::W0B + l * C::LB;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_w<H>(z, af[ks], wl + ks * 16 * SW * 2, lofs);
      } else {                              // weights past shared memory, rounded per fragment
        const float* w = p.wrest + (size_t)l * H * H;
        init_bias<NT>(z, p.brest + (size_t)l * H, t);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int k = ks * 16 + 2 * t;
          const bool upper = ks * 16 + 8 < H;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = nt * 8 + g;
            const uint32_t b0 = bf16x2(__ldg(w + k * H + n), __ldg(w + (k + 1) * H + n));
            const uint32_t b1 =
                upper ? bf16x2(__ldg(w + (k + 8) * H + n), __ldg(w + (k + 9) * H + n)) : 0u;
            mma_bf16(z[nt], af[ks], b0, b1);
          }
        }
      }
    }
    if (p.has_ln) layer_norm<H>(z, s_lg, s_lb, t);

    // --- e' = (e + h) * mask to the edge's row and into the stage (the
    //     x_src columns, read by no one else) for the per-node sums ---
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = g + 8 * h2;
      const float m = st.m[r0 + r];          // 0 on padding rows
      const int eid = st.eid[r0 + r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t;
        const float2 ev = *reinterpret_cast<const float2*>(xw + r * SX + 2 * H + col);
        const float2 v = make_float2((ev.x + z[nt][2 * h2]) * m, (ev.y + z[nt][2 * h2 + 1]) * m);
        *reinterpret_cast<float2*>(xw + r * SX + col) = v;
        if (eid >= 0) *reinterpret_cast<float2*>(p.e_new + (size_t)eid * H + col) = v;
      }
      if (eid >= 0 && t == 0) p.covered[eid] = 1;
    }
    PHASE(1);                               // the MLP, LayerNorm and e'
    consumer_sync(grp);
    PHASE(2);                               // the barrier

    // --- agg: per node, e' * (1/d) summed in slot order ---
    node_walk<H, true>(st.rows, SX, st, p.rowptr, base, end, tile, p.agg, p.partials, tid);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    PHASE(3);                               // the per-node sums
  }
  PHASE_END(1);
}

template <int H>
__global__ void __launch_bounds__(kFwdThreads, 1) nmp_bf16_fwd_kernel(const FwdArgs p) {
  using C = Cfg<H>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(
      load_params<H>(smem, p.w0, p.b0, p.wrest, p.brest, p.lng, p.lnb, p.lps));
  const uint32_t full0 = smem_u32(stages + kFwdStages * stage_words(H));
  const uint32_t empty0 = full0 + 8 * kFwdStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full0 + 8 * s, 2 * kFwdProducers);   // fields + copies of each producer thread
      mbar_init(empty0 + 8 * s, kCWarps);   // one arrival per warp of the consuming group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_real = p.rowptr[p.n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + kRows - 1) / kRows : 1;
  if (threadIdx.x >= kFwdGroups * kCThreads)
    produce<H, kFwdProducers, kFwdStages>(stages, full0, empty0, p.x, p.e, p.perm, p.src, p.rowptr,
                           p.tile_lo, p.emask, p.einv, n_real, n_tiles, blockIdx.x,
                           gridDim.x);
  else
    fwd_consume<H>(p, stages, full0, empty0, smem_u32(smem),
                   reinterpret_cast<const float*>(smem + weight_bytes(H, p.lps)), n_real,
                   n_tiles, blockIdx.x, gridDim.x);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float *x, *e;
  const int *perm, *src, *rowptr, *tile_lo;
  const float *emask, *einv, *w0, *b0, *wrest, *brest, *lng, *lnb, *genew, *gagg;
  float *gx, *ge, *partials, *wpartials;
  uint32_t* gxs;
  uint8_t* covered;
  int n_nodes, n_hidden, has_ln;
};

// ELU'(z) from a = ELU(z): 1 where z > 0 (a > 0), exp(z) = a + 1 elsewhere
__device__ __forceinline__ float elu_grad(float a) { return a > 0.f ? 1.f : a + 1.f; }

// The backward's slabs in a K-major layout of 8 x 8 bf16 core matrices
// (128 contiguous bytes, each 8 rows (features) of 16 bytes (8 consecutive
// slots)); per group of 8 slots (a k-group) a row of core matrices, one per
// group of 8 features.  The warps write their rows by stmatrix.trans (two
// 16 x 8 blocks an instruction), the weight gradients read every row's by
// ldmatrix (A and B fragments over K = slots), the input gradients their
// own rows' by ldmatrix.trans.  The activation slab holds the Lp layers
// side by side in each k-group row; the parts slab G's three bf16 parts,
// one H-feature block each.
template <int H>
struct Kmaj {
  static constexpr int MG = H / 8;                     // core matrices of H features
  __host__ __device__ static constexpr int act_row(int lp) { return lp * MG * 128; }
  __host__ __device__ static constexpr int act_bytes(int lp) { return kRows / 8 * act_row(lp); }
  static constexpr int PROW = MG * 128;                // a k-group row of one part
  static constexpr int PART = kRows / 8 * PROW;        // bytes of one part
};

// this lane's byte offset in an stmatrix / ldmatrix .x4.trans of the warp's
// 16 rows (slots r0 ..) x 16 features (two core-matrix columns) in a
// K-major slab with k-group rows of `row` bytes: matrices (slots r0.., f),
// (r0 + 8.., f), (r0.., f + 8), (r0 + 8.., f + 8), lane 8q + j giving memory
// row j (feature) of matrix q; x2: the first two
__device__ __forceinline__ uint32_t kmaj_lane(int lane, int r0, int row) {
  const int q = lane >> 3;
  return (r0 / 8 + (q & 1)) * row + (q >> 1) * 128 + (lane & 7) * 16;
}

__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stsm_x2_trans(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1,%2};\n" ::"r"(addr),
               "r"(r0), "r"(r1)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// The warp's 16 rows x H features of bf16 pairs v[nt][h] (rows g + 8h,
// features 8 nt + 2t, + 1) into a K-major slab (base: the block's first
// core-matrix column, lofs: kmaj_lane's offset), by stmatrix.trans
template <int H>
__device__ __forceinline__ void kmaj_store(uint32_t base, const uint32_t (&v)[H / 8][2]) {
  if (H == 8) {
    stsm_x2_trans(base, v[0][0], v[0][1]);
  } else {
#pragma unroll
    for (int p = 0; p < H / 16; ++p)
      stsm_x4_trans(base + p * 256, v[2 * p][0], v[2 * p][1], v[2 * p + 1][0], v[2 * p + 1][1]);
  }
}
// ... and back (v as the A fragments of the rows: the chain's layout)
template <int H>
__device__ __forceinline__ void kmaj_load(uint32_t (&v)[H / 8][2], uint32_t base) {
  if (H == 8) {
    ldsm_x2_trans(v[0][0], v[0][1], base);
  } else {
#pragma unroll
    for (int p = 0; p < H / 16; ++p) {
      uint32_t r[4];
      ldsm_x4_trans(r, base + p * 256);
      v[2 * p][0] = r[0];
      v[2 * p][1] = r[1];
      v[2 * p + 1][0] = r[2];
      v[2 * p + 1][1] = r[3];
    }
  }
}

// G's three bf16 parts of the warp's 16 rows into the parts slab (split3)
template <int H>
__device__ __forceinline__ void store_parts(uint32_t parts_l, const float (&gz)[H / 8][4]) {
  uint32_t v[3][H / 8][2];
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      split3(gz[nt][2 * h2], gz[nt][2 * h2 + 1], v[0][nt][h2], v[1][nt][h2], v[2][nt][h2]);
#pragma unroll
  for (int q = 0; q < 3; ++q) kmaj_store<H>(parts_l + q * Kmaj<H>::PART, v[q]);
}

// out[nt] += G W^T for the warp's 16 rows: G's three bf16 parts (pa: the
// parts slab at the warp's rows, with this lane's kmaj_lane offset) as A
// fragments by ldmatrix.trans; W [n][k] bf16 words in shared memory (row n
// = output column of this product, row stride SW / 2 words), B = W^T by
// 4-byte loads; the parts' products smallest first
template <int H>
__device__ __forceinline__ void mm_cot(float (&out)[H / 8][4], uint32_t pa, const uint32_t* W,
                                       int g, int t) {
  constexpr int NT = H / 8, WPR = Cfg<H>::SW / 2;
  uint32_t v[3][NT][2];
#pragma unroll
  for (int q = 0; q < kCotParts; ++q) kmaj_load<H>(v[q], pa + q * Kmaj<H>::PART);
#pragma unroll
  for (int ks = 0; ks < Cfg<H>::KS; ++ks) {
    const bool up = 2 * ks + 1 < NT;        // compile-time: a whole k-step of 16
    const int hi = up ? 2 * ks + 1 : NT - 1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t* wr = W + (nt * 8 + g) * WPR + ks * 8 + t;
      const uint32_t b0 = wr[0], b1 = up ? wr[4] : 0u;
#pragma unroll
      for (int q = kCotParts - 1; q >= 0; --q) {
        const uint32_t a[4] = {v[q][2 * ks][0], v[q][2 * ks][1], up ? v[q][hi][0] : 0u,
                               up ? v[q][hi][1] : 0u};
        mma_bf16(out[nt], a, b0, b1);
      }
    }
  }
}

// The warp's column sums of G (its 16 rows) added to its sums s (H floats):
// over the rows g, g + 8 of each lane, then over the lanes' g by shuffles,
// lanes g == 0 adding
template <int H>
__device__ __forceinline__ void col_sums(float* s, const float (&gz)[H / 8][4], int g, int t) {
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float v = gz[nt][q] + gz[nt][2 + q];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
      if (g == 0) s[nt * 8 + 2 * t + q] += v;
    }
}

// One weight-gradient product over the tile's 128 rows (K = rows): for each
// of the CM m-tiles mt[i] (skipped when >= m_tiles) acc[i] += act^T[16
// features from 16 mt[i]][rows] x G[rows][the warp's 8 features], the A
// fragment of (m-tile, k-step) from afrag, G's three bf16 parts as B
// fragments by ldmatrix from the parts slab (pb: the n-tile's rows with
// this lane's offset).  The tile's product is summed in fresh fragments,
// one per part (three independent chains), and added to acc once per tile
// in fp32, the smallest part first (the tensor cores' accumulation does
// not round to nearest: carried through a block's ~33,000 rows a fragment
// lost ~2e-4 of its value in the fp32 kernel).
template <int CM, int H, class FA>
__device__ __forceinline__ void wgrad(float (&acc)[CM][4], const int (&mt)[CM], int m_tiles,
                                      FA afrag, uint32_t pb) {
  float fresh[3][CM][4] = {};
#pragma unroll kWgradUnroll
  for (int ks = 0; ks < kRows / 16; ++ks) {
    uint32_t b0[3], b1[3];
#pragma unroll
    for (int q = 0; q < kCotParts; ++q)
      ldsm_x2(b0[q], b1[q], pb + q * Kmaj<H>::PART + 2 * ks * Kmaj<H>::PROW);
#pragma unroll
    for (int i = 0; i < CM; ++i) {
      if (mt[i] >= m_tiles) continue;
      uint32_t a[4];
      afrag(mt[i], ks, a);
#pragma unroll
      for (int q = 0; q < kCotParts; ++q) mma_bf16(fresh[q][i], a, b0[q], b1[q]);
    }
  }
#pragma unroll
  for (int i = 0; i < CM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += fresh[2][i][j] + fresh[1][i][j] + fresh[0][i][j];
}

template <int H>
__device__ void bwd_consume(const BwdArgs& p, float* stages, uint32_t full0, uint32_t empty0,
                            unsigned char* smem, unsigned char* slabs, int n_real, int n_tiles,
                            int first, int stride) {
  using C = Cfg<H>;
  using K = Kmaj<H>;
  constexpr int NT = C::NT, SX = C::SX, SW = C::SW, SA = C::SA, KS = C::KS;
  constexpr int MS = kCWarps / NT;           // warps per n-tile in the weight gradients
  constexpr int M0T = (3 * H + 15) / 16;     // m-tiles over w0's 3H input rows
  constexpr int MHT = (H + 15) / 16;         // m-tiles over a hidden layer's H rows
  constexpr int CW0 = (M0T + MS - 1) / MS, CWH = (MHT + MS - 1) / MS;
  const int lp = p.n_hidden;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const uint32_t lofs = b_lane_offset<H>(lane);
  // act^T of the staged rows once they hold bf16 (row stride SX floats)
  const uint32_t aofs_x = ((lane >> 4) * 8 + (lane & 7)) * SX * 4 + ((lane >> 3) & 1) * 16;
  const uint32_t w_s = smem_u32(smem);
  const uint32_t* w_words = reinterpret_cast<const uint32_t*>(smem);
  const float* s_b = reinterpret_cast<const float*>(smem + weight_bytes(H, lp));
  const float* s_br = s_b + H;
  const float* s_lg = s_b + (1 + lp) * H;
  const int arow = K::act_row(lp);
  const uint32_t act_s = smem_u32(slabs);                    // K-major: act_l^T, l < lp
  const uint32_t act_w = act_s + kmaj_lane(lane, r0, arow);  // the warp's rows
  // K-major: G's parts, two buffers of three (G_{l+1} read while G_l is
  // written: one barrier a layer); the free one then takes the x_dst
  // gradients (fp32 [kRows][SA])
  const uint32_t parts_s = act_s + K::act_bytes(lp);
  const uint32_t parts_w = parts_s + kmaj_lane(lane, r0, K::PROW);
  constexpr int PBUF = 3 * K::PART;
  // each warp's column sums, added once a tile: the biases (b0, brest_l:
  // G_0 .. G_lp) and the LayerNorm (ln_g then ln_b)
  float* s_sum = reinterpret_cast<float*>(slabs + K::act_bytes(lp) + 2 * PBUF) +
                 warp * (lp + 3) * H;
  float* s_ln = s_sum + (lp + 1) * H;
  for (int i = lane; i < (lp + 3) * H; i += 32) s_sum[i] = 0.f;

  const int nt_w = warp % NT, mg = warp / NT;   // this warp's weight-gradient n-tile, m group
  int mt0[CW0], mth[CWH];
#pragma unroll
  for (int i = 0; i < CW0; ++i) mt0[i] = mg + i * MS;
#pragma unroll
  for (int i = 0; i < CWH; ++i) mth[i] = mg + i * MS;
  // the B fragments: the n-tile's rows of the parts slab, k-groups 2ks, + 1
  const uint32_t pb = parts_s + ((lane >> 3) & 1) * K::PROW + nt_w * 128 + (lane & 7) * 16;
  // the hidden layers' A: features 16 mt (+ 8), slots 16 ks (+ 8)
  const uint32_t la = (lane >> 4) * arow + ((lane >> 3) & 1) * 128 + (lane & 7) * 16;
  float acc0[CW0][4] = {};                  // w0 tiles
  float acch[kMaxHidden][CWH][4] = {};      // wrest_l tiles

  PHASE_BEGIN;
  uint32_t it = 0;
  for (int tile = first; tile < n_tiles; tile += stride, ++it) {
    const int s = it % kBwdStages;
    ring_wait(full0 + 8 * s, (it / kBwdStages) & 1);
    __syncwarp();
    PHASE(0);                               // wait for a landed stage
    const Stage st = stage_at<H>(stages + s * stage_words(H));
    const int base = tile * kRows, end = min(base + kRows, n_real);

    // the cotangent's rows, requested before the recompute so that their
    // latency hides behind it
    float2 cot_n[2][NT], cot_a[2][NT];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + g + 8 * h2;
      const int eid = st.eid[r], d = st.dst[r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t;
        cot_n[h2][nt] = cot_a[h2][nt] = make_float2(0.f, 0.f);
        if (eid >= 0) {
          cot_n[h2][nt] = __ldg(reinterpret_cast<const float2*>(p.genew + (size_t)eid * H + col));
          cot_a[h2][nt] = __ldg(reinterpret_cast<const float2*>(p.gagg + (size_t)d * H + col));
        }
      }
    }

    // --- forward recompute of the warp's 16 rows: rb(ELU(z_l)) to the
    //     activation slab, the rounding's remainder (bf16) kept for ELU' ---
    float z[NT][4];
    init_bias<NT>(z, s_b, t);
    layer0<H>(z, st, r0, w_s, lofs, g, t);
    uint32_t res[kMaxHidden][NT][2];
#pragma unroll
    for (int l = 0; l < kMaxHidden; ++l) {
      if (l >= lp) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[nt][j] = elu_ftz(z[nt][j]);
      uint32_t h[NT][2], af[KS][4];
      pack_rows<H>(h, z);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        res[l][nt][0] = bf16x2(z[nt][0] - bf16_lo(h[nt][0]), z[nt][1] - bf16_hi(h[nt][0]));
        res[l][nt][1] = bf16x2(z[nt][2] - bf16_lo(h[nt][1]), z[nt][3] - bf16_hi(h[nt][1]));
      }
      kmaj_store<H>(act_w + l * K::MG * 128, h);
      chain<H>(af, h);
      init_bias<NT>(z, s_br + l * H, t);
      const uint32_t wl = w_s + C::W0B + l * C::LB;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma_w<H>(z, af[ks], wl + ks * 16 * SW * 2, lofs);
    }
    // the warp's staged rows rounded to bf16 in place ([x_src | x_dst | e]
    // in the first 6H bytes of each row), for w0's gradient
#pragma unroll 4
    for (int r = r0; r < r0 + 16; ++r) {
      float* row = st.rows + r * SX;
      float2 v[(3 * H / 2 + 31) / 32];
#pragma unroll
      for (int i = 0; i < (3 * H / 2 + 31) / 32; ++i)
        if (lane + 32 * i < 3 * H / 2) v[i] = reinterpret_cast<const float2*>(row)[lane + 32 * i];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < (3 * H / 2 + 31) / 32; ++i)
        if (lane + 32 * i < 3 * H / 2)
          reinterpret_cast<uint32_t*>(row)[lane + 32 * i] = bf16x2(v[i].x, v[i].y);
      __syncwarp();
    }
    PHASE(1);                               // the forward recompute

    // --- cotangent of (e + h), LayerNorm backward ---
    float gh[NT][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + g + 8 * h2;
      const float m = st.m[r], iv = st.inv[r];   // 0 on padding rows
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        gh[nt][2 * h2] = fmaf(cot_a[h2][nt].x, iv, cot_n[h2][nt].x) * m;
        gh[nt][2 * h2 + 1] = fmaf(cot_a[h2][nt].y, iv, cot_n[h2][nt].y) * m;
      }
    }
    float gz[NT][4];
    if (p.has_ln) {
      float cg[NT][2] = {}, cb[NT][2] = {};   // this tile's column sums of the warp's rows
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float sm = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) sm += z[nt][2 * h2] + z[nt][2 * h2 + 1];
        const float mu = row_sum(sm) * (1.f / H);
        float v = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float d0 = z[nt][2 * h2] - mu, d1 = z[nt][2 * h2 + 1] - mu;
          v += d0 * d0 + d1 * d1;
        }
        const float rstd = rsqrtf(row_sum(v) * (1.f / H) + 1e-5f);
        float xh[NT][2], gxl[NT][2], s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float ghv = gh[nt][2 * h2 + q];
            xh[nt][q] = (z[nt][2 * h2 + q] - mu) * rstd;
            cg[nt][q] += ghv * xh[nt][q];
            cb[nt][q] += ghv;
            gxl[nt][q] = ghv * s_lg[nt * 8 + 2 * t + q];
            s1 += gxl[nt][q];
            s2 += gxl[nt][q] * xh[nt][q];
          }
        const float m1 = row_sum(s1) * (1.f / H), m2 = row_sum(s2) * (1.f / H);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            gz[nt][2 * h2 + q] = rstd * (gxl[nt][q] - m1 - xh[nt][q] * m2);
      }
      // over the lanes' rows (g), then into the warp's sums (lanes g == 0)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            cg[nt][q] += __shfl_xor_sync(kFull, cg[nt][q], off);
            cb[nt][q] += __shfl_xor_sync(kFull, cb[nt][q], off);
          }
          if (g == 0) {
            s_ln[nt * 8 + 2 * t + q] += cg[nt][q];
            s_ln[H + nt * 8 + 2 * t + q] += cb[nt][q];
          }
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) gz[nt][j] = gh[nt][j];
    }
    // g_h waits for layer 0 in the free tail of the warp's staged rows
    // (past their bf16 copies and what w0's ldmatrix reads of them)
    constexpr int GHO = (3 * H + 15) / 16 * 8;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(st.rows + (r0 + g + 8 * h2) * SX + GHO + nt * 8 + 2 * t) =
            make_float2(gh[nt][2 * h2], gh[nt][2 * h2 + 1]);
    col_sums<H>(s_sum + lp * H, gz, g, t);   // the last layer's bias
    int cur = 0;                            // the buffer of the parts read next
    store_parts<H>(parts_w, gz);
    consumer_sync();
    PHASE(2);                               // g_h, the LayerNorm's backward, a barrier

    // --- hidden layers, last to first: the weight gradient over the tile,
    //     the input gradient of the warp's rows ---
#pragma unroll
    for (int l = kMaxHidden - 1; l >= 0; --l) {
      if (l >= lp) continue;
      if (MS <= MHT || mg < MHT) {          // (every warp at H = 32)
        const uint32_t al = act_s + l * K::MG * 128 + la;
        auto act = [&](int mt, int ks, uint32_t (&a)[4]) {
          ldsm_x4(a, al + 2 * ks * arow + mt * 256);
        };
        wgrad<CWH, H>(acch[l], mth, MHT, act, pb + cur * PBUF);
      }
      PHASE(3);                             // hidden weight gradients
      float ga[NT][4] = {};
      mm_cot<H>(ga, parts_w + cur * PBUF, w_words + (C::W0B + l * C::LB) / 4, g, t);
      uint32_t aw[NT][2];
      kmaj_load<H>(aw, act_w + l * K::MG * 128);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const uint32_t hw = aw[nt][h2], rw = res[l][nt][h2];
          const float a0 = bf16_lo(hw) + bf16_lo(rw), a1 = bf16_hi(hw) + bf16_hi(rw);
          // the cotangent of rb(a_l), rounded, times ELU'
          gz[nt][2 * h2] = round_bf16(ga[nt][2 * h2]) * elu_grad(a0);
          gz[nt][2 * h2 + 1] = round_bf16(ga[nt][2 * h2 + 1]) * elu_grad(a1);
        }
      col_sums<H>(s_sum + l * H, gz, g, t);   // the bias of layer l's input (b0 at l = 0)
      PHASE(4);                             // hidden input gradients
      cur ^= 1;
      store_parts<H>(parts_w + cur * PBUF, gz);
      consumer_sync();
      PHASE(5);                             // their barriers
    }

    // --- layer 0: w0's gradient over the tile (mma.sync: A the staged rows'
    //     bf16 copies by ldmatrix.trans, B the parts by ldmatrix); per row
    //     g_e, the slot's x_src gradient, its x_dst gradient for the node
    //     walk ---
    {
      const uint32_t ax = smem_u32(st.rows) + aofs_x;
      auto act = [&](int mt, int ks, uint32_t (&a)[4]) {
        ldsm_x4_trans(a, ax + ks * 16 * SX * 4 + mt * 32);
      };
      wgrad<CW0, H>(acc0, mt0, M0T, act, pb + cur * PBUF);
    }
    float pd[NT][4];                        // the x_dst gradients of the warp's rows
#pragma unroll 1
    for (int part = 0; part < 3; ++part) {
      const int sl = part == 0 ? 2 : part - 1;   // w0's slice: e, src, dst
      float pz[NT][4] = {};
      mm_cot<H>(pz, parts_w + cur * PBUF, w_words + sl * H * (SW / 2), g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) pz[nt][j] = round_bf16(pz[nt][j]);
      if (part == 2) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) pd[nt][j] = pz[nt][j];
        continue;
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + g + 8 * h2;
        const int eid = st.eid[r];
        if (eid < 0) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = nt * 8 + 2 * t;
          if (part == 0) {
            const float2 ghv =
                *reinterpret_cast<const float2*>(st.rows + r * SX + GHO + col);
            *reinterpret_cast<float2*>(p.ge + (size_t)eid * H + col) =
                make_float2(pz[nt][2 * h2] + ghv.x, pz[nt][2 * h2 + 1] + ghv.y);
          } else {                          // bf16 already: exact
            p.gxs[((size_t)base + r) * (H / 2) + nt * 4 + t] =
                bf16x2(pz[nt][2 * h2], pz[nt][2 * h2 + 1]);
          }
        }
        if (part == 0 && t == 0) p.covered[eid] = 1;
      }
    }
    PHASE(6);                               // layer 0: w0's gradient, g_e, g_x's parts
    float* Dn = reinterpret_cast<float*>(slabs + K::act_bytes(lp) + (cur ^ 1) * PBUF);
    store_c<NT>(Dn + r0 * SA, SA, pd, g, t);
    consumer_sync();
    node_walk<H, false>(Dn, SA, st, p.rowptr, base, end, tile, p.gx, p.partials, tid);
    consumer_sync();                        // the stage and the slabs are free
    if (tid == 0) mbar_arrive(empty0 + 8 * s);
    PHASE(7);                               // the x_dst sums and their barriers
  }
  PHASE_END(3);

  // --- this block's partial weight gradients, one writer per element ---
  const int lpx = lp > 0 ? lp : 1;
  float* P = p.wpartials + (size_t)blockIdx.x * wgrad_size(H, lpx);
  float* P_b0 = P + 3 * H * H;
  float* P_wr = P_b0 + H;
  float* P_br = P_wr + lpx * H * H;
  float* P_ln = P_br + lpx * H;             // lng then lnb
  const int col = nt_w * 8 + 2 * t;
#pragma unroll
  for (int i = 0; i < CW0; ++i) {
    if (mt0[i] >= M0T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = mt0[i] * 16 + g + (j >= 2 ? 8 : 0);
      if (row < 3 * H) P[row * H + col + (j & 1)] = acc0[i][j];
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxHidden; ++l) {
    if (l >= lpx) continue;
#pragma unroll
    for (int i = 0; i < CWH; ++i) {
      if (mth[i] >= MHT) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = mth[i] * 16 + g + (j >= 2 ? 8 : 0);
        if (row < H) P_wr[l * H * H + row * H + col + (j & 1)] = acch[l][i][j];
      }
    }
  }
  consumer_sync();
  // the biases and the LayerNorm: the warps' sums in order (s_sum)
  const float* sums = s_sum - warp * (lp + 3) * H;   // [kCWarps][lp + 3][H]
  for (int i = tid; i < (lpx + 3) * H; i += kCThreads) {
    const int l = i / H, c = i % H;
    float sm = 0.f;
    if (l <= lp || l >= lpx + 1)
      for (int w = 0; w < kCWarps; ++w)
        sm += sums[w * (lp + 3) * H + (l <= lp ? l : lp + 1 + (l - lpx - 1)) * H + c];
    if (l == 0)
      P_b0[c] = sm;
    else if (l <= lpx)
      P_br[(l - 1) * H + c] = sm;
    else
      P_ln[(l - lpx - 1) * H + c] = sm;
  }
}

template <int H>
__global__ void __launch_bounds__(kBwdThreads, 1) nmp_bf16_bwd_kernel(const BwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lp = p.n_hidden;
  float* stages = reinterpret_cast<float*>(
      load_params<H>(smem, p.w0, p.b0, p.wrest, p.brest, p.lng, p.lnb, lp));
  unsigned char* slabs = smem + bwd_slabs_at(H, lp);
  const uint32_t full0 = smem_u32(slabs + Kmaj<H>::act_bytes(lp) + 6 * Kmaj<H>::PART +
                                  kCWarps * (lp + 3) * H * 4);
  const uint32_t empty0 = full0 + 8 * kBwdStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full0 + 8 * s, 2 * kBwdProducers);   // fields + copies of each producer thread
      mbar_init(empty0 + 8 * s, 1);                   // the consumers, after their last barrier
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_real = p.rowptr[p.n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + kRows - 1) / kRows : 1;
  if (threadIdx.x >= kCThreads)
    produce<H, kBwdProducers, kBwdStages>(stages, full0, empty0, p.x, p.e, p.perm, p.src, p.rowptr,
                           p.tile_lo, p.emask, p.einv, n_real, n_tiles, blockIdx.x,
                           gridDim.x);
  else
    bwd_consume<H>(p, stages, full0, empty0, smem, slabs, n_real, n_tiles, blockIdx.x,
                   gridDim.x);
}

// ---------------------------------------------------------------------------
// the passes around the edge kernels
// ---------------------------------------------------------------------------

// tile_lo[b] = the least n with rowptr[n] >= b * kRows, b < n_tiles;
// tile_lo[n_tiles] = n_nodes.  Thread n writes the tiles b with
// rowptr[n - 1] < b * kRows <= rowptr[n]: one writer each.  A node belongs
// to the tile in which its run starts; the last tile also owns the nodes
// of degree 0 after the last slot.
__global__ void tile_lo_kernel(const int* __restrict__ rowptr, int* __restrict__ tile_lo,
                               int n_nodes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n > n_nodes) return;
  const int n_real = rowptr[n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + kRows - 1) / kRows : 1;
  const int b_lo = n == 0 ? 0 : rowptr[n - 1] / kRows + 1;
  const int b_hi = min(rowptr[n] / kRows, n_tiles - 1);
  for (int b = b_lo; b <= b_hi; ++b) tile_lo[b] = n;
  if (n == n_nodes) tile_lo[n_tiles] = n_nodes;
}

// out[n] for the node cut at the end of tile u where it starts: partial 1
// of u, then partial 0 of u + 1 .. its last tile, in tile order
template <int H>
__global__ void fixup_kernel(const int* __restrict__ rowptr, const int* __restrict__ tile_lo,
                             const float* __restrict__ partials, float* __restrict__ out,
                             int n_nodes) {
  const int u = blockIdx.x * (blockDim.x / H) + threadIdx.x / H;
  const int j = threadIdx.x % H;
  const int n_real = rowptr[n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + kRows - 1) / kRows : 1;
  if (u >= n_tiles - 1) return;             // the last tile cuts no node
  const int base = u * kRows, end = base + kRows;
  const int n = tile_lo[u + 1] - 1;         // the last node starting before `end`
  if (n < 0) return;
  const int rs0 = rowptr[n], re0 = rowptr[n + 1];
  if (rs0 < base || re0 <= end) return;     // not started here, or not cut
  float acc = partials[((size_t)u * 2 + 1) * H + j];
  const int last = (re0 - 1) / kRows;
  for (int v = u + 1; v <= last; ++v) acc += partials[((size_t)v * 2) * H + j];
  out[(size_t)n * H + j] = acc;
}

// rows of the edges no slot wrote (outside the layout) = 0: a thread an edge
template <int H>
__global__ void zero_kernel(const uint8_t* __restrict__ covered, float* __restrict__ rows,
                            long long n_edges) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_edges || covered[i]) return;
  float4* r = reinterpret_cast<float4*>(rows + i * H);
#pragma unroll
  for (int c = 0; c < H / 4; ++c) r[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// out[i] = sum over blocks, in block order; the weight matrices' sums (w0:
// the first 3h*h, wrest: lpx*h*h after b0) rounded to bf16, once
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int n_groups, int wsize, int h,
                                       int lpx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wsize) return;
  float s = 0.f;
  for (int g = 0; g < n_groups; ++g) s += partials[(size_t)g * wsize + i];
  const int wr_lo = 3 * h * h + h, wr_hi = wr_lo + lpx * h * h;
  if (i < 3 * h * h || (i >= wr_lo && i < wr_hi)) s = round_bf16(s);
  out[i] = s;
}

// g_x[n] += the x_src gradients of n's src slots (bf16 per slot), in
// src_slots order; H / 2 threads per node, a feature pair each
template <int H>
__global__ void node_src_kernel(const uint32_t* __restrict__ gxs,
                                const int* __restrict__ src_slots,
                                const int* __restrict__ src_rowptr, float* __restrict__ gx,
                                int n_nodes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int n = (int)(i / (H / 2)), j = (int)(i % (H / 2));
  if (n >= n_nodes) return;
  float s0 = 0.f, s1 = 0.f;
  for (int q = src_rowptr[n]; q < src_rowptr[n + 1]; ++q) {
    const uint32_t w = gxs[(size_t)src_slots[q] * (H / 2) + j];
    s0 += bf16_lo(w);
    s1 += bf16_hi(w);
  }
  float2* o = reinterpret_cast<float2*>(gx + (size_t)n * H) + j;
  const float2 d = *o;
  *o = make_float2(d.x + s0, d.y + s1);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct LaunchPlan {
  int grid, per_sm, lps, tiles, stages;
  size_t smem;
};

cudaError_t device_limits(int* optin, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <class K>
cudaError_t finish_plan(K kern, int threads, size_t smem, int sms, long long n_slots,
                        LaunchPlan* p) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return err;
  long long tiles = (n_slots + kRows - 1) / kRows;
  if (tiles < 1) tiles = 1;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  p->grid = (int)(tiles < cap ? tiles : cap);
  p->per_sm = per_sm;
  p->tiles = (int)tiles;
  p->smem = smem;
  return cudaSuccess;
}

template <int H>
cudaError_t fwd_plan_h(int n_hidden, long long n_slots, LaunchPlan* p) {
  int optin = 0, sms = 0;
  cudaError_t err = device_limits(&optin, &sms);
  if (err != cudaSuccess) return err;
  // as many hidden layers' weights in shared memory as fit
  const long long fixed = fwd_smem(H, 0), per_layer = fwd_smem(H, 1) - fixed;
  if (optin < fixed) return cudaErrorInvalidValue;
  const long long fit = (optin - fixed) / per_layer;
  p->lps = (int)(n_hidden < fit ? n_hidden : fit);
  p->stages = kFwdStages;
  return finish_plan(nmp_bf16_fwd_kernel<H>, kFwdThreads, fwd_smem(H, p->lps), sms, n_slots, p);
}

template <int H>
cudaError_t bwd_plan_h(int n_hidden, long long n_slots, LaunchPlan* p) {
  int optin = 0, sms = 0;
  cudaError_t err = device_limits(&optin, &sms);
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_smem(H, n_hidden);
  if ((size_t)optin < smem) return cudaErrorInvalidValue;
  p->lps = n_hidden;
  p->stages = kBwdStages;
  return finish_plan(nmp_bf16_bwd_kernel<H>, kBwdThreads, smem, sms, n_slots, p);
}

cudaError_t plan_for(bool bwd, int hidden, int n_hidden, long long n_slots, LaunchPlan* p) {
  if (n_hidden < 0 || (bwd && n_hidden > kMaxHidden) || n_slots < 0 ||
      n_slots > (1LL << 31) - kRows)
    return cudaErrorInvalidValue;
  switch (hidden) {
    case 8: return bwd ? bwd_plan_h<8>(n_hidden, n_slots, p) : fwd_plan_h<8>(n_hidden, n_slots, p);
    case 16: return bwd ? bwd_plan_h<16>(n_hidden, n_slots, p) : fwd_plan_h<16>(n_hidden, n_slots, p);
    case 32: return bwd ? bwd_plan_h<32>(n_hidden, n_slots, p) : fwd_plan_h<32>(n_hidden, n_slots, p);
    default: return cudaErrorInvalidValue;
  }
}

int report_plan(bool bwd, int hidden, int n_hidden, long long n_slots, int* plan) {
  LaunchPlan p;
  const cudaError_t err = plan_for(bwd, hidden, n_hidden, n_slots, &p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.grid;
  plan[1] = (int)p.smem;
  plan[2] = p.per_sm;
  plan[3] = p.lps;
  plan[4] = p.tiles;
  plan[5] = p.stages;
  return 0;
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

// the passes of either direction after its edge kernel that take H as a
// template: the fix-up of the cut nodes' rows and the zeroing of the rows
// outside the layout
template <int H>
cudaError_t after_edges(const int* rowptr, const int* tile_lo, const float* partials, float* out,
                        int n_nodes, int tiles, const uint8_t* covered, float* rows,
                        long long n_edges, cudaStream_t st) {
  constexpr int threads = 256;
  fixup_kernel<H><<<(tiles + threads / H - 1) / (threads / H), threads, 0, st>>>(
      rowptr, tile_lo, partials, out, n_nodes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_edges <= 0) return err;
  zero_kernel<H><<<(int)((n_edges + threads - 1) / threads), threads, 0, st>>>(covered, rows,
                                                                             n_edges);
  return cudaGetLastError();
}

cudaError_t after_edges_for(int hidden, const int* rowptr, const int* tile_lo,
                            const float* partials, float* out, int n_nodes, int tiles,
                            const uint8_t* covered, float* rows, long long n_edges,
                            cudaStream_t st) {
  switch (hidden) {
    case 8: return after_edges<8>(rowptr, tile_lo, partials, out, n_nodes, tiles, covered, rows, n_edges, st);
    case 16: return after_edges<16>(rowptr, tile_lo, partials, out, n_nodes, tiles, covered, rows, n_edges, st);
    case 32: return after_edges<32>(rowptr, tile_lo, partials, out, n_nodes, tiles, covered, rows, n_edges, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// plan[0..5] = the edge pass's grid, its dynamic shared memory per block in
// bytes, its resident blocks per SM (occupancy API), the hidden layers
// whose weights sit in shared memory, the tiles the scratch must hold
// (tile_lo: tiles + 1 int32, partials: tiles x 2 x H fp32) and the ring's
// stages
extern "C" int nmp_edge_mlp_agg_fwd_bf16_plan(int hidden, int n_hidden, long long n_slots,
                                              int* plan) {
  return report_plan(false, hidden, n_hidden, n_slots, plan);
}

// the same for the backward, whose grid is also the count of partial
// weight-gradient rows
extern "C" int nmp_edge_mlp_agg_bwd_bf16_plan(int hidden, int n_hidden, long long n_slots,
                                              int* plan) {
  return report_plan(true, hidden, n_hidden, n_slots, plan);
}

extern "C" int nmp_edge_mlp_agg_fwd_bf16(
    const void* x, const void* e, const void* perm, const void* src, const void* rowptr,
    const void* emask, const void* einv, const void* w0, const void* b0, const void* wrest,
    const void* brest, const void* lng, const void* lnb, void* e_new, void* agg, void* tile_lo,
    void* partials, void* covered, int n_nodes, long long n_slots, long long n_edges,
    int hidden, int n_hidden, int has_ln, void* stream) {
  LaunchPlan pl;
  cudaError_t err = plan_for(false, hidden, n_hidden, n_slots, &pl);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_nodes <= 0)                         // no node: no edge in the layout
    return (int)cudaMemsetAsync(e_new, 0, (size_t)n_edges * hidden * sizeof(float), st);
  // 16-byte row copies (x, e) and stores (agg, partials); 8-byte e' stores
  if (!aligned(x, 16) || !aligned(e, 16) || !aligned(e_new, 8) || !aligned(agg, 16) ||
      !aligned(partials, 16))
    return (int)cudaErrorMisalignedAddress;
  err = cudaMemsetAsync(covered, 0, (size_t)n_edges, st);
  if (err != cudaSuccess) return (int)err;
  tile_lo_kernel<<<(n_nodes + 256) / 256, 256, 0, st>>>((const int*)rowptr, (int*)tile_lo,
                                                        n_nodes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  FwdArgs a{(const float*)x, (const float*)e, (const int*)perm, (const int*)src,
            (const int*)rowptr, (const int*)tile_lo, (const float*)emask, (const float*)einv,
            (const float*)w0, (const float*)b0, (const float*)wrest, (const float*)brest,
            (const float*)lng, (const float*)lnb, (float*)e_new, (float*)agg,
            (float*)partials, (uint8_t*)covered, n_nodes, n_hidden, pl.lps, has_ln};
  switch (hidden) {
    case 8: nmp_bf16_fwd_kernel<8><<<pl.grid, kFwdThreads, pl.smem, st>>>(a); break;
    case 16: nmp_bf16_fwd_kernel<16><<<pl.grid, kFwdThreads, pl.smem, st>>>(a); break;
    case 32: nmp_bf16_fwd_kernel<32><<<pl.grid, kFwdThreads, pl.smem, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)after_edges_for(hidden, (const int*)rowptr, (const int*)tile_lo,
                              (const float*)partials, (float*)agg, n_nodes, pl.tiles,
                              (const uint8_t*)covered, (float*)e_new, n_edges, st);
}

// 17 operands; gx, ge, gw (w0, b0, wrest, brest, lng, lnb flat); scratch
// tile_lo (tiles + 1 int32), partials (tiles x 2 x H fp32), gxs (slots x H
// bf16), covered (a byte per edge), wpartials (n_groups x weight-gradient
// floats)
extern "C" int nmp_edge_mlp_agg_bwd_bf16(
    const void* x, const void* e, const void* perm, const void* src, const void* rowptr,
    const void* src_slots, const void* src_rowptr, const void* emask, const void* einv,
    const void* w0, const void* b0, const void* wrest, const void* brest, const void* lng,
    const void* lnb, const void* genew, const void* gagg, void* gx, void* ge, void* gw,
    void* tile_lo, void* partials, void* gxs, void* covered, void* wpartials, int n_nodes,
    long long n_slots, long long n_edges, int hidden, int n_hidden, int has_ln, int n_groups,
    void* stream) {
  LaunchPlan pl;
  cudaError_t err = plan_for(true, hidden, n_hidden, n_slots, &pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.grid != n_groups) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int lpx = n_hidden > 0 ? n_hidden : 1;
  const int wsize = wgrad_size(hidden, lpx);
  if (n_nodes <= 0) {                       // no node: no edge in the layout, no gradient
    err = cudaMemsetAsync(ge, 0, (size_t)n_edges * hidden * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(gw, 0, (size_t)wsize * sizeof(float), st);
  }
  // 16-byte row copies (x, e) and node-walk stores (gx, partials); 8-byte
  // cotangent loads and g_e stores
  if (!aligned(x, 16) || !aligned(e, 16) || !aligned(gx, 16) || !aligned(partials, 16) ||
      !aligned(ge, 8) || !aligned(genew, 8) || !aligned(gagg, 8) || !aligned(gxs, 4))
    return (int)cudaErrorMisalignedAddress;
  err = cudaMemsetAsync(covered, 0, (size_t)n_edges, st);
  if (err != cudaSuccess) return (int)err;
  tile_lo_kernel<<<(n_nodes + 256) / 256, 256, 0, st>>>((const int*)rowptr, (int*)tile_lo,
                                                        n_nodes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  BwdArgs a{(const float*)x, (const float*)e, (const int*)perm, (const int*)src,
            (const int*)rowptr, (const int*)tile_lo, (const float*)emask, (const float*)einv,
            (const float*)w0, (const float*)b0, (const float*)wrest, (const float*)brest,
            (const float*)lng, (const float*)lnb, (const float*)genew, (const float*)gagg,
            (float*)gx, (float*)ge, (float*)partials, (float*)wpartials, (uint32_t*)gxs,
            (uint8_t*)covered, n_nodes, n_hidden, has_ln};
  switch (hidden) {
    case 8: nmp_bf16_bwd_kernel<8><<<pl.grid, kBwdThreads, pl.smem, st>>>(a); break;
    case 16: nmp_bf16_bwd_kernel<16><<<pl.grid, kBwdThreads, pl.smem, st>>>(a); break;
    case 32: nmp_bf16_bwd_kernel<32><<<pl.grid, kBwdThreads, pl.smem, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(wsize + 255) / 256, 256, 0, st>>>(
      (const float*)wpartials, (float*)gw, n_groups, wsize, hidden, lpx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the cut nodes' x_dst sums, then the x_src sums added to every node's
  err = after_edges_for(hidden, (const int*)rowptr, (const int*)tile_lo, (const float*)partials,
                        (float*)gx, n_nodes, pl.tiles, (const uint8_t*)covered, (float*)ge,
                        n_edges, st);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(((long long)n_nodes * (hidden / 2) + 255) / 256);
#define SRC_ARGS \
  (const uint32_t*)gxs, (const int*)src_slots, (const int*)src_rowptr, (float*)gx, n_nodes
  switch (hidden) {
    case 8: node_src_kernel<8><<<grid, 256, 0, st>>>(SRC_ARGS); break;
    case 16: node_src_kernel<16><<<grid, 256, 0, st>>>(SRC_ARGS); break;
    case 32: node_src_kernel<32><<<grid, 256, 0, st>>>(SRC_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRC_ARGS
  return (int)cudaGetLastError();
}

#ifdef NMP_BF16_PHASES
extern "C" int nmp_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int nmp_phase_zero() {
  unsigned long long z[4][9] = {};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
#endif

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
