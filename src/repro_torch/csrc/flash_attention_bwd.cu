// Flash-attention backward for NVIDIA Hopper (sm_90a), bf16 and fp32.
//
// Replaces no TPU kernel: the reference differentiates the transformer's
// blocked_attention (src/repro/models/transformer/attention.py:45) under
// jax.checkpoint, so XLA recomputes each score tile in the backward; the
// Pallas forward (src/repro/kernels/flash_attention/kernel.py:75, ported as
// csrc/flash_attention.cu) has no backward twin.  This is its gradient, the
// FlashAttention-2 backward: P is recomputed from the forward's row
// log-sum-exp instead of being stored, so nothing of size S x S touches
// device memory.  Per head, with s = scale * q . k masked to -1e30:
//   P = exp(s - lse),  dV = P^T dO,  dP = dO V^T,  D = rowsum(dO o O),
//   dS = P o (dP - D),  dQ = scale * dS K,  dK = scale * dS^T Q.
// bf16: P and dS are rounded to bf16 as the products' operands (the
// precision of the model's bf16 einsums), every sum is fp32.
//
// Four kernels, launched by four entries (the wrapper counts each):
//   (a) flash_bwd_delta: D per row (one warp a row); for bf16 also the
//       row's lse * log2(e), both fp32 in rows padded to kRowPad, so (b)
//       fetches a stage's 64 of each by one bulk copy.
//   (b) flash_bwd_dkdv: one block per 128-key tile of one KV head and one
//       group of the query heads that share it; it walks the group's heads
//       and the query rows that the causal mask / window leave non-empty
//       for its keys and writes fp32 partial dK, dV for its group.
//   (c) flash_bwd_dq: one block per 128 query rows of one head over its
//       non-empty key tiles (dQ has one writer).
//   (d) flash_bwd_reduce: dK, dV = the groups' partials summed in group
//       order, times scale for dK, rounded to the input's type.
// No float atomics: every sum has a fixed order, so two launches are
// bitwise equal (repeated training steps must be).
//
// What bounds it on the H100 SXM: operations.  One Granite-34B-code
// training layer (B = 1, S = 4096, Hq = 48 over Hkv = 1, D = 128, causal)
// needs 5 products of 2 * D * S^2 / 2 flops per head, 515.5 GFLOP -> 0.52
// ms at 989 TFLOP/s bf16, against 0.21 GB of inputs and outputs.  (b) and
// (c) both recompute S and dP, so 7 products run (0.73 ms at the dense
// rate): in exchange dQ has one writer and needs no ordered cross-block
// sum (a single pass with ordered dQ accumulation is ROADMAP's next lead).
//
// bf16 design (the model's path), kernel 6's machinery (csrc/flash_attention.cuh):
// - (b): 384 threads, one producer warpgroup and two consumer warpgroups
//   of 64 keys each (wgmma M = 64).  K and V (128 keys) arrive once by TMA
//   and stay in shared memory; the producer's one thread keeps a ring of
//   kStagesB (Q, dO) stages of 64 query rows in flight by TMA, each with
//   its 64 lse and D values by bulk copy, on full / empty mbarriers.  Per
//   stage a consumer warpgroup runs S^T = K Q^T and dP^T = V dO^T on
//   wgmma m64n64k16 from shared memory (both K-major), forms P^T =
//   exp2(S^T scale log2(e) - lse log2(e)) and dS^T = P^T o (dP^T - D) in
//   fp32 registers, and runs dV += P^T dO and dK += dS^T Q with P^T and
//   dS^T rounded to bf16 as register A operands (the m64n64 accumulator is
//   the A fragment of four k16 slices) and dO, Q read MN-major through the
//   descriptor's transpose bit, m64nDk16.  dK and dV stay in registers
//   (128 fp32 a thread at D = 128): setmaxnreg gives the consumers 240
//   registers and the producer 24.  A stage whose pairs are all masked
//   for a warpgroup's keys is skipped; the mask is evaluated only on
//   stages that cross the diagonal, the window edge or S.  Grid (group,
//   key tile, batch x KV head): the key tiles ascend, so under the causal
//   mask the heaviest blocks (the early keys see every later query) are
//   dispatched first; ops.bwd_groups picks the group count that balances
//   the blocks over the SMs at one block per SM.  Shared memory at D = 128:
//   K, V 64 KB + 3 stages x 33 KB.
// - (c): the same three warpgroups, 64 query rows per consumer
//   warpgroup; Q and dO (128 rows) arrive once by TMA, a ring of kStagesC
//   (K, V) stages of 128 keys by TMA, as in kernel 6's forward.  Per stage:
//   S = Q K^T and dP = dO V^T on wgmma m64n128k16 from shared memory, dS
//   in fp32 registers, dQ += dS K with dS in registers as the A operand
//   and K read MN-major.  Shared memory at D = 128: Q, dO 64 KB + 2
//   stages x 64 KB.  Grid (head, query tile, batch) with the tiles in
//   reverse order: the longest rows first, and the heads of one tile,
//   which read the same K / V rows, side by side in L2.
// - What the design does about the first design's limits (mma.sync
//   products, synchronous loads into padded tiles behind __syncthreads,
//   4-warp blocks of 64 keys x 32 rows a step, 242 registers at the cap):
//   every product is a wgmma; every tile arrives by TMA (or bulk copy)
//   while the consumers compute on the stage before; a Q / dO byte read
//   by (b) serves 128 keys (was 64) and a K / V byte read by (c) 128 rows
//   (was 64); the 7-product structure stays (see above).
//
// fp32 (the tests' sweep; the model never runs it): SIMT, eight lanes per
// row as the forward's fp32 kernel.  Head dims 16, 32, 64, 128.  Softcap
// has no backward here (no ported configuration sets one).
//
// Layouts: q, o, dO, dQ contiguous [B, S, Hq, D]; k, v, dK, dV contiguous
// [B, S, Hkv, D]; lse fp32 [B, Hq, S]; `delta` fp32, [B, Hq, S] (fp32) or
// [2][B, Hq, Sp] (bf16: D, then lse * log2(e); Sp = S rounded up to
// kRowPad = ops.BWD_ROW_TILE); partials fp32 [G, B, S, Hkv, D].  C entry
// points launch on the given stream, do not synchronise, and return
// cudaGetLastError() (or the error of a tensor map encoding or of the
// shared memory attribute).
#include <cstdint>

#include <cuda.h>  // CUtensorMap (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention.cuh"  // Tile, wgmma products, tensor maps (shared with the forward)

namespace {

struct Bwd {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  float* dk_part;
  float* dv_part;
  void* dk;
  void* dv;
  int B, S, Hq, Hkv, groups;
  float scale;
  int causal, window;
};

__device__ __forceinline__ bool key_ok(const Bwd& p, int qpos, int kpos) {
  return qpos < p.S && kpos < p.S && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// Query rows [lo, hi) that can see a key of [k0, k0 + bn).
__device__ __forceinline__ void query_range(const Bwd& p, int k0, int bn, int& lo, int& hi) {
  lo = p.causal ? k0 : 0;
  hi = p.window > 0 ? min(p.S, k0 + bn - 1 + p.window) : p.S;
}

// Keys [lo, hi) that rows [q0, q0 + bm) can see.
__device__ __forceinline__ void key_range(const Bwd& p, int q0, int bm, int& lo, int& hi) {
  hi = p.causal ? min(p.S, q0 + bm) : p.S;
  lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// bf16: the rows of D and lse * log2(e) are padded to a multiple of this
// (the query rows of one (b) stage)
constexpr int kRowPad = 64;

__host__ __device__ __forceinline__ int padded_rows(int S) {
  return (S + kRowPad - 1) / kRowPad * kRowPad;
}

// ---------------------------------------------------------------------------
// (a) D = rowsum(dO o O), (d) the partials' reduction
// ---------------------------------------------------------------------------

// Rows (b, s, h) for s < Sp, one warp each, into delta [B, Hq, Sp]; with
// `lse2` (bf16) also lse * log2(e) into lse2 [B, Hq, Sp]; rows past S zero.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const Bwd p, int D, int Sp,
                                                              float* lse2) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;  // (b, s, h)
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)p.B * Sp * p.Hq) return;
  const int h = (int)(row % p.Hq);
  const int64_t bs = row / p.Hq;
  const int s = (int)(bs % Sp), b = (int)(bs / Sp);
  float sum = 0.f;
  if (s < p.S) {
    const int64_t at = (((int64_t)b * p.S + s) * p.Hq + h) * D;
    const T* o = static_cast<const T*>(p.o) + at;
    const T* g = static_cast<const T*>(p.dout) + at;
    for (int d = lane; d < D; d += 32) sum = fmaf(to_f(o[d]), to_f(g[d]), sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int64_t at = ((int64_t)b * p.Hq + h) * Sp + s;
    p.delta[at] = sum;
    if (lse2 != nullptr)
      lse2[at] = s < p.S ? p.lse[((int64_t)b * p.Hq + h) * p.S + s] * kLog2e : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_reduce_kernel(const Bwd p, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * 256) {
    float dk = 0.f, dv = 0.f;
    for (int g = 0; g < p.groups; ++g) {
      dk += p.dk_part[g * n + i];
      dv += p.dv_part[g * n + i];
    }
    static_cast<T*>(p.dk)[i] = from_f<T>(dk * p.scale);
    static_cast<T*>(p.dv)[i] = from_f<T>(dv);
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA rings on mbarriers, a producer and two wgmma consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;  // consumer warpgroups, 64 rows (keys or queries) each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kKeysB = 128;    // (b): keys per block
constexpr int kRowsB = 64;     // (b): query rows per ring stage
constexpr int kStagesB = 3;    // (b): (Q, dO) ring depth
constexpr int kRowsC = 128;    // (c): query rows per block
constexpr int kKeysC = 128;    // (c): keys per ring stage
constexpr int kStagesC = 2;    // (c): (K, V) ring depth
constexpr int kRegsProducer = 24, kRegsConsumer = 240;  // 128 x 24 + 256 x 240 = 65,536 - 1,024

// K, V, the Q ring, the dO ring (each tile 1024-byte aligned, as the
// 128-byte swizzle needs), the lse and D rings, then the mbarriers; 1 KB
// of slack aligns the base.
template <int D>
constexpr int smem_dkdv() {
  return 2 * Tile<D>::kBytes + kStagesB * (2 * Tile<D, kRowsB>::kBytes + 2 * kRowsB * 4) +
         8 * (1 + 2 * kStagesB) + 1024;
}
// Q, dO, the K ring, the V ring, the mbarriers
template <int D>
constexpr int smem_dq() {
  return 2 * Tile<D>::kBytes + 2 * kStagesC * Tile<D, kKeysC>::kBytes + 8 * (1 + 2 * kStagesC) +
         1024;
}

__device__ __forceinline__ void init_ring(uint32_t once, uint32_t full, uint32_t empty,
                                          int stages) {
  mbar_init(once, 1);
  for (int s = 0; s < stages; ++s) {
    mbar_init(full + 8 * s, 1);
    mbar_init(empty + 8 * s, kConsumers * 4);  // one arrival per consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// (b) partial dK, dV of one 128-key tile for one group of query heads
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Bwd p) {
  using TK = Tile<D>;          // K, V: 128 key rows
  using TQ = Tile<D, kRowsB>;  // one stage's Q, dO: 64 query rows
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023u) & ~1023u;
  const uint32_t sV = sK + TK::kBytes;
  const uint32_t sQ = sV + TK::kBytes;              // stage s at sQ + s * TQ::kBytes
  const uint32_t sG = sQ + kStagesB * TQ::kBytes;   // dO, likewise
  const uint32_t sL = sG + kStagesB * TQ::kBytes;   // lse * log2(e): kRowsB floats a stage
  const uint32_t sD = sL + kStagesB * kRowsB * 4;   // D, likewise
  const uint32_t kv_full = sD + kStagesB * kRowsB * 4;
  const uint32_t full = kv_full + 8;                // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kStagesB;       // empty[s] at empty + 8 s

  const int grp = blockIdx.x, k0 = blockIdx.y * kKeysB;
  const int b = blockIdx.z / p.Hkv, hk = blockIdx.z % p.Hkv;
  const int G = p.Hq / p.Hkv, per = (G + p.groups - 1) / p.groups;
  const int h_lo = hk * G + min(G, grp * per), h_hi = hk * G + min(G, (grp + 1) * per);
  int q_lo, q_hi;
  query_range(p, k0, kKeysB, q_lo, q_hi);
  const int t_first = q_lo / kRowsB, t_end = (q_hi + kRowsB - 1) / kRowsB;
  const int Sp = padded_rows(p.S);

  if (threadIdx.x == 0) init_ring(kv_full, full, empty, kStagesB);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<kRegsProducer>();
    if (threadIdx.x == kConsumers * 128) {
      const float* lse2 = p.delta + (int64_t)p.B * p.Hq * Sp;
      mbar_expect_tx(kv_full, 2 * TK::kBytes);
      for (int c = 0; c < TK::kBoxes; ++c) {
        tma_load(sK + c * TK::kBoxBytes, &tk, kv_full, c * TK::C, k0, hk, b);
        tma_load(sV + c * TK::kBoxBytes, &tv, kv_full, c * TK::C, k0, hk, b);
      }
      int i = 0;
      for (int h = h_lo; h < h_hi; ++h)
        for (int t = t_first; t < t_end; ++t, ++i) {
          const int s = i % kStagesB;
          const uint32_t f = full + 8 * s;
          mbar_wait(empty + 8 * s, ((i / kStagesB) & 1) ^ 1);
          mbar_expect_tx(f, 2 * TQ::kBytes + 2 * kRowsB * 4);
          for (int c = 0; c < TQ::kBoxes; ++c) {
            tma_load(sQ + s * TQ::kBytes + c * TQ::kBoxBytes, &tq, f, c * TQ::C, t * kRowsB, h, b);
            tma_load(sG + s * TQ::kBytes + c * TQ::kBoxBytes, &tg, f, c * TQ::C, t * kRowsB, h, b);
          }
          const int64_t row = ((int64_t)b * p.Hq + h) * Sp + t * kRowsB;
          bulk_load(sL + s * kRowsB * 4, lse2 + row, kRowsB * 4, f);
          bulk_load(sD + s * kRowsB * 4, p.delta + row, kRowsB * 4, f);
        }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ----
    setmaxnreg_inc<kRegsConsumer>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    const int kw = k0 + 64 * wg;             // this warpgroup's first key
    const int key0 = kw + 16 * warp + g;     // this thread's keys: key0, key0 + 8
    const float sl = p.scale * kLog2e;
    const float* Ls = reinterpret_cast<const float*>(smem_raw + (sL - base));
    const float* Ds = reinterpret_cast<const float*>(smem_raw + (sD - base));

    float dk[D / 2], dv[D / 2], st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;

    mbar_wait(kv_full, 0);
    __syncwarp();
    int i = 0;
    for (int h = h_lo; h < h_hi; ++h)
      for (int t = t_first; t < t_end; ++t, ++i) {
        const int s = i % kStagesB, q0 = t * kRowsB;
        // every pair of this stage and this warpgroup's keys masked: skip
        const bool none = kw >= p.S || (p.causal && q0 + kRowsB - 1 < kw) ||
                          (p.window > 0 && q0 - (kw + 63) >= p.window);
        mbar_wait(full + 8 * s, (i / kStagesB) & 1);
        __syncwarp();  // wgmma is .aligned: the warp converges after the spin
        if (!none) {
          const uint32_t tQ = sQ + s * TQ::kBytes, tG = sG + s * TQ::kBytes;
          // S^T = K Q^T, dP^T = V dO^T: 64 keys x 64 query rows, over D in k16 steps
          fence_regs(st);
          fence_regs(dpt);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            wgmma_qk(st, TK::k_desc(sK, 64 * wg, kk), TQ::k_desc(tQ, 0, kk), kk > 0);
            wgmma_qk(dpt, TK::k_desc(sV, 64 * wg, kk), TQ::k_desc(tG, 0, kk), kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(st);
          fence_regs(dpt);

          // P^T = exp2(s scale log2 e - lse log2 e), dS^T = P^T (dP^T - D); masked
          // pairs 0 (the mask only where the stage is not wholly inside)
          const bool inside = kw + 63 < p.S && q0 + kRowsB <= p.S &&
                              (!p.causal || kw + 63 <= q0) &&
                              (p.window <= 0 || q0 + kRowsB - 1 - kw < p.window);
          const float* L = Ls + s * kRowsB;
          const float* Dl = Ds + s * kRowsB;
          uint32_t pa[4][4], da[4][4];  // A fragments of the four k16 slices
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l = *reinterpret_cast<const float2*>(L + 8 * j + 2 * c);
            const float2 dd = *reinterpret_cast<const float2*>(Dl + 8 * j + 2 * c);
            float pr[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = ex2(st[4 * j + e] * sl - ((e & 1) ? l.y : l.x));
              if (!inside && !key_ok(p, q0 + 8 * j + 2 * c + (e & 1), key0 + 8 * (e >> 1)))
                x = 0.f;
              pr[e] = x;
              ds[e] = x * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
            }
            // accumulator chunk j is half j % 2 of k16 slice j / 2
            pa[j / 2][2 * (j % 2)] = pack_bf16(pr[0], pr[1]);
            pa[j / 2][2 * (j % 2) + 1] = pack_bf16(pr[2], pr[3]);
            da[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
            da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
          }

          // dV += P^T dO, dK += dS^T Q: dO and Q [query rows, D] read MN-major
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pa);
          fence_regs(da);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kRowsB / 16; ++kk) {
            wgmma_pv(dv, pa[kk], TQ::mn_desc(tG, kk));
            wgmma_pv(dk, da[kk], TQ::mn_desc(tQ, kk));
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pa);
          fence_regs(da);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }

    // this group's partials for keys key0 and key0 + 8
    const int64_t n_all = (int64_t)p.B * p.S * p.Hkv * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kpos = key0 + 8 * half;
      if (kpos >= p.S) continue;
      const int64_t at = grp * n_all + (((int64_t)b * p.S + kpos) * p.Hkv + hk) * D + 2 * c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(p.dk_part + at + 8 * j) =
            make_float2(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
        *reinterpret_cast<float2*>(p.dv_part + at + 8 * j) =
            make_float2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
      }
    }
  }
}

// (c) dQ of 128 query rows of one head
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const Bwd p) {
  using T = Tile<D>;            // Q, dO: 128 query rows
  using TK = Tile<D, kKeysC>;   // one stage's K, V
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sG = sQ + T::kBytes;
  const uint32_t sK = sG + T::kBytes;              // stage s at sK + s * TK::kBytes
  const uint32_t sV = sK + kStagesC * TK::kBytes;  // stage s at sV + s * TK::kBytes
  const uint32_t qg_full = sV + kStagesC * TK::kBytes;
  const uint32_t full = qg_full + 8;
  const uint32_t empty = full + 8 * kStagesC;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kRowsC;  // longest rows first
  const int hk = h / (p.Hq / p.Hkv);
  int k_lo, k_hi;
  key_range(p, q0, kRowsC, k_lo, k_hi);
  const int t_begin = k_lo / kKeysC, t_end = (k_hi + kKeysC - 1) / kKeysC;

  if (threadIdx.x == 0) init_ring(qg_full, full, empty, kStagesC);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    setmaxnreg_dec<kRegsProducer>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(qg_full, 2 * T::kBytes);
      for (int c = 0; c < T::kBoxes; ++c) {
        tma_load(sQ + c * T::kBoxBytes, &tq, qg_full, c * T::C, q0, h, b);
        tma_load(sG + c * T::kBoxBytes, &tg, qg_full, c * T::C, q0, h, b);
      }
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % kStagesC;
        const uint32_t f = full + 8 * s;
        mbar_wait(empty + 8 * s, ((i / kStagesC) & 1) ^ 1);
        mbar_expect_tx(f, 2 * TK::kBytes);
        for (int c = 0; c < TK::kBoxes; ++c) {
          tma_load(sK + s * TK::kBytes + c * TK::kBoxBytes, &tk, f, c * TK::C, t * kKeysC, hk, b);
          tma_load(sV + s * TK::kBytes + c * TK::kBoxBytes, &tv, f, c * TK::C, t * kKeysC, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    setmaxnreg_inc<kRegsConsumer>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    const int qa = q0 + 64 * wg;  // this warpgroup's first row
    const int row0 = qa + 16 * warp + g, row1 = row0 + 8;
    const float sl = p.scale * kLog2e;
    const int Sp = padded_rows(p.S);
    const int64_t rows = ((int64_t)b * p.Hq + h) * Sp;
    const float* lse2 = p.delta + (int64_t)p.B * p.Hq * Sp;
    const float L0 = row0 < p.S ? lse2[rows + row0] : 0.f, L1 = row1 < p.S ? lse2[rows + row1] : 0.f;
    const float D0 = row0 < p.S ? p.delta[rows + row0] : 0.f;
    const float D1 = row1 < p.S ? p.delta[rows + row1] : 0.f;

    float dq[D / 2], sc[kKeysC / 2], dp[kKeysC / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
#pragma unroll
    for (int e = 0; e < kKeysC / 2; ++e) sc[e] = dp[e] = 0.f;

    mbar_wait(qg_full, 0);
    __syncwarp();
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int s = i % kStagesC, k0 = t * kKeysC;
      // every pair of this warpgroup's rows and this stage masked: skip
      const bool none = qa >= p.S || (p.causal && k0 > qa + 63) ||
                        (p.window > 0 && qa - (k0 + kKeysC - 1) >= p.window);
      mbar_wait(full + 8 * s, (i / kStagesC) & 1);
      __syncwarp();
      if (!none) {
        const uint32_t tK = sK + s * TK::kBytes, tV = sV + s * TK::kBytes;
        // S = Q K^T, dP = dO V^T: 64 rows x kKeysC keys, over D in k16 steps
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_qk(sc, T::k_desc(sQ, 64 * wg, kk), TK::k_desc(tK, 0, kk), kk > 0);
          wgmma_qk(dp, T::k_desc(sG, 64 * wg, kk), TK::k_desc(tV, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        const bool inside = k0 + kKeysC <= p.S && qa + 63 < p.S &&
                            (!p.causal || k0 + kKeysC - 1 <= qa) &&
                            (p.window <= 0 || qa + 63 - k0 < p.window);
        uint32_t da[kKeysC / 16][4];  // dS as the A fragments of its k16 slices
#pragma unroll
        for (int j = 0; j < kKeysC / 8; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int half = e >> 1;
            float x = ex2(sc[4 * j + e] * sl - (half ? L1 : L0));
            if (!inside && !key_ok(p, half ? row1 : row0, k0 + 8 * j + 2 * c + (e & 1))) x = 0.f;
            ds[e] = x * (dp[4 * j + e] - (half ? D1 : D0));
          }
          da[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
          da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dQ += dS K: K [keys, D] read MN-major
        fence_regs(dq);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeysC / 16; ++kk) wgmma_pv(dq, da[kk], TK::mn_desc(tK, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
        fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    const int64_t q_ss = (int64_t)p.Hq * D;
    bf16* out = static_cast<bf16*>(p.dq) + ((int64_t)b * p.S + row0) * q_ss + (int64_t)h * D + 2 * c;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (row0 + 8 * half >= p.S) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * half * q_ss + 8 * j) =
            pack_bf16(dq[4 * j + 2 * half] * p.scale, dq[4 * j + 2 * half + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT, eight lanes per row
// ---------------------------------------------------------------------------

constexpr int kLanes = 8;
constexpr int kRowsF = 128 / kLanes;  // rows a block owns (keys in (b), queries in (c))
constexpr int kStepF = 32;            // rows of the other side per shared tile

// this lane's columns: i * kLanes * VEC + ln * VEC + cc, as the forward's
template <int D>
struct Cols {
  static constexpr int E = D / kLanes;
  static constexpr int VEC = E >= 4 ? 4 : E;
  static constexpr int NV = E / VEC;
  __device__ static int col(int i, int ln, int cc) { return i * kLanes * VEC + ln * VEC + cc; }
};

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// n rows from r0 of head h of a contiguous [B, S, H, D] fp32 tensor into
// [n][D] shared memory, zeros past S
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int b, int r0,
                                              int n, int h, int S, int H) {
  for (int i = threadIdx.x; i < n * D / 4; i += 128) {
    const int r = i / (D / 4), cc = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      val = *reinterpret_cast<const float4*>(src + (((int64_t)b * S + r0 + r) * H + h) * D + cc);
    *reinterpret_cast<float4*>(dst + r * D + cc) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_f32_kernel(const Bwd p) {
  using C = Cols<D>;
  __shared__ __align__(16) float sQ[kStepF * D];
  __shared__ __align__(16) float sG[kStepF * D];
  __shared__ float sL[kStepF], sD[kStepF];
  const int k0 = blockIdx.x * kRowsF;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv, grp = blockIdx.z;
  const int G = p.Hq / p.Hkv, per = (G + p.groups - 1) / p.groups;
  const int h_lo = hk * G + min(G, grp * per), h_hi = hk * G + min(G, (grp + 1) * per);
  const int ln = threadIdx.x % kLanes, kpos = k0 + threadIdx.x / kLanes;
  const bool live = kpos < p.S;
  const int64_t krow = (((int64_t)b * p.S + kpos) * p.Hkv + hk) * D;
  float kk[C::E], vv[C::E], dk[C::E], dv[C::E];
#pragma unroll
  for (int i = 0; i < C::NV; ++i)
#pragma unroll
    for (int cc = 0; cc < C::VEC; ++cc) {
      const int e = i * C::VEC + cc, col = C::col(i, ln, cc);
      kk[e] = live ? static_cast<const float*>(p.k)[krow + col] : 0.f;
      vv[e] = live ? static_cast<const float*>(p.v)[krow + col] : 0.f;
      dk[e] = dv[e] = 0.f;
    }
  int q_lo, q_hi;
  query_range(p, k0, kRowsF, q_lo, q_hi);
  for (int h = h_lo; h < h_hi; ++h) {
    for (int q0 = q_lo / kStepF * kStepF; q0 < q_hi; q0 += kStepF) {
      __syncthreads();
      load_rows_f32<D>(sQ, static_cast<const float*>(p.q), b, q0, kStepF, h, p.S, p.Hq);
      load_rows_f32<D>(sG, static_cast<const float*>(p.dout), b, q0, kStepF, h, p.S, p.Hq);
      if (threadIdx.x < kStepF) {
        const int q = q0 + threadIdx.x;
        const int64_t at = ((int64_t)b * p.Hq + h) * p.S + q;
        sL[threadIdx.x] = q < p.S ? p.lse[at] : 0.f;
        sD[threadIdx.x] = q < p.S ? p.delta[at] : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < kStepF; ++r) {
        const float* qr = sQ + r * D;
        const float* gr = sG + r * D;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < C::NV; ++i)
#pragma unroll
          for (int cc = 0; cc < C::VEC; ++cc) {
            const int e = i * C::VEC + cc, col = C::col(i, ln, cc);
            s = fmaf(kk[e], qr[col], s);
            dp = fmaf(vv[e], gr[col], dp);
          }
        s = row_sum8(s);
        dp = row_sum8(dp);
        const float pr = key_ok(p, q0 + r, kpos) ? expf(s * p.scale - sL[r]) : 0.f;
        const float ds = pr * (dp - sD[r]);
#pragma unroll
        for (int i = 0; i < C::NV; ++i)
#pragma unroll
          for (int cc = 0; cc < C::VEC; ++cc) {
            const int e = i * C::VEC + cc, col = C::col(i, ln, cc);
            dv[e] = fmaf(pr, gr[col], dv[e]);
            dk[e] = fmaf(ds, qr[col], dk[e]);
          }
      }
    }
  }
  if (!live) return;
  const int64_t at = grp * ((int64_t)p.B * p.S * p.Hkv * D) + krow;
#pragma unroll
  for (int i = 0; i < C::NV; ++i)
#pragma unroll
    for (int cc = 0; cc < C::VEC; ++cc) {
      const int e = i * C::VEC + cc, col = C::col(i, ln, cc);
      p.dk_part[at + col] = dk[e];
      p.dv_part[at + col] = dv[e];
    }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32_kernel(const Bwd p) {
  using C = Cols<D>;
  __shared__ __align__(16) float sK[kStepF * D];
  __shared__ __align__(16) float sV[kStepF * D];
  const int n_qt = (p.S + kRowsF - 1) / kRowsF;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kRowsF;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const int ln = threadIdx.x % kLanes, qpos = q0 + threadIdx.x / kLanes;
  const bool live = qpos < p.S;
  const int64_t qrow = (((int64_t)b * p.S + qpos) * p.Hq + h) * D;
  const int64_t at = ((int64_t)b * p.Hq + h) * p.S + qpos;
  const float L = live ? p.lse[at] : 0.f, Dl = live ? p.delta[at] : 0.f;
  float qq[C::E], gg[C::E], dq[C::E];
#pragma unroll
  for (int i = 0; i < C::NV; ++i)
#pragma unroll
    for (int cc = 0; cc < C::VEC; ++cc) {
      const int e = i * C::VEC + cc, col = C::col(i, ln, cc);
      qq[e] = live ? static_cast<const float*>(p.q)[qrow + col] : 0.f;
      gg[e] = live ? static_cast<const float*>(p.dout)[qrow + col] : 0.f;
      dq[e] = 0.f;
    }
  int k_lo, k_hi;
  key_range(p, q0, kRowsF, k_lo, k_hi);
  for (int k0 = k_lo / kStepF * kStepF; k0 < k_hi; k0 += kStepF) {
    __syncthreads();
    load_rows_f32<D>(sK, static_cast<const float*>(p.k), b, k0, kStepF, hk, p.S, p.Hkv);
    load_rows_f32<D>(sV, static_cast<const float*>(p.v), b, k0, kStepF, hk, p.S, p.Hkv);
    __syncthreads();
    for (int r = 0; r < kStepF; ++r) {
      const float* kr = sK + r * D;
      const float* vr = sV + r * D;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < C::NV; ++i)
#pragma unroll
        for (int cc = 0; cc < C::VEC; ++cc) {
          const int e = i * C::VEC + cc, col = C::col(i, ln, cc);
          s = fmaf(qq[e], kr[col], s);
          dp = fmaf(gg[e], vr[col], dp);
        }
      s = row_sum8(s);
      dp = row_sum8(dp);
      const float pr = key_ok(p, qpos, k0 + r) ? expf(s * p.scale - L) : 0.f;
      const float ds = pr * (dp - Dl);
#pragma unroll
      for (int i = 0; i < C::NV; ++i)
#pragma unroll
        for (int cc = 0; cc < C::VEC; ++cc) {
          const int e = i * C::VEC + cc, col = C::col(i, ln, cc);
          dq[e] = fmaf(ds, kr[col], dq[e]);
        }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < C::NV; ++i)
#pragma unroll
    for (int cc = 0; cc < C::VEC; ++cc) {
      const int e = i * C::VEC + cc;
      static_cast<float*>(p.dq)[qrow + C::col(i, ln, cc)] = dq[e] * p.scale;
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

Bwd make(const void* q, const void* k, const void* v, const void* o, const void* dout,
         const float* lse, float* delta, void* dq, float* dk_part, float* dv_part, void* dk,
         void* dv, int B, int S, int Hq, int Hkv, int groups, float scale, int causal,
         int window) {
  return Bwd{q, k, v, o, dout, lse, delta, dq, dk_part, dv_part, dk, dv,
             B, S, Hq, Hkv, groups, scale, causal, window};
}

bool bad_shape(int B, int S, int Hq, int Hkv, int D, int groups) {
  return B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || groups <= 0 ||
         groups > Hq / Hkv || (int64_t)B * Hkv > 65535 || B > 65535 || Hq > 65535 ||
         groups > 65535 || !(D == 16 || D == 32 || D == 64 || D == 128);
}

// q and dO in boxes of RQ query rows, k and v in boxes of RK keys (dense
// [B, S, H, D] tensors)
template <int D, int RQ, int RK>
int encode_all(const Bwd& p, CUtensorMap* tq, CUtensorMap* tg, CUtensorMap* tk,
               CUtensorMap* tv) {
  const int64_t qs = (int64_t)p.Hq * D, ks = (int64_t)p.Hkv * D;
  int e = encode<D, RQ>(tq, p.q, p.B, p.S, p.Hq, p.S * qs, qs, D);
  if (!e) e = encode<D, RQ>(tg, p.dout, p.B, p.S, p.Hq, p.S * qs, qs, D);
  if (!e) e = encode<D, RK>(tk, p.k, p.B, p.S, p.Hkv, p.S * ks, ks, D);
  if (!e) e = encode<D, RK>(tv, p.v, p.B, p.S, p.Hkv, p.S * ks, ks, D);
  return e;
}

template <int D>
int dkdv_bf16(const Bwd& p, cudaStream_t s) {
  constexpr int smem = smem_dkdv<D>();
  const int n_kt = (p.S + kKeysB - 1) / kKeysB;
  if (n_kt > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tg, tk, tv;
  const int e = encode_all<D, kRowsB, kKeysB>(p, &tq, &tg, &tk, &tv);
  if (e) return e;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.groups, n_kt, p.B * p.Hkv);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, smem, s>>>(tq, tg, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int D>
int dq_bf16(const Bwd& p, cudaStream_t s) {
  constexpr int smem = smem_dq<D>();
  const int n_qt = (p.S + kRowsC - 1) / kRowsC;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tg, tk, tv;
  const int e = encode_all<D, kRowsC, kKeysC>(p, &tq, &tg, &tk, &tv);
  if (e) return e;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.Hq, n_qt, p.B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, s>>>(tq, tg, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int D>
int dkdv_f32(const Bwd& p, cudaStream_t s) {
  const dim3 grid((p.S + kRowsF - 1) / kRowsF, p.B * p.Hkv, p.groups);
  flash_bwd_dkdv_f32_kernel<D><<<grid, 128, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int dq_f32(const Bwd& p, cudaStream_t s) {
  const dim3 grid((p.S + kRowsF - 1) / kRowsF, p.Hq, p.B);
  flash_bwd_dq_f32_kernel<D><<<grid, 128, 0, s>>>(p);
  return (int)cudaGetLastError();
}

#define BY_HEAD_DIM(fn, p, s)              \
  switch (D) {                             \
    case 16: return fn<16>(p, s);          \
    case 32: return fn<32>(p, s);          \
    case 64: return fn<64>(p, s);          \
    case 128: return fn<128>(p, s);        \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

#define BWD_ARGS                                                                             \
  const void *q, const void *k, const void *v, const void *o, const void *dout,              \
      const float *lse, float *delta, void *dq, float *dk_part, float *dv_part, void *dk,    \
      void *dv, int B, int S, int Hq, int Hkv, int D, int groups, float scale, int causal,    \
      int window, int bf16_io, void *stream
#define BWD_MAKE                                                                              \
  if (bad_shape(B, S, Hq, Hkv, D, groups)) return (int)cudaErrorInvalidValue;                 \
  const Bwd p = make(q, k, v, o, dout, lse, delta, dq, dk_part, dv_part, dk, dv, B, S, Hq, Hkv, \
                     groups, scale, causal, window);                                          \
  cudaStream_t s = static_cast<cudaStream_t>(stream);

// (a) D = rowsum(dO o O) into `delta` (bf16: and lse * log2(e) after it)
extern "C" int flash_attention_bwd_delta(BWD_ARGS) {
  BWD_MAKE
  const int Sp = bf16_io ? padded_rows(S) : S;
  const int64_t rows = (int64_t)B * Sp * Hq;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  if (bf16_io)
    flash_bwd_delta_kernel<bf16><<<blocks, 256, 0, s>>>(p, D, Sp, delta + (int64_t)B * Hq * Sp);
  else
    flash_bwd_delta_kernel<float><<<blocks, 256, 0, s>>>(p, D, Sp, nullptr);
  return (int)cudaGetLastError();
}

// (b) the groups' partial dK, dV
extern "C" int flash_attention_bwd_dkdv(BWD_ARGS) {
  BWD_MAKE
  if (bf16_io) {
    BY_HEAD_DIM(dkdv_bf16, p, s)
  }
  BY_HEAD_DIM(dkdv_f32, p, s)
}

// (c) dQ
extern "C" int flash_attention_bwd_dq(BWD_ARGS) {
  BWD_MAKE
  if (bf16_io) {
    BY_HEAD_DIM(dq_bf16, p, s)
  }
  BY_HEAD_DIM(dq_f32, p, s)
}

// (d) dK, dV from the partials
extern "C" int flash_attention_bwd_reduce(BWD_ARGS) {
  BWD_MAKE
  const int64_t n = (int64_t)B * S * Hkv * D;
  const int64_t want = (n + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  if (bf16_io)
    flash_bwd_reduce_kernel<bf16><<<blocks, 256, 0, s>>>(p, n);
  else
    flash_bwd_reduce_kernel<float><<<blocks, 256, 0, s>>>(p, n);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
