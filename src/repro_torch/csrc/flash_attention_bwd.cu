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
//   (a) flash_bwd_delta: D per row (one warp a row).
//   (b) flash_bwd_dkdv: one block per 64-key tile of one KV head and one
//       group of the query heads that share it; it walks the group's heads
//       and the query tiles that the causal mask / window leave non-empty
//       for its keys and writes fp32 partial dK, dV for its group.
//   (c) flash_bwd_dq: one block per 64-row query tile of one head over its
//       non-empty key tiles (dQ has one writer).
//   (d) flash_bwd_reduce: dK, dV = the groups' partials summed in group
//       order, times scale for dK, rounded to the input's type.
// No float atomics: every sum has a fixed order, so two launches are
// bitwise equal (repeated training steps must be).
//
// Granite-34B-code's MQA (48 query heads over one KV head) is why (b)
// splits the heads into groups: at B = 1, S = 4096 there are only 64 key
// tiles of one KV head for 132 SMs; the wrapper picks the group count so
// that (b) has about four blocks per SM (ops.BWD_BLOCKS_PER_SM).
//
// What bounds it on the H100 SXM: operations.  One Granite layer (B = 1,
// S = 4096, Hq = 48, D = 128, causal) needs 5 products of 2 * D * S^2 / 2
// flops per head, 515 GFLOP -> 0.52 ms at 989 TFLOP/s bf16, against 0.2 GB
// of inputs and outputs.  This first design recomputes S and dP in both (b)
// and (c), 7 products instead of 5, on mma.sync.m16n8k16 (bf16 in, fp32
// sums) from padded shared-memory tiles loaded synchronously: simple and
// exact before it is fast (ROADMAP: a wgmma / TMA redesign is a speed lead).
//
// fp32 (the tests' sweep; the model never runs it): SIMT, eight lanes per
// row as the forward's fp32 kernel.  Head dims 16, 32, 64, 128.  Softcap
// has no backward here (no ported configuration sets one).
//
// Layouts: q, o, dO, dQ contiguous [B, S, Hq, D]; k, v, dK, dV contiguous
// [B, S, Hkv, D]; lse, D fp32 [B, Hq, S]; partials fp32 [G, B, S, Hkv, D].
// C entry points launch on the given stream, do not synchronise, and
// return cudaGetLastError().
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

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

// ---------------------------------------------------------------------------
// (a) D = rowsum(dO o O), (d) the partials' reduction
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const Bwd p, int D) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;  // (b, s, h)
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)p.B * p.S * p.Hq) return;
  const T* o = static_cast<const T*>(p.o) + row * D;
  const T* g = static_cast<const T*>(p.dout) + row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(to_f(o[d]), to_f(g[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = (int)(row % p.Hq);
    const int64_t bs = row / p.Hq;
    const int s = (int)(bs % p.S), b = (int)(bs / p.S);
    p.delta[((int64_t)b * p.Hq + h) * p.S + s] = sum;
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
// bf16: mma.sync.m16n8k16 on padded shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kTileKB = 64;  // (b): keys per block, 16 per warp
constexpr int kTileQB = 32;  // (b): query rows per step
constexpr int kTileQC = 64;  // (c): query rows per block, 16 per warp
constexpr int kTileKC = 64;  // (c): keys per step

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (16 x 8, fp32) += a (16 x 16, row) * b (16 x 8, col).  Fragments (lane =
// 4 g + c): a[0] (g, 2c..2c+1), a[1] (g + 8, 2c..), a[2] (g, 2c + 8..),
// a[3] (g + 8, 2c + 8..); b[0] (k 2c..2c+1, n g), b[1] (k 2c + 8.., n g);
// d[0..1] (g, 2c..2c+1), d[2..3] (g + 8, 2c..2c+1).  So the d fragments of
// two neighbouring n-tiles are the a fragment of one k16 step.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8 x 8 matrices: lanes 8 m .. 8 m + 7 give the rows of
// matrix m; lane (g, c) receives rows 2c, 2c + 1 of column g of each.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + n) of head h of a contiguous [B, S, H, D] bf16 tensor into
// a [n][D + 8] shared tile, zeros past S; 16-byte copies by every thread
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b, int r0, int n,
                                          int h, int S, int H) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < n * kChunks; i += kWarps * 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (((int64_t)b * S + r0 + r) * H + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

// A fragment of rows [r0, r0 + 16), columns [k0, k0 + 16) of a padded tile
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int r0, int k0, int g,
                                       int c) {
  constexpr int P = D + 8;
  a[0] = ld32(t + (r0 + g) * P + k0 + 2 * c);
  a[1] = ld32(t + (r0 + g + 8) * P + k0 + 2 * c);
  a[2] = ld32(t + (r0 + g) * P + k0 + 2 * c + 8);
  a[3] = ld32(t + (r0 + g + 8) * P + k0 + 2 * c + 8);
}

// acc[j] (16 x 8 n-tile j over D) += a (16 x 16 over rows [k0, k0 + 16) of
// the padded tile t) * t[k0 .. k0 + 16][:]: t is row-major [k][n], read
// transposed by ldmatrix, two n-tiles per load
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                         const bf16* t, int k0, int lane) {
  constexpr int P = D + 8;
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    uint32_t r[4];
    ldsm_x4_trans(r, smem_addr(t + row * P + 16 * j + col));
    mma(acc[2 * j], a, r[0], r[1]);
    mma(acc[2 * j + 1], a, r[2], r[3]);
  }
}

template <int D>
constexpr int smem_dkdv() {
  return (2 * kTileKB + 2 * kTileQB) * (D + 8) * 2 + 2 * kTileQB * 4;
}
template <int D>
constexpr int smem_dq() {
  return (2 * kTileQC + 2 * kTileKC) * (D + 8) * 2;
}

// (b) partial dK, dV of one 64-key tile for one group of query heads
template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dkdv_bf16_kernel(const Bwd p) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTileKB * P;
  bf16* sQ = sV + kTileKB * P;
  bf16* sG = sQ + kTileQB * P;  // dO
  float* sL = reinterpret_cast<float*>(sG + kTileQB * P);  // lse * log2(e)
  float* sD = sL + kTileQB;                               // D

  const int k0 = blockIdx.x * kTileKB;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv, grp = blockIdx.z;
  const int G = p.Hq / p.Hkv, per = (G + p.groups - 1) / p.groups;
  const int h_lo = hk * G + min(G, grp * per), h_hi = hk * G + min(G, (grp + 1) * per);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const float sl = p.scale * kLog2e;

  load_rows<D>(sK, static_cast<const bf16*>(p.k), b, k0, kTileKB, hk, p.S, p.Hkv);
  load_rows<D>(sV, static_cast<const bf16*>(p.v), b, k0, kTileKB, hk, p.S, p.Hkv);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  int q_lo, q_hi;
  query_range(p, k0, kTileKB, q_lo, q_hi);
  const int kr = 16 * warp;  // this warp's first key row in the tile
  for (int h = h_lo; h < h_hi; ++h) {
    for (int q0 = q_lo / kTileQB * kTileQB; q0 < q_hi; q0 += kTileQB) {
      __syncthreads();  // the previous step's tiles are read
      load_rows<D>(sQ, static_cast<const bf16*>(p.q), b, q0, kTileQB, h, p.S, p.Hq);
      load_rows<D>(sG, static_cast<const bf16*>(p.dout), b, q0, kTileQB, h, p.S, p.Hq);
      if (threadIdx.x < kTileQB) {
        const int q = q0 + threadIdx.x;
        const int64_t at = ((int64_t)b * p.Hq + h) * p.S + q;
        sL[threadIdx.x] = q < p.S ? p.lse[at] * kLog2e : 0.f;
        sD[threadIdx.x] = q < p.S ? p.delta[at] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 query rows a warp
      float st[kTileQB / 8][4], dpt[kTileQB / 8][4];
#pragma unroll
      for (int n = 0; n < kTileQB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a<D>(ak, sK, kr, 16 * kk, g, c);
        frag_a<D>(av, sV, kr, 16 * kk, g, c);
#pragma unroll
        for (int n = 0; n < kTileQB / 8; ++n) {
          const bf16* qr = sQ + (8 * n + g) * P + 16 * kk + 2 * c;
          const bf16* gr = sG + (8 * n + g) * P + 16 * kk + 2 * c;
          mma(st[n], ak, ld32(qr), ld32(qr + 8));
          mma(dpt[n], av, ld32(gr), ld32(gr + 8));
        }
      }
      // P^T = exp(s - lse) and dS^T = P^T (dP^T - D), masked to 0
#pragma unroll
      for (int n = 0; n < kTileQB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + kr + g + 8 * (e >> 1), qi = 8 * n + 2 * c + (e & 1);
          const float pr = key_ok(p, q0 + qi, kpos) ? ex2(st[n][e] * sl - sL[qi]) : 0.f;
          st[n][e] = pr;
          dpt[n][e] = pr * (dpt[n][e] - sD[qi]);
        }
      // dV += P^T dO, dK += dS^T Q: k16 step s over query rows 16 s ..
#pragma unroll
      for (int s = 0; s < kTileQB / 16; ++s) {
        const uint32_t ap[4] = {pack2(st[2 * s][0], st[2 * s][1]),
                                pack2(st[2 * s][2], st[2 * s][3]),
                                pack2(st[2 * s + 1][0], st[2 * s + 1][1]),
                                pack2(st[2 * s + 1][2], st[2 * s + 1][3])};
        const uint32_t as[4] = {pack2(dpt[2 * s][0], dpt[2 * s][1]),
                                pack2(dpt[2 * s][2], dpt[2 * s][3]),
                                pack2(dpt[2 * s + 1][0], dpt[2 * s + 1][1]),
                                pack2(dpt[2 * s + 1][2], dpt[2 * s + 1][3])};
        mma_rows<D>(dv, ap, sG, 16 * s, lane);
        mma_rows<D>(dk, as, sQ, 16 * s, lane);
      }
    }
  }

  // this group's partials for keys k0 + kr + g (+ 8)
  const int64_t n_all = (int64_t)p.B * p.S * p.Hkv * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kpos = k0 + kr + g + 8 * half;
    if (kpos >= p.S) continue;
    const int64_t at = grp * n_all + (((int64_t)b * p.S + kpos) * p.Hkv + hk) * D + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(p.dk_part + at + 8 * j) =
          make_float2(dk[j][2 * half], dk[j][2 * half + 1]);
      *reinterpret_cast<float2*>(p.dv_part + at + 8 * j) =
          make_float2(dv[j][2 * half], dv[j][2 * half + 1]);
    }
  }
}

// (c) dQ of one 64-row query tile of one head
template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dq_bf16_kernel(const Bwd p) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + kTileQC * P;
  bf16* sK = sG + kTileQC * P;
  bf16* sV = sK + kTileKC * P;

  const int q0 = (int)(gridDim.x - 1 - blockIdx.x) * kTileQC;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int qr = 16 * warp;
  const float sl = p.scale * kLog2e;

  load_rows<D>(sQ, static_cast<const bf16*>(p.q), b, q0, kTileQC, h, p.S, p.Hq);
  load_rows<D>(sG, static_cast<const bf16*>(p.dout), b, q0, kTileQC, h, p.S, p.Hq);
  float L[2], Dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + qr + g + 8 * half;
    const int64_t at = ((int64_t)b * p.Hq + h) * p.S + q;
    L[half] = q < p.S ? p.lse[at] * kLog2e : 0.f;
    Dl[half] = q < p.S ? p.delta[at] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  int k_lo, k_hi;
  key_range(p, q0, kTileQC, k_lo, k_hi);
  for (int k0 = k_lo / kTileKC * kTileKC; k0 < k_hi; k0 += kTileKC) {
    __syncthreads();
    load_rows<D>(sK, static_cast<const bf16*>(p.k), b, k0, kTileKC, hk, p.S, p.Hkv);
    load_rows<D>(sV, static_cast<const bf16*>(p.v), b, k0, kTileKC, hk, p.S, p.Hkv);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[kTileKC / 8][4], dp[kTileKC / 8][4];
#pragma unroll
    for (int n = 0; n < kTileKC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      frag_a<D>(aq, sQ, qr, 16 * kk, g, c);
      frag_a<D>(ag, sG, qr, 16 * kk, g, c);
#pragma unroll
      for (int n = 0; n < kTileKC / 8; ++n) {
        const bf16* kr = sK + (8 * n + g) * P + 16 * kk + 2 * c;
        const bf16* vr = sV + (8 * n + g) * P + 16 * kk + 2 * c;
        mma(s[n], aq, ld32(kr), ld32(kr + 8));
        mma(dp[n], ag, ld32(vr), ld32(vr + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < kTileKC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int qpos = q0 + qr + g + 8 * half, kpos = k0 + 8 * n + 2 * c + (e & 1);
        const float pr = key_ok(p, qpos, kpos) ? ex2(s[n][e] * sl - L[half]) : 0.f;
        dp[n][e] = pr * (dp[n][e] - Dl[half]);
      }
    // dQ += dS K: k16 step t over keys 16 t ..
#pragma unroll
    for (int t = 0; t < kTileKC / 16; ++t) {
      const uint32_t as[4] = {pack2(dp[2 * t][0], dp[2 * t][1]),
                              pack2(dp[2 * t][2], dp[2 * t][3]),
                              pack2(dp[2 * t + 1][0], dp[2 * t + 1][1]),
                              pack2(dp[2 * t + 1][2], dp[2 * t + 1][3])};
      mma_rows<D>(dq, as, sK, 16 * t, lane);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + qr + g + 8 * half;
    if (q >= p.S) continue;
    bf16* out = static_cast<bf16*>(p.dq) + (((int64_t)b * p.S + q) * p.Hq + h) * D + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack2(dq[j][2 * half] * p.scale, dq[j][2 * half + 1] * p.scale);
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

template <int D>
int dkdv_bf16(const Bwd& p, cudaStream_t s) {
  constexpr int smem = smem_dkdv<D>();
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + kTileKB - 1) / kTileKB, p.B * p.Hkv, p.groups);
  flash_bwd_dkdv_bf16_kernel<D><<<grid, kWarps * 32, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int dq_bf16(const Bwd& p, cudaStream_t s) {
  constexpr int smem = smem_dq<D>();
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + kTileQC - 1) / kTileQC, p.Hq, p.B);
  flash_bwd_dq_bf16_kernel<D><<<grid, kWarps * 32, smem, s>>>(p);
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

// (a) D = rowsum(dO o O) into `delta`
extern "C" int flash_attention_bwd_delta(BWD_ARGS) {
  BWD_MAKE
  const int64_t rows = (int64_t)B * S * Hq;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  if (bf16_io)
    flash_bwd_delta_kernel<bf16><<<blocks, 256, 0, s>>>(p, D);
  else
    flash_bwd_delta_kernel<float><<<blocks, 256, 0, s>>>(p, D);
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
