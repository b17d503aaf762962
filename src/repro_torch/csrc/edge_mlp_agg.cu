// Dst-aligned edge MLP + weighted aggregation (the legacy fused op) for
// NVIDIA Hopper (sm_90a), fp32 and bf16 edge features.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_agg/kernel.py:435 (edge_mlp_agg, body _kernel :68)
// over the tiles of ops.dst_aligned_layout: node block b holds the edges
// whose destination lies in [b*BN, (b+1)*BN), padded to NE edge tiles of BE
// slots.  Per slot s and per node n of the block:
//   h        = ELU(feats[s] @ w1 + b1)                         [Hh]
//   e_new[s] = h @ w2 + b2                                     [H], feats' type
//   agg[n]   = sum of e_new[s] * w[s] over the slots with dstl[s] == n (fp32)
// with w = 1/d_ij (0 on padding), all arithmetic in fp32 whatever the type
// of feats.
//
// What bounds it on the H100 SXM (published peaks at its 700 W limit):
// bytes, narrowly.  At the paper's large widths (Fin = 3H = 96, Hh = H = 32)
// a slot costs 2 * (96*32 + 32*32) = 8,192 FLOP of fp32 FMA against 520
// bytes (fp32 feats in, e_new out, dstl, w): 15.8 FLOP/byte, just under the
// fp32 CUDA-core ridge of 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte.  The two
// bounds are within 25% of each other, so the kernel has to keep both the
// FMA pipes and the memory busy.
//
// Design:
// - Grid: one block of 128 threads per node block.  A node block's NE*BE
//   slots are contiguous in every tile array, so the block walks them as
//   one sequence in chunks of 128 slots, in order: the loop takes the place
//   of the TPU kernel's sequential edge-block grid axis.
// - Staging: w1, b1, w2 and b2 sit in shared memory once per block,
//   zero-padded to 32 hidden and 32 output channels (16.5 KB at Fin = 96).
//   A chunk's feats rows are copied into shared memory in 16-byte cp.async
//   pieces, each row padded to an odd number of 16-byte units so that every
//   thread's 16-byte reads of its own row are free of bank conflicts.  The
//   next chunk's copy starts as soon as this chunk's MLP is done, under the
//   e_new stores and the aggregate.  Rows whose bytes are not a multiple of
//   16 take plain element loads instead.
// - MLP: thread t owns slot t of the chunk and all 32 channels in
//   registers.  Each 16-byte read of its feats row feeds 4 (fp32) or 8
//   (bf16) rows of w1, read as broadcast float4s.  fp32 FMAs on the CUDA
//   cores (no TF32 and no tensor cores in this first version); ELU is
//   expm1f for x <= 0, as jax.nn.elu and F.elu compute it.  e_new goes to
//   shared memory, then out to device memory one coalesced row per warp.
// - Aggregate: a [BN, 32] fp32 accumulator in shared memory and no atomics.
//   Warp w owns the nodes n with n % 4 == w.  It walks the chunk's slots in
//   order, a ballot picking its slots with a non-zero weight and an
//   in-range dstl, and lane c adds e_new[s, c] * w[s] to acc[n, c].  So
//   every (node, channel) sum runs over the tiles in order and the slots in
//   order, two launches are bitwise equal, and the kernel does not rely on
//   the layout being dst-sorted.  Zero-weight (padding) slots are skipped,
//   where the TPU kernel's one-hot product adds them as zeros: agg agrees to
//   fp32 rounding, not bitwise.  The accumulator is written once, after the
//   last chunk.
// - Sizes: Fin <= 128, Hh and H <= 32, BN <= 256 (the wrapper raises
//   beyond); 64-bit offsets into the tile arrays.
//
// C entry points return cudaGetLastError() (or the error of the shared
// memory attribute); they launch on the given stream and do not
// synchronise.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;       // one slot per thread per chunk
constexpr int kChunk = kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kCh = 32;             // hidden and output channels, zero-padded
constexpr int kEStride = kCh + 4;   // e_new rows in shared memory: 9 units
constexpr int kMaxFin = 128, kMaxBlockN = 256;

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// 16 bytes of a feats row in shared memory, as fp32 (bf16 -> fp32 is exact:
// the bf16 bits are the top half of the fp32 word)
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shared-memory layout of one block, in bytes from the start; every piece
// begins on a 16-byte boundary.
struct Smem {
  int units, kp, row;  // 16-byte units of a feats row, w1 rows, row stride (elements)
  size_t w1, w2, b1, b2, acc, e, wt, d, f, total;
  __host__ __device__ Smem(int fin, int bn, int elem) {
    const int v = 16 / elem;
    units = (fin + v - 1) / v;
    kp = units * v;
    row = (units | 1) * v;
    w1 = 0;
    w2 = w1 + sizeof(float) * kp * kCh;
    b1 = w2 + sizeof(float) * kCh * kCh;
    b2 = b1 + sizeof(float) * kCh;
    acc = b2 + sizeof(float) * kCh;
    e = acc + sizeof(float) * bn * kCh;
    wt = e + sizeof(float) * kChunk * kEStride;
    d = wt + sizeof(float) * 2 * kChunk;
    f = d + sizeof(int) * 2 * kChunk;
    total = f + (size_t)elem * kChunk * row;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_mlp_agg_kernel(const T* __restrict__ feats, const int* __restrict__ dstl,
                    const float* __restrict__ wgt, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, T* __restrict__ e_new,
                    float* __restrict__ agg, int slots, int fin, int hh, int h, int bn,
                    int vec_rows) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(fin, bn, sizeof(T));
  float* s_w1 = reinterpret_cast<float*>(smem + L.w1);   // [kp, 32]
  float* s_w2 = reinterpret_cast<float*>(smem + L.w2);   // [32, 32]
  float* s_b1 = reinterpret_cast<float*>(smem + L.b1);   // [32]
  float* s_b2 = reinterpret_cast<float*>(smem + L.b2);   // [32]
  float* s_acc = reinterpret_cast<float*>(smem + L.acc); // [bn, 32]
  float* s_e = reinterpret_cast<float*>(smem + L.e);     // [chunk, kEStride]
  float* s_wt = reinterpret_cast<float*>(smem + L.wt);   // [2, chunk]
  int* s_d = reinterpret_cast<int*>(smem + L.d);         // [2, chunk]
  T* s_f = reinterpret_cast<T*>(smem + L.f);             // [chunk, row]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t blk = blockIdx.x;

  for (int i = t; i < L.kp * kCh; i += kThreads) {
    const int k = i / kCh, j = i % kCh;
    s_w1[i] = (k < fin && j < hh) ? w1[k * hh + j] : 0.f;
  }
  for (int i = t; i < kCh * kCh; i += kThreads) {
    const int k = i / kCh, j = i % kCh;
    s_w2[i] = (k < hh && j < h) ? w2[k * h + j] : 0.f;
  }
  if (t < kCh) {
    s_b1[t] = t < hh ? b1[t] : 0.f;
    s_b2[t] = t < h ? b2[t] : 0.f;
  }
  for (int i = t; i < bn * kCh; i += kThreads) s_acc[i] = 0.f;
  // the feats rows' padding columns (fin .. kp) stay zero: loads never write them
  unsigned* f_words = reinterpret_cast<unsigned*>(s_f);
  for (int i = t; i < kChunk * L.row * (int)sizeof(T) / 4; i += kThreads) f_words[i] = 0u;
  __syncthreads();

  const T* f_blk = feats + blk * slots * fin;
  const int* d_blk = dstl + blk * slots;
  const float* w_blk = wgt + blk * slots;
  T* e_blk = e_new + blk * slots * h;
  const int n_chunks = (slots + kChunk - 1) / kChunk;

  // chunk c's feats rows into s_f, its dstl and weights into buffer c % 2
  auto load_chunk = [&](int c) {
    const int s0 = c * kChunk;
    const int n = min(kChunk, slots - s0);
    const T* src = f_blk + (int64_t)s0 * fin;
    if (vec_rows) {
      for (int i = t; i < n * L.units; i += kThreads) {
        const int r = i / L.units, u = i - r * L.units;
        cp_async16(s_f + r * L.row + u * V, src + (int64_t)i * V);
      }
      cp_async_commit();
    } else {
      for (int i = t; i < n * fin; i += kThreads) {
        const int r = i / fin, k = i - r * fin;
        s_f[r * L.row + k] = src[i];
      }
    }
    if (t < n) {
      s_d[(c & 1) * kChunk + t] = d_blk[s0 + t];
      s_wt[(c & 1) * kChunk + t] = w_blk[s0 + t];
    }
  };

  load_chunk(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * kChunk;
    const int n = min(kChunk, slots - s0);
    cp_async_wait_all();
    __syncthreads();

    if (t < n) {
      float acc[kCh];
#pragma unroll
      for (int j = 0; j < kCh; ++j) acc[j] = 0.f;
      const T* f_row = s_f + t * L.row;
      for (int u = 0; u < L.units; ++u) {
        float f[V];
        load16(f_row + u * V, f);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float4* w = reinterpret_cast<const float4*>(s_w1 + (u * V + i) * kCh);
#pragma unroll
          for (int q = 0; q < kCh / 4; ++q) {
            const float4 wq = w[q];
            acc[4 * q + 0] = fmaf(f[i], wq.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(f[i], wq.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(f[i], wq.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(f[i], wq.w, acc[4 * q + 3]);
          }
        }
      }
      float hid[kCh];
#pragma unroll
      for (int j = 0; j < kCh; ++j) {
        const float x = acc[j] + s_b1[j];
        hid[j] = x > 0.f ? x : expm1f(x);
        acc[j] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kCh; ++k) {
        const float4* w = reinterpret_cast<const float4*>(s_w2 + k * kCh);
#pragma unroll
        for (int q = 0; q < kCh / 4; ++q) {
          const float4 wq = w[q];
          acc[4 * q + 0] = fmaf(hid[k], wq.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(hid[k], wq.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(hid[k], wq.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(hid[k], wq.w, acc[4 * q + 3]);
        }
      }
      float4* e_row = reinterpret_cast<float4*>(s_e + t * kEStride);
#pragma unroll
      for (int q = 0; q < kCh / 4; ++q)
        e_row[q] = make_float4(acc[4 * q + 0] + s_b2[4 * q + 0], acc[4 * q + 1] + s_b2[4 * q + 1],
                               acc[4 * q + 2] + s_b2[4 * q + 2], acc[4 * q + 3] + s_b2[4 * q + 3]);
    }
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk(c + 1);

    for (int r = warp; r < n; r += kWarps)
      if (lane < h) e_blk[(int64_t)(s0 + r) * h + lane] = from_f32<T>(s_e[r * kEStride + lane]);

    // the aggregate: this warp's nodes, the chunk's slots in order
    const int* sd = s_d + (c & 1) * kChunk;
    const float* sw = s_wt + (c & 1) * kChunk;
    for (int g = 0; g < n; g += 32) {
      const int s = g + lane;
      const int d = s < n ? sd[s] : -1;
      const float w = s < n ? sw[s] : 0.f;
      unsigned mine = __ballot_sync(kFull, w != 0.f && d >= 0 && d < bn && d % kWarps == warp);
      while (mine) {
        const int l = __ffs(mine) - 1;
        mine &= mine - 1;
        const int dd = __shfl_sync(kFull, d, l);
        const float ww = __shfl_sync(kFull, w, l);
        float* a = s_acc + dd * kCh + lane;
        *a = __fadd_rn(*a, __fmul_rn(s_e[(g + l) * kEStride + lane], ww));
      }
    }
  }
  __syncthreads();
  for (int r = warp; r < bn; r += kWarps)
    if (lane < h) agg[(blk * bn + r) * h + lane] = s_acc[r * kCh + lane];
}

template <typename T>
cudaError_t launch(const void* feats, const void* dstl, const void* wgt, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* e_new, void* agg,
                   int n_blocks, int slots, int fin, int hh, int h, int bn,
                   cudaStream_t stream) {
  if (fin < 1 || fin > kMaxFin || hh < 1 || hh > kCh || h < 1 || h > kCh || bn < 1 ||
      bn > kMaxBlockN || slots < 0 || n_blocks < 0)
    return cudaErrorInvalidValue;
  if (n_blocks == 0) return cudaSuccess;
  const size_t smem = Smem(fin, bn, sizeof(T)).total;
  auto kern = edge_mlp_agg_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec_rows = (fin * sizeof(T)) % 16 == 0 && (uintptr_t)feats % 16 == 0;
  kern<<<n_blocks, kThreads, smem, stream>>>(
      (const T*)feats, (const int*)dstl, (const float*)wgt, (const float*)w1, (const float*)b1,
      (const float*)w2, (const float*)b2, (T*)e_new, (float*)agg, slots, fin, hh, h, bn,
      vec_rows);
  return cudaGetLastError();
}

}  // namespace

#define MLP_AGG_ARGS                                                                      \
  const void *feats, const void *dstl, const void *wgt, const void *w1, const void *b1,  \
      const void *w2, const void *b2, void *e_new, void *agg, int n_blocks, int slots,   \
      int fin, int hh, int h, int block_n, void *stream
#define MLP_AGG_PASS                                                                      \
  feats, dstl, wgt, w1, b1, w2, b2, e_new, agg, n_blocks, slots, fin, hh, h, block_n,    \
      (cudaStream_t)stream

extern "C" int edge_mlp_agg_f32(MLP_AGG_ARGS) { return (int)launch<float>(MLP_AGG_PASS); }

extern "C" int edge_mlp_agg_bf16(MLP_AGG_ARGS) { return (int)launch<bf16>(MLP_AGG_PASS); }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
