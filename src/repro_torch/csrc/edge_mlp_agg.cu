// Dst-aligned edge MLP + weighted aggregation (the legacy fused op) for
// NVIDIA Hopper (sm_90a), fp32 and bf16 edge features, 3xTF32 tensor-core
// products.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_agg/kernel.py:435 (edge_mlp_agg, body _kernel :68)
// over the tiles of ops.dst_aligned_layout: node block b holds the edges
// whose destination lies in [b*BN, (b+1)*BN), padded to NE edge tiles of BE
// slots.  Per slot s and per node n of the block:
//   h        = ELU(feats[s] @ w1 + b1)                         [Hh]
//   e_new[s] = h @ w2 + b2                                     [H], feats' type
//   agg[n]   = sum of e_new[s] * w[s] over the slots with dstl[s] == n (fp32)
// with w = 1/d_ij (0 on padding), all arithmetic fp32-accurate whatever the
// type of feats.
//
// What bounds it on the H100 SXM (published peaks at its 700 W limit):
// bytes.  At the paper's large widths (Fin = 3H = 96, Hh = H = 32) a slot
// costs 2 * (96*32 + 32*32) = 8,192 FLOP against 520 bytes (fp32 feats in,
// e_new out, dstl, w): 15.8 FLOP/byte, just under the fp32 CUDA-core ridge
// of 20, so fp32 FMAs would have to keep both the FMA pipes and the memory
// busy.  In 3xTF32 on the tensor cores (three TF32 products per fp32
// product, 495 TFLOP/s) the operations take a third of the bytes' time.
//
// Design:
// - Grid: persistent, one block per SM of G groups of 4 warps (G = 3 for
//   fp32 feats at Fin 96, 4 for bf16; the launch plan picks the most that
//   fit in shared memory).  Group j of block b walks the node blocks
//   j * grid + b, + G * grid, ...; each node block's NE*BE slots are
//   contiguous in every tile array, so a group walks its node blocks as one
//   sequence of 64-slot tiles.  A node block is summed by one group, in
//   tile order, whatever the grid.
// - Staging: a 2-stage cp.async ring per group.  The copy of the group's
//   next tile (its feats rows, dstl and w) is issued before this tile's
//   products run, so it is in flight under them, across node-block edges
//   too.  Stage rows are padded so that the A-fragment loads are free of
//   bank conflicts: 8 mod 32 floats for fp32 rows (8-byte loads of a k
//   pair), 4 mod 8 words for bf16 rows (4-byte loads of a k pair).  Rows
//   whose bytes are not a multiple of 16 take plain element loads instead.
// - MLP on tensor cores: each warp owns 16 of the tile's rows; layer 1 is
//   a [16 x Kp] x [Kp x 32] product, layer 2 [16 x 32] x [32 x 32], in
//   3xTF32 mma.sync.m16n8k8 (csrc/nmp_tf32.cuh).  w1 and w2 are split into
//   TF32 hi / lo once per block into shared memory (a B fragment is one
//   16-byte load, no split).  bf16 feats are exact in TF32, so layer 1's A
//   has no lo part and takes hi*hi + hi*lo only: 2 products per fragment
//   instead of 3, a third fewer tensor-core instructions and no A split.
//   Layer 1's C fragments are layer 2's A fragments (the k pair 2t, 2t + 1
//   of an n-tile is the column pair a lane holds), so the hidden layer never
//   leaves registers.  ELU is the branch-free form of the NMP kernels.
//   e_new (fp32) goes to a per-group slab in shared memory, and from there
//   to device memory as coalesced rows (rounded to bf16 for bf16 feats).
// - Aggregate: the TPU kernel's own form, a one-hot product on the tensor
//   cores: agg[16 nodes x 8 channels] += onehot[16 x 8 slots] *
//   (e_new * w)[8 slots x 8 channels].  Warp w of a group owns the nodes
//   n % 4 == w of its node block (so the few consecutive nodes of a sorted
//   tile spread over the group's warps), as rows of its m-tiles, whose sums
//   stay in registers (C fragments) from the node block's first tile to
//   its last.  The one-hot is exact in TF32, so each k-step is 2 products
//   (hi and lo of e_new * w); a k-step of 8 slots that has no slot in a
//   warp's m-tiles is skipped (one ballot per tile over the slots' m-tile
//   bits), so on a dst-sorted layout most are.  Slots with w == 0 (padding), with dstl outside
//   [0, BN) or past the tile's end add nothing.  No float atomics, one
//   writer per agg row, a fixed order: two launches are bitwise equal, for
//   any grid, and nothing assumes a dst-sorted layout.  A non-finite e_new
//   reaches the 16 nodes of its m-tile (0 * inf), as in the TPU kernel's
//   one-hot product, not only its own node.
// - Shared memory per block: weights pre-split [Kp/2 + 16 row pairs] x 136
//   floats + biases (35,072 B at Fin 96); per group 2 stages of 64 rows
//   (fp32: 26,624 B of rows + 512 of dstl / w each; bf16: 13,312 + 512) and
//   a [64 x 40] fp32 e_new slab (10,240 B).  fp32 at Fin 96: 3 groups,
//   228,608 B, one block of 12 warps per SM; bf16: 4 groups, 186,624 B, 16
//   warps.  The register accumulators of the aggregate take 16 floats per
//   lane for each 64 nodes of BN.
// - Sizes: Fin <= 128, Hh and H <= 32 (zero-padded to 8-multiples: k-steps
//   and n-tiles past them are skipped), BN <= 256, any BE; 64-bit offsets
//   into the tile arrays.
//
// C entry points return cudaGetLastError() (or the error of the attribute
// or occupancy call); they launch on the given stream and do not
// synchronise.  edge_mlp_agg_plan reports the launch.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>

#include "nmp_tf32.cuh"

namespace {

constexpr int kGroupWarps = 4;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kRows = 16 * kGroupWarps;   // slots per tile: 16 rows per warp
constexpr int kCh = 32;                   // hidden and output channels, padded
constexpr int kRS = 4 * kCh + 8;          // pre-split weight row-pair stride
constexpr int kES = kCh + 8;              // e_new slab stride: 8 mod 32
constexpr int kMaxFin = 128, kMaxBlockN = 256;
constexpr uint32_t kOne = 0x3f800000u;    // 1.0f, exact in TF32

using bf16 = __nv_bfloat16;

// most groups a block runs (launch bounds: 168 registers a thread at 384
// threads, 128 at 512): fp32 stages fill shared memory at 3 groups at Fin
// 96, bf16 stages are half the size
template <typename T> struct MaxGroups { static constexpr int value = 4; };
template <> struct MaxGroups<float> { static constexpr int value = 3; };

// Shared-memory layout of one block, in bytes from the start; every piece
// begins on a 16-byte boundary.
struct Layout {
  int kp, row;  // layer 1's K (Fin rounded up to 8), stage row stride (elements)
  size_t w1, w2, b1, b2, groups, feat_bytes, stage_bytes, group_bytes;
  __host__ __device__ Layout(int fin, int elem) {
    kp = (fin + 7) / 8 * 8;
    if (elem == 4) {
      row = kp + ((8 - kp) % 32 + 32) % 32;   // 8 mod 32 floats
    } else {
      int words = (kp / 2 + 3) / 4 * 4;
      if (words % 8 == 0) words += 4;          // 4 mod 8 words
      row = 2 * words;
    }
    w1 = 0;
    w2 = w1 + sizeof(float) * (kp / 2) * kRS;
    b1 = w2 + sizeof(float) * (kCh / 2) * kRS;
    b2 = b1 + sizeof(float) * kCh;
    groups = b2 + sizeof(float) * kCh;
    feat_bytes = (size_t)elem * kRows * row;
    stage_bytes = feat_bytes + 2 * sizeof(float) * kRows;   // rows, dstl, w
    group_bytes = 2 * stage_bytes + sizeof(float) * kRows * kES;
  }
  __host__ __device__ size_t total(int n_groups) const {
    return groups + n_groups * group_bytes;
  }
};

// w [rows][cols] zero-padded to [2 * pairs][32] -> wp [pairs][kRS]: for the
// row pair (2p, 2p + 1) and column n the float4 (hi 2p, hi 2p + 1, lo 2p,
// lo 2p + 1) of the TF32 split, so one 16-byte load gives a lane both B
// values of a k-step
__device__ void presplit(float* wp, const float* w, int rows, int cols, int pairs) {
  for (int i = threadIdx.x; i < pairs * kCh; i += blockDim.x) {
    const int p = i / kCh, n = i % kCh;
    const float v0 = (2 * p < rows && n < cols) ? w[(2 * p) * cols + n] : 0.f;
    const float v1 = (2 * p + 1 < rows && n < cols) ? w[(2 * p + 1) * cols + n] : 0.f;
    uint32_t h0, l0, h1, l1;
    split(v0, h0, l0);
    split(v1, h1, l1);
    *reinterpret_cast<float4*>(wp + p * kRS + n * 4) =
        make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                    __uint_as_float(l1));
  }
}

// the A fragment of a warp's 16 rows at the k pair (k0 + 2t, k0 + 2t + 1):
// a[0] = (g, 2t), a[1] = (g + 8, 2t), a[2] = (g, 2t + 1), a[3] = (g + 8, 2t + 1),
// split into hi / lo (bf16: lo is 0 and not formed)
__device__ __forceinline__ void load_a(const float* A, int lda, int k0, int g, int t,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 u = *reinterpret_cast<const float2*>(A + g * lda + k0 + 2 * t);
  const float2 v = *reinterpret_cast<const float2*>(A + (g + 8) * lda + k0 + 2 * t);
  split(u.x, ah[0], al[0]);
  split(v.x, ah[1], al[1]);
  split(u.y, ah[2], al[2]);
  split(v.y, ah[3], al[3]);
}
__device__ __forceinline__ void load_a(const bf16* A, int lda, int k0, int g, int t,
                                       uint32_t (&ah)[4], uint32_t (&)[4]) {
  // a k pair of bf16 is one word; bf16 -> fp32 is exact, and so is TF32
  const uint32_t u = *reinterpret_cast<const uint32_t*>(A + g * lda + k0 + 2 * t);
  const uint32_t v = *reinterpret_cast<const uint32_t*>(A + (g + 8) * lda + k0 + 2 * t);
  ah[0] = u << 16;
  ah[1] = v << 16;
  ah[2] = u & 0xffff0000u;
  ah[3] = v & 0xffff0000u;
}

// c[nt] += A [16 x 8 ks1] x Bp (pre-split) over the n-tiles nt < nt_n
template <typename T>
__device__ __forceinline__ void layer1(float (&c)[4][4], const T* A, int lda, const float* Bp,
                                       int ks1, int nt_n, int g, int t) {
  constexpr bool kLo = std::is_same<T, float>::value;
  float small[4][4] = {};
  for (int ks = 0; ks < ks1; ++ks) {
    uint32_t ah[4], al[4];
    load_a(A, lda, ks * 8, g, t, ah, al);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= nt_n) break;
      const float4 b = *reinterpret_cast<const float4*>(Bp + (ks * 4 + t) * kRS + (nt * 8 + g) * 4);
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      if constexpr (kLo) mma_tf32(small[nt], al, bh0, bh1);
      mma_tf32(small[nt], ah, __float_as_uint(b.z), __float_as_uint(b.w));
      mma_tf32(c[nt], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[nt][j] += small[nt][j];
}

// o[nt] += h [16 x 8 ks2] x Bp, A read from h's C fragments: the k pair
// (2t, 2t + 1) of k-step ks is the column pair of n-tile ks
__device__ __forceinline__ void layer2(float (&o)[4][4], const float (&h)[4][4],
                                       const float* Bp, int ks2, int nt_n, int g, int t) {
  float small[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks >= ks2) break;
    uint32_t ah[4], al[4];
    split(h[ks][0], ah[0], al[0]);
    split(h[ks][2], ah[1], al[1]);
    split(h[ks][1], ah[2], al[2]);
    split(h[ks][3], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= nt_n) break;
      const float4 b = *reinterpret_cast<const float4*>(Bp + (ks * 4 + t) * kRS + (nt * 8 + g) * 4);
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      mma_tf32(small[nt], al, bh0, bh1);
      mma_tf32(small[nt], ah, __float_as_uint(b.z), __float_as_uint(b.w));
      mma_tf32(o[nt], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] += small[nt][j];
}

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(kGroupThreads) : "memory");
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// MT: node m-tiles of 16 a warp owns (ceil(BN / 64))
template <typename T, int MT>
__global__ void __launch_bounds__(kGroupThreads * MaxGroups<T>::value, 1)
edge_mlp_agg_kernel(const T* __restrict__ feats, const int* __restrict__ dstl,
                    const float* __restrict__ wgt, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, T* __restrict__ e_new,
                    float* __restrict__ agg, int n_blocks, int slots, int fin, int hh, int h,
                    int bn, int vec_rows, int vec_out) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(fin, sizeof(T));
  float* s_w1 = reinterpret_cast<float*>(smem + L.w1);
  float* s_w2 = reinterpret_cast<float*>(smem + L.w2);
  float* s_b1 = reinterpret_cast<float*>(smem + L.b1);
  float* s_b2 = reinterpret_cast<float*>(smem + L.b2);
  const int n_groups = blockDim.x / kGroupThreads;

  presplit(s_w1, w1, fin, hh, L.kp / 2);
  presplit(s_w2, w2, hh, h, kCh / 2);
  if (threadIdx.x < kCh) {
    s_b1[threadIdx.x] = threadIdx.x < hh ? b1[threadIdx.x] : 0.f;
    s_b2[threadIdx.x] = threadIdx.x < h ? b2[threadIdx.x] : 0.f;
  }
  // stage rows' padding columns (fin .. kp) stay zero: copies never write them
  {
    float4* z = reinterpret_cast<float4*>(smem + L.groups);
    const size_t n16 = n_groups * L.group_bytes / 16;
    for (size_t i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int grp = threadIdx.x / kGroupThreads, tid = threadIdx.x % kGroupThreads;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  unsigned char* gbase = smem + L.groups + grp * L.group_bytes;
  float* s_e = reinterpret_cast<float*>(gbase + 2 * L.stage_bytes);   // [kRows][kES]
  auto s_f = [&](int st) { return reinterpret_cast<T*>(gbase + st * L.stage_bytes); };
  auto s_d = [&](int st) {
    return reinterpret_cast<int*>(gbase + st * L.stage_bytes + L.feat_bytes);
  };
  auto s_w = [&](int st) { return reinterpret_cast<float*>(s_d(st) + kRows); };

  const int worker = grp * gridDim.x + blockIdx.x, n_workers = gridDim.x * n_groups;
  const int tiles_nb = (slots + kRows - 1) / kRows;
  const int my_nbs = worker < n_blocks ? (n_blocks - 1 - worker) / n_workers + 1 : 0;
  const long long n_tiles = (long long)my_nbs * tiles_nb;
  const int units = fin * (int)sizeof(T) / 16;
  const int step_r = units > 0 ? kGroupThreads / units : 0, step_u = kGroupThreads - step_r * units;

  // tile i of the group's sequence into stage i % 2: feats rows, dstl and w
  // (dstl -1 and w 0 past the node block's last slot)
  auto issue = [&](long long i) {
    const int st = (int)(i & 1);
    const int64_t nb = worker + (i / tiles_nb) * (int64_t)n_workers;
    const int s0 = (int)(i % tiles_nb) * kRows;
    const int n = min(kRows, slots - s0);
    const int64_t slot0 = nb * slots + s0;
    const T* src = feats + slot0 * fin;
    T* dst = s_f(st);
    if (vec_rows) {
      // piece j = r * units + u, stepped by the group's 128 threads
      int r = tid / units, u = tid - r * units;
      for (int j = tid; j < n * units; j += kGroupThreads) {
        cp_async16(dst + r * L.row + u * V, src + (int64_t)j * V);
        r += step_r;
        u += step_u;
        if (u >= units) {
          u -= units;
          ++r;
        }
      }
    } else {
      for (int j = tid; j < n * fin; j += kGroupThreads) {
        const int r = j / fin, k = j - r * fin;
        dst[r * L.row + k] = src[j];
      }
    }
    if (tid < kRows) {
      if (tid < n) {
        cp_async4(s_d(st) + tid, dstl + slot0 + tid);
      } else {
        s_d(st)[tid] = -1;
      }
    } else if (tid - kRows < n) {
      cp_async4(s_w(st) + tid - kRows, wgt + slot0 + tid - kRows);
    } else {
      s_w(st)[tid - kRows] = 0.f;
    }
  };

  const int nt_h = (hh + 7) / 8, nt_o = (h + 7) / 8, ks1 = L.kp / 8;
  float acc[MT][4][4] = {};
  if (n_tiles > 0) issue(0);
  for (long long i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    group_sync(grp);          // tile i landed; tile i - 1's reads are done
    if (i + 1 < n_tiles) issue(i + 1);
    const int st = (int)(i & 1);
    const int64_t nb = worker + (i / tiles_nb) * (int64_t)n_workers;
    const int s0 = (int)(i % tiles_nb) * kRows;
    const int n = min(kRows, slots - s0);

    // --- the MLP on the warp's 16 rows ---
    {
      float z[4][4], o[4][4];
      init_bias<4>(z, s_b1, t);
      layer1<T>(z, s_f(st) + warp * 16 * L.row, L.row, s_w1, ks1, nt_h, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[nt][j] = elu(z[nt][j]);
      init_bias<4>(o, s_b2, t);
      layer2(o, z, s_w2, nt_h, nt_o, g, t);
      float* ew = s_e + warp * 16 * kES;
      store_c<4>(ew, kES, o, g, t);
      __syncwarp();
      // e_new out: the warp's rows are contiguous in device memory
      const int rows = min(16, n - warp * 16);
      if (rows > 0) {
        T* out = e_new + (nb * slots + s0 + warp * 16) * h;
        if (vec_out) {
          const int per_row = h / V;
          for (int j = lane; j < rows * per_row; j += 32) {
            const int r = j / per_row, c = (j - r * per_row) * V;
            const float* e = ew + r * kES + c;
            if constexpr (std::is_same<T, float>::value) {
              *reinterpret_cast<float4*>(out + r * h + c) = *reinterpret_cast<const float4*>(e);
            } else {
              uint4 q;
              uint32_t* w = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
              for (int p = 0; p < 4; ++p) {
                const __nv_bfloat162 v = __floats2bfloat162_rn(e[2 * p], e[2 * p + 1]);
                w[p] = *reinterpret_cast<const uint32_t*>(&v);
              }
              *reinterpret_cast<uint4*>(out + r * h + c) = q;
            }
          }
        } else {
          for (int j = lane; j < rows * h; j += 32) {
            const int r = j / h, c = j - r * h;
            out[j] = from_f32<T>(ew[r * kES + c]);
          }
        }
      }
    }
    group_sync(grp);          // the tile's e_new slab is complete

    // --- the aggregate: one-hot [nodes x slots] x (e_new * w) ---
    // Warp w owns the nodes n % 4 == w, as rows n / 4 of its m-tiles, so
    // the few consecutive nodes of a dst-sorted tile spread over the 4
    // warps.  Lane l reads slots 2l and 2l + 1: the OR over a quad of lanes
    // is the m-tile bits of k-step l / 4, and one ballot gives the k-steps
    // that touch this warp's m-tiles.
    {
      const int* sd = s_d(st);
      const float* sw = s_w(st);
      auto bit = [&](int d, float w) {
        return (w != 0.f && d >= 0 && d < bn) ? 1u << ((d & 3) | ((d >> 6) << 2)) : 0u;
      };
      const int2 d2 = *reinterpret_cast<const int2*>(sd + 2 * lane);
      const float2 w2 = *reinterpret_cast<const float2*>(sw + 2 * lane);
      unsigned qbits = bit(d2.x, w2.x) | bit(d2.y, w2.y);
      qbits |= __shfl_xor_sync(kFull, qbits, 1);
      qbits |= __shfl_xor_sync(kFull, qbits, 2);
      unsigned own = 0;
#pragma unroll
      for (int j = 0; j < MT; ++j) own |= 1u << (warp + 4 * j);
      unsigned ksteps = __ballot_sync(kFull, (qbits & own) != 0) & 0x11111111u;
      while (ksteps) {
        const int ks = (__ffs(ksteps) - 1) >> 2;
        ksteps &= ksteps - 1;
        const unsigned bits = __shfl_sync(kFull, qbits, 4 * ks);
        const int sa = ks * 8 + t, sb = sa + 4;
        const float wa = sw[sa], wb = sw[sb];
        const int da = sd[sa], db = sd[sb];
        const bool va = bit(da, wa) != 0, vb = bit(db, wb) != 0;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float x0 = va ? __fmul_rn(s_e[sa * kES + nt * 8 + g], wa) : 0.f;
          const float x1 = vb ? __fmul_rn(s_e[sb * kES + nt * 8 + g], wb) : 0.f;
          split(x0, bh[nt][0], bl[nt][0]);
          split(x1, bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (!((bits >> (warp + 4 * j)) & 1u)) continue;
          const int n0 = 4 * (16 * j + g) + warp, n1 = n0 + 32;   // rows g, g + 8
          const uint32_t a[4] = {va && da == n0 ? kOne : 0u, va && da == n1 ? kOne : 0u,
                                 vb && db == n0 ? kOne : 0u, vb && db == n1 ? kOne : 0u};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (nt >= nt_o) break;
            mma_tf32(acc[j][nt], a, bh[nt][0], bh[nt][1]);
            mma_tf32(acc[j][nt], a, bl[nt][0], bl[nt][1]);
          }
        }
      }
    }

    // --- the node block's last tile: its agg rows out, the sums reset ---
    if (s0 + kRows >= slots) {
#pragma unroll
      for (int j = 0; j < MT; ++j) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = 4 * (16 * j + g + 8 * hf) + warp, col = nt * 8 + 2 * t;
            float* a = agg + (nb * bn + row) * h + col;
            if (row < bn && col < h) a[0] = acc[j][nt][2 * hf];
            if (row < bn && col + 1 < h) a[1] = acc[j][nt][2 * hf + 1];
            acc[j][nt][2 * hf] = acc[j][nt][2 * hf + 1] = 0.f;
          }
        }
      }
    }
  }
}

struct Plan {
  int grid, groups, smem, blocks_per_sm, threads;
};

// the launch for NB node blocks: one block per SM (at most NB), each of as
// many groups as fit in shared memory (at most MaxGroups, and no more than
// NB needs); blocks_per_sm only when asked (the occupancy query)
template <typename T, int MT>
cudaError_t plan_kernel(int fin, int n_blocks, Plan& p, bool occupancy) {
  int dev, sms, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const Layout L(fin, sizeof(T));
  const int fit = (int)((optin - (long long)L.groups) / (long long)L.group_bytes);
  if (fit < 1) return cudaErrorInvalidValue;
  p.grid = std::max(1, std::min(sms, n_blocks));
  p.groups = std::max(1, std::min({fit, MaxGroups<T>::value, (n_blocks + p.grid - 1) / p.grid}));
  p.threads = p.groups * kGroupThreads;
  p.smem = (int)L.total(p.groups);
  p.blocks_per_sm = 0;
  auto kern = edge_mlp_agg_kernel<T, MT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess || !occupancy) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.blocks_per_sm, kern, p.threads,
                                                       p.smem);
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
  if (slots == 0)                 // no slot: every agg row is 0
    return cudaMemsetAsync(agg, 0, sizeof(float) * (size_t)n_blocks * bn * h, stream);
  const int vec_rows = (fin * sizeof(T)) % 16 == 0 && (uintptr_t)feats % 16 == 0;
  const int vec_out = (h * sizeof(T)) % 16 == 0 && (uintptr_t)e_new % 16 == 0;
  Plan p;
  const int mtiles = (bn + 15) / 16;
#define MLP_AGG_LAUNCH(MT)                                                                  \
  {                                                                                         \
    cudaError_t err = plan_kernel<T, MT>(fin, n_blocks, p, false);                                 \
    if (err != cudaSuccess) return err;                                                     \
    edge_mlp_agg_kernel<T, MT><<<p.grid, p.threads, p.smem, stream>>>(                      \
        (const T*)feats, (const int*)dstl, (const float*)wgt, (const float*)w1,             \
        (const float*)b1, (const float*)w2, (const float*)b2, (T*)e_new, (float*)agg,       \
        n_blocks, slots, fin, hh, h, bn, vec_rows, vec_out);                                \
  }
  if (mtiles <= 4) MLP_AGG_LAUNCH(1)
  else if (mtiles <= 8) MLP_AGG_LAUNCH(2)
  else MLP_AGG_LAUNCH(4)
#undef MLP_AGG_LAUNCH
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

// the launch for Fin, block_n, feats' element size (4 or 2) and NB node
// blocks: out = {grid, groups per block, dynamic shared memory per block
// (bytes), blocks per SM, threads per block}
extern "C" int edge_mlp_agg_plan(int fin, int block_n, int elem, int n_blocks, int* out) {
  if (fin < 1 || fin > kMaxFin || block_n < 1 || block_n > kMaxBlockN || n_blocks < 1 ||
      (elem != 4 && elem != 2))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const int mtiles = (block_n + 15) / 16;
  cudaError_t err;
  if (elem == 4)
    err = mtiles <= 4 ? plan_kernel<float, 1>(fin, n_blocks, p, true)
        : mtiles <= 8 ? plan_kernel<float, 2>(fin, n_blocks, p, true)
                      : plan_kernel<float, 4>(fin, n_blocks, p, true);
  else
    err = mtiles <= 4 ? plan_kernel<bf16, 1>(fin, n_blocks, p, true)
        : mtiles <= 8 ? plan_kernel<bf16, 2>(fin, n_blocks, p, true)
                      : plan_kernel<bf16, 4>(fin, n_blocks, p, true);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.grid;
  out[1] = p.groups;
  out[2] = p.smem;
  out[3] = p.blocks_per_sm;
  out[4] = p.threads;
  return 0;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
