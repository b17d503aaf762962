// Fused NMP forward and backward (Eq. 4a + 4b and its VJP) at any width H
// >= 1 and any number of hidden layers, for NVIDIA Hopper (sm_90a), fp32
// operands.
//
// Replaces, at every shape the tuned pair (csrc/nmp_fwd.cu, csrc/nmp_bwd.cu:
// H in {8, 16, 32}, the backward at most 5 hidden layers) does not take,
// the Pallas TPU kernels
//   src/repro/kernels/segment_agg/kernel.py::nmp_edge_mlp_agg_fwd (:215)
//   src/repro/kernels/segment_agg/kernel.py::nmp_edge_mlp_agg_bwd (:357)
// which take any H and any depth (every operand a whole-array BlockSpec).
// For every real edge (i <- j) of one rank:
//   z_0 = [x_j_src, x_i_dst, e_ij] w0 + b0,  z_{l+1} = ELU(z_l) wrest_l + brest_l,
//   e'_ij = (e_ij + LN(z_Lp)) * mask_ij   (LN optional: biased variance, eps 1e-5)
//   agg_i = sum_j e'_ij * (1 / d_ij)
// and the backward's outputs: g_e, g_x and the weight gradients for the
// cotangents (g_e', g_agg), as csrc/nmp_bwd.cu computes them.
//
// What bounds it on the H100 SXM (published peaks at its 700 W limit):
// operations at the widths it exists for.  Per edge the forward does 2 (2H*H
// + Lp*H*H) FLOP, and 2 H*H per destination node (x_dst w0_dst, once per
// node), against ~16 H bytes (the gathered x rows, e, e'): at H = 512 ~200
// FLOP/byte, above the ridge of either route (fp32 CUDA cores 20, TF32
// tensor cores 148).  The least time is the tensor cores' in 3xTF32 (3x the
// FLOP at 495 TFLOP/s): 1.80 ms at GraphCast's d512 layer (180,180 edges,
// Lp = 1).  The backward recomputes the forward and does two products per
// layer (input and weight gradients): 3x the forward's FLOP.
//
// Two routes; kernels/segment_agg/ops.py::any_route picks one from H (the
// depth does not move it), and the launch plans report it:
// - "fma", H < 64 or H % 4 != 0 (H = 4 is the paper's smoke config): exact
//   fp32 FMAs on the CUDA cores.  Where a LayerNorm over a handful of
//   features amplifies the recomputed pre-activation's error by 1 / (var +
//   eps), up to 1e5 at H = 4, 3xTF32's ~22 bits of each operand leave the
//   backward's g_x outside the gradient band (chip_smoke.py's sweep times
//   and checks both routes at every width; at H = 4 and 12 the FMA route's
//   forward is as fast and its backward faster).
// - "tc", H >= 64 and H % 4 == 0: 3xTF32 wgmma on the tensor cores.
//
// FMA route.  One building block, block_gemm: a block of 8 warps computes
// C = A B for A [M x K] and B [K x N] read through functions (a gather, a
// slab in shared or global memory, a transposed weight), M in tiles of 64
// rows, N in chunks of 16 NT columns (NT in {1, 2, 4, 8} by H), K in chunks
// of 32 staged in shared memory (the next chunk loaded into registers while
// this one is summed), zero past M, N and K: that is how any width is
// padded, and why the padding never reaches a sum or a LayerNorm.  Each
// thread sums NT rows x 4 columns by FMAs in k order, each K chunk apart
// and then added to the total (blocked summation).  The forward walks
// 64-slot tiles (layer 0 over gathered [x_src | x_dst | e] rows, the hidden
// layers over activation slabs, LayerNorm and e' a warp per row, the
// aggregate a warp per node, nodes cut by a tile edge to the tile's two
// partial rows summed by the fix-up pass in tile order: csrc/nmp_fwd.cu
// (a), (c)); the backward recomputes each tile and adds its weight
// gradients into its block's partial row, summed in block order.
//
// Tensor-core route.  One building block for every product: a block of 3
// warpgroups computes C [128 x N] = A [128 x K] B [K x N] in passes of 128
// columns; each pass streams K through a ring of 4 shared-memory stages of
// 32 k.  A stage holds
//   B: the pass's 128 columns x 32 k of the weights in TF32 hi and lo, split
//      (each part rounded to nearest) and laid out once per call by
//      tc_pack_kernel in exactly the stage's image (wgmma's K-major core
//      matrices, no swizzle: tf32 wgmma has no transpose), so one
//      cp.async.bulk brings it (32 KB);
//   A: the tile's 128 rows x 32 k in fp32, gathered by cp.async 16-byte
//      copies (x_src, e and activation rows by slot; zero fill past K and on
//      padding), rows padded to 36 floats (conflict-free fragment loads).
// The producer warpgroup (registers lowered to 56 by setmaxnreg) waits each
// stage's empty mbarrier, posts the bulk copy with its byte count, and its
// 128 threads' cp.async land on the stage's full mbarrier (.noinc
// arrivals).  Each consumer warpgroup (registers raised to 224) owns 64
// rows: it splits its A fragments into TF32 hi / lo in registers and runs
// wgmma.m64n128k8.tf32 with A in registers and B in shared memory, per
// stage the cross terms A_hi B_lo and A_lo B_hi first and A_hi B_hi last
// into a fresh fragment, added to the pass's sum in fp32: the tensor cores'
// fp32 accumulation truncates, and one long accumulation over K sat up to
// 33x the forward band from a float64 forward at H = 1024
// (tools/nmp_any_accum_ab.py).  The two warpgroups read each weight stage
// (128 rows per weight byte) and take turns at the tensor cores (named
// barriers), so one's drain and sums run under the other's products.  The
// producer and consumer sides are separate code (tc_sides), so that ptxas
// honours setmaxnreg; barrier 2 joins the block between a layer's
// epilogue and the next layer's loads.
//   Forward: x_dst w0_dst per node first (nmp_node_dst_f32, its own launch
//   and counter: the rows kernel), then per 128-slot tile layer 0 over
//   [x_src | e] (K = 2H) with that node row and b0 added in the epilogue,
//   each hidden layer over the previous one's slab (2 slabs of 128 x H per
//   block in global scratch, L2), LayerNorm and e' a warp per two rows and
//   the aggregate a warp per node, the rows in registers, nodes cut by a
//   tile edge as in the FMA route (fix-up over 128-slot tiles).  L2 to
//   shared bytes per call at GraphCast's layer: weights 6 MB a tile = 8.4
//   GB, rows 3 MB a tile = 4.2 GB (the FMA route streamed 11.8 GB of
//   weights alone).  Where the time goes at H = 512, Lp = 1 (the probe
//   copies of tools/nmp_any_tc_probe.py): the products and their loads
//   about 40%, the rest the epilogues, the LayerNorm pass and the
//   aggregate, which run while the tensor cores wait.
//   Backward, edge pass per tile: the forward recomputed (each ELU(z_l) to
//   a per-slot array A_l, z_Lp to a per-block slab), g_h and the
//   LayerNorm's backward a warp per row (the gradient of z_Lp to the
//   per-slot array G_Lp, the LayerNorm's column sums to the tile's own row
//   of partials), for each hidden layer, last first, G_l = G_{l+1} W_l^T *
//   ELU'(A_l) (W_l as stored is the K-major B), and g_e = g_h + G_0 w0_e^T.
//   Then, with no per-tile read-modify-write: the weight gradients as
//   split-K products over the slots, A_l^T G_{l+1} and [x_src | e]^T G_0
//   (gathered), and x^T G_dst over the nodes (w0_dst's share, from the
//   per-node sums of G_0), each block an output tile of 128 x 64 in
//   registers over a fixed range of slots (3xTF32 mma.sync.m16n8k8 from a
//   cp.async ring: both operands are slot-major, which tf32 wgmma cannot
//   transpose), its bias gradient by fixed-order column sums; the ranges
//   summed in order by nmp_wgrad_reduce_kernel; the per-node sums of G_0
//   over dst and src slots; g_x = [G_dst | G_src] [w0_dst; w0_src]^T by the
//   rows kernel.
// No float atomics: every sum has one writer and a fixed order, so two
// launches are bitwise equal (for a given grid, which the card fixes).
//
// C entry points return cudaGetLastError().  Scratch: the FMA route's
// entries take tile_lo / partials / work (forward) and g_z0 / slot_dst /
// node sums / partials / work (backward) as the wrapper allocates them; the
// tensor-core entries take one fp32 scratch of the size their plan reports
// and carve it: forward tile_lo, partials (tiles x 2 x H), the slabs (grid
// x 2 x 128 x H), the packed weights; backward slot_dst, the packed weights,
// the slabs, the per-slot arrays ((2 Lp + 1) x tiles x 128 x H: A_l, G_l;
// 1.1 GB at GraphCast's layer), the LayerNorm partials (tiles x 2H), the
// node sums (N x 2H) and the weight-gradient partials (splits x rows x H).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper_async.cuh"  // mbarriers, bulk copies, setmaxnreg, wgmma fences, descriptors
#include "nmp_tf32.cuh"      // the TF32 split, 3xTF32 mma.sync warp products

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;         // rows of a block product tile; slots per tile
constexpr int kKC = 32;         // K chunk
constexpr int kSA = kBM + 4;    // A chunk (k-major) row stride: 16-byte aligned
constexpr int kMeta = 5;        // per-slot fields staged per tile

// columns of a product chunk (16 NT) and the B chunk's row stride
__host__ __device__ constexpr int n_chunk(int nt) { return 16 * nt; }
__host__ __device__ constexpr int b_stride(int nt) { return 16 * nt + 4; }

// floats of one block product's staging: A [kKC][kSA] (k-major), B [kKC][b_stride]
__host__ __device__ constexpr int stage_floats(int nt) {
  return kKC * kSA + kKC * b_stride(nt);
}

__host__ __device__ inline long long wgrad_size(long long h, long long lpx) {
  return 3 * h * h + h + lpx * h * h + lpx * h + 2 * h;
}

// ELU as torch computes it (expm1 below 0), to the last bit or two
__device__ __forceinline__ float elu_exact(float z) { return z > 0.f ? z : expm1f(z); }

// ELU'(z) from a = ELU(z): 1 where z > 0 (a > 0), exp(z) = a + 1 elsewhere
__device__ __forceinline__ float elu_grad(float a) { return a > 0.f ? 1.f : a + 1.f; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// C = A B over m < M, n < N, k < K by the block's 256 threads (see the top
// of the file).  Each K chunk is loaded into registers while the one before
// it is summed, then stored to shared memory.  Each thread owns NT rows x 4 columns of a [64 x 16 NT]
// chunk of C (threads t / (4 NT) along rows, t % (4 NT) along columns) and
// sums them by fp32 FMAs in k order: per k it reads its NT rows of the
// k-major A chunk (shared by the warp's lanes) and one float4 of B.  Each
// K chunk's 32 products are summed apart and then added to the total
// (blocked summation: an error growing with 32 + K / 32 terms, not K; at
// K = 3H = 3072 a single chain left some LayerNorm outputs 4x further from
// a float64 forward than cuBLAS's).
// AT / BT: a(m, k) is contiguous along m / b(k, n) along k, which orders
// the staging so that neighbouring threads read neighbouring addresses.
// epi(m, n, v) receives each result once, from a fixed thread.  Starts and
// ends with __syncthreads(): the caller may read what epi wrote and what it
// wrote before the call.
template <int NT, bool AT, bool BT, class FA, class FB, class FE>
__device__ void block_gemm(int M, int N, int K, FA a, FB b, FE epi, float* stage) {
  constexpr int NC = n_chunk(NT), SB = b_stride(NT), CG = NC / 4;
  constexpr int AP = kBM * kKC / kThreads, BP = kKC * NC / kThreads;   // staged per thread
  float* sa = stage;                        // [kKC][kSA]: A chunk, k-major
  float* sb = sa + kKC * kSA;               // [kKC][SB]
  const int tm = threadIdx.x / CG * NT;     // this thread's first row of the tile
  const int tn = threadIdx.x % CG * 4;      // ... and first column of the chunk
  // the next chunk's staged values, loaded into registers while this chunk
  // is summed (zero past M, N and K)
  float ra[AP], rb[BP];
  auto fetch = [&](int m0, int n0, int k0) {
#pragma unroll
    for (int u = 0; u < AP; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = AT ? i % kBM : i / kKC, k = AT ? i / kBM : i % kKC;
      ra[u] = (m0 + r < M && k0 + k < K) ? a(m0 + r, k0 + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BP; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int k = BT ? i % kKC : i / NC, n = BT ? i / kKC : i % NC;
      rb[u] = (k0 + k < K && n0 + n < N) ? b(k0 + k, n0 + n) : 0.f;
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int u = 0; u < AP; ++u) {
      const int i = threadIdx.x + u * kThreads;
      sa[(AT ? i / kBM : i % kKC) * kSA + (AT ? i % kBM : i / kKC)] = ra[u];
    }
#pragma unroll
    for (int u = 0; u < BP; ++u) {
      const int i = threadIdx.x + u * kThreads;
      sb[(BT ? i % kKC : i / NC) * SB + (BT ? i / kKC : i % NC)] = rb[u];
    }
  };
  for (int m0 = 0; m0 < M; m0 += kBM) {
    for (int n0 = 0; n0 < N; n0 += NC) {
      float acc[NT][4] = {};
      fetch(m0, n0, 0);
      for (int k0 = 0; k0 < K; k0 += kKC) {
        __syncthreads();                    // the last chunk's reads are done
        put();
        __syncthreads();
        if (k0 + kKC < K) fetch(m0, n0, k0 + kKC);
        float c[NT][4] = {};                // this chunk's sums, added to acc after it
#pragma unroll 8
        for (int k = 0; k < kKC; ++k) {
          const float4 bv = *reinterpret_cast<const float4*>(sb + k * SB + tn);
          float av[NT];
          if (NT % 4 == 0) {
#pragma unroll
            for (int j = 0; j < NT; j += 4) {
              const float4 u = *reinterpret_cast<const float4*>(sa + k * kSA + tm + j);
              av[j] = u.x;
              av[j + 1 < NT ? j + 1 : j] = u.y;
              av[j + 2 < NT ? j + 2 : j] = u.z;
              av[j + 3 < NT ? j + 3 : j] = u.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < NT; ++j) av[j] = sa[k * kSA + tm + j];
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            c[j][0] = fmaf(av[j], bv.x, c[j][0]);
            c[j][1] = fmaf(av[j], bv.y, c[j][1]);
            c[j][2] = fmaf(av[j], bv.z, c[j][2]);
            c[j][3] = fmaf(av[j], bv.w, c[j][3]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] += c[j][q];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = m0 + tm + j, n = n0 + tn + q;
          if (m < M && n < N) epi(m, n, acc[j][q]);
        }
    }
  }
  __syncthreads();
}

// the per-slot fields of one tile, in shared memory
struct Fields {
  int* eid;    // original edge id, -1 on padding
  int* src;
  int* dst;
  float* m;    // mask, 0 on padding
  float* inv;  // 1 / d, 0 on padding
};

// the fields of a tile of tm slots at p (kMeta x tm words)
__device__ inline Fields fields_at(float* p, int tm) {
  Fields f;
  f.eid = reinterpret_cast<int*>(p);
  f.src = f.eid + tm;
  f.dst = f.src + tm;
  f.m = reinterpret_cast<float*>(f.dst + tm);
  f.inv = f.m + tm;
  return f;
}

// layer 0's input row r of the tile, feature k of [x_src | x_dst | e]
__device__ __forceinline__ float x0_at(const float* __restrict__ x, const float* __restrict__ e,
                                       const Fields& f, int H, int r, int k) {
  const int eid = f.eid[r];
  if (eid < 0) return 0.f;
  if (k < H) return __ldg(x + (size_t)f.src[r] * H + k);
  if (k < 2 * H) return __ldg(x + (size_t)f.dst[r] * H + (k - H));
  return __ldg(e + (size_t)eid * H + (k - 2 * H));
}

// the forward of the tile's rows into the slabs: the last layer's
// pre-activation to `last`; with lp > 0 the activations ELU(z_l) to
// act(l), l < lp (act(l) is the hidden layer l's input)
template <int NT, class FACT>
__device__ void forward_rows(const float* __restrict__ x, const float* __restrict__ e,
                             const Fields& f, const float* __restrict__ w0,
                             const float* __restrict__ b0, const float* __restrict__ wrest,
                             const float* __restrict__ brest, int H, int lp, FACT act,
                             float* last, float* stage) {
  {
    float* out = lp > 0 ? act(0) : last;
    block_gemm<NT, false, false>(
        kBM, H, 3 * H, [&](int r, int k) { return x0_at(x, e, f, H, r, k); },
        [&](int k, int n) { return __ldg(w0 + (size_t)k * H + n); },
        [&](int r, int n, float v) {
          v += __ldg(b0 + n);
          out[r * H + n] = lp > 0 ? elu_exact(v) : v;
        },
        stage);
  }
  for (int l = 0; l < lp; ++l) {
    const float* in = act(l);
    float* out = l + 1 < lp ? act(l + 1) : last;
    const bool hidden = l + 1 < lp;
    const float* w = wrest + (size_t)l * H * H;
    const float* bias = brest + (size_t)l * H;
    block_gemm<NT, false, false>(
        kBM, H, H, [&](int r, int k) { return in[r * H + k]; },
        [&](int k, int n) { return __ldg(w + (size_t)k * H + n); },
        [&](int r, int n, float v) {
          v += __ldg(bias + n);
          out[r * H + n] = hidden ? elu_exact(v) : v;
        },
        stage);
  }
}

// stage the per-slot fields of the tile of tm slots [base, end); the
// destinations from the nodes' runs (or from slot_dst when given).  Run by
// nthreads threads (numbered from 0) that sync() joins; ends with sync().
template <class FS>
__device__ void stage_fields(const Fields& f, const int* __restrict__ perm,
                             const int* __restrict__ src, const int* __restrict__ rowptr,
                             const int* __restrict__ slot_dst, const float* __restrict__ emask,
                             const float* __restrict__ einv, int base, int end, int n0, int hi,
                             int tm, int nthreads, FS sync) {
  if ((int)threadIdx.x < tm) {
    const int slot = base + threadIdx.x;
    int eid = -1, s = 0, d = 0;
    float m = 0.f, iv = 0.f;
    if (slot < end) {
      eid = perm[slot];
      s = src[slot];
      if (slot_dst != nullptr) d = slot_dst[slot];
      m = emask[eid];
      iv = einv[eid];
    }
    f.eid[threadIdx.x] = eid;
    f.src[threadIdx.x] = s;
    f.dst[threadIdx.x] = d;
    f.m[threadIdx.x] = m;
    f.inv[threadIdx.x] = iv;
  }
  sync();
  if (slot_dst == nullptr) {
    // the nodes n0 .. hi - 1 hold every slot of [base, end)
    for (int n = n0 + threadIdx.x; n < hi; n += nthreads) {
      const int rs = max(rowptr[n], base), re = min(rowptr[n + 1], end);
      for (int s = rs; s < re; ++s) f.dst[s - base] = n;
    }
    sync();
  }
}

// LayerNorm and e' = (e + h) * e's mask of one row, from a lane's features
// of it (v) and of e (ev) in registers, c = lane + 32 i < H; e' to zr and to
// the edge's original position.  Sums in the order of c.
template <int C>
__device__ __forceinline__ void ln_out_cached(const float (&v)[C], const float (&ev)[C],
                                              float* zr, int eid, float m,
                                              const float* __restrict__ lng,
                                              const float* __restrict__ lnb,
                                              float* __restrict__ e_new, int H, int has_ln) {
  const int lane = threadIdx.x & 31;
  const float inv_h = 1.f / H;
  float mu = 0.f, rstd = 1.f;
  if (has_ln) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (lane + 32 * i < H) s += v[i];
    mu = warp_sum(s) * inv_h;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (lane + 32 * i < H) {
        const float d = v[i] - mu;
        q += d * d;
      }
    }
    rstd = rsqrtf(warp_sum(q) * inv_h + 1e-5f);
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = lane + 32 * i;
    if (c < H) {
      const float h = has_ln ? (v[i] - mu) * rstd * __ldg(lng + c) + __ldg(lnb + c) : v[i];
      const float out = (ev[i] + h) * m;
      zr[c] = out;
      if (eid >= 0) e_new[(size_t)eid * H + c] = out;
    }
  }
}

// LayerNorm and e' = (e + h) * mask over the tile's tm rows of z (row
// stride H), in place, a warp per row (warps `warp` of n_warps); e' also to
// its edge's original position.  With C > 0 and H <= 32 C a lane holds its
// features of two rows and of their e in registers, all read together (the
// rows' memory latencies overlap); the sums run in the same order either
// way.
template <int C>
__device__ void ln_out_rows(float* z, const Fields& f, const float* __restrict__ e,
                            const float* __restrict__ lng, const float* __restrict__ lnb,
                            float* __restrict__ e_new, int H, int has_ln, int tm, int warp,
                            int n_warps) {
  const int lane = threadIdx.x & 31;
  if constexpr (C > 0) {
    if (H <= 32 * C) {
      for (int r = warp; r < tm; r += 2 * n_warps) {
        const int rr[2] = {r, r + n_warps};
        float v[2][C > 0 ? C : 1], ev[2][C > 0 ? C : 1];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int eid = rr[q] < tm ? f.eid[rr[q]] : -1;
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const int c = lane + 32 * i;
            v[q][i] = c < H && rr[q] < tm ? z[(size_t)rr[q] * H + c] : 0.f;
            ev[q][i] = c < H && eid >= 0 ? __ldg(e + (size_t)eid * H + c) : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (rr[q] < tm)
            ln_out_cached<C>(v[q], ev[q], z + (size_t)rr[q] * H, f.eid[rr[q]], f.m[rr[q]], lng,
                             lnb, e_new, H, has_ln);
      }
      return;
    }
  }
  const float inv_h = 1.f / H;
  for (int r = warp; r < tm; r += n_warps) {
    float* zr = z + (size_t)r * H;
    const int eid = f.eid[r];
    const float m = f.m[r];
    float mu = 0.f, rstd = 1.f;
    if (has_ln) {
      float s = 0.f;
      for (int c = lane; c < H; c += 32) s += zr[c];
      mu = warp_sum(s) * inv_h;
      float v = 0.f;
      for (int c = lane; c < H; c += 32) {
        const float d = zr[c] - mu;
        v += d * d;
      }
      rstd = rsqrtf(warp_sum(v) * inv_h + 1e-5f);
    }
    for (int c = lane; c < H; c += 32) {
      const float h = has_ln ? (zr[c] - mu) * rstd * __ldg(lng + c) + __ldg(lnb + c) : zr[c];
      const float ev = eid >= 0 ? __ldg(e + (size_t)eid * H + c) : 0.f;
      const float out = (ev + h) * m;
      zr[c] = out;
      if (eid >= 0) e_new[(size_t)eid * H + c] = out;
    }
  }
}

// agg: per node n0 .. hi - 1, e' (rows of z) * (1/d) summed in slot order,
// a warp per node; a node cut by a tile edge goes to the tile's partial
// rows (0: running in from the tile before, 1: running past this one's
// end).  With C > 0 and H <= 32 C a lane sums its features of the node in
// registers, a slot's row at a time (the same order per feature).
template <int C>
__device__ void agg_nodes(const float* z, const Fields& f, const int* __restrict__ rowptr,
                          float* __restrict__ agg, float* __restrict__ partials, int tile,
                          int base, int end, int n0, int hi, int H, int warp, int n_warps) {
  const int lane = threadIdx.x & 31;
  for (int n = n0 + warp; n < hi; n += n_warps) {
    const int rs0 = rowptr[n], re0 = rowptr[n + 1];
    if (rs0 < base && re0 <= base) continue;   // ended before this tile
    const int rs = max(rs0, base), re = min(re0, end);
    float* out = rs0 < base  ? partials + (size_t)tile * 2 * H
                 : re0 > end ? partials + ((size_t)tile * 2 + 1) * H
                             : agg + (size_t)n * H;
    if constexpr (C > 0) {
      if (H <= 32 * C) {
        float acc[C > 0 ? C : 1];
#pragma unroll
        for (int i = 0; i < C; ++i) acc[i] = 0.f;
        for (int s = rs; s < re; ++s) {
          const float* zs = z + (size_t)(s - base) * H;
          const float w = f.inv[s - base];
#pragma unroll
          for (int i = 0; i < C; ++i)
            if (lane + 32 * i < H) acc[i] = fmaf(zs[lane + 32 * i], w, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (lane + 32 * i < H) out[lane + 32 * i] = acc[i];
        continue;
      }
    }
    for (int c = lane; c < H; c += 32) {
      float acc = 0.f;
      for (int s = rs; s < re; ++s) acc = fmaf(z[(size_t)(s - base) * H + c], f.inv[s - base], acc);
      out[c] = acc;
    }
  }
}

// g_h = (g_e' + g_agg[dst] / d) * mask and the LayerNorm's backward, a warp
// per row r < tm: Z (the last pre-activation) <- g_h, XH <- x-hat (LN
// only), G <- the gradient of z_Lp (all row stride H).  With C > 0 and H <=
// 32 C a lane holds its features of the row, of g_e' and of g_agg in
// registers, read once and together; the sums run in the same order either
// way.
template <int C>
__device__ void ln_bwd_rows(float* Z, float* XH, float* G, const Fields& f,
                            const float* __restrict__ genew, const float* __restrict__ gagg,
                            const float* __restrict__ lng, int H, int has_ln, int tm, int warp,
                            int n_warps) {
  const int lane = threadIdx.x & 31;
  const float inv_h = 1.f / H;
  for (int r = warp; r < tm; r += n_warps) {
    float* zr = Z + (size_t)r * H;
    float* xr = XH + (size_t)r * H;
    float* gr = G + (size_t)r * H;
    const int eid = f.eid[r], d = f.dst[r];
    const float m = f.m[r], iv = f.inv[r];
    auto gh_at = [&](int c) {
      return eid >= 0 ? fmaf(__ldg(gagg + (size_t)d * H + c), iv,
                             __ldg(genew + (size_t)eid * H + c)) * m
                      : 0.f;
    };
    if constexpr (C > 0) {
      if (H <= 32 * C) {
        float v[C > 0 ? C : 1], gh[C > 0 ? C : 1];
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int c = lane + 32 * i;
          v[i] = c < H && has_ln ? zr[c] : 0.f;
          gh[i] = c < H ? gh_at(c) : 0.f;
        }
        if (!has_ln) {
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const int c = lane + 32 * i;
            if (c < H) zr[c] = gr[c] = gh[i];
          }
          continue;
        }
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (lane + 32 * i < H) s += v[i];
        const float mu = warp_sum(s) * inv_h;
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (lane + 32 * i < H) {
            const float dd = v[i] - mu;
            q += dd * dd;
          }
        }
        const float rstd = rsqrtf(warp_sum(q) * inv_h + 1e-5f);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int c = lane + 32 * i;
          if (c < H) {
            v[i] = (v[i] - mu) * rstd;       // x-hat
            const float gx = gh[i] * __ldg(lng + c);
            s1 += gx;
            s2 += gx * v[i];
            xr[c] = v[i];
            zr[c] = gh[i];
          }
        }
        const float m1 = warp_sum(s1) * inv_h, m2 = warp_sum(s2) * inv_h;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int c = lane + 32 * i;
          if (c < H) gr[c] = rstd * (gh[i] * __ldg(lng + c) - m1 - v[i] * m2);
        }
        continue;
      }
    }
    if (!has_ln) {
      for (int c = lane; c < H; c += 32) zr[c] = gr[c] = gh_at(c);
      continue;
    }
    float s = 0.f;
    for (int c = lane; c < H; c += 32) s += zr[c];
    const float mu = warp_sum(s) * inv_h;
    float v = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float dd = zr[c] - mu;
      v += dd * dd;
    }
    const float rstd = rsqrtf(warp_sum(v) * inv_h + 1e-5f);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float xh = (zr[c] - mu) * rstd, gh = gh_at(c);
      const float gx = gh * __ldg(lng + c);
      s1 += gx;
      s2 += gx * xh;
      xr[c] = xh;
      zr[c] = gh;
    }
    const float m1 = warp_sum(s1) * inv_h, m2 = warp_sum(s2) * inv_h;
    for (int c = lane; c < H; c += 32)
      gr[c] = rstd * (zr[c] * __ldg(lng + c) - m1 - xr[c] * m2);
  }
}

// (a) tile_lo[b] = the least n with rowptr[n] >= b * tm, b < n_tiles;
// tile_lo[n_tiles] = n_nodes; one writer per tile (csrc/nmp_fwd.cu (a))
__global__ void any_tile_lo_kernel(const int* __restrict__ rowptr, int* __restrict__ tile_lo,
                                   int n_nodes, int tm) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n > n_nodes) return;
  const int n_real = rowptr[n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + tm - 1) / tm : 1;
  const int b_lo = n == 0 ? 0 : rowptr[n - 1] / tm + 1;
  const int b_hi = min(rowptr[n] / tm, n_tiles - 1);
  for (int b = b_lo; b <= b_hi; ++b) tile_lo[b] = n;
  if (n == n_nodes) tile_lo[n_tiles] = n_nodes;
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
nmp_any_fwd_kernel(const float* __restrict__ x, const float* __restrict__ e,
                   const int* __restrict__ perm, const int* __restrict__ src,
                   const int* __restrict__ rowptr, const int* __restrict__ tile_lo,
                   const float* __restrict__ emask, const float* __restrict__ einv,
                   const float* __restrict__ w0, const float* __restrict__ b0,
                   const float* __restrict__ wrest, const float* __restrict__ brest,
                   const float* __restrict__ lng, const float* __restrict__ lnb,
                   float* __restrict__ e_new, float* __restrict__ agg,
                   float* __restrict__ partials, float* __restrict__ work, int n_nodes, int H,
                   int lp, int has_ln, int work_smem) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  const Fields f = fields_at(stage + stage_floats(NT), kBM);
  float* slab = work_smem ? stage + stage_floats(NT) + kMeta * kBM
                          : work + (size_t)blockIdx.x * 2 * kBM * H;
  float* s0 = slab;
  float* s1 = slab + (size_t)kBM * H;
  const int warp = threadIdx.x >> 5;
  const int n_real = rowptr[n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + kBM - 1) / kBM : 1;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kBM, end = min(base + kBM, n_real);
    const int lo = tile_lo[tile], hi = tile_lo[tile + 1];
    const int n0 = max(lo - 1, 0);          // the node walk's first node
    stage_fields(f, perm, src, rowptr, nullptr, emask, einv, base, end, n0, hi, kBM, kThreads,
                 [] { __syncthreads(); });
    // activations alternate between the slabs; the last layer's output
    // lands in `z`
    float* z = lp % 2 == 0 ? s0 : s1;
    forward_rows<NT>(x, e, f, w0, b0, wrest, brest, H, lp,
                     [&](int l) { return l % 2 == 0 ? s0 : s1; }, z, stage);
    ln_out_rows<0>(z, f, e, lng, lnb, e_new, H, has_ln, kBM, warp, kWarps);
    __syncthreads();
    agg_nodes<0>(z, f, rowptr, agg, partials, tile, base, end, n0, hi, H, warp, kWarps);
    __syncthreads();
  }
}

// (c) agg[n] for the node cut at the end of tile u where it starts: partial
// 1 of u, then partial 0 of u + 1 .. its last tile, in tile order
__global__ void any_fixup_kernel(const int* __restrict__ rowptr, const int* __restrict__ tile_lo,
                                 const float* __restrict__ partials, float* __restrict__ agg,
                                 int n_nodes, int H, int tm) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int u = (int)(i / H), j = (int)(i % H);
  const int n_real = rowptr[n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + tm - 1) / tm : 1;
  if (u >= n_tiles - 1) return;             // the last tile cuts no node
  const int base = u * tm, end = base + tm;
  const int n = tile_lo[u + 1] - 1;         // the last node starting before `end`
  if (n < 0) return;
  const int rs0 = rowptr[n], re0 = rowptr[n + 1];
  if (rs0 < base || re0 <= end) return;     // not started here, or not cut
  float acc = partials[((size_t)u * 2 + 1) * H + j];
  const int last = (re0 - 1) / tm;
  for (int v = u + 1; v <= last; ++v) acc += partials[((size_t)v * 2) * H + j];
  agg[(size_t)n * H + j] = acc;
}

// slot_dst[s] = n for n's dst-sorted slots rowptr[n] .. rowptr[n + 1]
__global__ void any_slot_dst_kernel(const int* __restrict__ rowptr, int* __restrict__ slot_dst,
                                    int n_nodes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  for (int s = rowptr[n]; s < rowptr[n + 1]; ++s) slot_dst[s] = n;
}

// sum of v(r) over rows r < rows in a fixed order: runs of 8, then the
// runs' sums (blocked, as block_gemm sums its K chunks)
template <class F>
__device__ __forceinline__ float tile_sum(F v, int rows = kBM) {
  float s = 0.f;
  for (int r0 = 0; r0 < rows; r0 += 8) {
    float p = 0.f;
#pragma unroll
    for (int r = r0; r < r0 + 8; ++r) p += v(r);
    s += p;
  }
  return s;
}

// column sums of a [kBM][H] slab, added to out[0 .. H)
__device__ __forceinline__ void add_col_sums(const float* g, int H, float* out) {
  for (int c = threadIdx.x; c < H; c += kThreads)
    out[c] += tile_sum([&](int r) { return g[(size_t)r * H + c]; });
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
nmp_any_bwd_kernel(const float* __restrict__ x, const float* __restrict__ e,
                   const int* __restrict__ perm, const int* __restrict__ src,
                   const int* __restrict__ slot_dst, const int* __restrict__ rowptr,
                   int n_nodes, const float* __restrict__ emask,
                   const float* __restrict__ einv, const float* __restrict__ w0,
                   const float* __restrict__ b0, const float* __restrict__ wrest,
                   const float* __restrict__ brest, const float* __restrict__ lng,
                   const float* __restrict__ lnb, const float* __restrict__ genew,
                   const float* __restrict__ gagg, float* __restrict__ ge,
                   float* __restrict__ gz0, float* __restrict__ partials,
                   float* __restrict__ work, int H, int lp, int has_ln, int work_smem) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  const Fields f = fields_at(stage + stage_floats(NT), kBM);
  const size_t sl = (size_t)kBM * H;        // floats of one slab
  float* slab = work_smem ? stage + stage_floats(NT) + kMeta * kBM
                          : work + (size_t)blockIdx.x * (lp + 3) * sl;
  float* A = slab;                          // [lp][kBM][H]: hidden layer l's input ELU(z_l)
  float* Z = A + lp * sl;                   // the last pre-activation, then g_h
  float* G0 = Z + sl;                       // gradient slabs (G1: also x-hat)
  float* G1 = G0 + sl;
  const int lpx = lp > 0 ? lp : 1;
  float* P = partials + (size_t)blockIdx.x * wgrad_size(H, lpx);
  float* P_w0 = P;
  float* P_b0 = P_w0 + (size_t)3 * H * H;
  float* P_wr = P_b0 + H;
  float* P_br = P_wr + (size_t)lpx * H * H;
  float* P_lg = P_br + (size_t)lpx * H;
  float* P_lb = P_lg + H;
  const int warp = threadIdx.x >> 5;
  const int n_real = rowptr[n_nodes];
  const int n_tiles = (n_real + kBM - 1) / kBM;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kBM, end = min(base + kBM, n_real);
    stage_fields(f, perm, src, rowptr, slot_dst, emask, einv, base, end, 0, 0, kBM, kThreads,
                 [] { __syncthreads(); });
    forward_rows<NT>(x, e, f, w0, b0, wrest, brest, H, lp,
                     [&](int l) { return A + l * sl; }, Z, stage);
    // Z <- g_h, G1 <- x-hat, G0 <- the gradient of z_Lp
    ln_bwd_rows<0>(Z, G1, G0, f, genew, gagg, lng, H, has_ln, kBM, warp, kWarps);
    __syncthreads();
    if (has_ln) {                           // LayerNorm gradients: column sums in row order
      for (int c = threadIdx.x; c < H; c += kThreads) {
        P_lg[c] += tile_sum([&](int r) { return Z[(size_t)r * H + c] * G1[(size_t)r * H + c]; });
        P_lb[c] += tile_sum([&](int r) { return Z[(size_t)r * H + c]; });
      }
      __syncthreads();
    }
    // hidden layers, last first
    float* gc = G0;
    float* gn = G1;
    for (int l = lp - 1; l >= 0; --l) {
      const float* al = A + l * sl;
      const float* wl = wrest + (size_t)l * H * H;
      float* pw = P_wr + (size_t)l * H * H;
      block_gemm<NT, true, false>(
          H, H, kBM, [&](int m, int k) { return al[(size_t)k * H + m]; },
          [&](int k, int n) { return gc[(size_t)k * H + n]; },
          [&](int m, int n, float v) { pw[(size_t)m * H + n] += v; }, stage);
      add_col_sums(gc, H, P_br + (size_t)l * H);
      block_gemm<NT, false, true>(
          kBM, H, H, [&](int r, int k) { return gc[(size_t)r * H + k]; },
          [&](int k, int n) { return __ldg(wl + (size_t)n * H + k); },
          [&](int r, int n, float v) { gn[(size_t)r * H + n] = v * elu_grad(al[(size_t)r * H + n]); },
          stage);
      float* tmp = gc;
      gc = gn;
      gn = tmp;
    }
    // layer 0: w0 and b0 gradients, g_e = g_h + G0 w0_e^T, G0 per slot
    block_gemm<NT, true, false>(
        3 * H, H, kBM, [&](int m, int k) { return x0_at(x, e, f, H, k, m); },
        [&](int k, int n) { return gc[(size_t)k * H + n]; },
        [&](int m, int n, float v) { P_w0[(size_t)m * H + n] += v; }, stage);
    add_col_sums(gc, H, P_b0);
    block_gemm<NT, false, true>(
        kBM, H, H, [&](int r, int k) { return gc[(size_t)r * H + k]; },
        [&](int k, int n) { return __ldg(w0 + (size_t)(2 * H + n) * H + k); },
        [&](int r, int n, float v) {
          const int eid = f.eid[r];
          if (eid >= 0) ge[(size_t)eid * H + n] = v + Z[(size_t)r * H + n];
        },
        stage);
    for (int i = threadIdx.x; i < kBM * H; i += kThreads) {
      const int r = i / H;
      if (base + r < end) gz0[(size_t)(base + r) * H + (i - r * H)] = gc[i];
    }
    __syncthreads();
  }
}

// (c) out[i] = sum over the blocks' partial rows in block order, in runs
// of 16 rows whose sums are then added (blocked)
__global__ void any_reduce_partials_kernel(const float* __restrict__ partials,
                                           float* __restrict__ out, int n_rows,
                                           long long wsize) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wsize) return;
  float s = 0.f;
  for (int g0 = 0; g0 < n_rows; g0 += 16) {
    float p = 0.f;
    for (int g = g0; g < min(g0 + 16, n_rows); ++g) p += partials[(size_t)g * wsize + i];
    s += p;
  }
  out[i] = s;
}

// (d1) gs[n] = [sum of g_z0 over n's dst slots (rowptr order) | over its
// src slots (src_slots order)]
__global__ void any_node_sums_kernel(const float* __restrict__ gz0, const int* __restrict__ rowptr,
                                     const int* __restrict__ src_slots,
                                     const int* __restrict__ src_rowptr, float* __restrict__ gs,
                                     int n_nodes, int H) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int n = (int)(i / H), j = (int)(i % H);
  if (n >= n_nodes) return;
  float gd = 0.f, gsr = 0.f;
  for (int s = rowptr[n]; s < rowptr[n + 1]; ++s) gd += gz0[(size_t)s * H + j];
  for (int p = src_rowptr[n]; p < src_rowptr[n + 1]; ++p)
    gsr += gz0[(size_t)src_slots[p] * H + j];
  gs[(size_t)n * 2 * H + j] = gd;
  gs[(size_t)n * 2 * H + H + j] = gsr;
}

// (d2) g_x[n] = gs[n] [w0_dst; w0_src]^T, 64 nodes a block
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
any_node_kernel(const float* __restrict__ gs, const float* __restrict__ w0,
                float* __restrict__ gx, int n_nodes, int H) {
  extern __shared__ __align__(16) float smem[];
  const int nb = blockIdx.x * kBM;
  block_gemm<NT, false, true>(
      min(kBM, n_nodes - nb), H, 2 * H,
      [&](int r, int k) { return gs[(size_t)(nb + r) * 2 * H + k]; },
      [&](int k, int n) {
        return k < H ? __ldg(w0 + (size_t)(H + n) * H + k) : __ldg(w0 + (size_t)n * H + (k - H));
      },
      [&](int r, int n, float v) { gx[(size_t)(nb + r) * H + n] = v; }, smem);
}

// ---------------------------------------------------------------------------
// The tensor-core route: 3xTF32 wgmma fed by a ring of bulk-copy (weights)
// and cp.async (rows) stages; see the top of the file
// ---------------------------------------------------------------------------

constexpr int kTM = 128;                  // rows (slots) of a tile: 2 consumer warpgroups x 64
constexpr int kNC = 128;                  // columns of a product pass (wgmma N)
constexpr int kKS = 32;                   // K of a ring stage
constexpr int kKSteps = kKS / 8;          // its k-steps of 8 (wgmma's K in tf32)
constexpr int kChunks = kKS / 4;          // its 16-byte chunks of a row
constexpr int kRing = 4;                  // ring stages
constexpr int kTCThreads = 384;           // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kTCWarps = 8;               // consumer warps
constexpr int kSAS = kKS + 4;             // A stage row stride (floats): 16-byte rows
constexpr int kBPart = kNC * kKS;         // floats of a stage's hi (or lo) weights
constexpr uint32_t kStageB = 2 * kBPart * 4;   // bytes: hi then lo
constexpr uint32_t kStageA = kTM * kSAS * 4;   // bytes
constexpr int kTCSmem = kRing * (kStageB + kStageA) + kMeta * kTM * 4 + 16 * kRing + 1024;

// floats of a product's packed weights: per pass of kNC columns, per stage
// of kKS k, hi then lo (kBPart each)
__host__ __device__ inline long long packed_floats(int K, int N) {
  return (long long)((N + kNC - 1) / kNC) * ((K + kKS - 1) / kKS) * 2 * kBPart;
}

// B(k, n) of a product, k < K, n < N, from two K segments of the weights:
// k < k0: p0[k * sk0 + n * sn0], else p1[(k - k0) * sk1 + n * sn1]
struct BSrc {
  const float* p0;
  long long sk0, sn0;
  int k0;
  const float* p1;
  long long sk1, sn1;
  int K, N;
};

// x = hi + lo + r: hi and lo each x's part rounded to TF32 (to nearest,
// ties away from zero), |r| <= 2^-23 |x|.  csrc/nmp_tf32.cuh's split leaves
// lo for the tensor cores to truncate, an error of up to 2^-21 |x| whose
// sums the deep sweep cases carried past the forward band.
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// The weights of one product in the ring's stage image: within a stage's
// hi (and lo) part, (n, k) at ks * 1024 + half * 512 + (n / 8) * 32 + (n %
// 8) * 4 + k % 4 for k-step ks = k / 8, half = k % 8 / 4: wgmma's K-major
// core matrices (8 rows of n x 16 bytes of k), the two K halves of a k-step
// 2048 bytes apart (leading byte offset), 8-row groups 128 bytes apart
// (stride byte offset).  Zero past K and N.
__global__ void tc_pack_kernel(const BSrc b, float* __restrict__ out) {
  const int kst_n = (b.K + kKS - 1) / kKS;
  const long long total = packed_floats(b.K, b.N) / 2;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long st = i / kBPart;
    const int w = (int)(i % kBPart);
    const int nc = (int)(st / kst_n), kst = (int)(st % kst_n);
    const int ks = w >> 10, half = (w >> 9) & 1, ng = (w >> 5) & 15, nr = (w >> 2) & 7, kq = w & 3;
    const int n = nc * kNC + ng * 8 + nr, k = kst * kKS + ks * 8 + half * 4 + kq;
    float v = 0.f;
    if (n < b.N && k < b.K)
      v = k < b.k0 ? b.p0[k * b.sk0 + n * b.sn0] : b.p1[(k - b.k0) * b.sk1 + n * b.sn1];
    uint32_t hi, lo;
    split_rn(v, hi, lo);
    float* dst = out + st * 2 * kBPart + w;
    dst[0] = __uint_as_float(hi);
    dst[kBPart] = __uint_as_float(lo);
  }
}

// d[0:64] += A (64x8 tf32, registers) * B (8x128 tf32, K-major, shared)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the ring in shared memory and the stages this thread has produced or
// consumed (both sides walk the same sequence of stages)
struct Ring {
  uint32_t b, a, full, empty;   // shared addresses: B stages, A stages, mbarriers
  const float* as;              // the A stages (generic address)
  uint32_t it;
};

// The block's shared memory (1024-byte aligned): the B stages, the A
// stages, the tile's fields, the mbarriers; initialises the barriers (ends
// with __syncthreads()).
__device__ Ring tc_setup(unsigned char* smem_raw, Fields* f) {
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  Ring rg;
  rg.b = smem_u32(base);
  rg.a = rg.b + kRing * kStageB;
  rg.as = reinterpret_cast<const float*>(base + kRing * kStageB);
  float* meta = reinterpret_cast<float*>(base + kRing * (kStageB + kStageA));
  *f = fields_at(meta, kTM);
  rg.full = smem_u32(meta + kMeta * kTM);
  rg.empty = rg.full + 8 * kRing;
  rg.it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(rg.full + 8 * s, 129);       // the bulk copy's arrival + 128 threads' cp.async
      mbar_init(rg.empty + 8 * s, kTCWarps);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return rg;
}

// Producer side of C [kTM x N] = A [kTM x K] B (the producer warpgroup):
// per pass of kNC columns, per stage of kKS k, the packed weights by one
// bulk copy and the rows by cp.async, warp w the rows 32 w .. 32 w + 31;
// asrc(r, k) is the address of A's 4 floats at (r, k) or nullptr for zeros
// (called for k < K only).
template <class FA>
__device__ void tc_produce(Ring& rg, const float* __restrict__ wpack, int K, int N, FA asrc) {
  const int lane = threadIdx.x & 31, pw = (threadIdx.x >> 5) & 3;
  const int c = lane % kChunks;             // this lane's 16-byte chunk of a row's kKS k
  const int kst_n = (K + kKS - 1) / kKS, nc_n = (N + kNC - 1) / kNC;
  for (int nc = 0; nc < nc_n; ++nc) {
    for (int kst = 0; kst < kst_n; ++kst, ++rg.it) {
      const int s = rg.it % kRing;
      mbar_wait(rg.empty + 8 * s, ((rg.it / kRing) & 1) ^ 1);
      const uint32_t full = rg.full + 8 * s;
      if (pw == 0 && lane == 0) {
        mbar_expect_tx(full, kStageB);
        bulk_load(rg.b + s * kStageB, wpack + ((size_t)nc * kst_n + kst) * 2 * kBPart, kStageB,
                  full);
      }
      const uint32_t a0 = rg.a + s * kStageA;
      const int k = kst * kKS + 4 * c;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {   // 32 rows a warp, 32 / kChunks a step
        const int r = 32 * pw + (32 / kChunks) * j + lane / kChunks;
        const float* p = k < K ? asrc(r, k) : nullptr;
        cp_async16_zfill(a0 + (r * kSAS + 4 * c) * 4, p != nullptr ? p : wpack, p != nullptr ? 16 : 0);
      }
      cp_async_mbar_arrive(full);
    }
  }
}

// Consumer side (one warpgroup, rows 64 wg .. 64 wg + 63 of the tile):
// epi(r, c, v0, v1) receives C's columns c, c + 1 of row r (c even, c < N)
// once, from a fixed thread, after the pass's last stage.
template <class FE>
__device__ void tc_consume(Ring& rg, int K, int N, FE epi) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * w + g;      // rows r0 and r0 + 8 of the fragments
  const int kst_n = (K + kKS - 1) / kKS, nc_n = (N + kNC - 1) / kNC;
  for (int nc = 0; nc < nc_n; ++nc) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kst = 0; kst < kst_n; ++kst, ++rg.it) {
      const int s = rg.it % kRing;
      mbar_wait(rg.full + 8 * s, (rg.it / kRing) & 1);
      __syncwarp();                         // wgmma is .aligned: the warp converges after the spin
      const float* sa = rg.as + (size_t)s * kTM * kSAS;
      uint32_t ah[kKSteps][4], al[kKSteps][4];
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int k = 8 * kk + t;
        split_rn(sa[r0 * kSAS + k], ah[kk][0], al[kk][0]);
        split_rn(sa[(r0 + 8) * kSAS + k], ah[kk][1], al[kk][1]);
        split_rn(sa[r0 * kSAS + k + 4], ah[kk][2], al[kk][2]);
        split_rn(sa[(r0 + 8) * kSAS + k + 4], ah[kk][3], al[kk][3]);
      }
      float part[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) part[i] = 0.f;
      fence_regs(part);
      fence_regs(ah);
      fence_regs(al);
      // turns: warpgroup 1 issues after warpgroup 0's products of this
      // stage, 0 after 1's of the stage before, so one's drain and sums run
      // under the other's products
      if (wg == 0) {
        if (rg.it > 0) asm volatile("bar.sync 4, 256;\n" ::: "memory");
      } else {
        asm volatile("bar.sync 3, 256;\n" ::: "memory");
      }
      wgmma_fence();
      const uint32_t bh = rg.b + s * kStageB, bl = bh + kBPart * 4;
      // the cross terms first, while the sum is small, then hi * hi: each
      // product truncates the sum (the tensor cores' fp32 accumulation does
      // not round to nearest), so only the last four do so at its full size
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        wgmma_tf32(part, ah[kk], make_desc(bl + kk * 4096, 2048, 128, 0));
        wgmma_tf32(part, al[kk], make_desc(bh + kk * 4096, 2048, 128, 0));
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) wgmma_tf32(part, ah[kk], make_desc(bh + kk * 4096, 2048, 128, 0));
      wgmma_commit();
      if (wg == 0)
        asm volatile("bar.arrive 3, 256;\n" ::: "memory");
      else
        asm volatile("bar.arrive 4, 256;\n" ::: "memory");
      wgmma_wait_all();
      fence_regs(part);
      fence_regs(ah);
      fence_regs(al);
      __syncwarp();
      if (lane == 0) mbar_arrive(rg.empty + 8 * s);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = nc * kNC + 8 * j + 2 * t;
      if (c < N) {
        epi(r0, c, acc[4 * j], acc[4 * j + 1]);
        epi(r0 + 8, c, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// C = A B for the block, from one side: the producer warpgroup produces,
// the consumer warpgroups consume
template <bool PRODUCER, class FA, class FE>
__device__ __forceinline__ void tc_product(Ring& rg, const float* wpack, int K, int N, FA asrc,
                                           FE epi) {
  if constexpr (PRODUCER)
    tc_produce(rg, wpack, K, N, asrc);
  else
    tc_consume(rg, K, N, epi);
}

// named barriers: 1 the consumers, 2 the block, 3 and 4 the consumer
// warpgroups' turns at the tensor cores
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 2, 384;\n" ::: "memory");
}

// the end of the consumers' turns: warpgroup 0 takes warpgroup 1's last
// hand-over
__device__ __forceinline__ void turns_end(const Ring& rg) {
  if (threadIdx.x < 128 && rg.it > 0) asm volatile("bar.sync 4, 256;\n" ::: "memory");
}

// The kernel's two sides, each in its own code with its own registers: the
// producer warpgroup gives up what the consumers' fragments take (the block
// is launched at 168 a thread).  body<PRODUCER>(rg, f) walks the tiles.
template <class FB>
__device__ __forceinline__ void tc_sides(Ring& rg, const Fields& f, FB body) {
  if (threadIdx.x >= 256) {
    setmaxnreg_dec<56>();
    body(std::true_type{}, rg, f);
  } else {
    setmaxnreg_inc<224>();
    body(std::false_type{}, rg, f);
    turns_end(rg);
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Forward (tc) operands
struct TcFwd {
  const float *x, *e, *emask, *einv, *b0, *brest, *lng, *lnb, *pdst, *wpack;
  const int *perm, *src, *rowptr, *tile_lo;
  float *e_new, *agg, *partials, *work;
  int n_nodes, H, lp, has_ln;
};

// layer 0's A over [x_src | e] (K = 2H): the slot's rows, zeros on padding
__device__ __forceinline__ const float* x0_row(const float* x, const float* e, const Fields& f,
                                               int H, int r, int k) {
  const int eid = f.eid[r];
  if (eid < 0) return nullptr;
  return k < H ? x + (size_t)f.src[r] * H + k : e + (size_t)eid * H + (k - H);
}

// layer 0's epilogue: + x_dst w0_dst of the slot's node + b0, ELU when a
// hidden layer follows
__device__ __forceinline__ void x0_out(float* out, const float* pdst, const float* b0,
                                       const Fields& f, int H, bool elu, int r, int c, float v0,
                                       float v1) {
  const float2 d = __ldg(reinterpret_cast<const float2*>(pdst + (size_t)f.dst[r] * H + c));
  v0 = v0 + d.x + __ldg(b0 + c);
  v1 = v1 + d.y + __ldg(b0 + c + 1);
  if (elu) {
    v0 = elu_exact(v0);
    v1 = elu_exact(v1);
  }
  store2(out + (size_t)r * H + c, v0, v1);
}

// a hidden layer's epilogue: + bias, ELU when another hidden layer follows
__device__ __forceinline__ void hidden_out(float* out, const float* bias, int H, bool elu, int r,
                                           int c, float v0, float v1) {
  v0 += __ldg(bias + c);
  v1 += __ldg(bias + c + 1);
  if (elu) {
    v0 = elu_exact(v0);
    v1 = elu_exact(v1);
  }
  store2(out + (size_t)r * H + c, v0, v1);
}

__global__ void __launch_bounds__(kTCThreads, 1) nmp_tc_fwd_kernel(const TcFwd p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Fields fields;
  Ring ring = tc_setup(smem_raw, &fields);
  tc_sides(ring, fields, [&](auto side, Ring& rg, const Fields& f) {
    constexpr bool P = decltype(side)::value;
    const int H = p.H, lp = p.lp;
    const long long p0 = packed_floats(2 * H, H), ph = packed_floats(H, H);
    float* s0 = p.work + (size_t)blockIdx.x * 2 * kTM * H;
    float* s1 = s0 + (size_t)kTM * H;
    const int n_real = p.rowptr[p.n_nodes];
    const int n_tiles = n_real > 0 ? (n_real + kTM - 1) / kTM : 1;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int base = tile * kTM, end = min(base + kTM, n_real);
      const int lo = p.tile_lo[tile], hi = p.tile_lo[tile + 1];
      const int n0 = max(lo - 1, 0);
      if constexpr (!P)
        stage_fields(f, p.perm, p.src, p.rowptr, nullptr, p.emask, p.einv, base, end, n0, hi, kTM,
                     256, consumer_sync);
      block_sync();
      // layer 0 over [x_src | e]; x_dst w0_dst (pdst) and b0 in the epilogue
      float* out0 = lp > 0 ? s0 : s1;
      tc_product<P>(
          rg, p.wpack, 2 * H, H,
          [&](int r, int k) { return x0_row(p.x, p.e, f, H, r, k); },
          [&](int r, int c, float v0, float v1) {
            x0_out(out0, p.pdst, p.b0, f, H, lp > 0, r, c, v0, v1);
          });
      block_sync();
      // hidden layers: slab l % 2 -> slab (l + 1) % 2; the last layer's
      // output into the slab its input is not in
      for (int l = 0; l < lp; ++l) {
        const float* in = l % 2 == 0 ? s0 : s1;
        const bool hidden = l + 1 < lp;
        float* out = l % 2 == 0 ? s1 : s0;
        const float* bias = p.brest + (size_t)l * H;
        tc_product<P>(
            rg, p.wpack + p0 + l * ph, H, H,
            [&](int r, int k) -> const float* { return in + (size_t)r * H + k; },
            [&](int r, int c, float v0, float v1) {
              hidden_out(out, bias, H, hidden, r, c, v0, v1);
            });
        block_sync();
      }
      if constexpr (!P) {
        float* z = lp == 0 || (lp - 1) % 2 == 0 ? s1 : s0;   // the last layer's output
        const int warp = threadIdx.x >> 5;
        // the rows in registers: 4 features a lane to H = 128, 32 to 1024
        if (H <= 128) {
          ln_out_rows<4>(z, f, p.e, p.lng, p.lnb, p.e_new, H, p.has_ln, kTM, warp, kTCWarps);
          consumer_sync();
          agg_nodes<4>(z, f, p.rowptr, p.agg, p.partials, tile, base, end, n0, hi, H, warp,
                       kTCWarps);
        } else {
          ln_out_rows<32>(z, f, p.e, p.lng, p.lnb, p.e_new, H, p.has_ln, kTM, warp, kTCWarps);
          consumer_sync();
          agg_nodes<32>(z, f, p.rowptr, p.agg, p.partials, tile, base, end, n0, hi, H, warp,
                        kTCWarps);
        }
      }
      block_sync();
    }
  });
}

// C [rows x N] = A [rows x K] B, 128 rows a tile (x_dst w0_dst per node;
// the backward's g_x)
struct TcRows {
  const float* a;
  long long lda;
  int rows, K, N;
  const float* wpack;
  float* out;
  long long ldo;
};

__global__ void __launch_bounds__(kTCThreads, 1) nmp_tc_rows_kernel(const TcRows p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Fields fields;
  Ring ring = tc_setup(smem_raw, &fields);
  tc_sides(ring, fields, [&](auto side, Ring& rg, const Fields&) {
    constexpr bool P = decltype(side)::value;
    const int n_tiles = (p.rows + kTM - 1) / kTM;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int r0 = tile * kTM;
      tc_product<P>(
          rg, p.wpack, p.K, p.N,
          [&](int r, int k) -> const float* {
            return r0 + r < p.rows ? p.a + (size_t)(r0 + r) * p.lda + k : nullptr;
          },
          [&](int r, int c, float v0, float v1) {
            if (r0 + r < p.rows) store2(p.out + (size_t)(r0 + r) * p.ldo + c, v0, v1);
          });
    }
  });
}

// Backward (tc) edge pass operands
struct TcBwd {
  const float *x, *e, *emask, *einv, *b0, *brest, *lng, *genew, *gagg, *pdst, *wpack;
  const int *perm, *src, *slot_dst, *rowptr;
  float *ge, *acts, *work, *lnpart;
  int n_nodes, H, lp, has_ln;
  long long rows;   // rows of each per-slot array: tiles x kTM
};

__global__ void __launch_bounds__(kTCThreads, 1) nmp_tc_bwd_kernel(const TcBwd p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Fields fields;
  Ring ring = tc_setup(smem_raw, &fields);
  tc_sides(ring, fields, [&](auto side, Ring& rg, const Fields& f) {
    constexpr bool P = decltype(side)::value;
    const int H = p.H, lp = p.lp;
    const long long p0 = packed_floats(2 * H, H), ph = packed_floats(H, H);
    const size_t arr = (size_t)p.rows * H;    // floats of one per-slot array
    float* Z = p.work + (size_t)blockIdx.x * 2 * kTM * H;   // z_Lp, then g_h
    float* XH = Z + (size_t)kTM * H;                        // x-hat
    auto A = [&](int l) { return p.acts + l * arr; };          // ELU(z_l): hidden layer l's input
    auto G = [&](int l) { return p.acts + (lp + l) * arr; };   // the gradient of z_l
    const int n_real = p.rowptr[p.n_nodes];
    const int n_tiles = (n_real + kTM - 1) / kTM;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int base = tile * kTM, end = min(base + kTM, n_real);
      if constexpr (!P)
        stage_fields(f, p.perm, p.src, nullptr, p.slot_dst, p.emask, p.einv, base, end, 0, 0, kTM,
                     256, consumer_sync);
      block_sync();
      // the forward, recomputed: ELU(z_l) to the per-slot arrays, z_Lp to Z
      float* out0 = lp > 0 ? A(0) + (size_t)base * H : Z;
      tc_product<P>(
          rg, p.wpack, 2 * H, H,
          [&](int r, int k) { return x0_row(p.x, p.e, f, H, r, k); },
          [&](int r, int c, float v0, float v1) {
            x0_out(out0, p.pdst, p.b0, f, H, lp > 0, r, c, v0, v1);
          });
      block_sync();
      for (int l = 0; l < lp; ++l) {
        const float* in = A(l) + (size_t)base * H;
        const bool hidden = l + 1 < lp;
        float* out = hidden ? A(l + 1) + (size_t)base * H : Z;
        const float* bias = p.brest + (size_t)l * H;
        tc_product<P>(
            rg, p.wpack + p0 + l * ph, H, H,
            [&](int r, int k) -> const float* { return in + (size_t)r * H + k; },
            [&](int r, int c, float v0, float v1) {
              hidden_out(out, bias, H, hidden, r, c, v0, v1);
            });
        block_sync();
      }
      // g_h and the LayerNorm's backward: Z <- g_h, XH <- x-hat, G(lp) <-
      // the gradient of z_Lp; the LayerNorm's column sums to the tile's
      // partials
      if constexpr (!P) {
        const int warp = threadIdx.x >> 5;
        float* g_lp = G(lp) + (size_t)base * H;
        if (H <= 128)
          ln_bwd_rows<4>(Z, XH, g_lp, f, p.genew, p.gagg, p.lng, H, p.has_ln, kTM, warp, kTCWarps);
        else
          ln_bwd_rows<32>(Z, XH, g_lp, f, p.genew, p.gagg, p.lng, H, p.has_ln, kTM, warp, kTCWarps);
        if (p.has_ln) {
          consumer_sync();
          float* lg = p.lnpart + (size_t)tile * 2 * H;
          for (int c = threadIdx.x; c < H; c += 256) {
            lg[c] = tile_sum([&](int r) { return Z[(size_t)r * H + c] * XH[(size_t)r * H + c]; },
                             kTM);
            lg[H + c] = tile_sum([&](int r) { return Z[(size_t)r * H + c]; }, kTM);
          }
        }
      }
      block_sync();
      // hidden layers, last first: G(l) = G(l + 1) W_l^T * ELU'(A(l))
      for (int l = lp - 1; l >= 0; --l) {
        const float* gin = G(l + 1) + (size_t)base * H;
        const float* al = A(l) + (size_t)base * H;
        float* gout = G(l) + (size_t)base * H;
        tc_product<P>(
            rg, p.wpack + p0 + (lp + l) * ph, H, H,
            [&](int r, int k) -> const float* { return gin + (size_t)r * H + k; },
            [&](int r, int c, float v0, float v1) {
              const float2 a = load2(al + (size_t)r * H + c);
              store2(gout + (size_t)r * H + c, v0 * elu_grad(a.x), v1 * elu_grad(a.y));
            });
        block_sync();
      }
      // g_e = g_h + G(0) w0_e^T
      const float* g0 = G(0) + (size_t)base * H;
      tc_product<P>(
          rg, p.wpack + p0 + 2 * lp * ph, H, H,
          [&](int r, int k) -> const float* { return g0 + (size_t)r * H + k; },
          [&](int r, int c, float v0, float v1) {
            const int eid = f.eid[r];
            if (eid >= 0) {
              const float2 gh = load2(Z + (size_t)r * H + c);
              store2(p.ge + (size_t)eid * H + c, v0 + gh.x, v1 + gh.y);
            }
          });
      block_sync();
    }
  });
}

// rows of one operand of a weight-gradient product, indexed by k (a slot
// or a node): base[(idx ? idx[k] : k) * ld + j], j < cols
struct RowSrc {
  const float* base;
  const int* idx;
  long long ld;
  int cols;
};

constexpr int kWM = 128, kWN = 64, kWK = 32, kWStages = 3, kWThreads = 256;
constexpr int kWSA = kWM + 8, kWSB = kWN + 8;   // stage row strides (floats): conflict-free fragments
constexpr int kWSmem = kWStages * kWK * (kWSA + kWSB) * 4;

// Weight-gradient product, split over K: partials[split] [M (+1)][N] =
// sum over k in the split's range of a(k, m) b(k, n), m < M (a0's columns,
// then a1's), n < N = b.cols; with `bias` the row M holds b's column sums.
// K = *k_count when given (the real slots, on the device), else k_fixed.
struct Wgrad {
  RowSrc a0, a1, b;
  const int* k_count;
  int k_fixed, k_per_split, M, bias;
  float* partials;
};

__global__ void __launch_bounds__(kWThreads) nmp_wgrad_kernel(const Wgrad p) {
  extern __shared__ __align__(16) float wsm[];
  const int N = p.b.cols;
  const int n_tiles = (N + kWN - 1) / kWN;
  const int mt = blockIdx.x / n_tiles, m0 = mt * kWM, n0 = (blockIdx.x % n_tiles) * kWN;
  const int K = p.k_count != nullptr ? *p.k_count : p.k_fixed;
  const int kb = blockIdx.y * p.k_per_split, ke = min(K, kb + p.k_per_split);
  const int steps = ke > kb ? (ke - kb + kWK - 1) / kWK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool sums = p.bias && mt == 0 && threadIdx.x < kWN;
  auto load = [&](int step) {
    const int k0 = kb + step * kWK;
    float* sa = wsm + (step % kWStages) * kWK * (kWSA + kWSB);
    float* sb = sa + kWK * kWSA;
    for (int i = threadIdx.x; i < kWK * kWM / 4; i += kWThreads) {
      const int kk = i / (kWM / 4), c = i % (kWM / 4), k = k0 + kk, m = m0 + 4 * c;
      const float* src = nullptr;
      if (k < ke && m < p.M) {
        const bool first = m < p.a0.cols;
        const int* idx = first ? p.a0.idx : p.a1.idx;
        const long long row = idx != nullptr ? idx[k] : k;
        src = (first ? p.a0.base : p.a1.base) + row * (first ? p.a0.ld : p.a1.ld) +
              (first ? m : m - p.a0.cols);
      }
      cp_async16_zfill(smem_u32(sa + kk * kWSA + 4 * c), src != nullptr ? src : p.b.base,
                       src != nullptr ? 16 : 0);
    }
    for (int i = threadIdx.x; i < kWK * kWN / 4; i += kWThreads) {
      const int kk = i / (kWN / 4), c = i % (kWN / 4), k = k0 + kk, n = n0 + 4 * c;
      const float* src = nullptr;
      if (k < ke && n < N)
        src = p.b.base + (p.b.idx != nullptr ? (long long)p.b.idx[k] : k) * p.b.ld + n;
      cp_async16_zfill(smem_u32(sb + kk * kWSB + 4 * c), src != nullptr ? src : p.b.base,
                       src != nullptr ? 16 : 0);
    }
  };
  float acc[8][4] = {};
  float bsum = 0.f;
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kWStages - 2>();          // this step's stage has landed
    __syncthreads();                        // ... for every thread; the stage before is free
    if (step + kWStages - 1 < steps) load(step + kWStages - 1);
    cp_async_commit();
    const float* sa = wsm + (step % kWStages) * kWK * (kWSA + kWSB);
    const float* sb = sa + kWK * kWSA;
    float part[8][4] = {};
    warp_mm<8, kWK / 8, false>(
        part, [&](int r, int k) { return sa[k * kWSA + 16 * warp + r]; },
        [&](int k, int n) { return sb[k * kWSB + n]; }, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
    if (sums) bsum += tile_sum([&](int r) { return sb[r * kWSB + threadIdx.x]; }, kWK);
  }
  float* out = p.partials + (size_t)blockIdx.y * (p.M + p.bias) * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + 16 * warp + g + 8 * (q >> 1), n = n0 + 8 * j + 2 * t + (q & 1);
      if (m < p.M && n < N) out[(size_t)m * N + n] = acc[j][q];
    }
  if (sums && n0 + (int)threadIdx.x < N) out[(size_t)p.M * N + n0 + threadIdx.x] = bsum;
}

// consecutive rows of a weight-gradient product go to up to three
// destinations (rows of N floats each)
struct Seg {
  float* dst;
  int rows;
};

// the splits' partials summed in split order (runs of 16, then the runs)
__global__ void nmp_wgrad_reduce_kernel(const float* __restrict__ partials, int splits, int rows,
                                        int N, Seg s0, Seg s1, Seg s2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long size = (long long)rows * N;
  if (i >= size) return;
  float s = 0.f;
  for (int g0 = 0; g0 < splits; g0 += 16) {
    float q = 0.f;
    for (int g = g0; g < min(g0 + 16, splits); ++g) q += partials[(size_t)g * size + i];
    s += q;
  }
  const int m = (int)(i / N), n = (int)(i % N);
  float* dst = m < s0.rows             ? s0.dst + (size_t)m * N
               : m < s0.rows + s1.rows ? s1.dst + (size_t)(m - s0.rows) * N
                                       : s2.dst + (size_t)(m - s0.rows - s1.rows) * N;
  dst[n] = s;
}

// the n-tiles per warp for width H: 16 NT columns per product chunk
inline int nt_for(int H) { return H <= 16 ? 1 : H <= 32 ? 2 : H <= 64 ? 4 : 8; }

struct Plan {
  int grid, per_sm, work_smem, tiles;
  size_t smem;
  long long work;   // floats of global work scratch per block (0: in shared memory)
};

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// the launch of `kern` with `base` bytes of shared memory plus `slabs`
// bytes of slabs where they fit in shared memory, over `tiles` tiles
template <class K>
cudaError_t plan_kernel(K kern, size_t base, size_t slabs, long long tiles, Plan* p,
                        int threads = kThreads) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  if ((size_t)optin < base) return cudaErrorInvalidValue;
  p->work_smem = base + slabs <= (size_t)optin;
  p->smem = base + (p->work_smem ? slabs : 0);
  p->work = p->work_smem ? 0 : (long long)(slabs / sizeof(float));
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, p->smem);
  if (err != cudaSuccess) return err;
  if (tiles < 1) tiles = 1;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  p->grid = (int)(tiles < cap ? tiles : cap);
  p->per_sm = per_sm;
  p->tiles = (int)tiles;
  return cudaSuccess;
}

template <int NT>
cudaError_t plan_fwd_nt(int H, long long n_slots, Plan* p) {
  const size_t base = sizeof(float) * (stage_floats(NT) + kMeta * kBM);
  const size_t slabs = sizeof(float) * 2 * (size_t)kBM * H;
  return plan_kernel(nmp_any_fwd_kernel<NT>, base, slabs, (n_slots + kBM - 1) / kBM, p);
}

template <int NT>
cudaError_t plan_bwd_nt(int H, int lp, long long n_slots, Plan* p) {
  const size_t base = sizeof(float) * (stage_floats(NT) + kMeta * kBM);
  const size_t slabs = sizeof(float) * (size_t)(lp + 3) * kBM * H;
  return plan_kernel(nmp_any_bwd_kernel<NT>, base, slabs, (n_slots + kBM - 1) / kBM, p);
}

bool valid_shape(int H, int lp, long long n_slots) {
  return H >= 1 && lp >= 0 && n_slots >= 0 && n_slots <= (1LL << 31) - kTM &&
         (long long)kTM * H * (lp + 3) < (1LL << 31);
}

cudaError_t plan_fwd(int H, int lp, long long n_slots, Plan* p) {
  if (!valid_shape(H, lp, n_slots)) return cudaErrorInvalidValue;
  switch (nt_for(H)) {
    case 1: return plan_fwd_nt<1>(H, n_slots, p);
    case 2: return plan_fwd_nt<2>(H, n_slots, p);
    case 4: return plan_fwd_nt<4>(H, n_slots, p);
    default: return plan_fwd_nt<8>(H, n_slots, p);
  }
}

cudaError_t plan_bwd(int H, int lp, long long n_slots, Plan* p) {
  if (!valid_shape(H, lp, n_slots)) return cudaErrorInvalidValue;
  switch (nt_for(H)) {
    case 1: return plan_bwd_nt<1>(H, lp, n_slots, p);
    case 2: return plan_bwd_nt<2>(H, lp, n_slots, p);
    case 4: return plan_bwd_nt<4>(H, lp, n_slots, p);
    default: return plan_bwd_nt<8>(H, lp, n_slots, p);
  }
}

template <int NT>
void launch_fwd_nt(const Plan& p, cudaStream_t st, const float* x, const float* e,
                   const int* perm, const int* src, const int* rowptr, const int* tile_lo,
                   const float* emask, const float* einv, const float* w0, const float* b0,
                   const float* wrest, const float* brest, const float* lng, const float* lnb,
                   float* e_new, float* agg, float* partials, float* work, int n_nodes, int H,
                   int lp, int has_ln) {
  nmp_any_fwd_kernel<NT><<<p.grid, kThreads, p.smem, st>>>(
      x, e, perm, src, rowptr, tile_lo, emask, einv, w0, b0, wrest, brest, lng, lnb, e_new, agg,
      partials, work, n_nodes, H, lp, has_ln, p.work_smem);
}

template <int NT>
void launch_bwd_nt(const Plan& p, cudaStream_t st, const float* x, const float* e,
                   const int* perm, const int* src, const int* slot_dst, const int* rowptr,
                   int n_nodes, const float* emask, const float* einv, const float* w0,
                   const float* b0, const float* wrest, const float* brest, const float* lng,
                   const float* lnb, const float* genew, const float* gagg, float* ge,
                   float* gz0, float* partials, float* work, int H, int lp, int has_ln) {
  nmp_any_bwd_kernel<NT><<<p.grid, kThreads, p.smem, st>>>(
      x, e, perm, src, slot_dst, rowptr, n_nodes, emask, einv, w0, b0, wrest, brest, lng, lnb,
      genew, gagg, ge, gz0, partials, work, H, lp, has_ln, p.work_smem);
}

template <int NT>
cudaError_t launch_node_nt(cudaStream_t st, const float* gs, const float* w0, float* gx,
                           int n_nodes, int H) {
  const size_t smem = sizeof(float) * stage_floats(NT);
  cudaError_t err = cudaFuncSetAttribute(any_node_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  any_node_kernel<NT><<<(n_nodes + kBM - 1) / kBM, kThreads, smem, st>>>(gs, w0, gx, n_nodes, H);
  return cudaGetLastError();
}

// ---- the tensor-core route's launches ----

// a region carved from the entry's one scratch buffer (256-byte aligned
// pieces); with a null base it only counts
struct Carve {
  float* base;
  long long used = 0;
  float* take(long long n) {
    float* r = base != nullptr ? base + used : nullptr;
    used += (n + 63) / 64 * 64;
    return r;
  }
};

bool valid_tc(int H, int lp, long long n_slots) {
  return H >= 4 && H % 4 == 0 && valid_shape(H, lp, n_slots) &&
         (long long)2 * H * H * (lp + 2) < (1LL << 31);
}

// one block per SM of the tensor-core kernels (their shared memory);
// grid over `tiles`
template <class K>
cudaError_t plan_tc_kernel(K kern, long long tiles, Plan* p) {
  return plan_kernel(kern, kTCSmem, 0, tiles, p, kTCThreads);
}

// the split of a weight-gradient product over K (up to k_max): about 4
// blocks per SM in all, each range a whole number of 32-row stages
void wgrad_split(int M, int N, long long k_max, int sms, int* splits, int* k_per) {
  const long long tiles = (long long)((M + kWM - 1) / kWM) * ((N + kWN - 1) / kWN);
  const long long stages = (k_max + kWK - 1) / kWK;
  long long s = (4LL * sms + tiles - 1) / tiles;
  if (s > stages) s = stages;
  if (s < 1) s = 1;
  const long long per = (stages + s - 1) / s * kWK;
  *k_per = (int)(per > 0 ? per : kWK);
  *splits = k_max > 0 ? (int)((k_max + *k_per - 1) / *k_per) : 1;
}

// floats of the weight-gradient partials the backward needs (its largest
// product)
long long wgrad_partials(int H, int lp, long long n_slots, int n_nodes, int sms) {
  int s = 0, k = 0;
  long long most = 0;
  auto need = [&](int M, int bias, long long kmax) {
    wgrad_split(M, H, kmax, sms, &s, &k);
    const long long f = (long long)s * (M + bias) * H;
    if (f > most) most = f;
  };
  need(2 * H, 1, n_slots);
  need(H, 0, n_nodes);
  if (lp > 0) need(H, 1, n_slots);
  return most;
}

cudaError_t launch_pack(cudaStream_t st, const BSrc& b, float* out) {
  const long long n = packed_floats(b.K, b.N) / 2;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  tc_pack_kernel<<<blocks > 0 ? blocks : 1, 256, 0, st>>>(b, out);
  return cudaGetLastError();
}

// B(k, n) = w[k][n] of a row-major [K][N] weight (z = a w)
BSrc weight(const float* w, int K, int N) { return BSrc{w, N, 1, K, w, 0, 0, K, N}; }

// B(k, n) = w[n][k] of a row-major [N][K] weight (g w^T)
BSrc weight_t(const float* w, int K, int N) { return BSrc{w, 1, K, K, w, 0, 0, K, N}; }

// layer 0 over [x_src | e] (K = 2H): w0's rows 0 .. H - 1, then 2H .. 3H - 1
BSrc layer0(const float* w0, int H) {
  return BSrc{w0, H, 1, H, w0 + (size_t)2 * H * H, H, 1, 2 * H, H};
}

cudaError_t launch_rows(cudaStream_t st, const float* a, long long lda, int rows, int K, int N,
                        const float* wpack, float* out, long long ldo) {
  if (rows <= 0) return cudaSuccess;
  Plan pl;
  cudaError_t err = plan_tc_kernel(nmp_tc_rows_kernel, (rows + kTM - 1) / kTM, &pl);
  if (err != cudaSuccess) return err;
  nmp_tc_rows_kernel<<<pl.grid, kTCThreads, pl.smem, st>>>(
      TcRows{a, lda, rows, K, N, wpack, out, ldo});
  return cudaGetLastError();
}

cudaError_t launch_wgrad(cudaStream_t st, int sms, RowSrc a0, RowSrc a1, RowSrc b,
                         const int* k_count, long long k_max, int M, int bias, float* partials,
                         Seg s0, Seg s1, Seg s2) {
  int splits = 1, k_per = kWK;
  wgrad_split(M, b.cols, k_max, sms, &splits, &k_per);
  cudaError_t err = cudaFuncSetAttribute(nmp_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + kWM - 1) / kWM) * ((b.cols + kWN - 1) / kWN);
  nmp_wgrad_kernel<<<dim3(tiles, splits), kWThreads, kWSmem, st>>>(
      Wgrad{a0, a1, b, k_count, (int)k_max, k_per, M, bias, partials});
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long size = (long long)(M + bias) * b.cols;
  nmp_wgrad_reduce_kernel<<<(int)((size + 255) / 256), 256, 0, st>>>(partials, splits, M + bias,
                                                                     b.cols, s0, s1, s2);
  return cudaGetLastError();
}

// the tensor-core forward's plan and scratch (carve with a null base to
// count)
struct TcFwdScratch {
  int* tile_lo;
  float *partials, *work, *wpack;
};

cudaError_t plan_tc_fwd(int H, int lp, long long n_slots, Plan* p, Carve* c, TcFwdScratch* s) {
  if (!valid_tc(H, lp, n_slots)) return cudaErrorInvalidValue;
  const long long tiles = n_slots > 0 ? (n_slots + kTM - 1) / kTM : 1;
  cudaError_t err = plan_tc_kernel(nmp_tc_fwd_kernel, tiles, p);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(nmp_tc_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTCSmem);
  if (err != cudaSuccess) return err;
  s->tile_lo = reinterpret_cast<int*>(c->take(tiles + 1));
  s->partials = c->take(tiles * 2 * H);
  s->work = c->take((long long)p->grid * 2 * kTM * H);
  s->wpack = c->take(packed_floats(2 * H, H) + lp * packed_floats(H, H));
  return cudaSuccess;
}

struct TcBwdScratch {
  int* slot_dst;
  float *wpack, *work, *acts, *lnpart, *node_sums, *wpart;
  long long rows;
};

cudaError_t plan_tc_bwd(int H, int lp, long long n_slots, int n_nodes, Plan* p, Carve* c,
                        TcBwdScratch* s) {
  if (!valid_tc(H, lp, n_slots)) return cudaErrorInvalidValue;
  const long long tiles = n_slots > 0 ? (n_slots + kTM - 1) / kTM : 1;
  cudaError_t err = plan_tc_kernel(nmp_tc_bwd_kernel, tiles, p);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(nmp_tc_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTCSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  s->rows = tiles * kTM;
  s->slot_dst = reinterpret_cast<int*>(c->take(n_slots));
  // w0 [src | e], the hidden layers forward and transposed, w0_e^T, [w0_dst; w0_src]^T
  s->wpack = c->take(2 * packed_floats(2 * H, H) + (2 * lp + 1) * packed_floats(H, H));
  s->work = c->take((long long)p->grid * 2 * kTM * H);
  s->acts = c->take((2LL * lp + 1) * s->rows * H);
  s->lnpart = c->take(tiles * 2 * H);
  s->node_sums = c->take((long long)n_nodes * 2 * H);
  s->wpart = c->take(wgrad_partials(H, lp, n_slots, n_nodes, sms));
  return cudaSuccess;
}

}  // namespace

// plan[0..4] = the edge pass's grid, its dynamic shared memory per block in
// bytes, its resident blocks per SM (occupancy API), the floats of global
// work scratch per block (0: the slabs are in shared memory) and the tiles
// the forward's scratch must hold (tile_lo: tiles + 1 int32, partials:
// tiles x 2 x H fp32)
extern "C" int nmp_edge_mlp_agg_fwd_any_plan(int hidden, int n_hidden, long long n_slots,
                                             long long* plan) {
  Plan p;
  cudaError_t err = plan_fwd(hidden, n_hidden, n_slots, &p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.grid;
  plan[1] = (long long)p.smem;
  plan[2] = p.per_sm;
  plan[3] = p.work;
  plan[4] = p.tiles;
  return 0;
}

// plan[0..3] = the edge pass's grid (= partial rows), its dynamic shared
// memory per block, its resident blocks per SM and the floats of global
// work scratch per block (0: in shared memory)
extern "C" int nmp_edge_mlp_agg_bwd_any_plan(int hidden, int n_hidden, long long n_slots,
                                             long long* plan) {
  Plan p;
  cudaError_t err = plan_bwd(hidden, n_hidden, n_slots, &p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.grid;
  plan[1] = (long long)p.smem;
  plan[2] = p.per_sm;
  plan[3] = p.work;
  return 0;
}

extern "C" int nmp_edge_mlp_agg_fwd_any_f32(
    const void* x, const void* e, const void* perm, const void* src, const void* rowptr,
    const void* emask, const void* einv, const void* w0, const void* b0, const void* wrest,
    const void* brest, const void* lng, const void* lnb, void* e_new, void* agg, void* tile_lo,
    void* partials, void* work, int n_nodes, long long n_slots, long long n_edges, int hidden,
    int n_hidden, int has_ln, void* stream) {
  Plan p;
  cudaError_t err = plan_fwd(hidden, n_hidden, n_slots, &p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  // e' = 0 on the edges outside the layout: no slot writes them
  err = cudaMemsetAsync(e_new, 0, (size_t)n_edges * hidden * sizeof(float), st);
  if (err != cudaSuccess || n_nodes <= 0) return (int)err;
  any_tile_lo_kernel<<<(n_nodes + 256) / 256, 256, 0, st>>>((const int*)rowptr, (int*)tile_lo,
                                                            n_nodes, kBM);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define FWD_ARGS                                                                         \
  p, st, (const float*)x, (const float*)e, (const int*)perm, (const int*)src,            \
      (const int*)rowptr, (const int*)tile_lo, (const float*)emask, (const float*)einv,  \
      (const float*)w0, (const float*)b0, (const float*)wrest, (const float*)brest,      \
      (const float*)lng, (const float*)lnb, (float*)e_new, (float*)agg, (float*)partials, \
      (float*)work, n_nodes, hidden, n_hidden, has_ln
  switch (nt_for(hidden)) {
    case 1: launch_fwd_nt<1>(FWD_ARGS); break;
    case 2: launch_fwd_nt<2>(FWD_ARGS); break;
    case 4: launch_fwd_nt<4>(FWD_ARGS); break;
    default: launch_fwd_nt<8>(FWD_ARGS); break;
  }
#undef FWD_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long fix = (long long)p.tiles * hidden;
  any_fixup_kernel<<<(int)((fix + 255) / 256), 256, 0, st>>>(
      (const int*)rowptr, (const int*)tile_lo, (const float*)partials, (float*)agg, n_nodes,
      hidden, kBM);
  return (int)cudaGetLastError();
}

extern "C" int nmp_edge_mlp_agg_bwd_any_f32(
    const void* x, const void* e, const void* perm, const void* src, const void* rowptr,
    const void* src_slots, const void* src_rowptr, const void* emask, const void* einv,
    const void* w0, const void* b0, const void* wrest, const void* brest, const void* lng,
    const void* lnb, const void* genew, const void* gagg, void* gx, void* ge, void* gw,
    void* gz0, void* slot_dst, void* node_sums, void* partials, void* work, int n_nodes,
    long long n_slots, int hidden, int n_hidden, int has_ln, int n_rows, void* stream) {
  Plan p;
  cudaError_t err = plan_bwd(hidden, n_hidden, n_slots, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.grid != n_rows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int lpx = n_hidden > 0 ? n_hidden : 1;
  const long long wsize = wgrad_size(hidden, lpx);
  err = cudaMemsetAsync(partials, 0, (size_t)n_rows * wsize * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes > 0) {
    any_slot_dst_kernel<<<(n_nodes + 255) / 256, 256, 0, st>>>((const int*)rowptr,
                                                               (int*)slot_dst, n_nodes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
#define BWD_ARGS                                                                          \
  p, st, (const float*)x, (const float*)e, (const int*)perm, (const int*)src,             \
      (const int*)slot_dst, (const int*)rowptr, n_nodes, (const float*)emask,             \
      (const float*)einv, (const float*)w0, (const float*)b0, (const float*)wrest,        \
      (const float*)brest, (const float*)lng, (const float*)lnb, (const float*)genew,     \
      (const float*)gagg, (float*)ge, (float*)gz0, (float*)partials, (float*)work, hidden, \
      n_hidden, has_ln
    switch (nt_for(hidden)) {
      case 1: launch_bwd_nt<1>(BWD_ARGS); break;
      case 2: launch_bwd_nt<2>(BWD_ARGS); break;
      case 4: launch_bwd_nt<4>(BWD_ARGS); break;
      default: launch_bwd_nt<8>(BWD_ARGS); break;
    }
#undef BWD_ARGS
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  any_reduce_partials_kernel<<<(int)((wsize + 255) / 256), 256, 0, st>>>(
      (const float*)partials, (float*)gw, n_rows, wsize);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_nodes <= 0) return (int)err;
  const long long sums = (long long)n_nodes * hidden;
  any_node_sums_kernel<<<(int)((sums + 255) / 256), 256, 0, st>>>(
      (const float*)gz0, (const int*)rowptr, (const int*)src_slots, (const int*)src_rowptr,
      (float*)node_sums, n_nodes, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (nt_for(hidden)) {
    case 1: return (int)launch_node_nt<1>(st, (const float*)node_sums, (const float*)w0, (float*)gx, n_nodes, hidden);
    case 2: return (int)launch_node_nt<2>(st, (const float*)node_sums, (const float*)w0, (float*)gx, n_nodes, hidden);
    case 4: return (int)launch_node_nt<4>(st, (const float*)node_sums, (const float*)w0, (float*)gx, n_nodes, hidden);
    default: return (int)launch_node_nt<8>(st, (const float*)node_sums, (const float*)w0, (float*)gx, n_nodes, hidden);
  }
}

// The tensor-core route.  plan[0..4] = the edge pass's grid, its dynamic
// shared memory per block, its resident blocks per SM, its 128-slot tiles
// and the floats of the one scratch buffer the entry takes; kind 0 the
// forward, 1 the backward, 2 the per-node x_dst w0_dst pass (grid over
// the node tiles).
extern "C" int nmp_any_tc_plan(int kind, int hidden, int n_hidden, long long n_slots, int n_nodes,
                               long long* plan) {
  Plan p;
  Carve c{nullptr};
  cudaError_t err;
  if (kind == 0) {
    TcFwdScratch s;
    err = plan_tc_fwd(hidden, n_hidden, n_slots, &p, &c, &s);
  } else if (kind == 1) {
    TcBwdScratch s;
    err = plan_tc_bwd(hidden, n_hidden, n_slots, n_nodes, &p, &c, &s);
  } else {
    err = valid_tc(hidden, 0, n_nodes) ? plan_tc_kernel(nmp_tc_rows_kernel,
                                                        (n_nodes + kTM - 1) / kTM, &p)
                                       : cudaErrorInvalidValue;
    c.take(packed_floats(hidden, hidden));
  }
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.grid;
  plan[1] = (long long)p.smem;
  plan[2] = p.per_sm;
  plan[3] = p.tiles;
  plan[4] = c.used;
  return 0;
}

// out [N x H] = x [N x H] w0_dst (w0's rows H .. 2H - 1) in 3xTF32 on the
// tensor cores; scratch: the plan's floats (the packed weights)
extern "C" int nmp_node_dst_f32(const void* x, const void* w0, void* out, void* scratch,
                                int n_nodes, int hidden, void* stream) {
  if (!valid_tc(hidden, 0, n_nodes)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int H = hidden;
  float* wpack = (float*)scratch;
  cudaError_t err = launch_pack(st, weight((const float*)w0 + (size_t)H * H, H, H), wpack);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(nmp_tc_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTCSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_rows(st, (const float*)x, H, n_nodes, H, H, wpack, (float*)out, H);
}

// The tensor-core forward; pdst = x w0_dst per node (nmp_node_dst_f32)
extern "C" int nmp_edge_mlp_agg_fwd_tc_f32(
    const void* x, const void* e, const void* perm, const void* src, const void* rowptr,
    const void* emask, const void* einv, const void* w0, const void* b0, const void* wrest,
    const void* brest, const void* lng, const void* lnb, const void* pdst, void* e_new, void* agg,
    void* scratch, int n_nodes, long long n_slots, long long n_edges, int hidden, int n_hidden,
    int has_ln, void* stream) {
  Plan p;
  Carve c{(float*)scratch};
  TcFwdScratch s;
  cudaError_t err = plan_tc_fwd(hidden, n_hidden, n_slots, &p, &c, &s);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int H = hidden, lp = n_hidden;
  err = cudaMemsetAsync(e_new, 0, (size_t)n_edges * H * sizeof(float), st);
  if (err != cudaSuccess || n_nodes <= 0) return (int)err;
  err = launch_pack(st, layer0((const float*)w0, H), s.wpack);
  for (int l = 0; l < lp && err == cudaSuccess; ++l)
    err = launch_pack(st, weight((const float*)wrest + (size_t)l * H * H, H, H),
                      s.wpack + packed_floats(2 * H, H) + l * packed_floats(H, H));
  if (err != cudaSuccess) return (int)err;
  any_tile_lo_kernel<<<(n_nodes + 256) / 256, 256, 0, st>>>((const int*)rowptr, s.tile_lo,
                                                            n_nodes, kTM);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  TcFwd a{(const float*)x, (const float*)e, (const float*)emask, (const float*)einv,
          (const float*)b0, (const float*)brest, (const float*)lng, (const float*)lnb,
          (const float*)pdst, s.wpack, (const int*)perm, (const int*)src, (const int*)rowptr,
          s.tile_lo, (float*)e_new, (float*)agg, s.partials, s.work, n_nodes, H, lp, has_ln};
  nmp_tc_fwd_kernel<<<p.grid, kTCThreads, p.smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long fix = (long long)p.tiles * H;
  any_fixup_kernel<<<(int)((fix + 255) / 256), 256, 0, st>>>((const int*)rowptr, s.tile_lo,
                                                             s.partials, (float*)agg, n_nodes,
                                                             H, kTM);
  return (int)cudaGetLastError();
}

// The tensor-core backward; pdst = x w0_dst per node (nmp_node_dst_f32);
// gw: the stacked weight gradients (w0, b0, wrest, brest, lng, lnb); lnb
// is not read (its gradient does not depend on it)
extern "C" int nmp_edge_mlp_agg_bwd_tc_f32(
    const void* x, const void* e, const void* perm, const void* src, const void* rowptr,
    const void* src_slots, const void* src_rowptr, const void* emask, const void* einv,
    const void* w0, const void* b0, const void* wrest, const void* brest, const void* lng,
    const void* lnb, const void* genew, const void* gagg, const void* pdst, void* gx, void* ge,
    void* gw, void* scratch, int n_nodes, long long n_slots, int hidden, int n_hidden,
    int has_ln, void* stream) {
  Plan p;
  Carve c{(float*)scratch};
  TcBwdScratch s;
  cudaError_t err = plan_tc_bwd(hidden, n_hidden, n_slots, n_nodes, &p, &c, &s);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int H = hidden, lp = n_hidden, lpx = lp > 0 ? lp : 1;
  const size_t HH = (size_t)H * H;
  float* gw0 = (float*)gw;
  float* gb0 = gw0 + 3 * HH;
  float* gwr = gb0 + H;
  float* gbr = gwr + lpx * HH;
  float* glng = gbr + (size_t)lpx * H;
  err = cudaMemsetAsync(gw, 0, (size_t)wgrad_size(H, lpx) * sizeof(float), st);
  if (err != cudaSuccess || n_nodes <= 0) return (int)err;
  // the tiles past the real slots leave their LayerNorm partials at 0
  err = cudaMemsetAsync(s.lnpart, 0, (size_t)(s.rows / kTM) * 2 * H * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const float* fw0 = (const float*)w0;
  const float* fwr = (const float*)wrest;
  const long long p0 = packed_floats(2 * H, H), ph = packed_floats(H, H);
  // packed: w0 [src | e], wrest_l, wrest_l^T, w0_e^T, [w0_dst; w0_src]^T
  err = launch_pack(st, layer0(fw0, H), s.wpack);
  for (int l = 0; l < lp && err == cudaSuccess; ++l) {
    err = launch_pack(st, weight(fwr + l * HH, H, H), s.wpack + p0 + l * ph);
    if (err == cudaSuccess)
      err = launch_pack(st, weight_t(fwr + l * HH, H, H), s.wpack + p0 + (lp + l) * ph);
  }
  if (err == cudaSuccess)
    err = launch_pack(st, weight_t(fw0 + 2 * HH, H, H), s.wpack + p0 + 2 * lp * ph);
  float* wcat = s.wpack + p0 + (2 * lp + 1) * ph;
  // k < H: w0_dst[n][k], then w0_src[n][k - H]
  if (err == cudaSuccess) err = launch_pack(st, BSrc{fw0 + HH, 1, H, H, fw0, 1, H, 2 * H, H}, wcat);
  if (err != cudaSuccess) return (int)err;
  any_slot_dst_kernel<<<(n_nodes + 255) / 256, 256, 0, st>>>((const int*)rowptr, s.slot_dst,
                                                             n_nodes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  TcBwd a{(const float*)x, (const float*)e, (const float*)emask, (const float*)einv,
          (const float*)b0, (const float*)brest, (const float*)lng, (const float*)genew,
          (const float*)gagg, (const float*)pdst, s.wpack, (const int*)perm, (const int*)src,
          s.slot_dst, (const int*)rowptr, (float*)ge, s.acts, s.work, s.lnpart, n_nodes, H, lp,
          has_ln, s.rows};
  nmp_tc_bwd_kernel<<<p.grid, kTCThreads, p.smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* g0 = s.acts + (size_t)lp * s.rows * H;
  // per node: the sums of G_0 over its dst slots and its src slots; g_x
  const long long sums = (long long)n_nodes * H;
  any_node_sums_kernel<<<(int)((sums + 255) / 256), 256, 0, st>>>(
      g0, (const int*)rowptr, (const int*)src_slots, (const int*)src_rowptr, s.node_sums,
      n_nodes, H);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_rows(st, s.node_sums, 2 * H, n_nodes, 2 * H, H, wcat, (float*)gx, H);
  // the weight gradients, split over the slots (w0_dst: over the nodes)
  const int* n_real = (const int*)rowptr + n_nodes;
  const RowSrc none{nullptr, nullptr, 0, 0};
  if (err == cudaSuccess)
    err = launch_wgrad(st, sms, RowSrc{(const float*)x, (const int*)src, H, H},
                       RowSrc{(const float*)e, (const int*)perm, H, H}, RowSrc{g0, nullptr, H, H},
                       n_real, n_slots, 2 * H, 1, s.wpart, Seg{gw0, H}, Seg{gw0 + 2 * HH, H},
                       Seg{gb0, 1});
  if (err == cudaSuccess)
    err = launch_wgrad(st, sms, RowSrc{(const float*)x, nullptr, H, H}, none,
                       RowSrc{s.node_sums, nullptr, 2 * H, H}, nullptr, n_nodes, H, 0, s.wpart,
                       Seg{gw0 + HH, H}, Seg{nullptr, 0}, Seg{nullptr, 0});
  for (int l = 0; l < lp && err == cudaSuccess; ++l)
    err = launch_wgrad(st, sms, RowSrc{s.acts + (size_t)l * s.rows * H, nullptr, H, H}, none,
                       RowSrc{s.acts + (size_t)(lp + l + 1) * s.rows * H, nullptr, H, H}, n_real,
                       n_slots, H, 1, s.wpart, Seg{gwr + l * HH, H}, Seg{gbr + (size_t)l * H, 1},
                       Seg{nullptr, 0});
  if (err != cudaSuccess || !has_ln) return (int)err;
  // the LayerNorm's gradients: the tiles' column sums in tile order
  const int tiles = (int)(s.rows / kTM);
  any_reduce_partials_kernel<<<(2 * H + 255) / 256, 256, 0, st>>>(s.lnpart, glng, tiles, 2 * H);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
