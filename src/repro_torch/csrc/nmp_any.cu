// Fused NMP forward and backward (Eq. 4a + 4b and its VJP) at any width H
// >= 1 and any number of hidden layers, for NVIDIA Hopper (sm_90a), fp32
// operands, fp32 FMA products.
//
// Replaces, at every shape the tuned pair (csrc/nmp_fwd.cu, csrc/nmp_bwd.cu:
// H in {8, 16, 32}, the backward at most 5 hidden layers) does not take,
// the Pallas TPU kernels
//   src/repro/kernels/segment_agg/kernel.py::nmp_edge_mlp_agg_fwd
//   src/repro/kernels/segment_agg/kernel.py::nmp_edge_mlp_agg_bwd
// which take any H and any depth (every operand a whole-array BlockSpec).
// For every real edge (i <- j) of one rank:
//   z_0 = [x_j_src, x_i_dst, e_ij] w0 + b0,  z_{l+1} = ELU(z_l) wrest_l + brest_l,
//   e'_ij = (e_ij + LN(z_Lp)) * mask_ij   (LN optional: biased variance, eps 1e-5)
//   agg_i = sum_j e'_ij * (1 / d_ij)
// and the backward's outputs: g_e, g_x and the weight gradients for the
// cotangents (g_e', g_agg), as csrc/nmp_bwd.cu computes them.
//
// What bounds it on the H100 SXM (published peaks at its 700 W limit):
// operations at the widths it exists for.  Per edge the forward does 2 (3H*H
// + Lp*H*H) FLOP (8 H^2 at Lp = 1) against ~16 H bytes (the gathered x rows,
// e, e'): at H = 512 ~256 FLOP/byte, above the ridge of either route (fp32
// CUDA cores 20, TF32 tensor cores 148 FLOP/byte).  The card's least time is
// the tensor cores' in 3xTF32 (3x the FLOP at 495 TFLOP/s); this first
// design runs on the CUDA cores in plain fp32 FMAs instead (67 TFLOP/s, 2.5x
// that bound), for two reasons measured on the H100: a 3xTF32 version of it
// (csrc/nmp_tf32.cuh's split, mma.sync.m16n8k8) ran 30 ms at GraphCast's
// d512 layer, staging-bound, and its products (~22 bits of each operand)
// put the backward's gradient at H = 4, where a LayerNorm over 4 features
// amplifies the recomputed pre-activation's error by 1 / (var + eps) up to
// 1e5, 14x further from a float64 VJP than the plain fp32 version.  FMAs
// in k order keep fp32's own rounding.  The backward recomputes the forward
// and does its two products per layer (input and weight gradients): 3x the
// forward's FLOP.
//
// Design (simple first; the tensor cores, TMA and a copy ring are later
// work).  One building block, block_gemm: a block of 8 warps computes C =
// A B for A [M x K] and B [K x N] read through functions (a gather, a slab
// in shared or global memory, a transposed weight), M in tiles of 64 rows,
// N in chunks of 16 NT columns (NT in {1, 2, 4, 8} by H: a template
// argument, the only one), K in chunks of 32.  Each chunk of A (k-major)
// and B is staged in shared memory (loaded into registers while the chunk
// before it is summed), zero past M, N and K: that is how any
// width (H = 4, 12, 100) is padded, inside the kernel, and why the padding
// never reaches a sum or a LayerNorm.  Each thread sums NT rows x 4 columns
// of the chunk in registers, per k one float4 of B and NT values of A (a
// broadcast across the warp).
//   Forward, per tile of 64 consecutive dst-sorted slots (a persistent block
//   walks tiles b, b + grid, ...): the slots' fields, then layer 0 as one
//   block_gemm whose A gathers [x_src | x_dst | e] rows, each hidden layer
//   as one block_gemm over the activation slab (ELU in the epilogue), the
//   LayerNorm and e' = (e + h) * mask a warp per row (row statistics by
//   shuffles over the H features), e' to the edge's original position, and
//   the aggregate a warp per node in slot order: a node whose run lies in
//   the tile gets its row from this one writer, the parts of a node cut by
//   a tile edge go to the tile's two partial rows (0: running in, 1:
//   running past the end), summed by the fix-up pass in tile order (the
//   tuned kernel's scheme, csrc/nmp_fwd.cu (a), (c), with runtime H).  The
//   two activation slabs (2 x 64 x H floats) sit in shared memory where
//   they fit, else in a per-block global scratch (H = 512: 256 KB a block,
//   read back through L1 / L2).  e' starts zeroed (a memset): edges outside
//   the layout keep 0.
//   Backward, per tile: the forward recomputed into Lp activation slabs and
//   the last pre-activation; the cotangent g_h = (g_e' + g_agg[dst] / d) *
//   mask and the LayerNorm's backward a warp per row; then for each hidden
//   layer, last first, its weight gradient A_l^T G (a block_gemm over the
//   tile's rows, added into the block's own partial row), its bias
//   gradient (column sums in a fixed blocked order) and the input gradient G W_l^T *
//   ELU'; layer 0's w0 gradient X0^T G0 (X0 gathered again), g_e = g_h +
//   G0 w0_e^T, and G0 per slot to a scratch.  Then (c) the partial rows
//   summed in block order, (d1) per node the fixed-order sums of G0 over
//   its dst slots (rowptr) and its src slots (src_slots), and (d2) g_x =
//   [G_dst | G_src] [w0_dst; w0_src]^T, one block_gemm per 64 nodes.
//   A block's partial row holds every weight gradient (3H*H + H + Lp*(H*H
//   + H) + 2H floats; ~1.05 M at H = 512, Lp = 1), read and written once
//   per tile by one thread per element.
// No float atomics: every sum has one writer and a fixed order, so two
// launches are bitwise equal (for a given grid, which the card fixes).
//
// C entry points return cudaGetLastError().  Scratch the wrapper allocates:
// forward tile_lo (tiles + 1 int32), partials (tiles x 2 x H), work
// (grid x plan[3] floats, where the slabs are in global memory); backward
// slot_dst (slots int32), g_z0 (slots x H), the node sums (N x 2H),
// partials (grid x weight-gradient floats) and work (grid x plan[3]).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
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

__device__ inline Fields fields_at(float* p) {
  Fields f;
  f.eid = reinterpret_cast<int*>(p);
  f.src = f.eid + kBM;
  f.dst = f.src + kBM;
  f.m = reinterpret_cast<float*>(f.dst + kBM);
  f.inv = f.m + kBM;
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

// stage tile `tile`'s per-slot fields; the destinations from the nodes'
// runs (or from slot_dst when given).  Ends with __syncthreads().
__device__ void stage_fields(const Fields& f, const int* __restrict__ perm,
                             const int* __restrict__ src, const int* __restrict__ rowptr,
                             const int* __restrict__ slot_dst, const float* __restrict__ emask,
                             const float* __restrict__ einv, int base, int end, int n0, int hi) {
  if (threadIdx.x < kBM) {
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
  __syncthreads();
  if (slot_dst == nullptr) {
    // the nodes n0 .. hi - 1 hold every slot of [base, end)
    for (int n = n0 + threadIdx.x; n < hi; n += kThreads) {
      const int rs = max(rowptr[n], base), re = min(rowptr[n + 1], end);
      for (int s = rs; s < re; ++s) f.dst[s - base] = n;
    }
    __syncthreads();
  }
}

// (a) tile_lo[b] = the least n with rowptr[n] >= b * kBM, b < n_tiles;
// tile_lo[n_tiles] = n_nodes; one writer per tile (csrc/nmp_fwd.cu (a))
__global__ void any_tile_lo_kernel(const int* __restrict__ rowptr, int* __restrict__ tile_lo,
                                   int n_nodes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n > n_nodes) return;
  const int n_real = rowptr[n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + kBM - 1) / kBM : 1;
  const int b_lo = n == 0 ? 0 : rowptr[n - 1] / kBM + 1;
  const int b_hi = min(rowptr[n] / kBM, n_tiles - 1);
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
  const Fields f = fields_at(stage + stage_floats(NT));
  float* slab = work_smem ? stage + stage_floats(NT) + kMeta * kBM
                          : work + (size_t)blockIdx.x * 2 * kBM * H;
  float* s0 = slab;
  float* s1 = slab + (size_t)kBM * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_real = rowptr[n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + kBM - 1) / kBM : 1;
  const float inv_h = 1.f / H;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kBM, end = min(base + kBM, n_real);
    const int lo = tile_lo[tile], hi = tile_lo[tile + 1];
    const int n0 = max(lo - 1, 0);          // the node walk's first node
    stage_fields(f, perm, src, rowptr, nullptr, emask, einv, base, end, n0, hi);
    // activations alternate between the slabs; the last layer's output
    // lands in `z`
    float* z = lp % 2 == 0 ? s0 : s1;
    forward_rows<NT>(x, e, f, w0, b0, wrest, brest, H, lp,
                     [&](int l) { return l % 2 == 0 ? s0 : s1; }, z, stage);
    // LayerNorm and e' = (e + h) * mask, a warp per row, in place
    for (int r = warp; r < kBM; r += kWarps) {
      float* zr = z + (size_t)r * H;
      const int eid = f.eid[r];
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
      const float m = f.m[r];
      for (int c = lane; c < H; c += 32) {
        const float h = has_ln ? (zr[c] - mu) * rstd * __ldg(lng + c) + __ldg(lnb + c) : zr[c];
        const float ev = eid >= 0 ? __ldg(e + (size_t)eid * H + c) : 0.f;
        const float out = (ev + h) * m;
        zr[c] = out;
        if (eid >= 0) e_new[(size_t)eid * H + c] = out;
      }
    }
    __syncthreads();
    // agg: per node, e' * (1/d) summed in slot order, a warp per node
    for (int n = n0 + warp; n < hi; n += kWarps) {
      const int rs0 = rowptr[n], re0 = rowptr[n + 1];
      if (rs0 < base && re0 <= base) continue;   // ended before this tile
      const int rs = max(rs0, base), re = min(re0, end);
      // partial 0: runs in from the tile before; 1: runs past this one's end
      float* out = rs0 < base  ? partials + (size_t)tile * 2 * H
                   : re0 > end ? partials + ((size_t)tile * 2 + 1) * H
                               : agg + (size_t)n * H;
      for (int c = lane; c < H; c += 32) {
        float acc = 0.f;
        for (int s = rs; s < re; ++s) acc = fmaf(z[(size_t)(s - base) * H + c], f.inv[s - base], acc);
        out[c] = acc;
      }
    }
    __syncthreads();
  }
}

// (c) agg[n] for the node cut at the end of tile u where it starts: partial
// 1 of u, then partial 0 of u + 1 .. its last tile, in tile order
__global__ void any_fixup_kernel(const int* __restrict__ rowptr, const int* __restrict__ tile_lo,
                                 const float* __restrict__ partials, float* __restrict__ agg,
                                 int n_nodes, int H) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int u = (int)(i / H), j = (int)(i % H);
  const int n_real = rowptr[n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + kBM - 1) / kBM : 1;
  if (u >= n_tiles - 1) return;             // the last tile cuts no node
  const int base = u * kBM, end = base + kBM;
  const int n = tile_lo[u + 1] - 1;         // the last node starting before `end`
  if (n < 0) return;
  const int rs0 = rowptr[n], re0 = rowptr[n + 1];
  if (rs0 < base || re0 <= end) return;     // not started here, or not cut
  float acc = partials[((size_t)u * 2 + 1) * H + j];
  const int last = (re0 - 1) / kBM;
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

// sum of v(r) over the tile's kBM rows in a fixed order: 8 runs of 8,
// then the runs' sums (blocked, as block_gemm sums its K chunks)
template <class F>
__device__ __forceinline__ float tile_sum(F v) {
  float s = 0.f;
  for (int r0 = 0; r0 < kBM; r0 += 8) {
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
  const Fields f = fields_at(stage + stage_floats(NT));
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_real = rowptr[n_nodes];
  const int n_tiles = (n_real + kBM - 1) / kBM;
  const float inv_h = 1.f / H;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kBM, end = min(base + kBM, n_real);
    stage_fields(f, perm, src, rowptr, slot_dst, emask, einv, base, end, 0, 0);
    forward_rows<NT>(x, e, f, w0, b0, wrest, brest, H, lp,
                     [&](int l) { return A + l * sl; }, Z, stage);
    // g_h = (g_e' + g_agg[dst] / d) * mask, and the LayerNorm's backward, a
    // warp per row: Z <- g_h, G1 <- x-hat, G0 <- the gradient of z_Lp
    for (int r = warp; r < kBM; r += kWarps) {
      float* zr = Z + (size_t)r * H;
      float* xr = G1 + (size_t)r * H;
      float* gr = G0 + (size_t)r * H;
      const int eid = f.eid[r], d = f.dst[r];
      const float m = f.m[r], iv = f.inv[r];
      auto gh_at = [&](int c) {
        return eid >= 0 ? fmaf(__ldg(gagg + (size_t)d * H + c), iv,
                               __ldg(genew + (size_t)eid * H + c)) * m
                        : 0.f;
      };
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

// the n-tiles per warp for width H: 16 NT columns per product chunk
inline int nt_for(int H) { return H <= 16 ? 1 : H <= 32 ? 2 : H <= 64 ? 4 : 8; }

struct Plan {
  int grid, per_sm, work_smem, tiles;
  size_t smem;
  long long work;   // floats of global work scratch per block (0: in shared memory)
};

// the launch of `kern` with `base` bytes of shared memory plus `slabs`
// bytes of slabs where they fit in shared memory, over `tiles` tiles
template <class K>
cudaError_t plan_kernel(K kern, size_t base, size_t slabs, long long tiles, Plan* p) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((size_t)optin < base) return cudaErrorInvalidValue;
  p->work_smem = base + slabs <= (size_t)optin;
  p->smem = base + (p->work_smem ? slabs : 0);
  p->work = p->work_smem ? 0 : (long long)(slabs / sizeof(float));
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, p->smem);
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
  return H >= 1 && lp >= 0 && n_slots >= 0 && n_slots <= (1LL << 31) - kBM &&
         (long long)kBM * H * (lp + 3) < (1LL << 31);
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
                                                            n_nodes);
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
      hidden);
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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
