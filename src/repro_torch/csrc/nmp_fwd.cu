// Fused NMP forward (Eq. 4a + 4b) for NVIDIA Hopper (sm_90a), fp32
// operands, 3xTF32 tensor-core products (precision="bf16" runs
// csrc/nmp_bf16.cu).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_agg/kernel.py::nmp_edge_mlp_agg_fwd
// (body _nmp_fwd_kernel, helpers _gather_rows / _edge_mlp_tile /
// _scatter_add_rows).  For every real edge (i <- j) of one rank:
//   e'_ij = (e_ij + LN(MLP([x_j_src, x_i_dst, e_ij]))) * mask_ij
//   agg_i = sum_j e'_ij * (1 / d_ij)
// MLP: dense(3H -> H), then n_hidden x (ELU, dense(H -> H)), then an
// optional LayerNorm (biased variance, eps 1e-5).
//
// What bounds it on the H100 SXM (published peaks at its 700 W limit): at
// H=32 with 5 hidden layers an edge costs 2 * (2H*H + 5*H*H) = 14,336 FLOP
// of fp32 FMA (the x_dst slice of layer 0 counted once per node) against
// ~280 bytes of traffic, ~50 FLOP/byte, above the fp32 CUDA-core ridge of
// 20 FLOP/byte.  So, as in csrc/nmp_bwd.cu, the products run on the tensor
// cores in 3xTF32 (csrc/nmp_tf32.cuh), whose bound (3x the FLOP at 495
// TFLOP/s) lies below the bytes' (3.35 TB/s).
//
// Design (the TPU kernel runs the MLP as tile products on [BE, H] row tiles
// of a sequential grid; blocks here run in no order, and the result must be
// bitwise repeatable with no float atomics and whatever the grid):
//   (a) tile_lo: for each tile of kRows = 128 consecutive dst-sorted slots,
//       the first node whose run of slots starts in it or later
//       (lower_bound of rowptr), one writer per tile.  A node belongs to the
//       tile in which its run starts; the last tile also owns the nodes of
//       degree 0 after the last slot.
//   (b) edge pass: a persistent block holds the weights once, split into
//       TF32 hi and lo parts as they are loaded (so a B fragment is one
//       16-byte load and no split), and runs two groups of 8 warps that
//       walk their own tiles (tile 2b + group, then + 2 * grid, ...) and
//       meet only at their own named barrier: while one group waits on its
//       copies, the other keeps the tensor cores busy.  Per tile a group
//       takes the slots' destinations from the nodes' runs (rowptr, read a
//       tile ahead into registers with the tile's perm / src / tile_lo),
//       and stages the [x_src | x_dst | e] rows and each slot's mask and
//       1/d in shared memory by cp.async (padding rows zeroed).  Each warp
//       owns 16 rows: it runs layer 0 as a [16 x 3H] x [3H x H] product and
//       each hidden layer as [16 x H] x [H x H] (ELU between, through a
//       per-warp slab), the LayerNorm in registers (row statistics by two
//       lane shuffles: a row's H features sit on the 4 lanes of one mma row
//       group), and e' = (e + h) * mask, which it writes to the edge's
//       original position (perm) for real slots only and keeps in the slab.
//       Then the group sums e' * (1/d) per node in slot order: a node whose
//       run lies inside the tile gets its agg row from this one writer; the
//       parts of a node cut by a tile edge go to the tile's two partial rows
//       (0: the node running in from the tile before, 1: the node starting
//       here and running past the tile's end).
//   (c) fix-up: each node cut at the end of the tile where it starts gets
//       agg = partial 1 of that tile + partial 0 of each later tile it
//       covers, in tile order (any degree: a run may span many tiles).
//   (d) e' = 0 on the edges outside the layout: the edge pass marks each
//       edge it writes in a byte map, and a last pass writes zeros where no
//       mark is (on the serving mesh every edge is in the layout; zero-filling
//       all of e' in the wrapper cost 0.17 ms, 8% of a call).
// Every agg row has one writer and a fixed order: two launches are bitwise
// equal, for any grid.  Shared memory per block at H=32, Lp=5: 227,328 B
// (pre-split weights 69,632; per group the staged rows 53,248, the e' slab
// 20,480 and 4,608 of per-slot fields and cached runs), so one block of 16
// warps per SM.  On the H100 (before (d)) it ran 2.14 ms where two blocks of
// 8 warps, each with its own weights split per fragment, ran 2.38, and
// staging the next tile while this one is computed (one block of 8 warps)
// 3.07 against 2.45.  Row strides of 8 mod 32 floats make the 8-byte A
// loads and the 16-byte B loads free of bank conflicts.  Hidden layers
// whose weights do not fit in shared memory are read from global memory
// (L1 / L2) and split per fragment, so any n_hidden >= 0 runs.
//
// Scratch the wrapper allocates: tile_lo (tiles + 1 int32), the partial
// rows (tiles x 2 x H fp32), tiles = ceil(slots / 128), and the byte map
// (one per edge).  C entry points return cudaGetLastError();
// nmp_edge_mlp_agg_fwd_plan reports the launch.
#include "nmp_tf32.cuh"

namespace {

constexpr int kWarps = 8;             // warps per group
constexpr int kRows = 16 * kWarps;    // slots per tile: 16 rows per warp
constexpr int kGroups = 2;            // groups per block, each on its own tiles
constexpr int kThreads = kGroups * kWarps * 32;
constexpr int kMeta = 5;              // per-slot fields staged per tile

// row strides of 8 mod 32 floats: 8-byte fragment loads of A (row g,
// columns 2t, 2t + 1) hit 32 distinct banks per half warp
__host__ __device__ constexpr int pad8(int w) { return w + ((8 - w) % 32 + 32) % 32; }

template <int H>
struct Cfg {
  static constexpr int NT = H / 8;          // n-tiles of 8 output features
  static constexpr int SX = pad8(3 * H);    // staged-row stride (floats)
  static constexpr int SA = pad8(H);        // activation / e' slab stride
  static constexpr int RS = 4 * H + 8;      // pre-split weight row-pair stride
  static constexpr int CH = H / 4;          // 16-byte chunks per H-row
};

// 4-byte words of a group: a tile's stage (the staged rows, kMeta fields
// per slot and the node walk's cached runs) and the e' slab
__host__ __device__ constexpr int group_words(int h) {
  return kRows * pad8(3 * h) + kMeta * kRows + 2 * kWarps * 32 + kRows * pad8(h);
}

// 4-byte words of the weights of layer 0 and of `lps` hidden layers,
// pre-split (H/2 row pairs of RS floats per H input rows)
__host__ __device__ inline int weight_words(int h, int lps) {
  return (3 * h + lps * h) / 2 * (4 * h + 8);
}

// floats of shared memory: the weights with their biases, LayerNorm, and
// the groups
__host__ __device__ inline int smem_floats(int h, int lps) {
  return weight_words(h, lps) + (1 + lps) * h + 2 * h + kGroups * group_words(h);
}

// w [rows][H] -> wp [rows / 2][RS]: for the row pair (2p, 2p + 1) and
// column n the float4 (hi 2p, hi 2p + 1, lo 2p, lo 2p + 1) of the TF32
// split, so one 16-byte load gives a lane both B values of a k-step
template <int H>
__device__ void presplit(float* wp, const float* w, int rows) {
  for (int i = threadIdx.x; i < rows / 2 * H; i += blockDim.x) {
    const int p = i / H, n = i % H;
    uint32_t h0, l0, h1, l1;
    split(w[(2 * p) * H + n], h0, l0);
    split(w[(2 * p + 1) * H + n], h1, l1);
    *reinterpret_cast<float4*>(wp + p * Cfg<H>::RS + n * 4) =
        make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                    __uint_as_float(l1));
  }
}

// warp_mm with A read from a row-major slab (8-byte loads of the k pair
// 2t, 2t + 1) and B from pre-split weights (one 16-byte load per n-tile)
template <int NT, int KS, int H>
__device__ __forceinline__ void warp_mm_ps(float (&c)[NT][4], const float* A, int lda,
                                           const float* Bp, int g, int t) {
  float small[NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = ks * 8;
    const float2 u = *reinterpret_cast<const float2*>(A + g * lda + k0 + 2 * t);
    const float2 v = *reinterpret_cast<const float2*>(A + (g + 8) * lda + k0 + 2 * t);
    uint32_t ah[4], al[4];
    split(u.x, ah[0], al[0]);
    split(v.x, ah[1], al[1]);
    split(u.y, ah[2], al[2]);
    split(v.y, ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 b =
          *reinterpret_cast<const float4*>(Bp + (ks * 4 + t) * Cfg<H>::RS + (nt * 8 + g) * 4);
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
      mma_tf32(small[nt], al, bh0, bh1);
      mma_tf32(small[nt], ah, bl0, bl1);
      mma_tf32(c[nt], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[nt][j] += small[nt][j];
}

// barrier of one group's 256 threads (0 is __syncthreads')
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(kWarps * 32) : "memory");
}

// (a) tile_lo[b] = the least n with rowptr[n] >= b * kRows, b < n_tiles;
// tile_lo[n_tiles] = n_nodes.  Thread n writes the tiles b with
// rowptr[n - 1] < b * kRows <= rowptr[n]: one writer each.
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

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
nmp_fwd_tile_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    const int* __restrict__ perm, const int* __restrict__ src,
                    const int* __restrict__ rowptr, const int* __restrict__ tile_lo,
                    const float* __restrict__ emask, const float* __restrict__ einv,
                    const float* __restrict__ w0, const float* __restrict__ b0,
                    const float* __restrict__ wrest, const float* __restrict__ brest,
                    const float* __restrict__ lng, const float* __restrict__ lnb,
                    float* __restrict__ e_new, float* __restrict__ agg,
                    float* __restrict__ partials, uint8_t* __restrict__ covered,
                    int n_nodes, int n_hidden, int lps, int has_ln) {
  using C = Cfg<H>;
  constexpr int NT = C::NT, SX = C::SX, SA = C::SA, RS = C::RS, CH = C::CH;
  constexpr int LW = H / 2 * RS;            // one hidden layer's pre-split weight words
  extern __shared__ __align__(16) float smem[];
  float* s_w0 = smem;                       // layer 0: [3H/2][RS]
  float* s_wr = s_w0 + weight_words(H, 0);  // [lps][LW]
  float* s_b0 = s_wr + lps * LW;            // [H]
  float* s_br = s_b0 + H;                   // [lps][H]
  float* s_lg = s_br + lps * H;             // [H]
  float* s_lb = s_lg + H;                   // [H]
  const int grp = threadIdx.x / (kWarps * 32);
  float* s_x = s_lb + H + grp * group_words(H);   // the group's stage: [kRows][SX]
                                            // x_src | x_dst | e, then the fields below
  float* s_a = s_x + kRows * SX + kMeta * kRows + 2 * kWarps * 32;  // [kRows][SA]: ELU(z), e'
  int* s_eid = reinterpret_cast<int*>(s_x + kRows * SX);   // [kRows], -1: padding
  int* s_src = s_eid + kRows;
  int* s_dst = s_src + kRows;
  float* s_m = reinterpret_cast<float*>(s_dst + kRows);
  float* s_inv = s_m + kRows;
  int* s_run = reinterpret_cast<int*>(s_inv + kRows);     // [kWarps * 32][2]

  presplit<H>(s_w0, w0, 3 * H);
  for (int l = 0; l < lps; ++l) presplit<H>(s_wr + l * LW, wrest + (size_t)l * H * H, H);
  for (int i = threadIdx.x; i < lps * H; i += blockDim.x) s_br[i] = brest[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    s_b0[i] = b0[i];
    s_lg[i] = lng[i];
    s_lb[i] = lnb[i];
  }

  __syncthreads();
  const int tid = threadIdx.x % (kWarps * 32);   // within the group
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;                 // the warp's first row in a tile
  const int n_real = rowptr[n_nodes];
  const int n_tiles = n_real > 0 ? (n_real + kRows - 1) / kRows : 1;

  // the next tile's indices, loaded into registers while this one is
  // computed: (a) its slots' edge ids and sources and its node bounds,
  // (b) the run of this thread's first node in its node walk
  int pf_eid = -1, pf_src = 0, pf_lo = 0, pf_hi = 0, pf_rs = 0, pf_re = 0;
  auto prefetch_a = [&](int tile) {
    if (tile >= n_tiles) return;
    const int slot = tile * kRows + tid;
    pf_eid = -1;
    if (tid < kRows && slot < n_real) {
      pf_eid = perm[slot];
      pf_src = src[slot];
    }
    pf_lo = tile_lo[tile];
    pf_hi = tile_lo[tile + 1];
  };
  const int first_tile = blockIdx.x * kGroups + grp, stride = gridDim.x * kGroups;
  auto prefetch_b = [&]() {
    const int n = max(pf_lo - 1, 0) + tid;
    if (n < pf_hi) {
      pf_rs = rowptr[n];
      pf_re = rowptr[n + 1];
    }
  };

  prefetch_a(first_tile);
  prefetch_b();
  for (int tile = first_tile; tile < n_tiles; tile += stride) {
    // --- stage the tile: the slots' nodes, then the rows and fields by
    //     cp.async, then the next tile's indices are requested ---
    const int base = tile * kRows;
    const int end = min(base + kRows, n_real);
    const int lo = pf_lo, hi = pf_hi;
    const int n0 = max(lo - 1, 0);          // the node walk's first node
    if (tid < kRows) {
      s_eid[tid] = pf_eid;
      s_src[tid] = pf_src;
    }
    // the slots' destinations: the nodes from the one holding slot `base`
    // (at most lo - 1) to the last one starting before `end` (hi - 1)
    for (int n = n0 + tid; n < hi; n += kWarps * 32) {
      const bool first = n - n0 < kWarps * 32;
      const int rs0 = first ? pf_rs : rowptr[n], re0 = first ? pf_re : rowptr[n + 1];
      if (first) {
        s_run[2 * tid] = rs0;
        s_run[2 * tid + 1] = re0;
      }
      for (int s = max(rs0, base); s < min(re0, end); ++s) s_dst[s - base] = n;
    }
    group_sync(grp);
    if (tid < kRows) {
      const int eid = s_eid[tid];
      if (eid >= 0) {
        cp_async4(s_m + tid, emask + eid);
        cp_async4(s_inv + tid, einv + eid);
      } else {
        s_m[tid] = 0.f;
        s_inv[tid] = 0.f;
      }
    }
    for (int i = tid; i < kRows * 3 * CH; i += kWarps * 32) {
      const int r = i / (3 * CH);
      const int q = i - r * 3 * CH;
      const int part = q / CH;              // 0: x_src, 1: x_dst, 2: e
      float* to = s_x + r * SX + part * H + (q - part * CH) * 4;
      const int eid = s_eid[r];
      if (eid < 0) {
        *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      const float* row = part == 0 ? x + (size_t)s_src[r] * H
                       : part == 1 ? x + (size_t)s_dst[r] * H
                                   : e + (size_t)eid * H;
      cp_async16(to, row + (q - part * CH) * 4);
    }
    prefetch_a(tile + stride);
    cp_async_wait_all();
    group_sync(grp);

    // --- the MLP on the warp's 16 rows ---
    const float* xw = s_x + r0 * SX;
    float* aw = s_a + r0 * SA;
    float z[NT][4];
    init_bias<NT>(z, s_b0, t);
    warp_mm_ps<NT, 3 * H / 8, H>(z, xw, SX, s_w0, g, t);
    for (int l = 0; l < n_hidden; ++l) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[nt][j] = elu(z[nt][j]);
      __syncwarp();                         // the slab's last reads are done
      store_c<NT>(aw, SA, z, g, t);
      __syncwarp();
      if (l < lps) {
        init_bias<NT>(z, s_br + l * H, t);
        warp_mm_ps<NT, H / 8, H>(z, aw, SA, s_wr + l * LW, g, t);
      } else {                              // weights past shared memory
        auto a = [&](int r, int k) { return aw[r * SA + k]; };
        const float* w = wrest + (size_t)l * H * H;
        auto b = [&](int k, int n) { return __ldg(w + k * H + n); };
        init_bias<NT>(z, brest + (size_t)l * H, t);
        warp_mm<NT, H / 8, true>(z, a, b, g, t);
      }
    }
    if (has_ln) {
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
    // e' = (e + h) * mask into the slab, then out to the original positions
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = g + 8 * h2;
      const float m = s_m[r0 + r];            // 0 on padding rows
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 ev =
            *reinterpret_cast<const float2*>(xw + r * SX + 2 * H + nt * 8 + 2 * t);
        z[nt][2 * h2] = (ev.x + z[nt][2 * h2]) * m;
        z[nt][2 * h2 + 1] = (ev.y + z[nt][2 * h2 + 1]) * m;
      }
    }
    __syncwarp();
    store_c<NT>(aw, SA, z, g, t);
    __syncwarp();
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = (i - r * CH) * 4;
      const int eid = s_eid[r0 + r];
      if (eid < 0) continue;
      *reinterpret_cast<float4*>(e_new + (size_t)eid * H + c) =
          *reinterpret_cast<const float4*>(aw + r * SA + c);
      if (c == 0) covered[eid] = 1;
    }
    prefetch_b();
    group_sync(grp);

    // --- agg: per node, e' * (1/d) summed in slot order, four features a
    //     thread (a tile may own thousands of nodes with no slot here) ---
    {
      const int j = (tid % CH) * 4;
      for (int n = n0 + tid / CH; n < hi; n += kWarps * 32 / CH) {
        const bool cached = n - n0 < kWarps * 32;
        const int rs0 = cached ? s_run[2 * (n - n0)] : rowptr[n];
        const int re0 = cached ? s_run[2 * (n - n0) + 1] : rowptr[n + 1];
        if (rs0 < base && re0 <= base) continue;   // ended before this tile
        const int rs = max(rs0, base), re = min(re0, end);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = rs; s < re; ++s) {
          const float4 a = *reinterpret_cast<const float4*>(s_a + (s - base) * SA + j);
          const float w = s_inv[s - base];
          acc.x = fmaf(a.x, w, acc.x);
          acc.y = fmaf(a.y, w, acc.y);
          acc.z = fmaf(a.z, w, acc.z);
          acc.w = fmaf(a.w, w, acc.w);
        }
        // partial 0: runs in from the tile before; 1: runs past this one's end
        float* out = rs0 < base  ? partials + (size_t)tile * 2 * H
                     : re0 > end ? partials + ((size_t)tile * 2 + 1) * H
                                 : agg + (size_t)n * H;
        *reinterpret_cast<float4*>(out + j) = acc;
      }
    }
    group_sync(grp);
  }
}

// (c) agg[n] for the node cut at the end of tile u where it starts: partial
// 1 of u, then partial 0 of u + 1 .. its last tile, in tile order
template <int H>
__global__ void nmp_fwd_fixup_kernel(const int* __restrict__ rowptr,
                                     const int* __restrict__ tile_lo,
                                     const float* __restrict__ partials, float* __restrict__ agg,
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
  agg[(size_t)n * H + j] = acc;
}

// (d) e' = 0 on the edges the layout does not hold (no slot wrote them):
// one 16-byte chunk a thread, consecutive threads on consecutive chunks
template <int H>
__global__ void nmp_fwd_zero_kernel(const uint8_t* __restrict__ covered,
                                    float* __restrict__ e_new, long long n_edges) {
  constexpr int CH = H / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_edges * CH || covered[i / CH]) return;
  reinterpret_cast<float4*>(e_new)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

struct LaunchPlan {
  int grid, per_sm, lps, tiles;
  size_t smem;
};

template <int H>
cudaError_t plan_launch(int n_hidden, long long n_slots, LaunchPlan* p) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // as many hidden layers' weights in shared memory as fit
  const size_t fixed = sizeof(float) * smem_floats(H, 0);
  const size_t per_layer = sizeof(float) * (weight_words(H, 1) - weight_words(H, 0) + H);
  if ((size_t)optin < fixed) return cudaErrorInvalidValue;
  const long long fit = (long long)(((size_t)optin - fixed) / per_layer);
  const int lps = (int)(n_hidden < fit ? n_hidden : fit);
  const size_t smem = sizeof(float) * smem_floats(H, lps);
  auto kern = nmp_fwd_tile_kernel<H>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  long long tiles = (n_slots + kRows - 1) / kRows;
  if (tiles < 1) tiles = 1;
  const long long need = (tiles + kGroups - 1) / kGroups;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  p->grid = (int)(need < cap ? need : cap);
  p->per_sm = per_sm;
  p->lps = lps;
  p->tiles = (int)tiles;
  p->smem = smem;
  return cudaSuccess;
}

cudaError_t plan_for(int hidden, int n_hidden, long long n_slots, LaunchPlan* p) {
  if (n_hidden < 0 || n_slots < 0 || n_slots > (1LL << 31) - kRows)
    return cudaErrorInvalidValue;
  switch (hidden) {
    case 8: return plan_launch<8>(n_hidden, n_slots, p);
    case 16: return plan_launch<16>(n_hidden, n_slots, p);
    case 32: return plan_launch<32>(n_hidden, n_slots, p);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int fwd_plan(int hidden, int n_hidden, long long n_slots, int* plan) {
  LaunchPlan p;
  cudaError_t err = plan_for(hidden, n_hidden, n_slots, &p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.grid;
  plan[1] = (int)p.smem;
  plan[2] = p.per_sm;
  plan[3] = p.lps;
  plan[4] = p.tiles;
  return 0;
}

int fwd_launch(const void* x, const void* e, const void* perm, const void* src,
               const void* rowptr, const void* emask, const void* einv, const void* w0,
               const void* b0, const void* wrest, const void* brest, const void* lng,
               const void* lnb, void* e_new, void* agg, void* tile_lo, void* partials,
               void* covered, int n_nodes, long long n_slots, long long n_edges, int hidden,
               int n_hidden, int has_ln, void* stream) {
  LaunchPlan p;
  cudaError_t err = plan_for(hidden, n_hidden, n_slots, &p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_nodes <= 0)                         // no node: no edge in the layout
    return (int)cudaMemsetAsync(e_new, 0, (size_t)n_edges * hidden * sizeof(float), st);
  // 16-byte row copies (x, e) and stores (e', agg, partials)
  if (!aligned16(x) || !aligned16(e) || !aligned16(e_new) || !aligned16(agg) ||
      !aligned16(partials))
    return (int)cudaErrorMisalignedAddress;
  err = cudaMemsetAsync(covered, 0, (size_t)n_edges, st);
  if (err != cudaSuccess) return (int)err;
  tile_lo_kernel<<<(n_nodes + 256) / 256, 256, 0, st>>>((const int*)rowptr, (int*)tile_lo,
                                                        n_nodes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define EDGE_ARGS                                                                       \
  (const float*)x, (const float*)e, (const int*)perm, (const int*)src,                 \
      (const int*)rowptr, (const int*)tile_lo, (const float*)emask, (const float*)einv, \
      (const float*)w0, (const float*)b0, (const float*)wrest, (const float*)brest,    \
      (const float*)lng, (const float*)lnb, (float*)e_new, (float*)agg,                \
      (float*)partials, (uint8_t*)covered, n_nodes, n_hidden, p.lps, has_ln
  switch (hidden) {
    case 8: nmp_fwd_tile_kernel<8><<<p.grid, kThreads, p.smem, st>>>(EDGE_ARGS); break;
    case 16: nmp_fwd_tile_kernel<16><<<p.grid, kThreads, p.smem, st>>>(EDGE_ARGS); break;
    case 32: nmp_fwd_tile_kernel<32><<<p.grid, kThreads, p.smem, st>>>(EDGE_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef EDGE_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = kWarps * 32;
  const int per_block = threads / hidden;   // tiles per fix-up block
  const int grid = (p.tiles + per_block - 1) / per_block;
#define FIX_ARGS \
  (const int*)rowptr, (const int*)tile_lo, (const float*)partials, (float*)agg, n_nodes
  switch (hidden) {
    case 8: nmp_fwd_fixup_kernel<8><<<grid, threads, 0, st>>>(FIX_ARGS); break;
    case 16: nmp_fwd_fixup_kernel<16><<<grid, threads, 0, st>>>(FIX_ARGS); break;
    case 32: nmp_fwd_fixup_kernel<32><<<grid, threads, 0, st>>>(FIX_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FIX_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_edges > 0) {
    const int zgrid = (int)((n_edges * (hidden / 4) + threads - 1) / threads);
#define ZERO_ARGS (const uint8_t*)covered, (float*)e_new, n_edges
    switch (hidden) {
      case 8: nmp_fwd_zero_kernel<8><<<zgrid, threads, 0, st>>>(ZERO_ARGS); break;
      case 16: nmp_fwd_zero_kernel<16><<<zgrid, threads, 0, st>>>(ZERO_ARGS); break;
      case 32: nmp_fwd_zero_kernel<32><<<zgrid, threads, 0, st>>>(ZERO_ARGS); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef ZERO_ARGS
  }
  return (int)cudaGetLastError();
}

}  // namespace

// plan[0..4] = the edge pass's grid, its dynamic shared memory per block in
// bytes, its resident blocks per SM (occupancy API), the hidden layers whose
// weights sit in shared memory, and the tiles the scratch must hold
// (tile_lo: tiles + 1 int32, partials: tiles x 2 x H fp32)
extern "C" int nmp_edge_mlp_agg_fwd_plan(int hidden, int n_hidden, long long n_slots,
                                         int* plan) {
  return fwd_plan(hidden, n_hidden, n_slots, plan);
}

#define FWD_PARAMS                                                                         \
  const void *x, const void *e, const void *perm, const void *src, const void *rowptr,     \
      const void *emask, const void *einv, const void *w0, const void *b0,                 \
      const void *wrest, const void *brest, const void *lng, const void *lnb, void *e_new, \
      void *agg, void *tile_lo, void *partials, void *covered, int n_nodes,                \
      long long n_slots, long long n_edges, int hidden, int n_hidden, int has_ln,          \
      void *stream
#define FWD_ARGS                                                                          \
  x, e, perm, src, rowptr, emask, einv, w0, b0, wrest, brest, lng, lnb, e_new, agg,      \
      tile_lo, partials, covered, n_nodes, n_slots, n_edges, hidden, n_hidden, has_ln, \
      stream

extern "C" int nmp_edge_mlp_agg_fwd_f32(FWD_PARAMS) { return fwd_launch(FWD_ARGS); }

#undef FWD_PARAMS
#undef FWD_ARGS

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
