// Fused NMP backward (VJP of Eq. 4a + 4b) for NVIDIA Hopper (sm_90a), fp32
// operands, 3xTF32 tensor-core products (precision="bf16" runs
// csrc/nmp_bf16.cu).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_agg/kernel.py::nmp_edge_mlp_agg_bwd
// (body _nmp_bwd_kernel).  For every real edge (i <- j) it recomputes the
// forward of csrc/nmp_fwd.cu
//   z_0 = [x_src, x_dst, e] w0 + b0,  z_{l+1} = ELU(z_l) wrest_l + brest_l,
//   h = LN(z_Lp) (biased variance, eps 1e-5),  e' = (e + h) * mask
// and back-propagates the cotangent
//   g_e' = (g_enew + g_agg[dst] * (1/d_ij)) * mask
// through the LayerNorm, the Lp hidden layers (ELU derivative) and the
// three H-slices of w0.  Outputs: g_e in the original edge order (0 on
// edges outside the layout), g_x = sum over slots with src = n of g_x_src
// plus sum over slots with dst = n of g_x_dst, and the weight gradients
// summed over all edges (one flat buffer: w0, b0, wrest, brest, lng, lnb).
//
// What bounds it on the H100 SXM (published peaks at its 700 W limit):
// arithmetic.  Per edge 3 x 2 (2H*H + Lp*H*H) FLOP (recompute, input
// gradients, weight gradients; the x_dst slice of layer 0 counted once per
// node), 43,008 FLOP at H=32, Lp=5, against ~400 bytes of edge traffic:
// ~100 FLOP/byte, far above the fp32 ridge of 20 FLOP/byte.  So the work
// goes to the tensor cores, in 3xTF32: each fp32 operand is split into a
// TF32 high part and the remainder, and every product is lo*hi + hi*lo +
// hi*hi through mma.sync.m16n8k8.tf32 into fp32 accumulators.  That keeps
// ~21 bits of each operand (plain 1xTF32 keeps 11 and is not fp32: the
// parity runs keep TF32 off); measured against a float64 VJP the kernel's
// errors are those of the plain fp32 version or smaller.  Its bound is 3x
// the fp32 FLOP at 495 TFLOP/s, 2.5x below the fp32 CUDA-core bound, which
// a register-blocked fp32 SIMT product would be held to.  The splits run
// on the integer and FP32 pipes (with cvt.rna.tf32 the conversions took a
// third of the kernel's time on the H100).
//
// Design (the TPU kernel carries node- and weight-gradient scratch across
// a sequential grid; blocks here run in no order, and the result must be
// bitwise repeatable with no float atomics):
//   (a) slot_dst: each slot's destination node from rowptr (one writer
//       per slot).
//   (b) edge pass: a persistent block of 8 warps walks tiles of 128
//       consecutive dst-sorted slots (tile b, b + grid, ...).  Per tile the
//       [x_src | x_dst | e] rows are staged in shared memory by cp.async
//       (padding rows zeroed).  Each warp owns 16 rows: it recomputes the
//       forward as [16 x K] x [K x H] tile products (ELU activations kept
//       in shared memory, one slab per hidden layer), forms the cotangent
//       and the LayerNorm backward in registers (row statistics by two
//       lane shuffles: a row's H features sit on the 4 lanes of one mma
//       row group), and walks the hidden layers down with the same product
//       on the transposed weights.  Each layer's weight gradient A_l^T G_l
//       is a product over the tile's 128 rows, split among the warps by
//       output tile (n-tile, m-tile); each tile's product is summed in
//       fresh fragments and added, once per tile, to accumulators kept in
//       registers across all of the block's tiles (the tensor cores'
//       accumulation does not round to nearest: carried through a block's
//       ~33,000 rows it lost 2e-4 of the weight gradients).  The bias and
//       LayerNorm gradients are column sums kept per lane.  Per slot it
//       writes g_e (= g_h + g_z0 w0_e^T) to the edge's original position
//       and the layer-0 pre-activation gradient g_z0 to a per-slot scratch
//       row.  At the end each block writes its partial weight gradients,
//       one writer per element, to a partials row.
//   (c) a fixed-order reduction of the partials rows (block 0, 1, ...).
//   (d) node pass: g_x[n] = (sum of g_z0 over n's dst slots, rowptr order)
//       w0_dst^T + (sum over n's src slots, src_slots order) w0_src^T — the
//       x slices of layer 0 factor through these per-node sums, so a node
//       whose slots span tiles or blocks gets one fixed-order sum.
// Every sum has one writer and a fixed order: two launches are bitwise
// equal.  Shared memory per block: weights (3H + Lp*H rows of H + 4) and
// biases, the staged rows (128 x (3H + 4)), Lp activation slabs and 2
// gradient slabs (128 x (H + 4) each) and 5 x 128 slot fields: 220,672
// bytes at H=32, Lp=5, so one block (8 warps) per SM; with 4 warps and
// 64-slot tiles (129,280 bytes, still one block per SM) it ran 1.9x
// slower on the H100.  Row strides of 4 mod 32 floats keep the row-major fragment
// reads free of bank conflicts, and pairing each k-step's rows (2t, 2t + 1)
// does the same for the transposed ones.  Scratch the wrapper allocates:
// g_z0 per slot (slots x H fp32) and slot_dst (slots int32); partials
// (grid x weight-gradient floats).
//
// C entry points return cudaGetLastError(); nmp_edge_mlp_agg_bwd_plan
// reports how many partial rows the wrapper must allocate.
#include "nmp_tf32.cuh"

namespace {

constexpr int kWarps = 8;             // warps per edge-pass block
constexpr int kRows = 16 * kWarps;    // slots per tile: 16 rows per warp
constexpr int kMaxHidden = 5;         // hidden layers the accumulators hold
constexpr int kMeta = 5;              // per-slot fields staged per tile

template <int H>
struct Cfg {
  static constexpr int NT = H / 8;               // n-tiles of 8 output features
  static constexpr int SX = 3 * H + 4;           // staged-row stride (floats)
  static constexpr int SA = H + 4;               // activation / gradient slab stride
  static constexpr int SW = H + 4;               // weight row stride
  static constexpr int MS = kWarps / NT;         // warps per n-tile in the weight grads
  static constexpr int M0T = (3 * H + 15) / 16;  // m-tiles over w0's 3H input rows
  static constexpr int MHT = (H + 15) / 16;      // m-tiles over a hidden layer's H rows
  static constexpr int CW0 = (M0T + MS - 1) / MS;  // w0 m-tiles per warp, at most
  static constexpr int CWH = (MHT + MS - 1) / MS;  // hidden m-tiles per warp, at most
};

__host__ __device__ inline int wgrad_size(int h, int lp) {
  return 3 * h * h + h + lp * h * h + lp * h + 2 * h;
}

__host__ __device__ inline int smem_floats(int h, int n_hidden) {
  const int sw = h + 4, sa = h + 4, sx = 3 * h + 4;
  return (3 * h + n_hidden * h) * sw + (3 + n_hidden) * h + kRows * sx +
         (n_hidden + 2) * kRows * sa + kMeta * kRows;
}

// ELU'(z) from a = ELU(z): 1 where z > 0 (a > 0), exp(z) = a + 1 elsewhere
__device__ __forceinline__ float elu_grad(float a) { return a > 0.f ? 1.f : a + 1.f; }

// (a) slot_dst[s] = n for n's dst-sorted slots rowptr[n] .. rowptr[n + 1]
__global__ void slot_dst_kernel(const int* __restrict__ rowptr, int* __restrict__ slot_dst,
                                int n_nodes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  for (int s = rowptr[n]; s < rowptr[n + 1]; ++s) slot_dst[s] = n;
}

// One weight-gradient product over the tile: for each of the CM m-tiles
// mt[i] (skipped when >= m_tiles) acc[i] += act^T[16 rows of features
// from 16 mt[i]] x G[tile rows][8 features from n0], act(k, m) the tile
// row k's feature m (0 for m >= m_lim).  With BIAS, bias += the column sum
// of G at feature n0 + g over this lane's rows (2t, 2t + 1 of each k-step:
// the pair permutation of warp_mm, so the transposed reads of act and the
// reads of G are free of bank conflicts).
// The tile's product is summed in fresh fragments, the hi * hi terms apart
// from the two cross terms, and added to acc once per tile in fp32: the
// tensor cores' accumulation does not round to nearest, and a fragment
// carried through a block's ~33,000 rows lost ~2e-4 of its value that way.
template <int CM, bool BIAS, int SA, class FA>
__device__ __forceinline__ void wgrad(float (&acc)[CM][4], const int (&mt)[CM], int m_tiles,
                                      int m_lim, FA act, const float* G, int n0, float& bias,
                                      int g, int t) {
  float big[CM][4] = {}, small[CM][4] = {};
  float bsum = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < kRows; k0 += 8) {
    const int ka = k0 + 2 * t, kb = ka + 1;
    const float b0 = G[ka * SA + n0 + g];
    const float b1 = G[kb * SA + n0 + g];
    if (BIAS) bsum += b0 + b1;
    uint32_t bh0, bl0, bh1, bl1;
    split(b0, bh0, bl0);
    split(b1, bh1, bl1);
#pragma unroll
    for (int i = 0; i < CM; ++i) {
      if (mt[i] >= m_tiles) continue;
      const int m = mt[i] * 16 + g;
      uint32_t ah[4], al[4];
      split(m < m_lim ? act(ka, m) : 0.f, ah[0], al[0]);
      split(m + 8 < m_lim ? act(ka, m + 8) : 0.f, ah[1], al[1]);
      split(m < m_lim ? act(kb, m) : 0.f, ah[2], al[2]);
      split(m + 8 < m_lim ? act(kb, m + 8) : 0.f, ah[3], al[3]);
      mma_tf32(small[i], al, bh0, bh1);
      mma_tf32(small[i], ah, bl0, bl1);
      mma_tf32(big[i], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int i = 0; i < CM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += big[i][j] + small[i][j];
  if (BIAS) bias += bsum;
}

template <int H>
__global__ void __launch_bounds__(kWarps * 32, 8 / kWarps)
nmp_bwd_edge_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    const int* __restrict__ perm, const int* __restrict__ src,
                    const int* __restrict__ slot_dst, const int* __restrict__ n_real_ptr,
                    const float* __restrict__ emask, const float* __restrict__ einv,
                    const float* __restrict__ w0, const float* __restrict__ b0,
                    const float* __restrict__ wrest, const float* __restrict__ brest,
                    const float* __restrict__ lng, const float* __restrict__ lnb,
                    const float* __restrict__ genew, const float* __restrict__ gagg,
                    float* __restrict__ ge, float* __restrict__ gz0,
                    float* __restrict__ partials, int n_hidden, int has_ln) {
  using C = Cfg<H>;
  constexpr int NT = C::NT, SX = C::SX, SA = C::SA, SW = C::SW;
  const int lp = n_hidden;
  extern __shared__ __align__(16) float smem[];
  float* s_w0 = smem;                       // [3H][SW]
  float* s_wr = s_w0 + 3 * H * SW;          // [lp][H][SW]
  float* s_b0 = s_wr + lp * H * SW;         // [H]
  float* s_br = s_b0 + H;                   // [lp][H]
  float* s_lg = s_br + lp * H;              // [H]
  float* s_lb = s_lg + H;                   // [H]
  float* s_x = s_lb + H;                    // [kRows][SX]: x_src | x_dst | e
  float* s_a = s_x + kRows * SX;            // [lp][kRows][SA]: ELU(z_l)
  float* s_g = s_a + lp * kRows * SA;       // [2][kRows][SA]: gradient slabs
  int* s_eid = reinterpret_cast<int*>(s_g + 2 * kRows * SA);  // [kRows], -1: padding
  int* s_src = s_eid + kRows;
  int* s_dst = s_src + kRows;
  float* s_m = reinterpret_cast<float*>(s_dst + kRows);
  float* s_inv = s_m + kRows;

  for (int i = threadIdx.x; i < 3 * H * H; i += blockDim.x) s_w0[(i / H) * SW + i % H] = w0[i];
  for (int i = threadIdx.x; i < lp * H * H; i += blockDim.x) s_wr[(i / H) * SW + i % H] = wrest[i];
  for (int i = threadIdx.x; i < lp * H; i += blockDim.x) s_br[i] = brest[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    s_b0[i] = b0[i];
    s_lg[i] = lng[i];
    s_lb[i] = lnb[i];
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;                 // the warp's first row in a tile
  const int nt_w = warp % NT;               // weight-gradient n-tile of this warp
  const int mg = warp / NT;                 // ... and its m-tile group
  int mt0[C::CW0];
#pragma unroll
  for (int i = 0; i < C::CW0; ++i) mt0[i] = mg + i * C::MS;
  int mth[C::CWH];
#pragma unroll
  for (int i = 0; i < C::CWH; ++i) mth[i] = mg + i * C::MS;

  float acc0[C::CW0][4] = {};               // w0 tiles
  float acch[kMaxHidden][C::CWH][4] = {};   // wrest_l tiles
  float accb[kMaxHidden + 1] = {};          // b0, brest_l at column 8 nt_w + g
  float acc_lg[NT][2] = {}, acc_lb[NT][2] = {};

  const int n_real = *n_real_ptr;
  const int n_tiles = (n_real + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kRows;
    if (threadIdx.x < kRows) {
      const int slot = base + threadIdx.x;
      int eid = -1, s = 0, d = 0;
      float m = 0.f, iv = 0.f;
      if (slot < n_real) {
        eid = perm[slot];
        s = src[slot];
        d = slot_dst[slot];
        m = emask[eid];
        iv = einv[eid];
      }
      s_eid[threadIdx.x] = eid;
      s_src[threadIdx.x] = s;
      s_dst[threadIdx.x] = d;
      s_m[threadIdx.x] = m;
      s_inv[threadIdx.x] = iv;
    }
    __syncthreads();
    constexpr int CH = H / 4;               // 16-byte chunks per H-row
    for (int i = threadIdx.x; i < kRows * 3 * CH; i += blockDim.x) {
      const int r = i / (3 * CH);
      const int q = i - r * 3 * CH;
      const int part = q / CH;
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
    cp_async_wait_all();
    __syncthreads();

    // the cotangent's rows, loaded before the forward so that their latency
    // hides behind it
    float2 cot_n[2][NT], cot_a[2][NT];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + g + 8 * h2;
      const int eid = s_eid[r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t;
        cot_n[h2][nt] = cot_a[h2][nt] = make_float2(0.f, 0.f);
        if (eid >= 0) {
          cot_n[h2][nt] = *reinterpret_cast<const float2*>(genew + (size_t)eid * H + col);
          cot_a[h2][nt] = *reinterpret_cast<const float2*>(gagg + (size_t)s_dst[r] * H + col);
        }
      }
    }

    // --- forward recompute of the warp's 16 rows ---
    const float* xw = s_x + r0 * SX;
    float z[NT][4];
    init_bias<NT>(z, s_b0, t);
    {
      auto a = [&](int r, int k) { return xw[r * SX + k]; };
      auto b = [&](int k, int n) { return s_w0[k * SW + n]; };
      warp_mm<NT, 3 * H / 8, true>(z, a, b, g, t);
    }
    for (int l = 0; l < lp; ++l) {
      float* aw = s_a + l * kRows * SA + r0 * SA;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[nt][j] = elu(z[nt][j]);
      store_c<NT>(aw, SA, z, g, t);
      __syncwarp();
      const float* w = s_wr + l * H * SW;
      init_bias<NT>(z, s_br + l * H, t);
      auto a = [&](int r, int k) { return aw[r * SA + k]; };
      auto b = [&](int k, int n) { return w[k * SW + n]; };
      warp_mm<NT, H / 8, true>(z, a, b, g, t);
    }

    // --- cotangent of (e + h), LayerNorm backward ---
    float gh[NT][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + g + 8 * h2;
      const float m = s_m[r], iv = s_inv[r];    // 0 on padding rows
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        gh[nt][2 * h2] = fmaf(cot_a[h2][nt].x, iv, cot_n[h2][nt].x) * m;
        gh[nt][2 * h2 + 1] = fmaf(cot_a[h2][nt].y, iv, cot_n[h2][nt].y) * m;
      }
    }
    float gz[NT][4];
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
        float xh[NT][2], gx[NT][2], s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float ghv = gh[nt][2 * h2 + q];
            xh[nt][q] = (z[nt][2 * h2 + q] - mu) * rstd;
            acc_lg[nt][q] += ghv * xh[nt][q];
            acc_lb[nt][q] += ghv;
            gx[nt][q] = ghv * s_lg[nt * 8 + 2 * t + q];
            s1 += gx[nt][q];
            s2 += gx[nt][q] * xh[nt][q];
          }
        const float m1 = row_sum(s1) * (1.f / H), m2 = row_sum(s2) * (1.f / H);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            gz[nt][2 * h2 + q] = rstd * (gx[nt][q] - m1 - xh[nt][q] * m2);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) gz[nt][j] = gh[nt][j];
    }
    int cur = 0;
    store_c<NT>(s_g + r0 * SA, SA, gz, g, t);
    __syncthreads();

    // --- hidden layers, last to first: weight grads over the tile, input
    //     grads of the warp's rows ---
#pragma unroll
    for (int l = kMaxHidden - 1; l >= 0; --l) {
      if (l >= lp) continue;
      const float* gc = s_g + cur * kRows * SA;
      float* gn = s_g + (cur ^ 1) * kRows * SA;
      const float* a = s_a + l * kRows * SA;
      const float* w = s_wr + l * H * SW;
      if (mg < C::MHT) {
        auto act = [&](int k, int m) { return a[k * SA + m]; };
        if (mg == 0)
          wgrad<C::CWH, true, SA>(acch[l], mth, C::MHT, H, act, gc, nt_w * 8, accb[l + 1], g,
                                  t);
        else
          wgrad<C::CWH, false, SA>(acch[l], mth, C::MHT, H, act, gc, nt_w * 8, accb[l + 1],
                                   g, t);
      }
      float ga[NT][4] = {};
      const float* gw = gc + r0 * SA;
      auto ag = [&](int r, int k) { return gw[r * SA + k]; };
      auto wt = [&](int k, int n) { return w[n * SW + k]; };
      warp_mm<NT, H / 8, false>(ga, ag, wt, g, t);
      float aw[NT][4];
      load_c<NT>(aw, a + r0 * SA, SA, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) ga[nt][j] *= elu_grad(aw[nt][j]);
      store_c<NT>(gn + r0 * SA, SA, ga, g, t);
      __syncthreads();
      cur ^= 1;
    }

    // --- layer 0: w0 and b0 grads over the tile; g_e and g_z0 per row ---
    {
      const float* gc = s_g + cur * kRows * SA;
      float* gn = s_g + (cur ^ 1) * kRows * SA;
      auto act = [&](int k, int m) { return s_x[k * SX + m]; };
      if (mg == 0)
        wgrad<C::CW0, true, SA>(acc0, mt0, C::M0T, 3 * H, act, gc, nt_w * 8, accb[0], g, t);
      else
        wgrad<C::CW0, false, SA>(acc0, mt0, C::M0T, 3 * H, act, gc, nt_w * 8, accb[0], g, t);
      const float* gw = gc + r0 * SA;
      constexpr int CH4 = H / 4;
      // g_e = g_h + g_z0 w0_e^T
      warp_mm<NT, H / 8, false>(
          gh, [&](int r, int k) { return gw[r * SA + k]; },
          [&](int k, int n) { return s_w0[(2 * H + n) * SW + k]; }, g, t);
      store_c<NT>(gn + r0 * SA, SA, gh, g, t);
      __syncwarp();
      for (int i = lane; i < 16 * CH4; i += 32) {
        const int r = i / CH4, c = (i - r * CH4) * 4;
        const int eid = s_eid[r0 + r];
        if (eid < 0) continue;
        *reinterpret_cast<float4*>(ge + (size_t)eid * H + c) =
            *reinterpret_cast<const float4*>(gn + (r0 + r) * SA + c);
        *reinterpret_cast<float4*>(gz0 + (size_t)(base + r0 + r) * H + c) =
            *reinterpret_cast<const float4*>(gw + r * SA + c);
      }
    }
    __syncthreads();
  }

  // --- this block's partial weight gradients, one writer per element ---
  const int lpx = lp > 0 ? lp : 1;
  float* P = partials + (size_t)blockIdx.x * wgrad_size(H, lpx);
  float* P_b0 = P + 3 * H * H;
  float* P_wr = P_b0 + H;
  float* P_br = P_wr + lpx * H * H;
  float* P_ln = P_br + lpx * H;             // lng then lnb
  const int col = nt_w * 8 + 2 * t;
#pragma unroll
  for (int i = 0; i < C::CW0; ++i) {
    if (mt0[i] >= C::M0T) continue;
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
    for (int i = 0; i < C::CWH; ++i) {
      if (mth[i] >= C::MHT) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = mth[i] * 16 + g + (j >= 2 ? 8 : 0);
        if (row < H) P_wr[l * H * H + row * H + col + (j & 1)] = acch[l][i][j];
      }
    }
  }
  if (mg == 0) {                            // warp-uniform: the bias owners
#pragma unroll
    for (int l = 0; l <= kMaxHidden; ++l) {
      float v = row_sum(accb[l]);
      if (t == 0 && l <= lpx) (l == 0 ? P_b0 : P_br + (l - 1) * H)[nt_w * 8 + g] = v;
    }
  }
  // LayerNorm: column sums over the lanes' rows (g), then over the warps in
  // order, through the free gradient slab
  float* red = s_g;                         // [kWarps][2H]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float vg = acc_lg[nt][q], vb = acc_lb[nt][q];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        vg += __shfl_xor_sync(kFull, vg, off);
        vb += __shfl_xor_sync(kFull, vb, off);
      }
      if (g == 0) {
        red[warp * 2 * H + nt * 8 + 2 * t + q] = vg;
        red[warp * 2 * H + H + nt * 8 + 2 * t + q] = vb;
      }
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * H; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * 2 * H + i];
    P_ln[i] = s;
  }
}

// (c) out[i] = sum over blocks, in block order
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int n_groups, int wsize) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wsize) return;
  float s = 0.f;
  for (int g = 0; g < n_groups; ++g) s += partials[(size_t)g * wsize + i];
  out[i] = s;
}

// (d) g_x[n] = G_dst[n] w0_dst^T + G_src[n] w0_src^T, G_* the fixed-order
// sums of g_z0 over n's dst slots and src slots; H lanes per node
template <int H>
__global__ void nmp_bwd_node_kernel(const float* __restrict__ w0, const float* __restrict__ gz0,
                                    const int* __restrict__ rowptr,
                                    const int* __restrict__ src_slots,
                                    const int* __restrict__ src_rowptr, float* __restrict__ gx,
                                    int n_nodes) {
  constexpr int P = H + 1;
  __shared__ float s_ws[H * P], s_wd[H * P];
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    s_ws[(i / H) * P + i % H] = w0[i];
    s_wd[(i / H) * P + i % H] = w0[H * H + i];
  }
  __syncthreads();
  constexpr int kNodes = 32 / H;            // nodes per warp
  const int lane = threadIdx.x & 31;
  const int j = lane % H, grp = lane / H;
  const int warps = blockDim.x >> 5;
  const int warp = blockIdx.x * warps + (threadIdx.x >> 5);
  const int stride = gridDim.x * warps * kNodes;
  // the loop bound is uniform across the warp, so the shuffles below run
  // with all 32 lanes converged
  for (int base = warp * kNodes; base < n_nodes; base += stride) {
    const int n = base + grp;
    float gd = 0.f, gs = 0.f;
    if (n < n_nodes) {
      for (int s = rowptr[n]; s < rowptr[n + 1]; ++s) gd += gz0[(size_t)s * H + j];
      for (int p = src_rowptr[n]; p < src_rowptr[n + 1]; ++p)
        gs += gz0[(size_t)src_slots[p] * H + j];
    }
    float out = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) out = fmaf(s_wd[j * P + i], __shfl_sync(kFull, gd, i, H), out);
#pragma unroll
    for (int i = 0; i < H; ++i) out = fmaf(s_ws[j * P + i], __shfl_sync(kFull, gs, i, H), out);
    if (n < n_nodes) gx[(size_t)n * H + j] = out;
  }
}

struct LaunchPlan {
  int grid, per_sm;
  size_t smem;
};

template <int H>
cudaError_t plan_launch(int n_hidden, long long n_slots, LaunchPlan* p) {
  const size_t smem = sizeof(float) * smem_floats(H, n_hidden);
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((size_t)optin < smem) return cudaErrorInvalidValue;
  auto kern = nmp_bwd_edge_kernel<H>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kWarps * 32, smem);
  if (err != cudaSuccess) return err;
  long long need = (n_slots + kRows - 1) / kRows;
  if (need < 1) need = 1;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  p->grid = (int)(need < cap ? need : cap);
  p->per_sm = per_sm;
  p->smem = smem;
  return cudaSuccess;
}

cudaError_t plan_for(int hidden, int n_hidden, long long n_slots, LaunchPlan* p) {
  if (n_hidden < 0 || n_hidden > kMaxHidden) return cudaErrorInvalidValue;
  switch (hidden) {
    case 8: return plan_launch<8>(n_hidden, n_slots, p);
    case 16: return plan_launch<16>(n_hidden, n_slots, p);
    case 32: return plan_launch<32>(n_hidden, n_slots, p);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int bwd_plan(int hidden, int n_hidden, long long n_slots, int* plan) {
  LaunchPlan p;
  cudaError_t err = plan_for(hidden, n_hidden, n_slots, &p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.grid;
  plan[1] = (int)p.smem;
  plan[2] = p.per_sm;
  return 0;
}

int bwd_launch(const void* x, const void* e, const void* perm, const void* src,
               const void* rowptr, const void* src_slots, const void* src_rowptr,
               const void* emask, const void* einv, const void* w0, const void* b0,
               const void* wrest, const void* brest, const void* lng, const void* lnb,
               const void* genew, const void* gagg, void* gx, void* ge, void* gw, void* gz0,
               void* slot_dst, void* partials, int n_nodes, long long n_slots,
               int hidden, int n_hidden, int has_ln, int n_groups, void* stream) {
  LaunchPlan p;
  cudaError_t err = plan_for(hidden, n_hidden, n_slots, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.grid != n_groups) return (int)cudaErrorInvalidValue;
  // 16-byte row copies (x, e, g_e, g_z0) and 8-byte cotangent loads
  if (!aligned16(x) || !aligned16(e) || !aligned16(ge) || !aligned16(gz0) ||
      ((uintptr_t)genew & 7) || ((uintptr_t)gagg & 7))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_nodes > 0)
    slot_dst_kernel<<<(n_nodes + 255) / 256, 256, 0, st>>>((const int*)rowptr, (int*)slot_dst,
                                                          n_nodes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int* n_real = (const int*)rowptr + n_nodes;   // rowptr[N]: the real slots
#define EDGE_ARGS                                                                     \
  (const float*)x, (const float*)e, (const int*)perm, (const int*)src,               \
      (const int*)slot_dst, n_real, (const float*)emask, (const float*)einv,         \
      (const float*)w0, (const float*)b0, (const float*)wrest, (const float*)brest,  \
      (const float*)lng, (const float*)lnb, (const float*)genew, (const float*)gagg, \
      (float*)ge, (float*)gz0, (float*)partials, n_hidden, has_ln
  switch (hidden) {
    case 8: nmp_bwd_edge_kernel<8><<<p.grid, kWarps * 32, p.smem, st>>>(EDGE_ARGS); break;
    case 16: nmp_bwd_edge_kernel<16><<<p.grid, kWarps * 32, p.smem, st>>>(EDGE_ARGS); break;
    case 32: nmp_bwd_edge_kernel<32><<<p.grid, kWarps * 32, p.smem, st>>>(EDGE_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef EDGE_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int lpx = n_hidden > 0 ? n_hidden : 1;
  const int wsize = wgrad_size(hidden, lpx);
  reduce_partials_kernel<<<(wsize + 255) / 256, 256, 0, st>>>(
      (const float*)partials, (float*)gw, n_groups, wsize);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_nodes > 0) {
    const int warps = 8, per_block = warps * (32 / hidden);
    const int grid = (n_nodes + per_block - 1) / per_block;
#define NODE_ARGS                                                                    \
  (const float*)w0, (const float*)gz0, (const int*)rowptr, (const int*)src_slots,   \
      (const int*)src_rowptr, (float*)gx, n_nodes
    switch (hidden) {
      case 8: nmp_bwd_node_kernel<8><<<grid, warps * 32, 0, st>>>(NODE_ARGS); break;
      case 16: nmp_bwd_node_kernel<16><<<grid, warps * 32, 0, st>>>(NODE_ARGS); break;
      case 32: nmp_bwd_node_kernel<32><<<grid, warps * 32, 0, st>>>(NODE_ARGS); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef NODE_ARGS
  }
  return (int)cudaGetLastError();
}

}  // namespace

// plan[0..2] = the edge pass's grid (= partial rows), its dynamic shared
// memory per block in bytes, and its resident blocks per SM (occupancy API)
extern "C" int nmp_edge_mlp_agg_bwd_plan(int hidden, int n_hidden, long long n_slots,
                                         int* plan) {
  return bwd_plan(hidden, n_hidden, n_slots, plan);
}

extern "C" int nmp_edge_mlp_agg_bwd_f32(
    const void* x, const void* e, const void* perm, const void* src, const void* rowptr,
    const void* src_slots, const void* src_rowptr, const void* emask, const void* einv,
    const void* w0, const void* b0, const void* wrest, const void* brest,
    const void* lng, const void* lnb, const void* genew, const void* gagg,
    void* gx, void* ge, void* gw, void* gz0, void* slot_dst, void* partials,
    int n_nodes, long long n_slots, int hidden, int n_hidden, int has_ln, int n_groups,
    void* stream) {
  return bwd_launch(x, e, perm, src, rowptr, src_slots, src_rowptr, emask, einv, w0, b0,
                    wrest, brest, lng, lnb, genew, gagg, gx, ge, gw, gz0, slot_dst, partials,
                    n_nodes, n_slots, hidden, n_hidden, has_ln, n_groups, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
