// Fused NMP backward (VJP of Eq. 4a + 4b) for NVIDIA Hopper (sm_90a), fp32.
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
// gradients, weight gradients; the x_dst slice of layer 0, 3 x 2H*H, is
// paid once per node), 43,008 FLOP at H=32, Lp=5, against ~400 bytes of
// edge traffic: ~100 FLOP/byte, far above the fp32 ridge of 20 FLOP/byte.
//
// The TPU kernel carries its node-gradient and weight-gradient scratch
// across a sequential grid.  Blocks here run in no order, and the result
// must be bitwise repeatable (no float atomics anywhere), so:
//   (a) edge pass: one row group (H lanes, lane j = feature j) owns a
//       destination node, as in the forward, and walks its dst-sorted slots
//       (rowptr) in order.  Per slot it recomputes the activations (kept in
//       a per-group shared-memory row stack), writes g_e to the edge's
//       original position (perm) and g_x_src to a per-slot scratch row.
//       The x_dst slice factors through G_n = sum of the node's layer-0
//       pre-activation gradients: g_x_dst = w0_dst G_n and its weight term
//       x_n (x) G_n are formed once per node, so g_x of the dst side is
//       written once per node with no reduction.  Weight gradients go to a
//       PRIVATE shared-memory accumulator per row group (written only by its
//       own lanes, one element per lane), flushed to a partials buffer;
//   (b) a fixed-order reduction of those partials (group 0, 1, 2, ...);
//   (c) a node pass that adds each node's outgoing slots' g_x_src rows in
//       src-sorted order (src_slots / src_rowptr).
// The weights sit in shared memory with a padded row stride (H + 1), so
// both the forward access (lane j reads column j) and the transposed one
// of the input gradients (lane k reads row k) are free of bank conflicts.
// The per-group accumulators (33.8 KB at H=32, Lp=5) bound the warps per
// block (5 at H=32); the grid is capped at what is resident at once and
// strides over the nodes, so the partials have a fixed count per card.
// fp32 FMA on CUDA cores, no tensor cores in this first version.
//
// C entry points return cudaGetLastError(); nmp_edge_mlp_agg_bwd_groups
// reports how many partial rows the wrapper must allocate.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;

template <int H>
__device__ __forceinline__ float bcast(float v, int k) {
  return __shfl_sync(kFull, v, k, H);
}

template <int H>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = H / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off, H);
  return v;
}

__device__ __forceinline__ float elu(float z) { return z > 0.f ? z : expm1f(z); }

// floats of the flat weight-gradient buffer (and of one accumulator)
__host__ __device__ inline int wgrad_size(int h, int lp) {
  return 3 * h * h + h + lp * h * h + lp * h + 2 * h;
}

// floats of one row group's shared region: accumulator + activation stack,
// rounded to 32 and offset by H so the groups of a warp sit in other banks
__host__ __device__ inline int group_stride(int h, int n_hidden, int lp) {
  const int raw = wgrad_size(h, lp) + (n_hidden + 1) * h;
  return ((raw + 31) / 32) * 32 + h;
}

__host__ __device__ inline int weight_floats(int h, int lp) {
  return 3 * h * (h + 1) + h + lp * h * (h + 1) + lp * h + 2 * h;
}

template <int H>
__global__ void __launch_bounds__(kMaxWarps * 32)
nmp_bwd_edge_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    const int* __restrict__ perm, const int* __restrict__ src,
                    const int* __restrict__ rowptr,
                    const float* __restrict__ emask, const float* __restrict__ einv,
                    const float* __restrict__ w0, const float* __restrict__ b0,
                    const float* __restrict__ wrest, const float* __restrict__ brest,
                    const float* __restrict__ lng, const float* __restrict__ lnb,
                    const float* __restrict__ genew, const float* __restrict__ gagg,
                    float* __restrict__ gx, float* __restrict__ ge,
                    float* __restrict__ gxi_slot, float* __restrict__ partials,
                    int n_nodes, int n_hidden, int has_ln) {
  constexpr int P = H + 1;                  // padded row stride of the weights
  constexpr int kRows = 32 / H;             // row groups (nodes) per warp
  const int lp = n_hidden > 0 ? n_hidden : 1;
  extern __shared__ float smem[];
  float* s_w0 = smem;                       // [3H, P]
  float* s_b0 = s_w0 + 3 * H * P;           // [H]
  float* s_wr = s_b0 + H;                   // [lp * H, P]
  float* s_br = s_wr + lp * H * P;          // [lp, H]
  float* s_g = s_br + lp * H;               // [H]
  float* s_b = s_g + H;                     // [H]
  float* s_groups = smem + weight_floats(H, lp);
  for (int i = threadIdx.x; i < 3 * H * H; i += blockDim.x)
    s_w0[(i / H) * P + i % H] = w0[i];
  for (int i = threadIdx.x; i < n_hidden * H * H; i += blockDim.x)
    s_wr[(i / H) * P + i % H] = wrest[i];
  for (int i = threadIdx.x; i < n_hidden * H; i += blockDim.x) s_br[i] = brest[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    s_b0[i] = b0[i];
    s_g[i] = lng[i];
    s_b[i] = lnb[i];
  }

  const int lane = threadIdx.x & 31;
  const int j = lane % H;                   // feature owned by this lane
  const int grp = lane / H;
  const int warps = blockDim.x >> 5;
  const int warp_in_block = threadIdx.x >> 5;
  const int wsize = wgrad_size(H, lp);
  float* acc = s_groups + (warp_in_block * kRows + grp) * group_stride(H, n_hidden, lp);
  float* a_w0 = acc;                        // [3H, H]
  float* a_b0 = a_w0 + 3 * H * H;           // [H]
  float* a_wr = a_b0 + H;                   // [lp, H, H]
  float* a_br = a_wr + lp * H * H;          // [lp, H]
  float* a_g = a_br + lp * H;               // [H]
  float* a_b = a_g + H;                     // [H]
  float* zs = acc + wsize;                  // [n_hidden + 1, H] activations
  for (int i = j; i < wsize; i += H) acc[i] = 0.f;
  __syncthreads();

  const int warp = blockIdx.x * warps + warp_in_block;
  const int stride = gridDim.x * warps * kRows;
  // the loop bound is uniform across the warp, so every shuffle below runs
  // with all 32 lanes converged
  for (int base = warp * kRows; base < n_nodes; base += stride) {
    const int n = base + grp;
    const bool node_ok = n < n_nodes;
    const int beg = node_ok ? rowptr[n] : 0;
    const int cnt = node_ok ? rowptr[n + 1] - beg : 0;
    int max_cnt = cnt;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      max_cnt = max(max_cnt, __shfl_xor_sync(kFull, max_cnt, off));

    const float xn = node_ok ? x[(size_t)n * H + j] : 0.f;
    const float gag = node_ok ? gagg[(size_t)n * H + j] : 0.f;
    float pre = s_b0[j];
#pragma unroll
    for (int k = 0; k < H; ++k) pre = fmaf(bcast<H>(xn, k), s_w0[(H + k) * P + j], pre);

    float gn = 0.f;                         // G_n: sum of the node's g_z0
    for (int t = 0; t < max_cnt; ++t) {
      const bool ok = t < cnt;
      const int slot = beg + t;
      const int eid = ok ? perm[slot] : 0;
      const int s = ok ? src[slot] : 0;
      const float xi = ok ? x[(size_t)s * H + j] : 0.f;
      const float ev = ok ? e[(size_t)eid * H + j] : 0.f;

      // --- recompute the forward, keeping each layer's pre-activation ---
      float z = pre;
#pragma unroll
      for (int k = 0; k < H; ++k) z = fmaf(bcast<H>(xi, k), s_w0[k * P + j], z);
#pragma unroll
      for (int k = 0; k < H; ++k) z = fmaf(bcast<H>(ev, k), s_w0[(2 * H + k) * P + j], z);
      zs[j] = z;
      for (int l = 0; l < n_hidden; ++l) {
        const float a = elu(z);
        const float* w = s_wr + l * H * P;
        float o = s_br[l * H + j];
#pragma unroll
        for (int k = 0; k < H; ++k) o = fmaf(bcast<H>(a, k), w[k * P + j], o);
        z = o;
        zs[(l + 1) * H + j] = z;
      }

      // --- cotangent of (e + h): g_enew + g_agg[dst] / d_ij, masked ---
      const float m = ok ? emask[eid] : 0.f;
      const float gt = ok ? fmaf(gag, einv[eid], genew[(size_t)eid * H + j]) : 0.f;
      const float gh = gt * m;
      float gz = gh;
      if (has_ln) {
        const float mu = group_sum<H>(z) * (1.f / H);
        const float d = z - mu;
        const float var = group_sum<H>(d * d) * (1.f / H);
        const float rstd = rsqrtf(var + 1e-5f);
        const float xhat = d * rstd;
        a_g[j] += gh * xhat;
        a_b[j] += gh;
        const float gxh = gh * s_g[j];
        const float m1 = group_sum<H>(gxh) * (1.f / H);
        const float m2 = group_sum<H>(gxh * xhat) * (1.f / H);
        gz = rstd * (gxh - m1 - xhat * m2);
      }

      // --- hidden layers, last to first ---
      for (int l = n_hidden - 1; l >= 0; --l) {
        const float zl = zs[l * H + j];
        const float a = elu(zl);
        float* aw = a_wr + l * H * H;
#pragma unroll
        for (int k = 0; k < H; ++k) aw[k * H + j] = fmaf(bcast<H>(a, k), gz, aw[k * H + j]);
        a_br[l * H + j] += gz;
        const float* w = s_wr + (l * H + j) * P;      // row j of wrest_l
        float ga = 0.f;
#pragma unroll
        for (int i = 0; i < H; ++i) ga = fmaf(w[i], bcast<H>(gz, i), ga);
        gz = zl > 0.f ? ga : ga * expf(zl);
      }

      // --- layer 0: x_src and e slices per edge, x_dst slice per node ---
#pragma unroll
      for (int k = 0; k < H; ++k) {
        a_w0[k * H + j] = fmaf(bcast<H>(xi, k), gz, a_w0[k * H + j]);
        a_w0[(2 * H + k) * H + j] = fmaf(bcast<H>(ev, k), gz, a_w0[(2 * H + k) * H + j]);
      }
      gn += gz;
      float gxi = 0.f, gev = gh;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float gzi = bcast<H>(gz, i);
        gxi = fmaf(s_w0[j * P + i], gzi, gxi);
        gev = fmaf(s_w0[(2 * H + j) * P + i], gzi, gev);
      }
      if (ok) {
        gxi_slot[(size_t)slot * H + j] = gxi;
        ge[(size_t)eid * H + j] = gev;
      }
    }
#pragma unroll
    for (int k = 0; k < H; ++k)
      a_w0[(H + k) * H + j] = fmaf(bcast<H>(xn, k), gn, a_w0[(H + k) * H + j]);
    a_b0[j] += gn;
    float gxd = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) gxd = fmaf(s_w0[(H + j) * P + i], bcast<H>(gn, i), gxd);
    if (node_ok) gx[(size_t)n * H + j] = gxd;
  }
  __syncwarp();
  const size_t g = (size_t)warp * kRows + grp;
  for (int i = j; i < wsize; i += H) partials[g * wsize + i] = acc[i];
}

// (b) out[i] = sum over groups, in group order
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int n_groups, int wsize) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wsize) return;
  float s = 0.f;
  for (int g = 0; g < n_groups; ++g) s += partials[(size_t)g * wsize + i];
  out[i] = s;
}

// (c) gx[n] += sum of g_x_src over n's outgoing slots, in src-sorted order
__global__ void gx_src_kernel(float* __restrict__ gx, const float* __restrict__ gxi_slot,
                              const int* __restrict__ src_slots,
                              const int* __restrict__ src_rowptr, int n_nodes, int h) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_nodes * h) return;
  const int n = (int)(i / h);
  const int k = (int)(i - (long long)n * h);
  float s = gx[i];
  for (int p = src_rowptr[n]; p < src_rowptr[n + 1]; ++p)
    s += gxi_slot[(size_t)src_slots[p] * h + k];
  gx[i] = s;
}

struct LaunchPlan {
  int warps, grid, groups;
  size_t smem;
};

template <int H>
cudaError_t plan_launch(int n_hidden, int n_nodes, LaunchPlan* lp_out) {
  const int lp = n_hidden > 0 ? n_hidden : 1;
  constexpr int kRows = 32 / H;
  const size_t w_bytes = sizeof(float) * weight_floats(H, lp);
  const size_t warp_bytes = sizeof(float) * kRows * group_stride(H, n_hidden, lp);
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((size_t)optin < w_bytes + warp_bytes) return cudaErrorInvalidValue;
  int warps = (int)(((size_t)optin - w_bytes) / warp_bytes);
  if (warps > kMaxWarps) warps = kMaxWarps;
  const size_t smem = w_bytes + warps * warp_bytes;
  auto kern = nmp_bwd_edge_kernel<H>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, warps * 32, smem);
  if (err != cudaSuccess) return err;
  const int rows_per_block = warps * kRows;
  long long need = (n_nodes + rows_per_block - 1) / rows_per_block;
  if (need < 1) need = 1;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  lp_out->warps = warps;
  lp_out->grid = (int)(need < cap ? need : cap);
  lp_out->groups = lp_out->grid * warps * kRows;
  lp_out->smem = smem;
  return cudaSuccess;
}

cudaError_t plan_for(int hidden, int n_hidden, int n_nodes, LaunchPlan* p) {
  switch (hidden) {
    case 8: return plan_launch<8>(n_hidden, n_nodes, p);
    case 16: return plan_launch<16>(n_hidden, n_nodes, p);
    case 32: return plan_launch<32>(n_hidden, n_nodes, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int nmp_edge_mlp_agg_bwd_groups(int hidden, int n_hidden, int n_nodes,
                                           int* n_groups) {
  LaunchPlan p;
  cudaError_t err = plan_for(hidden, n_hidden, n_nodes, &p);
  if (err != cudaSuccess) return (int)err;
  *n_groups = p.groups;
  return 0;
}

extern "C" int nmp_edge_mlp_agg_bwd_f32(
    const void* x, const void* e, const void* perm, const void* src, const void* rowptr,
    const void* src_slots, const void* src_rowptr, const void* emask, const void* einv,
    const void* w0, const void* b0, const void* wrest, const void* brest,
    const void* lng, const void* lnb, const void* genew, const void* gagg,
    void* gx, void* ge, void* gw, void* gxi_slot, void* partials,
    int n_nodes, int hidden, int n_hidden, int has_ln, int n_groups, void* stream) {
  LaunchPlan p;
  cudaError_t err = plan_for(hidden, n_hidden, n_nodes, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.groups != n_groups) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define BWD_ARGS                                                                      \
  (const float*)x, (const float*)e, (const int*)perm, (const int*)src,               \
      (const int*)rowptr, (const float*)emask, (const float*)einv, (const float*)w0, \
      (const float*)b0, (const float*)wrest, (const float*)brest, (const float*)lng, \
      (const float*)lnb, (const float*)genew, (const float*)gagg, (float*)gx,        \
      (float*)ge, (float*)gxi_slot, (float*)partials, n_nodes, n_hidden, has_ln
  switch (hidden) {
    case 8: nmp_bwd_edge_kernel<8><<<p.grid, p.warps * 32, p.smem, st>>>(BWD_ARGS); break;
    case 16: nmp_bwd_edge_kernel<16><<<p.grid, p.warps * 32, p.smem, st>>>(BWD_ARGS); break;
    case 32: nmp_bwd_edge_kernel<32><<<p.grid, p.warps * 32, p.smem, st>>>(BWD_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int lp = n_hidden > 0 ? n_hidden : 1;
  const int wsize = wgrad_size(hidden, lp);
  reduce_partials_kernel<<<(wsize + 255) / 256, 256, 0, st>>>(
      (const float*)partials, (float*)gw, n_groups, wsize);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n_nodes * hidden;
  if (total > 0) {
    gx_src_kernel<<<(int)((total + 255) / 256), 256, 0, st>>>(
        (float*)gx, (const float*)gxi_slot, (const int*)src_slots,
        (const int*)src_rowptr, n_nodes, hidden);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
