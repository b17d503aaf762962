// Fused NMP forward (Eq. 4a + 4b) for NVIDIA Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_agg/kernel.py::nmp_edge_mlp_agg_fwd
// (body _nmp_fwd_kernel, helpers _gather_rows / _edge_mlp_tile /
// _scatter_add_rows).  For every real edge (i <- j) of one rank:
//   e'_ij = (e_ij + LN(MLP([x_j_src, x_i_dst, e_ij]))) * mask_ij
//   agg_i = sum_j e'_ij * (1 / d_ij)
// MLP: dense(3H -> H), then n_hidden x (ELU, dense(H -> H)), then an
// optional LayerNorm (biased variance, eps 1e-5).  The first dense layer
// runs as three H-slices of w0, so no [E, 3H] concat exists anywhere.
//
// What bounds it on the H100 SXM (published peaks at its 700 W limit):
// arithmetic.  At H=32 with 5 hidden layers an edge costs
// 2 * (2H*H + 5*H*H) = 14,336 FLOP of fp32 FMA (the x_dst slice of the
// first layer, 2H*H, is paid once per node, see below) against ~272 bytes
// of edge traffic (e read, e' written, x rows mostly from L2), i.e. ~53
// FLOP/byte, above the fp32 CUDA-core ridge of 67 TFLOP/s / 3.35 TB/s =
// 20 FLOP/byte.
// The design keeps every operand of the MLP in registers and shared memory:
//   * the weights (33.8 KB at H=32, Lp=5) sit in shared memory, loaded once
//     per block; blocks are capped at what fits on the SMs at once and
//     stride over the nodes, so the weights are not reloaded per node;
//   * one row of H features is held by H lanes of a warp (lane j owns
//     feature j); __shfl_sync broadcasts h_k for the dense layers and a
//     butterfly reduction forms the LayerNorm statistics — for H=32 one
//     warp per row, for H=8 or 16 four or two rows per warp;
//   * fp32 FMA on CUDA cores only (no TF32, no tensor cores in this first
//     version: at H <= 32 the products are too narrow for wgmma tiles
//     without restaging the rows through shared memory).
//
// Aggregation is deterministic, with no float atomics.  Edges come in the
// compact dst-sorted layout of compact_gather_layout; rowptr[n] ..
// rowptr[n+1] are node n's slots.  The row group that owns node n walks its
// slots in order, writes each e' straight to the edge's original position
// (perm, so no tile copies and no un-permute scatter exist), and sums
// e' * (1/d_ij) in a register in slot order — every aggregate row has one
// writer and one fixed summation order, so repeated runs are bitwise equal
// (the streamed == offline serving contract depends on this).  Because all
// slots of node n share x[n], the x_dst slice of the first layer is computed
// once per node and reused for each of its edges.
//
// e' of edges outside the layout (padding, masked) is not written: the
// caller zero-fills e'.  C entry points return cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

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

template <int H>
__global__ void __launch_bounds__(kThreads)
nmp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ e,
               const int* __restrict__ perm, const int* __restrict__ src,
               const int* __restrict__ rowptr,
               const float* __restrict__ emask, const float* __restrict__ einv,
               const float* __restrict__ w0, const float* __restrict__ b0,
               const float* __restrict__ wrest, const float* __restrict__ brest,
               const float* __restrict__ lng, const float* __restrict__ lnb,
               float* __restrict__ e_new, float* __restrict__ agg,
               int n_nodes, int n_hidden, int has_ln) {
  extern __shared__ float smem[];
  float* s_w0 = smem;                       // [3H, H]
  float* s_b0 = s_w0 + 3 * H * H;           // [H]
  float* s_wr = s_b0 + H;                   // [n_hidden, H, H]
  float* s_br = s_wr + n_hidden * H * H;    // [n_hidden, H]
  float* s_g = s_br + n_hidden * H;         // [H]
  float* s_b = s_g + H;                     // [H]
  for (int i = threadIdx.x; i < 3 * H * H; i += blockDim.x) s_w0[i] = w0[i];
  for (int i = threadIdx.x; i < n_hidden * H * H; i += blockDim.x) s_wr[i] = wrest[i];
  for (int i = threadIdx.x; i < n_hidden * H; i += blockDim.x) s_br[i] = brest[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    s_b0[i] = b0[i];
    s_g[i] = lng[i];
    s_b[i] = lnb[i];
  }
  __syncthreads();

  constexpr int kRows = 32 / H;             // rows (nodes) per warp
  const int lane = threadIdx.x & 31;
  const int j = lane % H;                   // feature owned by this lane
  const int warps = blockDim.x >> 5;
  const int warp = blockIdx.x * warps + (threadIdx.x >> 5);
  const int stride = gridDim.x * warps * kRows;

  // the loop bound is uniform across the warp, so every shuffle below runs
  // with all 32 lanes converged
  for (int base = warp * kRows; base < n_nodes; base += stride) {
    const int n = base + lane / H;
    const bool node_ok = n < n_nodes;
    const int beg = node_ok ? rowptr[n] : 0;
    const int cnt = node_ok ? rowptr[n + 1] - beg : 0;
    int max_cnt = cnt;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      max_cnt = max(max_cnt, __shfl_xor_sync(kFull, max_cnt, off));

    // first layer, x_dst slice: shared by every edge into node n
    const float xn = node_ok ? x[(size_t)n * H + j] : 0.f;
    float pre = s_b0[j];
#pragma unroll
    for (int k = 0; k < H; ++k) pre = fmaf(bcast<H>(xn, k), s_w0[(H + k) * H + j], pre);

    float acc = 0.f;
    for (int t = 0; t < max_cnt; ++t) {
      const bool ok = t < cnt;
      const int eid = ok ? perm[beg + t] : 0;
      const int s = ok ? src[beg + t] : 0;
      const float xi = ok ? x[(size_t)s * H + j] : 0.f;
      const float ev = ok ? e[(size_t)eid * H + j] : 0.f;

      float h = pre;
#pragma unroll
      for (int k = 0; k < H; ++k) h = fmaf(bcast<H>(xi, k), s_w0[k * H + j], h);
#pragma unroll
      for (int k = 0; k < H; ++k) h = fmaf(bcast<H>(ev, k), s_w0[(2 * H + k) * H + j], h);
      for (int l = 0; l < n_hidden; ++l) {
        const float a = h > 0.f ? h : expm1f(h);
        const float* w = s_wr + l * H * H;
        float o = s_br[l * H + j];
#pragma unroll
        for (int k = 0; k < H; ++k) o = fmaf(bcast<H>(a, k), w[k * H + j], o);
        h = o;
      }
      if (has_ln) {
        const float mu = group_sum<H>(h) * (1.f / H);
        const float d = h - mu;
        const float var = group_sum<H>(d * d) * (1.f / H);
        h = d * rsqrtf(var + 1e-5f) * s_g[j] + s_b[j];
      }
      if (ok) {
        const float en = (ev + h) * emask[eid];
        e_new[(size_t)eid * H + j] = en;
        acc += en * einv[eid];
      }
    }
    if (node_ok) agg[(size_t)n * H + j] = acc;
  }
}

template <int H>
cudaError_t launch(const float* x, const float* e, const int* perm, const int* src,
                   const int* rowptr, const float* emask, const float* einv,
                   const float* w0, const float* b0, const float* wrest,
                   const float* brest, const float* lng, const float* lnb,
                   float* e_new, float* agg, int n_nodes, int n_hidden, int has_ln,
                   cudaStream_t stream) {
  if (n_nodes <= 0) return cudaSuccess;
  const size_t smem =
      sizeof(float) * (3 * H * H + H + n_hidden * H * H + n_hidden * H + 2 * H);
  auto kern = nmp_fwd_kernel<H>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int rows_per_block = (kThreads / 32) * (32 / H);
  const long long need = (n_nodes + rows_per_block - 1) / rows_per_block;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(need < cap ? need : cap);
  kern<<<grid, kThreads, smem, stream>>>(x, e, perm, src, rowptr, emask, einv, w0, b0,
                                         wrest, brest, lng, lnb, e_new, agg, n_nodes,
                                         n_hidden, has_ln);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nmp_edge_mlp_agg_fwd_f32(
    const void* x, const void* e, const void* perm, const void* src, const void* rowptr,
    const void* emask, const void* einv, const void* w0, const void* b0,
    const void* wrest, const void* brest, const void* lng, const void* lnb,
    void* e_new, void* agg, int n_nodes, int hidden, int n_hidden, int has_ln,
    void* stream) {
#define NMP_ARGS                                                                     \
  (const float*)x, (const float*)e, (const int*)perm, (const int*)src,              \
      (const int*)rowptr, (const float*)emask, (const float*)einv, (const float*)w0, \
      (const float*)b0, (const float*)wrest, (const float*)brest, (const float*)lng, \
      (const float*)lnb, (float*)e_new, (float*)agg, n_nodes, n_hidden, has_ln,     \
      (cudaStream_t)stream
  switch (hidden) {
    case 8: return (int)launch<8>(NMP_ARGS);
    case 16: return (int)launch<16>(NMP_ARGS);
    case 32: return (int)launch<32>(NMP_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NMP_ARGS
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
