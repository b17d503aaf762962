// Packed halo wire kernels for NVIDIA Hopper (sm_90a), fp32.
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/halo_pack/kernel.py::pack_pallas       (_pack_kernel)
//   src/repro/kernels/halo_pack/kernel.py::unpack_add_pallas (_unpack_kernel)
// the send-side gather and recv-side scatter-add of the packed neighbor
// halo exchange (Eq. 4c/4d):
//   pack:       buf[w, :] = x[idx[w], :] * mask[w]
//   unpack-add: out = a;  out[idx[w], :] += buf[w, :] * mask[w]
//
// What bounds them on the H100 SXM (published peaks at its 700 W limit):
// bytes.  They do one multiply (and one add) per element moved, far below
// the fp32 ridge of ~20 FLOP/byte, so the least time is the bytes moved
// over 3.35 TB/s; at the wire widths of a halo round (a few hundred rows
// of H=32 floats) they are launch-bound.
// Design: one thread per (slot, feature) — neighbouring threads touch
// neighbouring features of one row, so each warp's loads and stores are
// coalesced 128-byte rows at H=32.  There is no tiling or staging: the
// TPU kernels' double-buffered row DMAs have no counterpart because the
// gather is a plain coalesced load here.
//
// Both are bitwise equal to their plain versions (x[idx] * mask and
// a.index_add(0, idx, buf * mask)): __fmul_rn / __fadd_rn forbid the FMA
// contraction that would round the product and the sum once instead of
// twice.  Unpack-add skips slots whose mask is 0: the padding slots all
// carry index 0, and parallel zero-adds to row 0 would race a real write to
// row 0.  Real recv ids are unique within a round, so no other two threads
// write one element.  The one value the skip changes is a -0.0 in row 0 of
// `a`, which the plain version's 0-add turns into +0.0 (equal under
// torch.equal).  Indices are clamped into [0, n) for memory safety, as the
// reference's wrapper clips them.  C entry points return cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void pack_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                            const float* __restrict__ mask, float* __restrict__ buf,
                            long long total, int f, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int w = (int)(i / f);
  const int c = (int)(i - (long long)w * f);
  const int r = min(max(idx[w], 0), n - 1);
  buf[i] = __fmul_rn(x[(size_t)r * f + c], mask[w]);
}

__global__ void unpack_add_kernel(float* __restrict__ out, const float* __restrict__ buf,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ mask, long long total, int f,
                                  int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int w = (int)(i / f);
  const float m = mask[w];
  if (m == 0.f) return;
  const int c = (int)(i - (long long)w * f);
  const int r = min(max(idx[w], 0), n - 1);
  float* o = out + (size_t)r * f + c;
  *o = __fadd_rn(*o, __fmul_rn(buf[i], m));
}

inline int blocks_for(long long total) {
  return (int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int halo_pack_f32(const void* x, const void* idx, const void* mask, void* buf,
                             int w, int f, int n, void* stream) {
  const long long total = (long long)w * f;
  if (total == 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  pack_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)idx, (const float*)mask, (float*)buf, total, f, n);
  return (int)cudaGetLastError();
}

extern "C" int halo_unpack_add_f32(const void* a, const void* buf, const void* idx,
                                   const void* mask, void* out, int w, int f, int n,
                                   void* stream) {
  cudaError_t err = cudaMemcpyAsync(out, a, sizeof(float) * (size_t)n * f,
                                    cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)w * f;
  if (total == 0) return (int)cudaGetLastError();
  unpack_add_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, (const float*)buf, (const int*)idx, (const float*)mask, total, f, n);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
