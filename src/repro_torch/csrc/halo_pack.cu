// Packed halo wire kernels for NVIDIA Hopper (sm_90a), fp32.
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/halo_pack/kernel.py::pack_pallas       (_pack_kernel)
//   src/repro/kernels/halo_pack/kernel.py::unpack_add_pallas (_unpack_kernel)
// the send-side gather and recv-side scatter-add of the packed neighbor
// halo exchange (Eq. 4c/4d):
//   pack:       buf[s, w, :] = x[s, idx[s, w], :] * mask[s, w]
//   unpack-add: out = a;  out[idx[w], :] += buf[w, :] * mask[w]
//
// What bounds them on the H100 SXM (published peaks at its 700 W limit):
// bytes.  They do one multiply (and one add) per element moved, far below
// the fp32 ridge of ~20 FLOP/byte, so the least time is the bytes moved
// over 3.35 TB/s; at the wire widths of a halo round (a few hundred rows
// of H=32 floats) that is well under a microsecond, and a launch costs
// more: they are launch-bound, so the host path around the launch is kept
// short (one C call, one kernel each) and the pack is made once per
// exchange, not once per round.
//
// pack, one launch per exchange: every round of an exchange gathers from
// the ORIGINAL aggregate (the reference's halo_sync_stacked says so), so
// the send buffers of all rounds, concatenated into one wire of
// W = sum of the rounds' widths (idx [S, W]), are packed by one launch
// over all S senders (S = R ranks in the stacked emulator, 1 for one
// rank's own wire) before the first unpack; round k's buffer is a slice of
// the result.  The gradient of an exchange packs the incoming gradient
// through the concatenated recv wire in one launch the same way.  One
// thread per 16 bytes of a row (one per float when F is not a multiple of
// 4 or a row is not 16-byte aligned): neighbouring threads touch
// neighbouring features of one row, so a warp's loads and stores are
// coalesced rows.
//
// unpack-add is one gather pass over the output rows, not a copy of the
// seed followed by a scatter:
//   out[r, :] = a[r, :] + buf[inv[r], :] * mask[inv[r]]   (inv[r] >= 0)
//   out[r, :] = a[r, :]                                   (inv[r] == -1)
// where inv is the inverse of idx over the slots with a non-zero mask
// (built once per halo plan, with the wire that carries idx and mask:
// kernels/halo_pack/ops.py::halo_wire; real ids are unique within a round,
// so it is well defined).  Every output
// element is written exactly once, by one thread, with no atomics and no
// race; 16-byte loads and stores when F is a multiple of 4 and the rows
// are 16-byte aligned.  A null seed
// pointer means a zero seed (the pack's adjoint), computed as 0 + product so
// the sums stay those of the plain version.
//
// Both are bitwise equal to their plain versions (x[idx] * mask and
// a.index_add(0, idx, buf * mask)): __fmul_rn / __fadd_rn forbid the FMA
// contraction that would round the product and the sum once instead of
// twice.  Slots with mask 0 (the padding slots, all index 0) add nothing;
// the one value that changes is a -0.0 in row 0 of `a`, which the plain
// version's 0-add turns into +0.0 (equal under torch.equal).  Pack clamps
// its indices into [0, n) for memory safety, as the reference's wrapper
// clips them; unpack-add reads only inv, whose entries halo_wire checked.
// C entry points return cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 scale(float4 v, float m) {
  return make_float4(__fmul_rn(v.x, m), __fmul_rn(v.y, m), __fmul_rn(v.z, m), __fmul_rn(v.w, m));
}
__device__ __forceinline__ float scale(float v, float m) { return __fmul_rn(v, m); }

// V floats per thread (4: one 16-byte access, 1: scalar); x [S, n, F], idx
// and mask [S, w], buf [S, w, F]; total = S * w * fv, fv = F / V
template <int V>
__global__ void pack_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                            const float* __restrict__ mask, float* __restrict__ buf,
                            long long total, int fv, int w, int n) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long slot = i / fv;            // over senders x w
  const int c = (int)(i - slot * fv);
  const long long sender = slot / w;
  const int r = min(max(idx[slot], 0), n - 1);
  const Vec v = reinterpret_cast<const Vec*>(x)[(sender * n + r) * fv + c];
  reinterpret_cast<Vec*>(buf)[i] = scale(v, mask[slot]);
}

__device__ __forceinline__ float madd(float s, float b, float m) {
  return __fadd_rn(s, __fmul_rn(b, m));
}

// V floats per thread (4: one 16-byte access, 1: scalar)
template <int V>
__global__ void unpack_add_kernel(const float* __restrict__ a, const float* __restrict__ buf,
                                  const int* __restrict__ inv,
                                  const float* __restrict__ mask, float* __restrict__ out,
                                  long long total, int fv) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long r = i / fv;
  const int c = (int)(i - r * fv);
  Vec s;
  if (a != nullptr) {
    s = reinterpret_cast<const Vec*>(a)[i];
  } else {
    s = Vec{};
  }
  const int w = inv[r];
  if (w >= 0) {
    const float m = mask[w];
    const Vec b = reinterpret_cast<const Vec*>(buf)[(size_t)w * fv + c];
    if constexpr (V == 4) {
      s.x = madd(s.x, b.x, m);
      s.y = madd(s.y, b.y, m);
      s.z = madd(s.z, b.z, m);
      s.w = madd(s.w, b.w, m);
    } else {
      s = madd(s, b, m);
    }
  }
  reinterpret_cast<Vec*>(out)[i] = s;
}

inline int blocks_for(long long total) {
  return (int)((total + kThreads - 1) / kThreads);
}

}  // namespace

// x [senders, n, f] -> buf [senders, w, f] through idx / mask [senders, w]
extern "C" int halo_pack_f32(const void* x, const void* idx, const void* mask, void* buf,
                             int w, int f, int n, int senders, void* stream) {
  const long long rows = (long long)senders * w;
  if (rows * f == 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (f % 4 == 0 && ((uintptr_t)x | (uintptr_t)buf) % 16 == 0) {
    const long long total = rows * (f / 4);
    pack_kernel<4><<<blocks_for(total), kThreads, 0, st>>>(
        (const float*)x, (const int*)idx, (const float*)mask, (float*)buf, total, f / 4, w, n);
  } else {
    const long long total = rows * f;
    pack_kernel<1><<<blocks_for(total), kThreads, 0, st>>>(
        (const float*)x, (const int*)idx, (const float*)mask, (float*)buf, total, f, w, n);
  }
  return (int)cudaGetLastError();
}

// a may be null (zero seed); inv [n] maps each output row to its slot or -1
extern "C" int halo_unpack_add_f32(const void* a, const void* buf, const void* inv,
                                   const void* mask, void* out, int n, int f,
                                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)a | (uintptr_t)buf | (uintptr_t)out;
  if (f % 4 == 0 && align % 16 == 0) {
    const long long total = (long long)n * (f / 4);
    if (total == 0) return 0;
    unpack_add_kernel<4><<<blocks_for(total), kThreads, 0, st>>>(
        (const float*)a, (const float*)buf, (const int*)inv, (const float*)mask,
        (float*)out, total, f / 4);
  } else {
    const long long total = (long long)n * f;
    if (total == 0) return 0;
    unpack_add_kernel<1><<<blocks_for(total), kThreads, 0, st>>>(
        (const float*)a, (const float*)buf, (const int*)inv, (const float*)mask,
        (float*)out, total, f);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
