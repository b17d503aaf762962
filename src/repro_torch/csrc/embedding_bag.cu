// Embedding-bag kernel for NVIDIA Hopper (sm_90a), fp32 and bf16 tables.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/kernel.py:35 (embedding_bag, body _kernel)
// the sum-pooled lookup on DLRM's hot path:
//   out[b, :] = sum_{h = 0..H-1} table[idx[b, h], :]
// accumulated in fp32 and written once in the table's type.
//
// What bounds it on the H100 SXM (published peaks at its 700 W limit):
// bytes.  It does one add per element it reads, far below the fp32 ridge of
// ~20 FLOP/byte, so the least time is
//   (B*H*D*s + B*D*s + B*H*4) bytes / 3.35 TB/s     (s = 4 fp32, 2 bf16):
// every gathered row read once, every bag written once, every index read
// once.  The rows are scattered over a table far larger than the 50 MB L2,
// so each is a cold read from HBM.
// Design: a group of G lanes per bag along D, each lane reading VEC
// contiguous elements with one 16-byte load, so one fp32 D=64 row is 16
// lanes x 16 B = one coalesced 256-byte read and a 256-thread block keeps
// 16 bags' rows in flight.  VEC is the widest of 16/8/4/2 bytes that divides
// D and keeps the table and output aligned, so a D that is not a multiple of
// 4 fp32 elements takes narrower loads (down to one element) and needs no
// separate tail.  A D wider than 32 loads loops over it in steps of 32 lanes.
// The TPU kernel's scalar prefetch of the indices has no counterpart: the
// lanes of a group read their bag's indices themselves (one broadcast load
// per row).  Its sequential h grid axis with the VMEM accumulator becomes
// a loop over h in registers, in order, from 0.f with __fadd_rn: the order
// and type of the plain version (kernels/embedding_bag/ref.py), so the two
// are bitwise equal.  No shared memory and no atomics: every bag has one
// writer, so a repeated launch is bitwise the same.
//
// Offsets are 64-bit: DLRM RM2's table has V*D = 3.2e9 > 2^31 elements.
// An index outside [0, V) stops the kernel with __trap(), so the launch
// fails as the plain version's index_select does (it raises on the CPU and
// asserts on the card): no bag is ever summed from a wrong row.  C entry
// points return cudaGetLastError(); a trap surfaces at the next
// synchronisation, as a device assert does.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     T* __restrict__ out, int64_t n_bags, int64_t bag_len, int64_t d,
                     int64_t v, int group) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  const int64_t bag = (int64_t)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  if (bag >= n_bags) return;
  const int lane = threadIdx.x % group;
  const int64_t chunks = d / VEC;
  const int* bag_idx = idx + bag * bag_len;
  for (int64_t c = lane; c < chunks; c += group) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int64_t h = 0; h < bag_len; ++h) {
      const int64_t r = __ldg(bag_idx + h);
      if (r < 0 || r >= v) __trap();
      const R raw = __ldg(reinterpret_cast<const R*>(table + r * d) + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], to_f32(vals[j]));
    }
    R res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = from_f32<T>(acc[j]);
    reinterpret_cast<R*>(out + bag * d)[c] = res;
  }
}

template <typename T, int VEC>
int launch(const void* table, const void* idx, void* out, int64_t n_bags,
           int64_t bag_len, int64_t d, int64_t v, cudaStream_t stream) {
  const int64_t chunks = d / VEC;
  int group = 1;
  while (group < 32 && group < chunks) group *= 2;
  const int64_t per_block = kThreads / group;
  const int64_t blocks = (n_bags + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  embedding_bag_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)table, (const int*)idx, (T*)out, n_bags, bag_len, d, v, group);
  return (int)cudaGetLastError();
}

template <typename T>
bool fits(int vec, const void* table, const void* out, int64_t d) {
  const uintptr_t bytes = (uintptr_t)vec * sizeof(T);
  return d % vec == 0 && (uintptr_t)table % bytes == 0 && (uintptr_t)out % bytes == 0;
}

template <typename T>
int dispatch(const void* table, const void* idx, void* out, int64_t n_bags,
             int64_t bag_len, int64_t d, int64_t v, void* stream) {
  if (n_bags < 0 || bag_len < 0 || d < 0 || (bag_len > 0 && v <= 0))
    return (int)cudaErrorInvalidValue;
  if (n_bags == 0 || d == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int kMaxVec = 16 / sizeof(T);
  if constexpr (kMaxVec >= 8) {
    if (fits<T>(8, table, out, d)) return launch<T, 8>(table, idx, out, n_bags, bag_len, d, v, s);
  }
  if (fits<T>(4, table, out, d)) return launch<T, 4>(table, idx, out, n_bags, bag_len, d, v, s);
  if (fits<T>(2, table, out, d)) return launch<T, 2>(table, idx, out, n_bags, bag_len, d, v, s);
  return launch<T, 1>(table, idx, out, n_bags, bag_len, d, v, s);
}

}  // namespace

extern "C" int embedding_bag_f32(const void* table, const void* idx, void* out,
                                 int64_t n_bags, int64_t bag_len, int64_t d, int64_t v,
                                 void* stream) {
  return dispatch<float>(table, idx, out, n_bags, bag_len, d, v, stream);
}

extern "C" int embedding_bag_bf16(const void* table, const void* idx, void* out,
                                  int64_t n_bags, int64_t bag_len, int64_t d, int64_t v,
                                  void* stream) {
  return dispatch<__nv_bfloat16>(table, idx, out, n_bags, bag_len, d, v, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
