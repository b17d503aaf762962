// bf16 tile machinery of the fused NMP kernels' bf16 entries (csrc/nmp_bf16.cu)
// on NVIDIA Hopper (sm_90a): rounding to bf16, packing bf16 pairs,
// mma.sync.m16n8k16.bf16 with fp32 accumulation, ldmatrix, and the split
// of an fp32 value into three bf16 parts.
//
// The policy is the reference's (src/repro/kernels/segment_agg/kernel.py::
// _dot with precision="bf16"): both operands of every edge-MLP product are
// rounded to bf16, to nearest even as astype(bfloat16) rounds
// (__float2bfloat16_rn; the TF32 split of csrc/nmp_tf32.cuh rounds ties
// away from zero, which is TF32's rule, not this one), and the products
// accumulate in fp32.  The backward's products have an fp32 cotangent on
// one side and a bf16 value on the other: the cotangent is split into three
// bf16 parts (split3), each part's product runs on the bf16 tensor cores,
// and the three sums add up to the fp32 product up to the cotangent's last
// bit (three 8-bit significands cover fp32's 24).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "nmp_tf32.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (lo, hi) rounded to bf16 and packed: lo in the low half, the element of
// the smaller k index, as mma.sync reads a bf16x2 register
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two halves of a bf16x2 word as fp32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// (x, y) = p1 + p2 + p3 per half, each part the bf16 rounding of what the
// parts before it leave (every remainder is exact in fp32)
__device__ __forceinline__ void split3(float x, float y, uint32_t& p1, uint32_t& p2,
                                       uint32_t& p3) {
  p1 = bf16x2(x, y);
  const float rx = x - bf16_lo(p1), ry = y - bf16_hi(p1);
  p2 = bf16x2(rx, ry);
  p3 = bf16x2(rx - bf16_lo(p2), ry - bf16_hi(p2));
}

// ELU as nmp_tf32.cuh's elu, with exp(z) as ex2.approx.ftz (denormal
// results flushed): __expf's handling of a denormal exp(z) took 4 of the
// ~19 instructions a value, and it changes nothing here, where z < -87 gives
// exp(z) - 1 = -1 either way.  Bitwise equal to elu otherwise.
__device__ __forceinline__ float elu_ftz(float z) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * 1.4426950408889634f));
  e -= 1.f;
  float p = 1.f / 40320.f;
  p = fmaf(p, z, 1.f / 5040.f);
  p = fmaf(p, z, 1.f / 720.f);
  p = fmaf(p, z, 1.f / 120.f);
  p = fmaf(p, z, 1.f / 24.f);
  p = fmaf(p, z, 1.f / 6.f);
  p = fmaf(p, z, 0.5f);
  p = fmaf(p, z, 1.f);
  return z > 0.f ? z : (z < -0.5f ? e : p * z);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four (x4) or two (x2) transposed 8 x 8 bf16 matrices from shared memory:
// lanes 8q .. 8q + 7 give the 16-byte rows of matrix q, and lane (g, t)
// receives (row 2t, column g) and (row 2t + 1, column g) of each matrix.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

}  // namespace
