// bf16 tile machinery shared by the fused NMP kernels' bf16 entries
// (csrc/nmp_fwd.cu, csrc/nmp_bwd.cu) on NVIDIA Hopper (sm_90a): rounding to
// bf16, the warp's [16 x K] x [K x H] product on bf16 operands in
// mma.sync.m16n8k16.bf16 with fp32 accumulation, and the 2xTF32 product of
// an fp32 operand (a cotangent) with a bf16-valued one.
//
// The policy is the reference's (src/repro/kernels/segment_agg/kernel.py::
// _dot with precision="bf16"): both operands of every edge-MLP product are
// rounded to bf16, to nearest even as astype(bfloat16) rounds
// (__float2bfloat16_rn; the TF32 split of csrc/nmp_tf32.cuh rounds ties
// away from zero, which is TF32's rule, not this one), and the products
// accumulate in fp32.  The backward's products have the fp32 cotangent on
// one side and a bf16 value on the other: a bf16 value is exact in TF32, so
// g_hi * b + g_lo * b (2xTF32) is the fp32 product up to the cotangent's
// lowest bits, and its third term of 3xTF32 is zero.
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

// the same for two values that are bf16 already (their low 16 bits zero):
// the top halves of both words, one byte permute
__device__ __forceinline__ uint32_t bf16x2_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's [16 x K] x [K x H] product on bf16-rounded operands, added to
// C fragments c[nt] (nmp_tf32.cuh's layout).  K is a multiple of 8; a last
// half k-step (K % 16 == 8) runs with its upper half zero.  A k-step's
// fragments: lane (g, t) holds a(g, k0 + 2t + {0, 1}), a(g + 8, ...) and
// the same at k0 + 8 + 2t, and b(k0 + 2t + {0, 1}, n) and b(k0 + 8 + 2t +
// {0, 1}, n), n = 8 nt + g.  With B_EXACT the b values are bf16 already
// (packed without rounding).
template <int NT, int K, bool B_EXACT, class FA, class FB>
__device__ __forceinline__ void warp_mm_bf16(float (&c)[NT][4], FA a, FB b, int g, int t) {
  constexpr int KS = (K + 15) / 16;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int kl = ks * 16 + 2 * t, kh = kl + 8;
    const bool upper = ks * 16 + 8 < K;     // warp-uniform, known at compile time
    uint32_t af[4];
    af[0] = bf16x2(a(g, kl), a(g, kl + 1));
    af[1] = bf16x2(a(g + 8, kl), a(g + 8, kl + 1));
    af[2] = upper ? bf16x2(a(g, kh), a(g, kh + 1)) : 0u;
    af[3] = upper ? bf16x2(a(g + 8, kh), a(g + 8, kh + 1)) : 0u;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      const uint32_t b0 = B_EXACT ? bf16x2_exact(b(kl, n), b(kl + 1, n))
                                  : bf16x2(b(kl, n), b(kl + 1, n));
      const uint32_t b1 = !upper   ? 0u
                          : B_EXACT ? bf16x2_exact(b(kh, n), b(kh + 1, n))
                                    : bf16x2(b(kh, n), b(kh + 1, n));
      mma_bf16(c[nt], af, b0, b1);
    }
  }
}

// The warp's [16 x K] x [K x H] product of an fp32 A (a cotangent) and a
// bf16-valued B in 2xTF32: a_hi * b + a_lo * b through m16n8k8.tf32 (b is
// exact in TF32, so the a * b_lo terms of 3xTF32 are zero), summed in
// fresh fragments and added to c[nt] in fp32.  The k order of a k-step is
// the pair permutation of nmp_tf32.cuh (lane t: k0 + 2t, k0 + 2t + 1).
template <int NT, int KS, class FA, class FB>
__device__ __forceinline__ void warp_mm_2x(float (&c)[NT][4], FA a, FB b, int g, int t) {
  float big[NT][4] = {}, small[NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int ka = ks * 8 + 2 * t, kb = ka + 1;
    uint32_t ah[4], al[4];
    split(a(g, ka), ah[0], al[0]);
    split(a(g + 8, ka), ah[1], al[1]);
    split(a(g, kb), ah[2], al[2]);
    split(a(g + 8, kb), ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t b0 = __float_as_uint(b(ka, nt * 8 + g));
      const uint32_t b1 = __float_as_uint(b(kb, nt * 8 + g));
      mma_tf32(small[nt], al, b0, b1);
      mma_tf32(big[nt], ah, b0, b1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[nt][j] += big[nt][j] + small[nt][j];
}

}  // namespace
