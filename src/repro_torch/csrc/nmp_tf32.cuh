// 3xTF32 tile machinery shared by the fused NMP kernels (csrc/nmp_fwd.cu,
// csrc/nmp_bwd.cu) on NVIDIA Hopper (sm_90a): the TF32 split, the warp's
// [16 x K] x [K x H] product in 3xTF32 mma.sync.m16n8k8, C-fragment moves
// between registers and shared memory, the branch-free ELU and the cp.async
// helpers.
//
// 3xTF32: each fp32 operand is split into a TF32 high part and the
// remainder, and every product is lo*hi + hi*lo + hi*hi into fp32
// accumulators, which keeps ~21 bits of each operand (plain 1xTF32 keeps
// 11).  The tensor cores' accumulation does not round to nearest, so no
// fragment is carried past one tile of rows: a tile's product is summed in
// fresh fragments and added to the caller's in fp32.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ELU with expm1 for z <= 0 in a few instructions and no branch (expm1f
// cost the kernel ~17%, and a branch between the two forms below cost
// more): __expf(z) - 1 below -0.5, where the result is at least 0.39 in
// magnitude, and the Taylor series to z^8 / 8! above (remainder below
// 6e-9); relative error a few 1e-7 either way.
__device__ __forceinline__ float elu(float z) {
  const float e = __expf(z) - 1.f;
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

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero)
// by integer add and mask, lo = x - hi exactly; the tensor cores read lo's
// top 19 bits.  Integer and FP32 pipes at full rate: cvt.rna.tf32.f32 for
// both parts made the conversions, not the products, the kernel's limit.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's [16 x K] x [K x H] product added to C fragments c[nt]:
// c[nt][0..3] = (row g, col 8nt + 2t), (g, 8nt + 2t + 1), (g + 8, 8nt + 2t),
// (g + 8, 8nt + 2t + 1) with g = lane / 4, t = lane % 4.  a(r, k) and
// b(k, n) read shared memory; A is split once per k-step and reused across
// the n-tiles.  The cross terms go to their own fragments (two shorter
// dependency chains per n-tile), added to c at the end.  The k index of a
// fragment may be any permutation of the k-step's 8 that A and B share:
// lane t takes k0 + kperm(t, 0/1), which is (t, t + 4) or, with PAIRS,
// (2t, 2t + 1) — the latter keeps B's row-major loads (row k, column
// 8nt + g) free of bank conflicts at row strides of 4 mod 32 floats.
__device__ __forceinline__ int kperm(bool pairs, int t, int i) {
  return pairs ? 2 * t + i : t + 4 * i;
}

template <int NT, int KS, bool PAIRS, class FA, class FB>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], FA a, FB b, int g, int t) {
  float small[NT][4] = {};
  const int ka = kperm(PAIRS, t, 0), kb = kperm(PAIRS, t, 1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = ks * 8;
    uint32_t ah[4], al[4];
    split(a(g, k0 + ka), ah[0], al[0]);
    split(a(g + 8, k0 + ka), ah[1], al[1]);
    split(a(g, k0 + kb), ah[2], al[2]);
    split(a(g + 8, k0 + kb), ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh0, bl0, bh1, bl1;
      split(b(k0 + ka, nt * 8 + g), bh0, bl0);
      split(b(k0 + kb, nt * 8 + g), bh1, bl1);
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

template <int NT>
__device__ __forceinline__ void init_bias(float (&c)[NT][4], const float* bias, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float b0 = bias[nt * 8 + 2 * t], b1 = bias[nt * 8 + 2 * t + 1];
    c[nt][0] = b0;
    c[nt][1] = b1;
    c[nt][2] = b0;
    c[nt][3] = b1;
  }
}

// C fragments of the warp's rows <-> a slab (row stride sa), as float2
template <int NT>
__device__ __forceinline__ void store_c(float* slab, int sa, const float (&c)[NT][4], int g,
                                        int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(slab + g * sa + col) = make_float2(c[nt][0], c[nt][1]);
    *reinterpret_cast<float2*>(slab + (g + 8) * sa + col) = make_float2(c[nt][2], c[nt][3]);
  }
}

template <int NT>
__device__ __forceinline__ void load_c(float (&c)[NT][4], const float* slab, int sa, int g,
                                       int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    const float2 u = *reinterpret_cast<const float2*>(slab + g * sa + col);
    const float2 v = *reinterpret_cast<const float2*>(slab + (g + 8) * sa + col);
    c[nt][0] = u.x;
    c[nt][1] = u.y;
    c[nt][2] = v.x;
    c[nt][3] = v.y;
  }
}

// sum over the 4 lanes (t) that hold one row of a C fragment
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_ptr);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gptr));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 4-byte copy (cached at all levels: the per-slot fields are gathered)
__device__ __forceinline__ void cp_async4(void* smem_ptr, const void* gptr) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_ptr);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gptr));
}

}  // namespace
