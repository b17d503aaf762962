// Flash-attention forward for NVIDIA Hopper (sm_90a), bf16 and fp32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:75 (flash_attention_fwd,
//   body _flash_fwd_kernel :25)
// the TPU twin of the transformer's blocked_attention: online-softmax
// attention with a running max m, a running sum l and an unnormalised
// accumulator, normalised once at the end by max(l, 1e-20):
//   s = (q . k) * scale;  s = cap * tanh(s / cap) if softcap;
//   s = -1e30 where masked (kpos >= S, causal kpos > qpos, window
//   qpos - kpos >= window);  out = softmax(s) @ v  in the input's type.
//
// What bounds it on the H100 SXM (published peaks at its 700 W limit):
// operations.  Granite-34B-code's prefill layer (B=1, S=32,768, 48 query
// heads over one KV head of dim 128, causal) needs
//   4 * D * Hq * S * (S + 1) / 2 = 13.19 TFLOP  -> 13.3 ms at 989 TFLOP/s bf16
// against 0.82 GB of q, k, v and out (0.25 ms at 3.35 TB/s).
//
// Design:
// - Grid: one block per (query tile, query head, batch); a loop over the
//   key tiles inside the block takes the place of the TPU's sequential
//   kv grid axis, with m, l and the accumulator in registers.  The query
//   tiles run in reverse order, so under the causal mask the longest
//   blocks start first.
// - GQA / MQA by index: query head h reads KV head h / (Hq / Hkv).  K and
//   V are never repeated (the TPU wrapper's jnp.repeat would write 805 MB
//   per layer at G = 48, S = 32k); all heads of a tile read the same
//   16.8 MB of K and V, which stay in the 50 MB L2.  The kernel reads the
//   [B, S, H, D] layout through strides: no transposed copies.
// - Block skipping: the key tiles that the causal mask leaves empty (above
//   the diagonal, as the Pallas kernel skips them) and, for window > 0, the
//   ones below the window are never loaded.  Every row keeps its diagonal
//   key (one S for queries and keys), so a skipped tile would have added
//   exactly 0 and the result is the same.
// - bf16 (the model's path): QK^T and PV on tensor cores with mma.sync
//   m16n8k16 (bf16 operands, fp32 accumulation), P rounded to bf16 for the
//   PV product: the precision of the model's blocked_attention (bf16
//   einsums with preferred_element_type=float32, p.astype(v.dtype)).  Four
//   warps, 16 query rows each (a 64-row tile); 64-key tiles of K and V
//   double-buffered in shared memory with cp.async, read by ldmatrix (.trans
//   for V) from rows padded by 16 bytes, which keeps ldmatrix free of bank
//   conflicts for every head dim.  Q stays in registers.
// - fp32 (the TPU kernel's sweep): fp32 operands, no TF32; a SIMT loop with
//   eight lanes per query row, 32-key tiles in shared memory.
// - Head dims 16, 32, 64 and 128 (the wrapper raises on others); ragged
//   sequence ends are masked in the kernel (kpos < S, zero rows in shared
//   memory), with no padding copies.
// - The reference's finite -1e30, not -inf.  No atomics: every output row
//   has one writer and every sum a fixed order, so two launches are
//   bitwise equal.
//
// C entry points return cudaGetLastError() (or the error of the shared
// memory attribute); they launch on the given stream and do not
// synchronise.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;  // element strides: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int B, S, Hq, Hkv;
  float scale, softcap;  // softcap <= 0: off
  int causal, window;    // window <= 0: global
};

// Key tiles [t_begin, t_end) of width bn that can hold an unmasked key for
// query rows [q0, q0 + bm).
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int bm, int bn,
                                          int& t_begin, int& t_end) {
  int hi = p.S;
  if (p.causal) hi = min(hi, q0 + bm);
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  t_begin = lo / bn;
  t_end = (hi + bn - 1) / bn;
}

__device__ __forceinline__ bool key_ok(const Params& p, int qpos, int kpos) {
  return kpos < p.S && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

__device__ __forceinline__ float cap_score(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

constexpr int kBM = 64;       // query rows per block: 4 warps x 16
constexpr int kBN = 64;       // keys per tile
constexpr int kWarps = kBM / 16;

template <int D>
constexpr int smem_bytes_bf16() {
  return (kBM + 4 * kBN) * (D + 8) * (int)sizeof(bf16);  // Q, K[2], V[2]
}

// Rows [0, rows) of a tile of D columns from src (row stride ld_src
// elements) into shared memory (row stride D + 8); rows at or past
// `valid` are zero-filled.
template <int D, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t ld_src, int rows,
                                          int valid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    bf16* d = dst + r * (D + 8) + c * 8;
    if (r < valid)
      cp_async16(d, src + r * ld_src + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_bf16_kernel(const Params p) {
  constexpr int LD = D + 8, THREADS = kWarps * 32, KC = D / 16, NT = kBN / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBM * LD;      // [2][kBN][LD]
  bf16* sV = sK + 2 * kBN * LD;  // [2][kBN][LD]

  const int n_qt = (p.S + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // mma fragment row group / column pair
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int t_begin, t_end;
  key_tiles(p, q0, kBM, kBN, t_begin, t_end);

  load_tile<D, THREADS>(sQ, Q + (int64_t)q0 * p.q_ss, p.q_ss, kBM, p.S - q0);
  auto load_kv = [&](int t, int buf) {
    const int k0 = t * kBN;
    load_tile<D, THREADS>(sK + buf * kBN * LD, K + (int64_t)k0 * p.k_ss, p.k_ss, kBN, p.S - k0);
    load_tile<D, THREADS>(sV + buf * kBN * LD, V + (int64_t)k0 * p.v_ss, p.v_ss, kBN, p.S - k0);
  };
  load_kv(t_begin, 0);
  cp_async_commit();

  // this thread's two rows of the warp's 16: r0 = g, r1 = g + 8
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  unsigned qf[KC][4];
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this thread's partial sums

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == t_begin) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldmatrix_x4(qf[kc], sQ + (warp * 16 + (lane % 16)) * LD + kc * 16 + (lane / 16) * 8);
    }
    const bf16* tK = sK + buf * kBN * LD;
    const bf16* tV = sV + buf * kBN * LD;

    // s = q k^T: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned kb[4];
        const int mat = lane / 8;
        ldmatrix_x4(kb, tK + ((j + mat / 2) * 8 + lane % 8) * LD + kc * 16 + (mat % 2) * 8);
        mma_bf16(s[j], qf[kc], kb[0], kb[1]);
        mma_bf16(s[j + 1], qf[kc], kb[2], kb[3]);
      }
    }

    // scale, softcap, mask (only where the tile is not wholly inside)
    const int k0 = t * kBN;
    const bool inside = k0 + kBN <= p.S && (!p.causal || k0 + kBN - 1 <= q0) &&
                        (p.window <= 0 || q0 + kBM - 1 - k0 < p.window);
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = cap_score(s[j][e] * p.scale, p.softcap);
        if (!inside && !key_ok(p, e < 2 ? row0 : row1, k0 + j * 8 + 2 * tq + (e & 1))) x = kNeg;
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // the four threads of a row group hold one row's 64 keys
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = __expf(s[j][0] - mn0);
      s[j][1] = __expf(s[j][1] - mn0);
      s[j][2] = __expf(s[j][2] - mn1);
      s[j][3] = __expf(s[j][3] - mn1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }

    // o += p v, p rounded to bf16: the s accumulators are the A fragments
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DT; dn += 2) {
        unsigned vb[4];
        const int mat = lane / 8;
        ldmatrix_x4_trans(vb, tV + (kk * 16 + (mat % 2) * 8 + lane % 8) * LD + (dn + mat / 2) * 8);
        mma_bf16(o[dn], pa, vb[0], vb[1]);
        mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  bf16* O = static_cast<bf16*>(p.o);
  const int64_t o_ss = (int64_t)p.Hq * D;
  bf16* O0 = O + ((int64_t)b * p.S + row0) * o_ss + (int64_t)h * D + 2 * tq;
  bf16* O1 = O0 + 8 * o_ss;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (row0 < p.S)
      *reinterpret_cast<unsigned*>(O0 + j * 8) = pack_bf16(o[j][0] / d0, o[j][1] / d0);
    if (row1 < p.S)
      *reinterpret_cast<unsigned*>(O1 + j * 8) = pack_bf16(o[j][2] / d1, o[j][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT, eight lanes per query row
// ---------------------------------------------------------------------------

constexpr int kLanes = 8;
constexpr int kRowsF = 128 / kLanes;  // query rows per block
constexpr int kBNF = 32;              // keys per tile

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_f32_kernel(const Params p) {
  constexpr int E = D / kLanes;               // elements per lane
  constexpr int VEC = E >= 4 ? 4 : E;         // contiguous elements per load
  constexpr int NV = E / VEC;
  __shared__ __align__(16) float sK[kBNF][D];
  __shared__ __align__(16) float sV[kBNF][D];

  const int n_qt = (p.S + kRowsF - 1) / kRowsF;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kRowsF;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int ln = threadIdx.x % kLanes;
  const int qpos = q0 + threadIdx.x / kLanes;
  const bool live = qpos < p.S;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  // this lane's columns: i * kLanes * VEC + ln * VEC + c (the eight lanes of
  // a row read 8 * VEC contiguous floats per step: no bank conflicts)
  float q[E], acc[E];
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + qpos * p.q_ss;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      q[i * VEC + c] = live ? Q[i * kLanes * VEC + ln * VEC + c] : 0.f;
      acc[i * VEC + c] = 0.f;
    }

  int t_begin, t_end;
  key_tiles(p, q0, kRowsF, kBNF, t_begin, t_end);
  float m = kNeg, l = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBNF;
    __syncthreads();
    for (int i = threadIdx.x; i < kBNF * D / 4; i += 128) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < p.S) {
        kv = *reinterpret_cast<const float4*>(K + (int64_t)(k0 + r) * p.k_ss + c);
        vv = *reinterpret_cast<const float4*>(V + (int64_t)(k0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<float4*>(&sK[r][c]) = kv;
      *reinterpret_cast<float4*>(&sV[r][c]) = vv;
    }
    __syncthreads();

    float s[kBNF];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kBNF; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          part = fmaf(q[i * VEC + c], sK[j][i * kLanes * VEC + ln * VEC + c], part);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      float x = cap_score(part * p.scale, p.softcap);
      if (!key_ok(p, qpos, k0 + j)) x = kNeg;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kBNF; ++j) {
      s[j] = expf(s[j] - mn);
      ps += s[j];
    }
    l = l * corr + ps;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = 0; j < kBNF; ++j)
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          acc[i * VEC + c] = fmaf(s[j], sV[j][i * kLanes * VEC + ln * VEC + c], acc[i * VEC + c]);
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-20f);
  float* O = static_cast<float*>(p.o) + (((int64_t)b * p.S + qpos) * p.Hq + h) * D;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      O[i * kLanes * VEC + ln * VEC + c] = acc[i * VEC + c] / den;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes_bf16<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.S + kBM - 1) / kBM, p.Hq, p.B);
  flash_fwd_bf16_kernel<D><<<grid, kWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.S + kRowsF - 1) / kRowsF, p.Hq, p.B);
  flash_fwd_f32_kernel<D><<<grid, 128, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int Hq,
             int Hkv, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
             int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
             int causal, int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 B, S, Hq, Hkv, scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return BF16 ? launch_bf16<16>(p, s) : launch_f32<16>(p, s);
    case 32: return BF16 ? launch_bf16<32>(p, s) : launch_f32<32>(p, s);
    case 64: return BF16 ? launch_bf16<64>(p, s) : launch_f32<64>(p, s);
    case 128: return BF16 ? launch_bf16<128>(p, s) : launch_f32<128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define FLASH_ARGS                                                                            \
  const void *q, const void *k, const void *v, void *o, int B, int S, int Hq, int Hkv, int D, \
      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,     \
      int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal, int window,          \
      float softcap, void *stream
#define FLASH_PASS                                                                       \
  q, k, v, o, B, S, Hq, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, \
      causal, window, softcap, stream

extern "C" int flash_attention_bf16(FLASH_ARGS) { return dispatch<true>(FLASH_PASS); }

extern "C" int flash_attention_f32(FLASH_ARGS) { return dispatch<false>(FLASH_PASS); }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
