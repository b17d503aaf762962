// Flash-attention forward for NVIDIA Hopper (sm_90a), bf16 and fp32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:75 (flash_attention_fwd,
//   body _flash_fwd_kernel :25)
// the TPU twin of the transformer's blocked_attention: online-softmax
// attention with a running max m, a running sum l and an unnormalised
// accumulator, normalised once at the end by max(l, 1e-20):
//   s = (q . k) * scale;  s = cap * tanh(s / cap) if softcap;
//   s = -1e30 where masked (kpos >= Skv, causal kpos > qpos, window
//   qpos - kpos >= window);  out = softmax(s) @ v  in the input's type,
//   with p = exp(s - m) rounded to bf16 before the PV product (the
//   precision of the model's bf16 einsums, p.astype(v.dtype)).
// Queries and keys may differ in length (q [B, Sq, Hq, D], k, v [B, Skv,
// Hkv, D]), and query row r sits at global position qpos = q_off + r: the
// context-parallel prefill gives each of n shards Sq = S / n rows at
// q_off = shard * S / n against all Skv = S keys.  The caller guarantees
// that every query row keeps at least one key (the entry points refuse a
// window that leaves the last row none).
//
// What bounds it on the H100 SXM (published peaks at its 700 W limit):
// operations.  Granite-34B-code's prefill layer (B=1, S=32,768, 48 query
// heads over one KV head of dim 128, causal) needs
//   4 * D * Hq * S * (S + 1) / 2 = 13.19 TFLOP  -> 13.3 ms at 989 TFLOP/s bf16
// against 0.82 GB of q, k, v and out (0.25 ms at 3.35 TB/s); Llama-3.2-3B's
// context-parallel layer on the last of 4 shards (Sq = 8,192 rows at
// 24,576 against Skv = 32,768 keys, 24 query heads over 8 KV heads) needs
// 2.886 TFLOP over its kept pairs -> 2.92 ms, every block walking 192 to
// 256 key tiles.  Gemma-2-2B's layers (B=1, S=32,768, 8 query heads over 4
// KV heads of dim 256, causal) need 4.40 TFLOP (4.45 ms) on a global layer
// and 1.03 TFLOP (1.04 ms) on a local one, whose 4,096-key window keeps
// 125.8 M pairs a head.  Only wgmma reaches the tensor cores' dense rate, and only
// if the products are fed without stalls: the tiles arrive by TMA while the
// math runs, and each K/V byte brought from L2 serves enough query rows.
//
// bf16 design (the model's path), one kernel for D = 16, 32, 64, 128, 256:
// - Block: 128 query rows of one head (one query tile) against the key
//   tiles that the mask leaves non-empty, kBN = 128 keys each (64 at
//   D = 256, below); 384 threads in
//   three warpgroups.  The grid is (query head, query tile, batch) with the
//   tiles in reverse order, so under the causal mask the longest blocks are
//   dispatched first, and the 48 heads of one tile, which read the same
//   K/V rows of the one KV head, run side by side and share them in L2.
// - Producer warpgroup (registers lowered to 40 by setmaxnreg): one thread
//   loads the Q tile once and keeps a ring of kStages K/V tiles in flight
//   with TMA (4-D tensor maps over the [B, Sq or Skv, H, D] strides, built
//   on the host for each call); full / empty mbarrier pairs hand each stage
//   to the consumers and back.  TMA writes zeros past Sq and Skv (the
//   kpos < Skv mask stays).
// - Two consumer warpgroups (registers raised to 232), 64 query rows each
//   (wgmma M = 64), both on the same K/V stage: 128 query rows per K/V byte
//   read, twice the mma.sync design's 64.
//   S = Q K^T: wgmma m64n(kBN)k16, both operands in shared memory, K-major.
//   Softmax in fp32 registers on the accumulator fragment, in base 2
//   (scale * log2(e) folded into the scores, ex2.approx); the mask is
//   evaluated only on tiles that cross the diagonal, the window edge or Skv.
//   O += P V: P rounded to bf16 in registers is wgmma's A operand (the
//   accumulator fragment of m64n(kBN) is the A fragment of kBN / 16 k16
//   slices); V is read in place as an MN-major B operand through the
//   descriptor's transpose bit, m64nDk16.  A warpgroup waits for its PV
//   product only after the next tile's QK^T is queued behind it, so the
//   tensor cores never drain between the two.
// - Shared memory: tiles of C = min(D, 64) columns per TMA box (one
//   swizzle span: 128, 64 or 32 bytes), swizzled by TMA exactly as the
//   wgmma descriptors expect; D = 128 is two boxes per row.  Q 32 KB +
//   2 x (K 32 KB + V 32 KB) = 160 KB at D = 128, with the mbarriers and
//   the alignment slack 164,904 B requested (smem_bytes_bf16): one block
//   per SM.
// - D = 256 (Gemma-2): at 128 keys a tile every tile doubles, Q 64 KB +
//   2 x (K 64 KB + V 64 KB) = 320 KB, over the 227 KB a block can have.
//   A single-stage ring at 128 keys (192 KB) would leave the consumers
//   waiting on every tile's load; so the K/V tiles hold 64 keys and the
//   ring keeps its two stages: Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB,
//   197,704 B requested (with the V ring's barriers).  Q stays 128 rows
//   (two consumer warpgroups of 64), so each K/V byte still serves 128
//   query rows.  A row is four TMA boxes of 64 columns; the QK^T product
//   walks them in sixteen k16 slices.  Registers of a consumer thread: O of m64n256 is 128 fp32, S
//   of m64n64 32, P of the tile in flight 16 (four k16 slices of bf16
//   pairs), beside the row statistics, within setmaxnreg's 232.  The PV
//   product is wgmma m64n256k16, four of them a tile.  Every other
//   dimension keeps its 128-key tiles, so its output is bitwise what it
//   was before D = 256 came in.
//   At 64 keys a tile the softmax's share of the work doubles against the
//   products', and Gemma-2 caps every score (cap 50 or 30), so D = 256 has
//   a schedule of its own (consume_pingpong, FlashAttention-3's
//   inter-warpgroup one): K and V on two rings, each warpgroup issuing
//   QK^T of tile i with PV of tile i - 1, and the two warpgroups taking
//   turns at the tensor cores by named barriers, so that one's softmax
//   runs under the other's products.  The softcap runs on the
//   special-function unit (cap_score_ex2: ex2.approx and rcp.approx, about
//   10 instructions a score where IEEE division and libm's tanhf took some
//   45 on the FMA pipe).  The order of every row's sums is the other
//   loop's, so without the softcap the output is bitwise what it was.
// - No split over keys and no atomics: every output row has one writer and
//   every sum a fixed order, so two launches are bitwise equal.  One launch
//   per call.
//
// fp32 (the TPU kernel's sweep; the model never runs it): fp32 operands, no
// TF32; a SIMT loop with eight lanes per query row, 32-key tiles in static
// shared memory (16-key tiles at D = 256: 2 x 16 x 256 x 4 B = 32 KB, where
// 32 keys would need 64 KB, over the 48 KB static limit).  Head dims 16,
// 32, 64, 128 and 256 (the wrapper raises on others).
//
// The row log-sum-exp: when the entry is given an fp32 `lse` [B, Hq, Sq]
// (not null), each row also writes m + log(max(l, 1e-20)) in natural units
// (the bf16 kernel's m is in base 2 and is converted), the statistic that
// the backward (csrc/flash_attention_bwd.cu) recomputes P from.  With a
// null `lse` nothing else changes: the output is bitwise the same.
//
// C entry points return cudaGetLastError() (or the error of the tensor map
// encoding or of the shared memory attribute); they launch on the given
// stream and do not synchronise.  cuTensorMapEncodeTiled is taken through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention.cuh"  // Tile, wgmma products, tensor maps (shared with the backward)

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                // [B, Hq, Sq] or null
  int64_t q_sb, q_ss, q_sh;  // element strides: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int B, Sq, Skv, q_off, Hq, Hkv;  // query row r is at position q_off + r
  float scale, softcap;  // softcap <= 0: off
  int causal, window;    // window <= 0: global
};

// d[0:128] += A (64x16, registers) * B (16x256, MN-major, shared): the PV
// product at D = 256 (N = 256, the instruction's largest)
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Key tiles [t_begin, t_end) of width bn that can hold an unmasked key for
// query rows [q0, q0 + bm) (positions q_off + q0 on).
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int bm, int bn,
                                          int& t_begin, int& t_end) {
  int hi = p.Skv;
  if (p.causal) hi = min(hi, p.q_off + q0 + bm);
  const int lo = p.window > 0 ? max(0, p.q_off + q0 - p.window + 1) : 0;
  t_begin = lo / bn;
  t_end = (hi + bn - 1) / bn;
}

// qpos: the query's global position (q_off + its row)
__device__ __forceinline__ bool key_ok(const Params& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

__device__ __forceinline__ float cap_score(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The softcap of the bf16 kernel at D = 256 (Gemma-2's layers), on the
// special-function unit: cap tanh(scale s / cap) log2(e) of the raw score
// s, with tanh(x) = (e - 1) / (e + 1), e = 2^(2 x log2(e)) by ex2.approx and
// the division by rcp.approx.  kin = 2 log2(e) scale / cap folds the scale
// and the base change into one multiply, kout = cap log2(e) leaves the
// capped score in the base-2 units of the softmax.  e - 1 is exact for e
// near 1, so a small x keeps its relative precision; y is clamped at 64,
// where tanh is 1 in fp32, so that e stays finite (inf * 0 otherwise).
// Largest error of the capped score against float64:
// tools/softcap_forms.py; its plain mirror: ref.py::softcap_ex2.
__device__ __forceinline__ float cap_score_ex2(float s, float kin, float kout) {
  const float e = ex2(fminf(s * kin, 64.f));
  return (e - 1.f) * rcp_approx(e + 1.f) * kout;
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers, warp specialisation, wgmma
// ---------------------------------------------------------------------------

constexpr int kBM = 128;        // query rows per block: kConsumers warpgroups x 64
constexpr int kStages = 2;      // K/V ring depth
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;

// keys per K/V tile: 128, and 64 at D = 256, where a 128-key ring of two
// stages would need 320 KB of shared memory (the file's header)
template <int D>
constexpr int kKeyTile = D == 256 ? 64 : 128;

// Q, the K ring, the V ring (each tile 1024-byte aligned, as the 128-byte
// swizzle needs), then the mbarriers (Q's, then a full / empty pair per
// stage, and at D = 256 a second pair, the V ring's); 1 KB of slack aligns
// the base.
template <int D>
constexpr int smem_bytes_bf16() {
  return Tile<D, kBM>::kBytes + 2 * kStages * Tile<D, kKeyTile<D>>::kBytes +
         8 * (1 + (D == 256 ? 4 : 2) * kStages) + 1024;
}

// The output rows row0 and row0 + 8 of a consumer thread (four threads a
// row, each with its partial sums l0, l1 and the rows' base-2 maxima m0, m1)
// and, with p.lse, their log-sum-exps.  The LSE's multiply and add are
// explicitly unfused: where the compiler would fuse them depends on the
// code around the inlined call, and the LSE must stay bitwise across the
// schedules (tools/flash_fwd_hash.py).
template <int D>
__device__ __forceinline__ void write_rows(const Params& p, const float (&o)[D / 2], float l0,
                                           float l1, float m0, float m1, int b, int h, int row0,
                                           int tq4) {
  const int row1 = row0 + 8;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  const int64_t o_ss = (int64_t)p.Hq * D;
  bf16* O0 = static_cast<bf16*>(p.o) + ((int64_t)b * p.Sq + row0) * o_ss + (int64_t)h * D + 2 * tq4;
  bf16* O1 = O0 + 8 * o_ss;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(O0 + j * 8) = pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(O1 + j * 8) = pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
  if (p.lse != nullptr && tq4 == 0) {
    float* lse = p.lse + ((int64_t)b * p.Hq + h) * p.Sq;
    if (row0 < p.Sq) lse[row0] = __fadd_rn(__fmul_rn(m0, kLn2), logf(d0));
    if (row1 < p.Sq) lse[row1] = __fadd_rn(__fmul_rn(m1, kLn2), logf(d1));
  }
}

// Named barriers of the D = 256 consumers' turns at the tensor cores:
// warpgroup w issues its products after a sync on kTurn + w.
constexpr int kTurn = 1;
constexpr int kConsumerThreads = 256;

// The D = 256 consumers (64 query rows a warpgroup; 64-key tiles).  Tile
// i's products, S_i = Q K_i^T and O += P_{i-1} V_{i-1}, are issued in one
// turn; the warpgroup waits for both, then runs the mask, the softcap and
// the softmax of tile i, rescales O and rounds P_i to bf16 for the next
// turn.  The two warpgroups take turns (named barriers), so that one's
// softmax runs under the other's products.  K and V have rings of their
// own: tile i's turn frees K_i's stage and V_{i-1}'s, into which the
// producer loads K_{i+2} and V_{i+1}, a whole tile before their turn.  Every
// row's sums are taken in the same order as the other head dims' loop, so
// without the softcap the output is bitwise the single-ring schedule's.
// (Waiting for S_i alone and running the softmax while PV_{i-1} finishes
// was 2% slower on an H100 at Gemma's softcapped global layer: PERF.md.)
template <int D>
__device__ __forceinline__ void consume_pingpong(const Params& p, uint32_t sQ, uint32_t sK,
                                                 uint32_t sV, uint32_t q_full, uint32_t full_k,
                                                 uint32_t empty_k, uint32_t full_v,
                                                 uint32_t empty_v, int q0, int t_begin,
                                                 int t_end, int wg, int h, int b) {
  constexpr int kBN = kKeyTile<D>;
  using TQ = Tile<D, kBM>;
  using T = Tile<D, kBN>;
  constexpr int RB = T::kRowBytes;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq4 = lane % 4;
  const int qa = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = qa + 16 * warp + g, row1 = row0 + 8;
  const bool softcap = p.softcap > 0.f;
  const float sl = p.scale * kLog2e;
  const float kin = 2.f * kLog2e * p.scale / p.softcap, kout = p.softcap * kLog2e;
  const uint32_t qrows = sQ + 64 * wg * RB;
  const int n = t_end - t_begin;

  float o[D / 2], sc[kBN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // m in base 2; l: this thread's partial sums
  uint32_t pa[kBN / 16][4] = {};  // P of the tile whose PV product is queued next
  // tile t's scores in sc -> its P in fp32 (in sc), after the scale, the
  // softcap and the mask; m and l move on, c0 / c1 rescale O
  auto softmax = [&](int t, float& c0, float& c1) {
    const int k0 = t * kBN;
    const int qa_pos = p.q_off + qa;
    const bool inside = k0 + kBN <= p.Skv && (!p.causal || k0 + kBN - 1 <= qa_pos) &&
                        (p.window <= 0 || qa_pos + 63 - k0 < p.window);
    if (softcap) {
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) sc[e] = cap_score_ex2(sc[e], kin, kout);
    } else {
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) sc[e] *= sl;
    }
    if (!inside) {
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e)
        if (!key_ok(p, p.q_off + ((e & 2) ? row1 : row0), k0 + 8 * (e / 4) + 2 * tq4 + (e & 1)))
          sc[e] = kNeg;
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    c0 = ex2(m0 - mn0);
    c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      float* e = sc + 8 * kk;
#pragma unroll
      for (int x = 0; x < 8; ++x) e[x] = ex2(e[x] - ((x & 2) ? mn1 : mn0));
      ps0 += (e[0] + e[1]) + (e[4] + e[5]);
      ps1 += (e[2] + e[3]) + (e[6] + e[7]);
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
  };
  // O rescaled, P rounded to bf16 as the A fragments of the next PV (k16
  // slice kk is accumulator chunks 2 kk and 2 kk + 1)
  auto rescale_pack = [&](float c0, float c1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // S = Q K^T of the tile in K stage s over D in k16 steps: box (16 kk) / C,
  // byte column 32 kk within it
  auto issue_qk = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(sc, make_desc(qrows + TQ::k_slice(kk), 16, 8 * RB, T::kDescLayout),
               make_desc(sK + s * T::kBytes + T::k_slice(kk), 16, 8 * RB, T::kDescLayout),
               kk > 0);
    wgmma_commit();
  };
  // O += P V of the tile in V stage s: V [keys, D] MN-major, as the other loop's
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) wgmma_pv(o, pa[kk], T::mn_desc(sV + s * T::kBytes, kk));
    wgmma_commit();
  };

  mbar_wait(q_full, 0);
  // tile 0 (peeled: no PV before it, and a wgmma under a branch would be
  // serialized by ptxas)
  mbar_wait(full_k, 0);
  __syncwarp();  // wgmma is .aligned: the warp converges after the spin
  if (wg == 1) named_bar_arrive(kTurn, kConsumerThreads);  // warpgroup 0 goes first
  named_bar_sync(kTurn + wg, kConsumerThreads);
  fence_regs(sc);
  wgmma_fence();
  issue_qk(0);
  if (wg == 0 || n > 1) named_bar_arrive(kTurn + 1 - wg, kConsumerThreads);
  wgmma_wait_all();
  fence_regs(sc);
  __syncwarp();
  if (lane == 0) mbar_arrive(empty_k);
  float c0, c1;
  softmax(t_begin, c0, c1);
  rescale_pack(c0, c1);
  for (int t = t_begin + 1, i = 1; t < t_end; ++t, ++i) {
    const int s = i % kStages, sp = (i - 1) % kStages;  // tile i's stage, tile i - 1's
    mbar_wait(full_k + 8 * s, (i / kStages) & 1);
    mbar_wait(full_v + 8 * sp, ((i - 1) / kStages) & 1);
    __syncwarp();
    named_bar_sync(kTurn + wg, kConsumerThreads);
    fence_regs(sc);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_qk(s);
    issue_pv(sp);
    // the other warpgroup's turn (its last sync is warpgroup 1's last turn)
    if (wg == 0 || i + 1 < n) named_bar_arrive(kTurn + 1 - wg, kConsumerThreads);
    wgmma_wait_all();  // S of tile i and PV of tile i - 1
    fence_regs(sc);
    fence_regs(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty_k + 8 * s);
      mbar_arrive(empty_v + 8 * sp);
    }
    softmax(t, c0, c1);
    rescale_pack(c0, c1);
  }
  // O += P V of the last tile (no turn: nothing is left to stagger)
  mbar_wait(full_v + 8 * ((n - 1) % kStages), ((n - 1) / kStages) & 1);
  __syncwarp();
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
  issue_pv((n - 1) % kStages);
  wgmma_wait_all();
  fence_regs(o);
  write_rows<D>(p, o, l0, l1, m0, m1, b, h, row0, tq4);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int kBN = kKeyTile<D>;
  using TQ = Tile<D, kBM>;  // the Q tile
  using T = Tile<D, kBN>;   // a K or V tile
  constexpr int RB = T::kRowBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + TQ::kBytes;           // stage s at sK + s * T::kBytes
  const uint32_t sV = sK + kStages * T::kBytes;  // stage s at sV + s * T::kBytes
  const uint32_t q_full = sV + kStages * T::kBytes;
  const uint32_t full = q_full + 8;              // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kStages;     // empty[s] at empty + 8 s
  // D = 256: full / empty hand the K ring's stages over, full_v / empty_v
  // the V ring's (consume_pingpong)
  const uint32_t full_v = empty + 8 * kStages, empty_v = full_v + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBM;
  const int hk = h / (p.Hq / p.Hkv);
  int t_begin, t_end;
  key_tiles(p, q0, kBM, kBN, t_begin, t_end);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);  // one arrival per consumer warp
      if constexpr (D == 256) {
        mbar_init(full_v + 8 * s, 1);
        mbar_init(empty_v + 8 * s, kConsumers * 4);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, TQ::kBytes);
      for (int c = 0; c < TQ::kBoxes; ++c)
        tma_load(sQ + c * TQ::kBoxBytes, &tq, q_full, c * TQ::C, q0, h, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % kStages;
        const uint32_t f = full + 8 * s;
        mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        if constexpr (D == 256) {  // K and V each on its own ring
          const uint32_t fv = full_v + 8 * s;
          mbar_expect_tx(f, T::kBytes);
          for (int c = 0; c < T::kBoxes; ++c)
            tma_load(sK + s * T::kBytes + c * T::kBoxBytes, &tk, f, c * T::C, t * kBN, hk, b);
          mbar_wait(empty_v + 8 * s, ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(fv, T::kBytes);
          for (int c = 0; c < T::kBoxes; ++c)
            tma_load(sV + s * T::kBytes + c * T::kBoxBytes, &tv, fv, c * T::C, t * kBN, hk, b);
        } else {
          mbar_expect_tx(f, 2 * T::kBytes);
          for (int c = 0; c < T::kBoxes; ++c) {
            tma_load(sK + s * T::kBytes + c * T::kBoxBytes, &tk, f, c * T::C, t * kBN, hk, b);
            tma_load(sV + s * T::kBytes + c * T::kBoxBytes, &tv, f, c * T::C, t * kBN, hk, b);
          }
        }
      }
    }
  } else if constexpr (D == 256) {
    setmaxnreg_inc<232>();
    consume_pingpong<D>(p, sQ, sK, sV, q_full, full, empty, full_v, empty_v, q0, t_begin, t_end,
                        wg, h, b);
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, tq4 = lane % 4;
    const int qa = q0 + 64 * wg;  // this warpgroup's first row
    const int row0 = qa + 16 * warp + g, row1 = row0 + 8;
    const bool softcap = p.softcap > 0.f;
    const float sl = p.scale * kLog2e;
    const uint32_t qrows = sQ + 64 * wg * RB;

    float o[D / 2], sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // m in base 2; l: this thread's partial sums

    uint32_t pa[kBN / 16][4] = {};  // P of the tile whose PV product is in flight
    mbar_wait(q_full, 0);
    __syncwarp();
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int s = i % kStages;
      const uint32_t tK = sK + s * T::kBytes, tV = sV + s * T::kBytes;
      mbar_wait(full + 8 * s, (i / kStages) & 1);
      __syncwarp();  // wgmma is .aligned: the warp converges after the spin

      // S = Q K^T over D in k16 steps: box (16 kk) / C, byte column 32 kk within it
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_qk(sc, make_desc(qrows + TQ::k_slice(kk), 16, 8 * RB, T::kDescLayout),
                 make_desc(tK + T::k_slice(kk), 16, 8 * RB, T::kDescLayout), kk > 0);
      wgmma_commit();
      wgmma_wait_all();  // S of tile i, and PV of tile i - 1
      fence_regs(sc);
      fence_regs(o);
      fence_regs(pa);
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % kStages));
      }

      // scale (base 2), softcap, mask (only where the tile is not wholly inside)
      const int k0 = t * kBN;
      const int qa_pos = p.q_off + qa;
      const bool inside = k0 + kBN <= p.Skv && (!p.causal || k0 + kBN - 1 <= qa_pos) &&
                          (p.window <= 0 || qa_pos + 63 - k0 < p.window);
      if (softcap) {
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) sc[e] = cap_score(sc[e] * p.scale, p.softcap) * kLog2e;
      } else {
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) sc[e] *= sl;
      }
      if (!inside) {
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e)
          if (!key_ok(p, p.q_off + ((e & 2) ? row1 : row0), k0 + 8 * (e / 4) + 2 * tq4 + (e & 1)))
            sc[e] = kNeg;
      }
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      // the four threads of a row group hold one row's kBN keys
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // P = exp2(s - m) in fp32 for the sums, rounded to bf16 as wgmma's A
      // fragments: k16 slice kk is accumulator chunks 2 kk and 2 kk + 1
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) e[x] = ex2(sc[8 * kk + x] - ((x & 2) ? mn1 : mn0));
        ps0 += (e[0] + e[1]) + (e[4] + e[5]);
        ps1 += (e[2] + e[3]) + (e[6] + e[7]);
        pa[kk][0] = pack_bf16(e[0], e[1]);
        pa[kk][1] = pack_bf16(e[2], e[3]);
        pa[kk][2] = pack_bf16(e[4], e[5]);
        pa[kk][3] = pack_bf16(e[6], e[7]);
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }

      // O += P V: V [keys, D] is MN-major; k16 slice kk starts at key row 16 kk,
      // the next box of C columns is T::kBoxBytes on (LBO), the next 8 keys 8 RB (SBO)
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv(o, pa[kk], T::mn_desc(tV, kk));
      wgmma_commit();  // waited for after the next tile's QK^T is queued
    }
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ((t_end - t_begin - 1) % kStages));

    write_rows<D>(p, o, l0, l1, m0, m1, b, h, row0, tq4);
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT, eight lanes per query row
// ---------------------------------------------------------------------------

constexpr int kLanes = 8;
constexpr int kRowsF = 128 / kLanes;  // query rows per block

// keys per tile: 32, and 16 at D = 256 (K and V tiles 32 KB, within the
// 48 KB of static shared memory)
template <int D>
constexpr int kKeyTileF32 = D == 256 ? 16 : 32;

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_f32_kernel(const Params p) {
  constexpr int kBNF = kKeyTileF32<D>;
  constexpr int E = D / kLanes;               // elements per lane
  constexpr int VEC = E >= 4 ? 4 : E;         // contiguous elements per load
  constexpr int NV = E / VEC;
  __shared__ __align__(16) float sK[kBNF][D];
  __shared__ __align__(16) float sV[kBNF][D];

  const int n_qt = (p.Sq + kRowsF - 1) / kRowsF;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kRowsF;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int ln = threadIdx.x % kLanes;
  const int row = q0 + threadIdx.x / kLanes;
  const int qpos = p.q_off + row;
  const bool live = row < p.Sq;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  // this lane's columns: i * kLanes * VEC + ln * VEC + c (the eight lanes of
  // a row read 8 * VEC contiguous floats per step: no bank conflicts)
  float q[E], acc[E];
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + row * p.q_ss;
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
      if (k0 + r < p.Skv) {
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
  float* O = static_cast<float*>(p.o) + (((int64_t)b * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      O[i * kLanes * VEC + ln * VEC + c] = acc[i * VEC + c] / den;
  if (p.lse != nullptr && ln == 0) p.lse[((int64_t)b * p.Hq + h) * p.Sq + row] = m + logf(den);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes_bf16<D>(), kBN = kKeyTile<D>;
  static_assert(smem <= 232448, "over the 227 KB of shared memory a block can have");
  const int n_qt = (p.Sq + kBM - 1) / kBM;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;  // boxes of kBM query rows, of kBN keys
  int e = encode<D, kBM>(&tq, p.q, p.B, p.Sq, p.Hq, p.q_sb, p.q_ss, p.q_sh);
  if (!e) e = encode<D, kBN>(&tk, p.k, p.B, p.Skv, p.Hkv, p.k_sb, p.k_ss, p.k_sh);
  if (!e) e = encode<D, kBN>(&tv, p.v, p.B, p.Skv, p.Hkv, p.v_sb, p.v_ss, p.v_sh);
  if (e) return e;
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.Hq, n_qt, p.B);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kRowsF - 1) / kRowsF, p.Hq, p.B);
  flash_fwd_f32_kernel<D><<<grid, 128, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
             int Skv, int q_off, int Hq, int Hkv, int D, int64_t q_sb, int64_t q_ss,
             int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
             int64_t v_sh, float scale, int causal, int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || q_off < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
      B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  // every query row keeps a key: the last row's window must reach below Skv
  if (window > 0 && (int64_t)q_off + Sq - window >= Skv) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, lse, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 B, Sq, Skv, q_off, Hq, Hkv, scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return BF16 ? launch_bf16<16>(p, s) : launch_f32<16>(p, s);
    case 32: return BF16 ? launch_bf16<32>(p, s) : launch_f32<32>(p, s);
    case 64: return BF16 ? launch_bf16<64>(p, s) : launch_f32<64>(p, s);
    case 128: return BF16 ? launch_bf16<128>(p, s) : launch_f32<128>(p, s);
    case 256: return BF16 ? launch_bf16<256>(p, s) : launch_f32<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define FLASH_ARGS                                                                            \
  const void *q, const void *k, const void *v, void *o, float *lse, int B, int Sq, int Skv,   \
      int q_off, int Hq, int Hkv, int D,                                                      \
      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,     \
      int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal, int window,          \
      float softcap, void *stream
#define FLASH_PASS                                                                            \
  q, k, v, o, lse, B, Sq, Skv, q_off, Hq, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   \
      v_ss, v_sh, scale, causal, window, softcap, stream

extern "C" int flash_attention_bf16(FLASH_ARGS) { return dispatch<true>(FLASH_PASS); }

extern "C" int flash_attention_f32(FLASH_ARGS) { return dispatch<false>(FLASH_PASS); }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
