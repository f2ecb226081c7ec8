// Tensor-core tile bodies for bf16 flash attention on Hopper (sm_90a): the
// forward (K1 and K1v, included by flash_attention_fwd.cu; K9's forward,
// flashmask_attention.cu), the dQ kernel (K2 and K2v, included by
// flash_attention_bwd.cu) and the dK/dV kernel (K2, K2v and K9's), each a
// template over the padded head dim (64 or 128) and a mask policy of
// flash_attention_tiles.cuh (the same `kind` / `visible` / `col_info`
// interface the CUDA-core bodies use: `LenCausalMask` for K1/K2,
// `StartRowMask` for K9). f32 and head dims above 128 keep the CUDA-core
// bodies of flash_attention_tiles.cuh.
//
// Block layout (all three kernels): two warpgroups of 128 threads, each
// owning 64 rows of the block's 128. Every load is a TMA copy into 128-
// byte-swizzled shared tiles (a tile is stored as panels of 64 bf16
// columns, 128 B per row; TMA's zero fill covers rows past the sequence
// and columns from d up to the padded head dim), issued by thread 0 one
// visited tile ahead of the math through a 2-stage ring: an `mbarrier` per
// stage says the bytes landed, a second one that both warpgroups are done
// with them. A separate producer warp would cost the consumers their
// registers: a block of 9 warps is given registers as one of 12 (168 a
// thread), and `setmaxnreg` did not let ptxas keep dK/dV's 192 accumulator
// registers unspilled; with 8 warps each thread may use 255 and nothing
// spills.
//  * forward: one block per (128 q rows, q head, batch). Q is loaded once;
//    K and V tiles of KN kv rows (64 at d <= 64, where two blocks then fit
//    an SM; 128 above) stream through the ring, K and V on their own
//    barriers, so S = Q K^T starts before V lands. S is wgmma with both
//    operands in shared memory; the scale and the online softmax run in f32
//    on the accumulator fragments; P is cast to bf16 (as the reference
//    casts p to v's dtype) and is the A operand of O += P V straight from
//    registers (the accumulator layout of S is the A fragment layout); O
//    stays in f32 registers. With kv_lens (K1v) the mask policy reads the
//    batch row's length; kv tiles past it are never loaded.
//  * dQ: the forward's block and ring (one block per 128 q rows, q head
//    and batch; K and V tiles of KN rows, each on its own barrier, so the
//    stage's V is released before its K), with Q and dO loaded once and
//    held, and each thread's two rows of lse and delta in registers. S = Q K^T and dP = dO V^T are shared x shared;
//    dS = P (dP - delta), P = exp(S scale - lse), is formed in f32 on the
//    accumulator fragments and cast to bf16 A fragments of dQ += dS K,
//    whose B is the same K tile read MN-major (a second descriptor over
//    it, as V is read in P V). dQ stays in f32 registers: no atomics, the
//    same bits on every run. A stage's V is released after dP, its K after
//    dS K. With kv_lens (K2v) the last kv tile is the one holding the
//    length; a length of 0 visits none and writes dQ = 0.
//  * dK/dV: one block per (128 kv rows, kv head, batch). K and V are loaded
//    once and stay; Q and dO tiles of 64 q rows, with their lse and delta
//    rows, stream through the ring, over every q head of the GQA group and
//    every q tile that sees the block. S^T = K Q^T and dP^T = V dO^T
//    (shared x shared) leave P^T and dS^T = P^T (dP^T - delta) in the
//    A-fragment layout of dV += P^T dO and dK += dS^T Q, which take them
//    from registers as bf16. dK and dV stay in f32 registers for the whole
//    block: no atomics, the same bits on every run, zeros for kv rows no q
//    row sees. With kv_lens (K2v) a block that starts at or past its batch
//    row's length visits no q tile; every q head of the GQA group shares
//    that length.
// Masks: `Mask::kind` per (64-row tile, 64-column tile); `visible` per
// accumulator element of masked tiles only. A warpgroup whose tile is
// skipped still waits for and releases the stage, so the ring stays in
// step; a stage neither warpgroup needs is never loaded. Masked
// probabilities are zeroed, never exponentiated: a row that sees no key
// has lse = -1e30.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <stdint.h>

#include "flash_attention_tiles.cuh"
#include "hopper_common.cuh"


namespace {

constexpr int kTcGroups = 2;                        // warpgroups
constexpr int kTcThreads = 128 * kTcGroups;
constexpr int kTcRows = 64 * kTcGroups;             // block rows
constexpr int kTcStages = 2;                        // the streamed ring
constexpr int kPanel = 64;       // bf16 columns of one 128-byte panel
constexpr int kRowBytes = 128;   // one panel row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------- PTX helpers
// (the shared ones are in hopper_common.cuh)

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The wgmma forms the bodies use (f32 += bf16 x bf16, 64 rows, depth 16):
// A and B both K-major in shared memory (scale_d = 0 overwrites d), and A
// from registers with B MN-major in shared memory (accumulates).

__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// d = A B (scale_d 0) or d += A B, both K-major in shared memory, N = 64
// or 128 columns
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 128) {
    wgmma_m64n128k16_ss(d, da, db, scale_d);
  } else {
    wgmma_m64n64k16_ss(d, da, db, scale_d);
  }
}

// d += A B with A from registers and B MN-major, N = the padded head dim
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_m64n64k16_rs(d, a, db);
  } else {
    wgmma_m64n128k16_rs(d, a, db);
  }
}

// Accumulator fragments (per warpgroup, 64 rows): thread t of the group
// holds rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns 8 j + 2 (t %
// 4) + {0, 1}, in d[4 j + 2 i + c] (row r + 8 i, column 8 j + 2 (t % 4) +
// c). The 16 columns of k-step kk of an A operand are j = 2 kk, 2 kk + 1.
template <int N>
__device__ __forceinline__ void a_frags(const float (&s)[N / 2],
                                        uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// The online softmax of one S tile (64 q rows x KN keys) in f32, in log2
// units, in place: masks it (kMasked tiles only), updates the rows' max m
// and sum l, and returns alpha (the factor the rows' O takes) and P as the
// bf16 A fragments of P V. `row` is this thread's first fragment row.
template <int KN, typename Mask>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[KN / 2], int kind, const Mask& mask, int row, int k0, int c,
    float scale_log2, float (&m_r)[2], float (&l_r)[2], float (&alpha)[2],
    uint32_t (&pf)[KN / 16][4]) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int j = 0; j < KN / 8; ++j)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int x = 4 * j + 2 * ii + cc;
        float v = sc[x] * scale_log2;
        if (kind == kMasked) {
          const int col = k0 + 8 * j + c + cc;
          // -inf: its p is 0, and m never drops below kNeg for it
          if (!mask.visible(row + 8 * ii, col, mask.col_info(col)))
            v = -__int_as_float(0x7f800000);
        }
        sc[x] = v;
        mx[ii] = fmaxf(mx[ii], v);
      }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 1));
    mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 2));
    const float mn = fmaxf(m_r[ii], mx[ii]);
    alpha[ii] = fast_exp2(m_r[ii] - mn);
    m_r[ii] = mn;
  }
#pragma unroll
  for (int j = 0; j < KN / 8; ++j)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int x = 4 * j + 2 * ii + cc;
        sc[x] = fast_exp2(sc[x] - m_r[ii]);
        sum[ii] += sc[x];
      }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    sum[ii] += __shfl_xor_sync(0xffffffffu, sum[ii], 1);
    sum[ii] += __shfl_xor_sync(0xffffffffu, sum[ii], 2);
    l_r[ii] = l_r[ii] * alpha[ii] + sum[ii];
  }
  a_frags<KN>(sc, pf);  // P in bf16, as the reference casts p to v's dtype
}

// O's rows r and r + 8 times alpha[0] and alpha[1]
template <int DP>
__device__ __forceinline__ void rescale(float (&acc)[DP / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      acc[4 * j + 2 * ii] *= alpha[ii];
      acc[4 * j + 2 * ii + 1] *= alpha[ii];
    }
}

// the kinds of a dK/dV block's two 64-row kv tiles (rows past Sk are
// skipped) against the q tile at q0; whether either is visited
template <typename Mask>
__device__ __forceinline__ bool dkv_kinds(const Mask& m, int k0, int q0,
                                          int sk, int& kind0, int& kind1) {
  kind0 = m.kind(q0, k0);
  kind1 = k0 + kBK < sk ? m.kind(q0, k0 + kBK) : kSkip;
  return kind0 != kSkip || kind1 != kSkip;
}

// Steps (g, qt) to the next q head g of the GQA group and q tile qt that
// a dK/dV block at k0 visits (qt = -1: before head g's first); false past
// the last.
template <typename Mask>
__device__ __forceinline__ bool dkv_next(const typename Mask::Args& margs,
                                         int b, int hk, int rep, int hq,
                                         int sq, int sk, int k0, int& g,
                                         int& qt) {
  const int nqt = (sq + kBQ - 1) / kBQ;
  while (g < rep) {
    const Mask mask(margs, b, hk * rep + g, hq, sq, sk);
    const int qt_end = max(mask.q_end(k0, nqt),
                           k0 + kBK < sk ? mask.q_end(k0 + kBK, nqt) : 0);
    for (qt = qt < 0 ? mask.q_first(k0) : qt + 1; qt < qt_end; ++qt) {
      int kind0, kind1;
      if (dkv_kinds(mask, k0, qt * kBQ, sk, kind0, kind1)) return true;
    }
    ++g;
    qt = -1;
  }
  return false;
}

// ------------------------------------------------------- q blocks (fwd, dQ)

// the kind of a kv tile of KN keys (KN / 64 tiles of the mask policy) for
// the 64-row q tile at q0: skipped if every part is, full if every part is
template <int KN, typename Mask>
__device__ __forceinline__ int kv_tile_kind(const Mask& m, int q0, int k0,
                                            int sk) {
  int skip = 0, full = 0;
#pragma unroll
  for (int u = 0; u < KN / kBK; ++u) {
    const int kind = k0 + u * kBK < sk ? m.kind(q0, k0 + u * kBK) : kSkip;
    skip += kind == kSkip;
    full += kind == kFull;
  }
  return skip == KN / kBK ? kSkip : full == KN / kBK ? kFull : kMasked;
}

// the kinds of a q block's two 64-row q tiles (rows past Sq are skipped)
// against the kv tile at k0; whether either is visited
template <int KN, typename Mask>
__device__ __forceinline__ bool fwd_kinds(const Mask& m, int q0, int k0,
                                          int sq, int sk, int& kind0,
                                          int& kind1) {
  kind0 = kv_tile_kind<KN>(m, q0, k0, sk);
  kind1 = q0 + kBQ < sq ? kv_tile_kind<KN>(m, q0 + kBQ, k0, sk) : kSkip;
  return kind0 != kSkip || kind1 != kSkip;
}

// byte offsets from the 1024-aligned shared base of a q block that holds
// NQ operands of its 128 q rows (the forward Q; dQ Q and dO) and streams K
// and V tiles of KN rows
template <int DP, int KN, int NQ>
struct QBlockSmem {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kQBytes = kPanels * kTcRows * kRowBytes;  // Q or dO
  static constexpr int kTileBytes = kPanels * KN * kRowBytes;    // K or V
  static constexpr int kQ = 0;
  static constexpr int kDO = kQBytes;  // NQ == 2
  static constexpr int kK = NQ * kQBytes;
  static constexpr int kV = kK + kTcStages * kTileBytes;
  static constexpr int kBar = kV + kTcStages * kTileBytes;
  // barriers: Q (and dO) loaded; K, V of stage s loaded; K, V of stage s
  // released
  static constexpr int kBarQ = kBar, kBarK = kBar + 8, kBarV = kBar + 24,
                       kFreeK = kBar + 40, kFreeV = kBar + 56;
  static constexpr int kBytes = kBar + 72 + 1024;  // + alignment slack
};
template <int DP, int KN>
using FwdTcSmem = QBlockSmem<DP, KN, 1>;
template <int DP, int KN>
using DqTcSmem = QBlockSmem<DP, KN, 2>;

// keys per kv tile of a q block (the N of S = Q K^T, the depth of O += P V
// or dQ += dS K) by padded head dim: at 64, 64 keys keep a forward thread
// under 128 registers, so two blocks share an SM; at 128, 128 keys halve
// the steps per row (the forward measured faster than 64 keys, or 64 at
// two blocks an SM, which spills)
template <int DP>
constexpr int ring_kn() {
  return DP == 64 ? 64 : 128;
}

// Thread 0 initialises a q block's barriers; the block then syncs.
template <typename L>
__device__ __forceinline__ void init_q_block(uint32_t base) {
  if (threadIdx.x == 0) {
    mbar_init(base + L::kBarQ, 1);
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(base + L::kBarK + 8 * s, 1);
      mbar_init(base + L::kBarV + 8 * s, 1);
      mbar_init(base + L::kFreeK + 8 * s, 4 * kTcGroups);
      mbar_init(base + L::kFreeV + 8 * s, 4 * kTcGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Thread 0 of a q block at q0: loads the next kv tile after `lt` that
// either warpgroup visits into stage `li & 1` of the ring (K, then V, each
// on its own barrier, once both warpgroups released that stage's K or V),
// from kv head `kvh` (b * Hkv + h / (Hq / Hkv)). `lt` becomes that tile
// (>= ntiles: none left) and `li` counts the tiles loaded.
template <typename L, int KN, typename Mask>
__device__ __forceinline__ void load_next_kv(
    uint32_t base, const CUtensorMap* tk, const CUtensorMap* tv,
    const Mask& mask, int q0, int sq, int sk, int ntiles, int kvh, int& lt,
    int& li) {
  int kind0, kind1;
  do {
    ++lt;
  } while (lt < ntiles &&
           !fwd_kinds<KN>(mask, q0, lt * KN, sq, sk, kind0, kind1));
  if (lt >= ntiles) return;
  const int s = li & 1;
  const uint32_t ph = (li >> 1) & 1;
  ++li;
  const uint32_t full_k = base + L::kBarK + 8 * s;
  const uint32_t full_v = base + L::kBarV + 8 * s;
  mbar_wait(base + L::kFreeK + 8 * s, ph ^ 1);
  mbar_arrive_tx(full_k, L::kTileBytes);
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
    tma_load(base + L::kK + s * L::kTileBytes + p * KN * kRowBytes, tk,
             full_k, p * kPanel, lt * KN, kvh);
  mbar_wait(base + L::kFreeV + 8 * s, ph ^ 1);
  mbar_arrive_tx(full_v, L::kTileBytes);
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
    tma_load(base + L::kV + s * L::kTileBytes + p * KN * kRowBytes, tv,
             full_v, p * kPanel, lt * KN, kvh);
}

// ------------------------------------------------------------------ forward

template <int DP, int KN, typename Mask>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    typename Mask::Args margs, int hq, int hkv, int sq,
                    int sk, int d, float scale_log2) {
  using L = FwdTcSmem<DP, KN>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t base = (smem_u32(tc_smem) + 1023) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  // causal: the last q blocks see the most kv tiles; launch them first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;
  const Mask mask(margs, b, h, hq, sq, sk);
  // the later warpgroup sees the most kv tiles
  const int kv_end = mask.kv_end(q0 + kTcRows - kBQ);
  const int ntiles = kv_end > 0 ? (kv_end + KN - 1) / KN : 0;
  init_q_block<L>(base);

  // Thread 0 issues every load, one visited kv tile ahead of the math:
  // `lt` is the last tile it loaded, `li` the count of loaded tiles.
  const int kvh = b * hkv + h / (hq / hkv);
  int lt = -1, li = 0;
  auto load_next = [&]() {
    load_next_kv<L, KN>(base, &tk, &tv, mask, q0, sq, sk, ntiles, kvh, lt,
                        li);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_tx(base + L::kBarQ, L::kQBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load(base + L::kQ + p * kTcRows * kRowBytes, &tq, base + L::kBarQ,
               p * kPanel, q0, b * hq + h);
    load_next();
  }

  // consumers: warpgroup wg owns q rows qw .. qw + 63
  const int wg = warp >> 2;
  const int r = 16 * (warp & 3) + (lane >> 2);  // fragment rows r, r + 8
  const int c = 2 * (lane & 3);                 // fragment column offset
  const int qw = q0 + kBQ * wg;
  const uint32_t qa = base + L::kQ + wg * kBQ * kRowBytes;
  float acc[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) acc[x] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};  // log2 units
  mbar_wait(base + L::kBarQ, 0);

  int i = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * KN;
    int kind0, kind1;
    if (!fwd_kinds<KN>(mask, q0, k0, sq, sk, kind0, kind1)) continue;
    const int kind = wg ? kind1 : kind0;  // uniform over the warpgroup
    const int s = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    ++i;
    if (threadIdx.x == 0) load_next();  // the next tile, into the other stage
    const uint32_t ks = base + L::kK + s * L::kTileBytes;
    const uint32_t vs = base + L::kV + s * L::kTileBytes;

    float sc[KN / 2];
    mbar_wait(base + L::kBarK + 8 * s, ph);
    if (kind != kSkip) {  // S = Q K^T
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<KN>(
            sc,
            sw128_desc(qa + (kk >> 2) * kTcRows * kRowBytes + (kk & 3) * 32,
                       16),
            sw128_desc(ks + (kk >> 2) * KN * kRowBytes + (kk & 3) * 32, 16),
            kk > 0);
      wg_commit();
      wg_wait0();
      keep(sc);
    }
    if (lane == 0) mbar_arrive(base + L::kFreeK + 8 * s);

    uint32_t pf[KN / 16][4];
    if (kind != kSkip) {
      float alpha[2];
      softmax_tile<KN>(sc, kind, mask, qw + r, k0, c, scale_log2, m_r, l_r,
                       alpha, pf);
      rescale<DP>(acc, alpha);
    }

    mbar_wait(base + L::kBarV + 8 * s, ph);
    if (kind != kSkip) {  // O += P V
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        wgmma_rs<DP>(acc, pf[kk],
                     sw128_desc(vs + kk * 16 * kRowBytes, KN * kRowBytes));
      wg_commit();
      wg_wait0();
      keep(acc);
    }
    if (lane == 0) mbar_arrive(base + L::kFreeV + 8 * s);
  }

  const size_t row0 = (size_t)(b * hq + h) * sq;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = qw + r + 8 * ii;
    if (row >= sq) continue;
    // a row that sees no key: O = 0, lse = -1e30
    const float inv = l_r[ii] > 0.f ? 1.f / l_r[ii] : 0.f;
    uint32_t* orow = reinterpret_cast<uint32_t*>(o + (row0 + row) * d);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c;
      if (col < d)
        orow[col >> 1] = pack_bf16(acc[4 * j + 2 * ii] * inv,
                                   acc[4 * j + 2 * ii + 1] * inv);
    }
    if ((lane & 3) == 0)
      lse[row0 + row] =
          l_r[ii] > 0.f ? m_r[ii] * kLn2 + logf(l_r[ii]) : kNeg;
  }
}

// ---------------------------------------------------------------------- dQ

template <int DP, int KN, typename Mask>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq,
                       typename Mask::Args margs, int hq, int hkv, int sq,
                       int sk, int d, float scale, float scale_log2) {
  using L = DqTcSmem<DP, KN>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t base = (smem_u32(tc_smem) + 1023) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  // causal: the last q blocks see the most kv tiles; launch them first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;
  const Mask mask(margs, b, h, hq, sq, sk);
  // the later warpgroup sees the most kv tiles
  const int kv_end = mask.kv_end(q0 + kTcRows - kBQ);
  const int ntiles = kv_end > 0 ? (kv_end + KN - 1) / KN : 0;
  init_q_block<L>(base);

  // Thread 0 issues every load: Q and dO once, then K and V one visited
  // kv tile ahead of the math.
  const int kvh = b * hkv + h / (hq / hkv);
  int lt = -1, li = 0;
  auto load_next = [&]() {
    load_next_kv<L, KN>(base, &tk, &tv, mask, q0, sq, sk, ntiles, kvh, lt,
                        li);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_tx(base + L::kBarQ, 2 * L::kQBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      tma_load(base + L::kQ + p * kTcRows * kRowBytes, &tq, base + L::kBarQ,
               p * kPanel, q0, b * hq + h);
      tma_load(base + L::kDO + p * kTcRows * kRowBytes, &tdo,
               base + L::kBarQ, p * kPanel, q0, b * hq + h);
    }
    load_next();
  }

  // consumers: warpgroup wg owns q rows qw .. qw + 63
  const int wg = warp >> 2;
  const int r = 16 * (warp & 3) + (lane >> 2);  // fragment rows r, r + 8
  const int c = 2 * (lane & 3);                 // fragment column offset
  const int qw = q0 + kBQ * wg;
  const uint32_t qa = base + L::kQ + wg * kBQ * kRowBytes;
  const uint32_t da = base + L::kDO + wg * kBQ * kRowBytes;
  const size_t row0 = (size_t)(b * hq + h) * sq;
  // the fragment rows' lse (log2 units) and delta; rows past Sq (Q and dO
  // zero-filled, never written) read neither
  float l2[2], dl[2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = qw + r + 8 * ii;
    l2[ii] = row < sq ? lse[row0 + row] * kLog2e : 0.f;
    dl[ii] = row < sq ? delta[row0 + row] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) acc[x] = 0.f;
  mbar_wait(base + L::kBarQ, 0);

  int i = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * KN;
    int kind0, kind1;
    if (!fwd_kinds<KN>(mask, q0, k0, sq, sk, kind0, kind1)) continue;
    const int kind = wg ? kind1 : kind0;  // uniform over the warpgroup
    const int s = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    ++i;
    if (threadIdx.x == 0) load_next();  // the next tile, into the other stage
    const uint32_t ks = base + L::kK + s * L::kTileBytes;
    const uint32_t vs = base + L::kV + s * L::kTileBytes;

    float sc[KN / 2], dp[KN / 2];  // S and dP: q rows x KN keys
    // both operands first: a wgmma group left in flight across the wait
    // for V (a divergent loop) makes ptxas serialize the kernel's wgmmas
    mbar_wait(base + L::kBarK + 8 * s, ph);
    mbar_wait(base + L::kBarV + 8 * s, ph);
    if (kind != kSkip) {  // S = Q K^T, dP = dO V^T
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t a_off =
            (kk >> 2) * kTcRows * kRowBytes + (kk & 3) * 32;
        const uint32_t b_off = (kk >> 2) * KN * kRowBytes + (kk & 3) * 32;
        wgmma_ss<KN>(sc, sw128_desc(qa + a_off, 16),
                     sw128_desc(ks + b_off, 16), kk > 0);
        wgmma_ss<KN>(dp, sw128_desc(da + a_off, 16),
                     sw128_desc(vs + b_off, 16), kk > 0);
      }
      wg_commit();
      wg_wait0();
      keep(sc);
      keep(dp);
    }
    if (lane == 0) mbar_arrive(base + L::kFreeV + 8 * s);

    if (kind != kSkip) {
      // dS = P (dP - delta) in place of dP; masked probabilities are zeroed
      // before they meet lse
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int x = 4 * j + 2 * ii + cc;
            const int col = k0 + 8 * j + c + cc;
            const bool ok =
                kind == kFull ||
                mask.visible(qw + r + 8 * ii, col, mask.col_info(col));
            const float p =
                ok ? fast_exp2(sc[x] * scale_log2 - l2[ii]) : 0.f;
            dp[x] = p * (dp[x] - dl[ii]);
          }
      uint32_t sf[KN / 16][4];
      a_frags<KN>(dp, sf);  // dS in bf16
      wg_fence();           // dQ += dS K, K read MN-major
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        wgmma_rs<DP>(acc, sf[kk],
                     sw128_desc(ks + kk * 16 * kRowBytes, KN * kRowBytes));
      wg_commit();
      wg_wait0();
      keep(acc);
    }
    if (lane == 0) mbar_arrive(base + L::kFreeK + 8 * s);
  }

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = qw + r + 8 * ii;
    if (row >= sq) continue;
    uint32_t* dqr = reinterpret_cast<uint32_t*>(dq + (row0 + row) * d);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c;
      if (col < d)
        dqr[col >> 1] = pack_bf16(acc[4 * j + 2 * ii] * scale,
                                  acc[4 * j + 2 * ii + 1] * scale);
    }
  }
}

// ------------------------------------------------------------------- dK/dV

template <int DP>
struct DkvTcSmem {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kKVBytes = kPanels * kTcRows * kRowBytes;  // K or V
  static constexpr int kTileBytes = kPanels * kBQ * kRowBytes;    // Q or dO
  static constexpr int kRowsBytes = kBQ * 4;  // one tile's lse or delta
  static constexpr int kStageBytes = 2 * kTileBytes + 2 * kRowsBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kDO = kQ + kTcStages * kTileBytes;
  static constexpr int kLse = kDO + kTcStages * kTileBytes;  // f32 [2][64]
  static constexpr int kDelta = kLse + kTcStages * kRowsBytes;
  static constexpr int kBar = kDelta + kTcStages * kRowsBytes;
  // barriers: K and V loaded; stage s loaded; stage s released
  static constexpr int kBarKV = kBar, kBarFull = kBar + 8,
                       kBarFree = kBar + 24;
  static constexpr int kBytes = kBar + 40 + 1024;  // + alignment slack
};

template <int DP, typename Mask>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tlse,
                        const __grid_constant__ CUtensorMap tdelta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv,
                        typename Mask::Args margs, int hq, int hkv, int sq,
                        int sk, int d, float scale, float scale_log2) {
  using L = DkvTcSmem<DP>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t base = (smem_u32(tc_smem) + 1023) & ~1023u;
  const float* lse_s = reinterpret_cast<const float*>(
      tc_smem + (base - smem_u32(tc_smem)) + L::kLse);
  const float* delta_s = lse_s + (L::kDelta - L::kLse) / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  // causal: the first kv blocks are seen by the most q tiles; launch first
  const int k0 = blockIdx.z * kTcRows;
  const int rep = hq / hkv;

  if (threadIdx.x == 0) {
    mbar_init(base + L::kBarKV, 1);
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(base + L::kBarFull + 8 * s, 1);
      mbar_init(base + L::kBarFree + 8 * s, 4 * kTcGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues every load: K and V once, then each visit's stage one
  // visit ahead of the math (cursor lg, lq; li stages loaded).
  int lg = 0, lq = -1, li = 0;
  auto load_next = [&]() {
    if (!dkv_next<Mask>(margs, b, hk, rep, hq, sq, sk, k0, lg, lq)) return;
    const int h = hk * rep + lg, q0 = lq * kBQ;
    const int s = li & 1;
    const uint32_t ph = (li >> 1) & 1;
    ++li;
    const uint32_t full = base + L::kBarFull + 8 * s;
    mbar_wait(base + L::kBarFree + 8 * s, ph ^ 1);
    mbar_arrive_tx(full, L::kStageBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      tma_load(base + L::kQ + s * L::kTileBytes + p * kBQ * kRowBytes, &tq,
               full, p * kPanel, q0, b * hq + h);
      tma_load(base + L::kDO + s * L::kTileBytes + p * kBQ * kRowBytes, &tdo,
               full, p * kPanel, q0, b * hq + h);
    }
    tma_load_2d(base + L::kLse + s * L::kRowsBytes, &tlse, full, q0,
                b * hq + h);
    tma_load_2d(base + L::kDelta + s * L::kRowsBytes, &tdelta, full, q0,
                b * hq + h);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_tx(base + L::kBarKV, 2 * L::kKVBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      tma_load(base + L::kK + p * kTcRows * kRowBytes, &tk, base + L::kBarKV,
               p * kPanel, k0, b * hkv + hk);
      tma_load(base + L::kV + p * kTcRows * kRowBytes, &tv, base + L::kBarKV,
               p * kPanel, k0, b * hkv + hk);
    }
    load_next();
  }

  // warpgroup wg owns kv rows kw .. kw + 63
  const int wg = warp >> 2;
  const int r = 16 * (warp & 3) + (lane >> 2);  // fragment rows r, r + 8
  const int c = 2 * (lane & 3);                 // fragment column offset
  const int kw = k0 + kBK * wg;
  const uint32_t ka = base + L::kK + wg * kBK * kRowBytes;
  const uint32_t va = base + L::kV + wg * kBK * kRowBytes;
  float acc_k[DP / 2], acc_v[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) acc_k[x] = acc_v[x] = 0.f;
  mbar_wait(base + L::kBarKV, 0);

  int g = 0, qt = -1, i = 0;
  while (dkv_next<Mask>(margs, b, hk, rep, hq, sq, sk, k0, g, qt)) {
    const Mask mask(margs, b, hk * rep + g, hq, sq, sk);
    const int q0 = qt * kBQ;
    int kind0, kind1;
    dkv_kinds(mask, k0, q0, sk, kind0, kind1);
    const int kind = wg ? kind1 : kind0;  // uniform over the warpgroup
    const int s = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    ++i;
    if (threadIdx.x == 0) load_next();  // the next visit, into the other stage
    mbar_wait(base + L::kBarFull + 8 * s, ph);
    if (kind != kSkip) {
      const uint32_t qs = base + L::kQ + s * L::kTileBytes;
      const uint32_t dos = base + L::kDO + s * L::kTileBytes;
      const float* ls = lse_s + s * kBQ;
      const float* dl = delta_s + s * kBQ;
      float st[32], dpt[32];  // S^T and dP^T: kv rows x q columns
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t a_off = (kk >> 2) * kTcRows * kRowBytes + (kk & 3) * 32;
        const uint32_t b_off = (kk >> 2) * kBQ * kRowBytes + (kk & 3) * 32;
        wgmma_ss<kBQ>(st, sw128_desc(ka + a_off, 16),
                      sw128_desc(qs + b_off, 16), kk > 0);
        wgmma_ss<kBQ>(dpt, sw128_desc(va + a_off, 16),
                      sw128_desc(dos + b_off, 16), kk > 0);
      }
      wg_commit();
      wg_wait0();
      keep(st);
      keep(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int qc = 8 * j + c + cc;  // q row within the tile
          const float l2 = ls[qc] * kLog2e, dlt = dl[qc];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const int x = 4 * j + 2 * ii + cc;
            const int col = kw + r + 8 * ii;
            const bool ok = kind == kFull ||
                            (q0 + qc < sq &&
                             mask.visible(q0 + qc, col, mask.col_info(col)));
            // masked probabilities are zeroed before they meet lse
            const float p = ok ? fast_exp2(st[x] * scale_log2 - l2) : 0.f;
            st[x] = p;
            dpt[x] = p * (dpt[x] - dlt);
          }
        }
      uint32_t pf[4][4], sf[4][4];
      a_frags<kBQ>(st, pf);   // P^T in bf16
      a_frags<kBQ>(dpt, sf);  // dS^T in bf16
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t row = kk * 16 * kRowBytes;
        wgmma_rs<DP>(acc_v, pf[kk], sw128_desc(dos + row, kBQ * kRowBytes));
        wgmma_rs<DP>(acc_k, sf[kk], sw128_desc(qs + row, kBQ * kRowBytes));
      }
      wg_commit();
      wg_wait0();
      keep(acc_k);
      keep(acc_v);
    }
    if (lane == 0) mbar_arrive(base + L::kBarFree + 8 * s);
  }

  const size_t kv0 = (size_t)(b * hkv + hk) * sk;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int row = kw + r + 8 * ii;
    if (row >= sk) continue;
    uint32_t* dkr = reinterpret_cast<uint32_t*>(dk + (kv0 + row) * d);
    uint32_t* dvr = reinterpret_cast<uint32_t*>(dv + (kv0 + row) * d);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c;
      if (col < d) {
        dkr[col >> 1] = pack_bf16(acc_k[4 * j + 2 * ii] * scale,
                                  acc_k[4 * j + 2 * ii + 1] * scale);
        dvr[col >> 1] =
            pack_bf16(acc_v[4 * j + 2 * ii], acc_v[4 * j + 2 * ii + 1]);
      }
    }
  }
}

// -------------------------------------------------------------- host side


// a bf16 [heads, rows, d] tensor as a 3-D map whose box is one 64-column
// panel of `box_rows` rows, 128-byte swizzled; out-of-range rows and
// columns read as zero
bool bf16_tmap(CUtensorMap* map, const void* ptr, int heads, int rows, int d,
               int box_rows) {
  const TmapEncode encode = tmap_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// an f32 [heads, sq] tensor whose rows lie `stride` floats apart (a
// multiple of 4: TMA's row stride is a multiple of 16 bytes) as a 2-D map
// whose box is one tile's 64 rows of one head; rows past Sq read as zero
bool f32_rows_tmap(CUtensorMap* map, const void* ptr, int heads, int sq,
                   int stride) {
  const TmapEncode encode = tmap_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)sq, (cuuint64_t)heads};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBQ, 1};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What the tensor-core bodies take: d a multiple of 8 up to 128 (TMA's
// row stride is a multiple of 16 bytes; larger head dims run the
// CUDA-core bodies) and TMA sources at 16-byte-aligned addresses (the
// pointers OR-ed together).
bool tc_takes(int d, uintptr_t ptrs) {
  return d % 8 == 0 && d <= kSmallD && ptrs % 16 == 0;
}

uintptr_t addr(const void* p) { return reinterpret_cast<uintptr_t>(p); }

template <int DP, typename Mask>
int run_fwd_tc(dim3 grid, const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, void* o, void* lse,
               typename Mask::Args margs, int hq, int hkv, int sq, int sk,
               int d, float scale, cudaStream_t stream) {
  constexpr int KN = ring_kn<DP>();
  const int smem = FwdTcSmem<DP, KN>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DP, KN, Mask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_tc_kernel<DP, KN, Mask><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      margs, hq, hkv, sq, sk, d, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename Mask>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  void* lse, typename Mask::Args margs, int b, int hq,
                  int hkv, int sq, int sk, int d, float scale,
                  cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int kn = d <= 64 ? ring_kn<64>() : ring_kn<128>();
  if (!tc_takes(d, addr(q) | addr(k) | addr(v)) ||
      !bf16_tmap(&tq, q, b * hq, sq, d, kTcRows) ||
      !bf16_tmap(&tk, k, b * hkv, sk, d, kn) ||
      !bf16_tmap(&tv, v, b * hkv, sk, d, kn))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hq, b, (sq + kTcRows - 1) / kTcRows);
  if (d <= 64)
    return run_fwd_tc<64, Mask>(grid, tq, tk, tv, o, lse, margs, hq, hkv, sq,
                                sk, d, scale, stream);
  return run_fwd_tc<128, Mask>(grid, tq, tk, tv, o, lse, margs, hq, hkv, sq,
                               sk, d, scale, stream);
}

template <int DP, typename Mask>
int run_bwd_dq_tc(dim3 grid, const CUtensorMap& tq, const CUtensorMap& tk,
                  const CUtensorMap& tv, const CUtensorMap& tdo,
                  const void* lse, const void* delta, void* dq,
                  typename Mask::Args margs, int hq, int hkv, int sq, int sk,
                  int d, float scale, cudaStream_t stream) {
  constexpr int KN = ring_kn<DP>();
  const int smem = DqTcSmem<DP, KN>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<DP, KN, Mask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_tc_kernel<DP, KN, Mask><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
      margs, hq, hkv, sq, sk, d, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

// lse and delta are read by plain loads (each thread its two rows), so
// only Q, K, V and dO must be 16-byte aligned
template <typename Mask>
int launch_bwd_dq_tc(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, typename Mask::Args margs, int b, int hq,
                     int hkv, int sq, int sk, int d, float scale,
                     cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const int kn = d <= 64 ? ring_kn<64>() : ring_kn<128>();
  if (!tc_takes(d, addr(q) | addr(k) | addr(v) | addr(dout)) ||
      !bf16_tmap(&tq, q, b * hq, sq, d, kTcRows) ||
      !bf16_tmap(&tdo, dout, b * hq, sq, d, kTcRows) ||
      !bf16_tmap(&tk, k, b * hkv, sk, d, kn) ||
      !bf16_tmap(&tv, v, b * hkv, sk, d, kn))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hq, b, (sq + kTcRows - 1) / kTcRows);
  if (d <= 64)
    return run_bwd_dq_tc<64, Mask>(grid, tq, tk, tv, tdo, lse, delta, dq,
                                   margs, hq, hkv, sq, sk, d, scale, stream);
  return run_bwd_dq_tc<128, Mask>(grid, tq, tk, tv, tdo, lse, delta, dq,
                                  margs, hq, hkv, sq, sk, d, scale, stream);
}

template <int DP, typename Mask>
int run_bwd_dkv_tc(dim3 grid, const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& tdo,
                   const CUtensorMap& tlse, const CUtensorMap& tdelta,
                   void* dk, void* dv, typename Mask::Args margs, int hq,
                   int hkv, int sq, int sk, int d, float scale,
                   cudaStream_t stream) {
  const int smem = DkvTcSmem<DP>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<DP, Mask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_tc_kernel<DP, Mask><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), margs, hq, hkv, sq, sk, d, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename Mask>
int launch_bwd_dkv_tc(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, typename Mask::Args margs, int b,
                      int hq, int hkv, int sq, int sk, int d, int ls_stride,
                      float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  if (!tc_takes(d, addr(q) | addr(k) | addr(v) | addr(dout) | addr(lse) |
                      addr(delta)) ||
      ls_stride % 4 != 0 ||
      !bf16_tmap(&tq, q, b * hq, sq, d, kBQ) ||
      !bf16_tmap(&tdo, dout, b * hq, sq, d, kBQ) ||
      !bf16_tmap(&tk, k, b * hkv, sk, d, kTcRows) ||
      !bf16_tmap(&tv, v, b * hkv, sk, d, kTcRows) ||
      !f32_rows_tmap(&tlse, lse, b * hq, sq, ls_stride) ||
      !f32_rows_tmap(&tdelta, delta, b * hq, sq, ls_stride))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(hkv, b, (sk + kTcRows - 1) / kTcRows);
  if (d <= 64)
    return run_bwd_dkv_tc<64, Mask>(grid, tq, tk, tv, tdo, tlse, tdelta, dk,
                                    dv, margs, hq, hkv, sq, sk, d, scale,
                                    stream);
  return run_bwd_dkv_tc<128, Mask>(grid, tq, tk, tv, tdo, tlse, tdelta, dk,
                                   dv, margs, hq, hkv, sq, sk, d, scale,
                                   stream);
}

}  // namespace
