// Paged flash-decode attention for Hopper (sm_90a), f32 accumulation: one
// query token per sequence against a block-paged KV cache read through a
// per-sequence block table. One kernel template, three cache formats:
// the model's dtype (bf16/f16/f32, K7), int8 with one f32 scale per block, and
// int4 packed two tokens per byte with one f32 scale per block (K7q).
// This header holds the template and its dispatch (`run<F>`); each format
// is instantiated in a source of its own (paged_decode.cu,
// paged_decode_int8.cu, paged_decode_int4.cu), so the three build in
// parallel. Those sources say what each replaces.
//
// Layout: q [S, Hq, D] bf16, f16 or f32; model-dtype caches [N, Hkv, bs, D] in
// q's dtype; int8 caches [N, Hkv, bs, D] int8; int4 caches [N, Hkv, bs/2,
// D] int8, where packed row t of a block holds token t in its low nibble
// and token bs/2 + t in its high nibble (signed 4-bit); k/v scales [N] f32
// (one layer's per-block scales: a cached value is code * scale[block]);
// block_tables [S, P] int32 (entries < 0 are padding, clamped to block 0
// as the TPU kernel does); seq_lens [S] int32; out [S, Hq, D] in q's dtype.
// The query heads [i*G, (i+1)*G) share kv head i (GQA, G = Hq / Hkv, any
// value). D is at most 256 and a multiple of 8, as the reference's kernel
// takes it (it serves d 256; head dims that are no multiple of 8 go to its
// XLA composition, and to the plain version here).
//
// What bounds it on the H100: memory. Each step reads every valid cache
// token once (len * D * bytes-per-element per kv head, for k and v: 2
// bytes in bf16, 1 in int8, 1/2 in int4, plus a scale per block) and does
// ~2 flops per element, far below the ~295 flop/byte ridge. To come near
// the card's 3.35 TB/s the whole card has to have bytes in flight at
// once: with one block per (kv head, sequence) a decode batch of 8
// sequences and 16 kv heads runs 128 blocks of 4 warps on 132 SMs, each
// walking its whole sequence chunk after chunk, so the longest sequence's
// serial walk sets the time (0.084 ms for 38.8 MB, 7.2x the bytes bound).
//
// Design: split-K over the context (Flash-Decoding's split, which the
// reference names; on the TPU the page axis is a sequential grid
// dimension carrying the running max, sum and accumulator, here blocks
// run in no order, so a second pass merges). The grid is (Hkv, S,
// splits): split z of a sequence covers tokens [z*T, (z+1)*T) of its
// table, T a multiple of 64 (of 256 or more with several splits) chosen
// on the host from the table's width alone (`ops/paged_decode.
// decode_splits`: no read of seq_lens, so the op needs no
// synchronisation). A block whose range starts at or past the
// sequence's length writes an empty partial (m = -1e30, l = 0) and
// exits without loading anything; the others write their running max m,
// sum l and unnormalised accumulator [G, D] in f32 to a workspace, and
// `paged_decode_merge_kernel` (launched by the same C entry) combines a
// row's partials by the log-sum-exp rule in split order, so two calls on
// the same inputs give the same bits. With one split the block writes
// the output itself and no merge runs.
//
// Inside a block (128 threads) the partition is walked in 64-token
// chunks (32 for f32 rows of up to 256 elements). Each chunk's K and V
// rows are gathered through the table into shared memory with 16-byte
// cp.async copies into a ring of kStages slots (3 where three slots of
// the largest rows fit in 72 KB, int8/int4 at D <= 128; else 2), all
// filled before the first chunk is computed; a slot is refilled as soon
// as its chunk is done, so the loads of later chunks overlap the compute
// of earlier ones. Each cache byte is read once for the whole GQA group,
// whose G query rows all live in the block. The int4
// format gathers each token's packed row (two tokens share one; the
// second read of a row is served by L2) and picks the token's nibble in
// registers. The quantized formats keep each token's block scales in
// shared memory: the k scale multiplies the token's logit and the v scale
// its probability in P.V (the TPU kernel applied them per page). Each
// chunk takes three barriers:
//  * scores: a token per group of DM/8 lanes, each lane one unit of 8
//    elements read as one 16-byte (int8: 8-byte) shared load, the G
//    partial dots reduced by shuffles within the group;
//  * softmax: one warp per query head updates the running max and sum;
//  * P.V: a thread owns one 8-element unit of one head's output (two or
//    four when G * D / 8 > 128) for every (128 / (G * D / 8))-th token of
//    the chunk, accumulating in f32 registers with 16-byte loads of V;
//    the token groups' sums are added in a fixed order once, at the end.
//
// Instantiations. A block holds G query heads of its kv head's group, G
// a template parameter in {1, 2, 4, 8, 16}, so the score partials and the
// output accumulators live in registers sized for it. A group of another
// size (3, 6, 7, 12, 32, ...) is cut into pieces of those sizes, largest
// first (7 = 4 + 2 + 1, 32 = 16 + 16), one launch each over the same
// cache: each piece reads the cache again (from L2 where it still holds
// it), the price of keeping every kernel's registers static; the pieces
// share one workspace and one merge. The largest head dim is a template
// parameter too (DM = 128 or 256), so the d <= 128 kernels keep their
// registers. Rows of a multiple of 16 bytes are copied 16 bytes at a time;
// 8-byte rows (an int8 or int4 row of d = 8 (mod 16) bytes) 8 bytes at a
// time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr int kUnit = 8;        // elements per unit of a row
constexpr int kPartStep = 64;   // a partition is whole 64-token chunks

// cache formats
constexpr int kModel = 0;    // q's dtype
constexpr int kInt8 = 1;     // int8 codes, one scale per block
constexpr int kInt4 = 2;     // int4 codes, two tokens per byte

template <typename T, int F>
struct CacheType { using type = int8_t; };
template <typename T>
struct CacheType<T, kModel> { using type = T; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// The 8 elements of the unit at p (shared memory) as f32, codes unscaled.
// `sh` selects the int4 nibble: 4 = low (first half of the block), 0 =
// high.
template <int F, typename C>
__device__ __forceinline__ void load_unit(const C* p, int sh,
                                          float (&x)[kUnit]) {
  if constexpr (F == kModel && std::is_same<C, __nv_bfloat16>::value) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else if constexpr (F == kModel && std::is_same<C, __half>::value) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else if constexpr (F == kModel) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < kUnit; ++i)
      x[i] = F == kInt8
                 ? (float)c[i]
                 : (float)((int)(int8_t)((uint8_t)c[i] << sh) >> 4);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cache tokens per chunk: 64, or 32 for f32 rows of up to 256 elements
template <typename C, int DM>
__host__ __device__ constexpr int chunk_tokens() {
  return sizeof(C) == 4 && DM > 128 ? 32 : 64;
}

// ring slots: 3 where three slots of DM-element K and V rows fit in 72 KB
template <typename C, int DM>
__host__ __device__ constexpr int ring_stages() {
  return 3 * 2 * chunk_tokens<C, DM>() * DM * (int)sizeof(C) <= 72 * 1024
             ? 3
             : 2;
}

// Shared memory of one block, in bytes, at head dim d: the K and V ring,
// then per slot the tokens' row offsets and k / v scales, then q [G][d],
// the chunk's scores [G][tok] and the running max, sum and rescale [G].
template <typename C, int DM>
size_t smem_bytes(int g, int d) {
  constexpr int tok = chunk_tokens<C, DM>(), st = ring_stages<C, DM>();
  return 2 * (size_t)st * tok * d * sizeof(C)       // K, V ring
         + sizeof(long long) * st * tok              // row offsets
         + sizeof(float) * 2 * st * tok              // k, v scales
         + sizeof(float) * ((size_t)g * d + (size_t)g * tok + 3 * g);
}

// One split of one (kv head, sequence): query heads [h_off, h_off + G) of
// the kv head's group of `grp`, tokens [z * part, (z + 1) * part) of the
// table. `vec` is the copy width in bytes (16 or 8). With splits == 1 it
// writes `out`; else its partial goes to ws_acc [S, Hq, splits, d] and
// ws_ml [S, Hq, splits, 2] (m, l).
template <typename T, int F, int G, int DM>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,
                    const typename CacheType<T, F>::type* __restrict__ kc,
                    const typename CacheType<T, F>::type* __restrict__ vc,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int hkv, int grp, int h_off, int bs, int d, int pages,
                    int part, int vec, float scale) {
  using C = typename CacheType<T, F>::type;
  constexpr int kTok = chunk_tokens<C, DM>();
  constexpr int kSt = ring_stages<C, DM>();
  constexpr int kU = DM / kUnit;              // units per row, lanes/token
  constexpr int kTpp = kThreads / kU;         // tokens per scores pass
  constexpr int kNp = G * kU;                 // (head, unit) pairs
  constexpr int kTgn = kNp < kThreads ? kThreads / kNp : 1;  // token groups
  constexpr int kPpt = kNp > kThreads ? kNp / kThreads : 1;  // pairs/thread
  static_assert(kU <= 32 && 32 % kU == 0, "a token's lanes share a warp");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* kbuf = reinterpret_cast<C*>(smem_raw);               // [kSt][kTok][d]
  C* vbuf = kbuf + kSt * kTok * d;                         // [kSt][kTok][d]
  long long* offs = reinterpret_cast<long long*>(vbuf + kSt * kTok * d);
  float* kss = reinterpret_cast<float*>(offs + kSt * kTok);  // [kSt][kTok]
  float* vss = kss + kSt * kTok;                              // [kSt][kTok]
  float* qs = vss + kSt * kTok;  // [G][d], pre-scaled
  float* ps = qs + G * d;        // [G][kTok]: scores, then probabilities
  float* ms = ps + G * kTok;     // [G] running max
  float* ls = ms + G;            // [G] running sum
  float* as = ls + G;            // [G] rescale factor of the current chunk

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, s = blockIdx.y, z = blockIdx.z;
  const int splits = gridDim.z;
  const int hq = hkv * grp;
  const int h0 = hk * grp + h_off;  // this block's first query head
  const int len = max(min(lens[s], pages * bs), 0);
  const int p0 = z * part;
  const int p1 = min(p0 + part, len);

  if (p0 >= len) {  // nothing of the sequence in this split
    if (splits > 1) {
      if (tid < G) {
        float* ml = ws_ml + (((size_t)s * hq + h0 + tid) * splits + z) * 2;
        ml[0] = kNeg;
        ml[1] = 0.f;
      }
    } else {
      for (int i = tid; i < G * d; i += kThreads)
        out[((size_t)s * hq + h0) * d + i] = from_f32<T>(0.f);
    }
    return;
  }

  const int* tab = tables + (size_t)s * pages;
  const int rows = F == kInt4 ? bs / 2 : bs;  // stored rows per block
  const int vpr = d * (int)sizeof(C) / vec;   // vectors per row
  const int epv = vec / (int)sizeof(C);       // elements per vector
  const int pn = p1 - p0;                     // tokens of this split
  const int nch = (pn + kTok - 1) / kTok;

  // the int4 nibble of the token at position pos
  auto nibble = [&](int pos) {
    return F == kInt4 && pos % bs >= rows ? 0 : 4;
  };
  // element offset and block scales of each token of chunk c, into slot
  // c % kSt (threads < kTok, one token each)
  auto row_offsets = [&](int c) {
    if (tid < kTok) {
      const int pos = p0 + c * kTok + tid;
      const int slot = (c % kSt) * kTok + tid;
      long long off = 0;
      float ks = 0.f, vs = 0.f;
      if (pos < p1) {
        const int blk = max(tab[pos / bs], 0);
        int t = pos % bs;
        if (F == kInt4 && t >= rows) t -= rows;
        off = (((long long)blk * hkv + hk) * rows + t) * d;
        if (F != kModel) {
          ks = kscale[blk];
          vs = vscale[blk];
        }
      }
      offs[slot] = off;
      kss[slot] = ks;
      vss[slot] = vs;
    }
  };
  // chunk c's K and V rows into slot c % kSt: one cp.async group (empty
  // past the last chunk, so the group count stays in step)
  auto fetch = [&](int c) {
    const int n = min(kTok, pn - c * kTok);
    const long long* o = offs + (c % kSt) * kTok;
    C* kd = kbuf + (c % kSt) * kTok * d;
    C* vd = vbuf + (c % kSt) * kTok * d;
    if (vec == 16) {
      for (int i = tid; i < n * vpr; i += kThreads) {
        const int t = i / vpr, e = (i - t * vpr) * epv;
        cp_async16(kd + t * d + e, kc + o[t] + e);
        cp_async16(vd + t * d + e, vc + o[t] + e);
      }
    } else {
      for (int i = tid; i < n * vpr; i += kThreads) {
        const int t = i / vpr, e = (i - t * vpr) * epv;
        cp_async8(kd + t * d + e, kc + o[t] + e);
        cp_async8(vd + t * d + e, vc + o[t] + e);
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < G * d; i += kThreads)
    qs[i] = to_f32(q[((size_t)s * hq + h0) * d + i]) * scale;
  if (tid < G) {
    ms[tid] = kNeg;
    ls[tid] = 0.f;
  }
  // P.V ownership: pair k of this thread is (head pg[k], unit pu[k]); its
  // tokens are tg, tg + kTgn, ...
  const int tg = kNp < kThreads ? tid / kNp : 0;
  int pg[kPpt], pu[kPpt];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const int pr = kNp < kThreads ? tid % kNp : tid + k * kThreads;
    pg[k] = pr / kU;
    pu[k] = pr % kU;
  }
  float acc[kPpt][kUnit];
#pragma unroll
  for (int k = 0; k < kPpt; ++k)
#pragma unroll
    for (int j = 0; j < kUnit; ++j) acc[k][j] = 0.f;

  // the ring: every slot's chunk in flight before the first is computed
  for (int j = 0; j < kSt && j < nch; ++j) row_offsets(j);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSt; ++j) fetch(j);

  const int su = tid % kU, st = tid / kU;  // scores: unit, token lane
  for (int c = 0; c < nch; ++c) {
    const int n = min(kTok, pn - c * kTok);
    const int c0 = p0 + c * kTok;  // position of the chunk's first token
    if (c == 0)
      cp_async_wait<kSt - 1>();
    else
      cp_async_wait<kSt - 2>();
    __syncthreads();  // chunk c landed; offsets of c + kSt - 1 visible
    if (c > 0) fetch(c + kSt - 1);  // into the slot chunk c - 1 freed
    const C* kr0 = kbuf + (c % kSt) * kTok * d;
    const C* vr0 = vbuf + (c % kSt) * kTok * d;
    const float* ksc = kss + (c % kSt) * kTok;
    const float* vsc = vss + (c % kSt) * kTok;

    // scores: token t on kU lanes, each one unit
#pragma unroll
    for (int pass = 0; pass < kTok / kTpp; ++pass) {
      const int t = pass * kTpp + st;
      float part_[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) part_[gi] = 0.f;
      if (t < n && su * kUnit < d) {
        float kv[kUnit];
        load_unit<F>(kr0 + t * d + su * kUnit, nibble(c0 + t), kv);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float4* qv =
              reinterpret_cast<const float4*>(qs + gi * d + su * kUnit);
          const float4 a = qv[0], b = qv[1];
          float p = a.x * kv[0];
          p = fmaf(a.y, kv[1], p);
          p = fmaf(a.z, kv[2], p);
          p = fmaf(a.w, kv[3], p);
          p = fmaf(b.x, kv[4], p);
          p = fmaf(b.y, kv[5], p);
          p = fmaf(b.z, kv[6], p);
          p = fmaf(b.w, kv[7], p);
          part_[gi] = p;
        }
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float p = part_[gi];
#pragma unroll
        for (int o = kU / 2; o > 0; o >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        if (su == 0 && t < n)
          ps[gi * kTok + t] = F != kModel ? p * ksc[t] : p;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int gi = warp; gi < G; gi += kWarps) {
      float* pr = ps + gi * kTok;
      const float s0 = lane < n ? pr[lane] : kNeg;
      const float s1 = kTok > 32 && lane + 32 < n ? pr[lane + 32] : kNeg;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mp = ms[gi];
      const float mn = fmaxf(mp, mx);
      const float e0 = lane < n ? __expf(s0 - mn) : 0.f;
      const float e1 = kTok > 32 && lane + 32 < n ? __expf(s1 - mn) : 0.f;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      // P.V weights: the v scale of each token's block folds in here
      pr[lane] = F != kModel ? e0 * vsc[lane] : e0;
      if (kTok > 32) pr[lane + 32] = F != kModel ? e1 * vsc[lane + 32] : e1;
      if (lane == 0) {
        const float alpha = __expf(mp - mn);
        as[gi] = alpha;
        ls[gi] = ls[gi] * alpha + sum;
        ms[gi] = mn;
      }
    }
    __syncthreads();

    // the slot's scales are spent: offsets of the chunk the next
    // iteration fetches into it
    if (c + kSt < nch) row_offsets(c + kSt);

    // P.V over this thread's tokens of the chunk
#pragma unroll
    for (int k = 0; k < kPpt; ++k) {
      const float a = as[pg[k]];
#pragma unroll
      for (int j = 0; j < kUnit; ++j) acc[k][j] *= a;
    }
    for (int t = tg; t < n; t += kTgn) {
      const int sh = nibble(c0 + t);
#pragma unroll
      for (int k = 0; k < kPpt; ++k) {
        if (pu[k] * kUnit >= d) continue;
        float vv[kUnit];
        load_unit<F>(vr0 + t * d + pu[k] * kUnit, sh, vv);
        const float w = ps[pg[k] * kTok + t];
#pragma unroll
        for (int j = 0; j < kUnit; ++j) acc[k][j] = fmaf(w, vv[j], acc[k][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every P.V is done: the ring is free, ls / ms final

  // this block's result for (head gi, element e): out, normalised, with
  // one split; else the partial
  const size_t row0 = (size_t)s * hq + h0;
  auto emit = [&](int gi, int e, float a) {
    if (splits == 1) {
      const float l = ls[gi] == 0.f ? 1.f : ls[gi];
      out[(row0 + gi) * d + e] = from_f32<T>(a / l);
    } else {
      ws_acc[((row0 + gi) * splits + z) * d + e] = a;
    }
  };
  if (splits > 1 && tid < G) {
    float* ml = ws_ml + ((row0 + tid) * splits + z) * 2;
    ml[0] = ms[tid];
    ml[1] = ls[tid];
  }
  if (kTgn > 1) {
    // the token groups' sums, added in group order
    float* red = reinterpret_cast<float*>(smem_raw);  // [kTgn][G][d]
    if (pu[0] * kUnit < d)
#pragma unroll
      for (int j = 0; j < kUnit; ++j)
        red[(tg * G + pg[0]) * d + pu[0] * kUnit + j] = acc[0][j];
    __syncthreads();
    for (int i = tid; i < G * d; i += kThreads) {
      const int gi = i / d, e = i - gi * d;
      float a = 0.f;
#pragma unroll
      for (int g2 = 0; g2 < kTgn; ++g2) a += red[(g2 * G + gi) * d + e];
      emit(gi, e, a);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPpt; ++k)
      if (pu[k] * kUnit < d)
#pragma unroll
        for (int j = 0; j < kUnit; ++j)
          emit(pg[k], pu[k] * kUnit + j, acc[k][j]);
  }
}

// One block per (query head, sequence): the row's partials combined by the
// log-sum-exp rule in split order (empty ones, l = 0, skipped); a row with
// no token gets 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const float* __restrict__ ws_acc,
                          const float* __restrict__ ws_ml,
                          T* __restrict__ out, int d, int splits) {
  const size_t row = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* ml = ws_ml + row * splits * 2;
  const float* acc = ws_acc + row * splits * d;
  float m = kNeg;
  for (int p = 0; p < splits; ++p)
    if (ml[2 * p + 1] > 0.f) m = fmaxf(m, ml[2 * p]);
  float l = 0.f;
  for (int p = 0; p < splits; ++p)
    if (ml[2 * p + 1] > 0.f) l += __expf(ml[2 * p] - m) * ml[2 * p + 1];
  const float inv = l > 0.f ? 1.f / l : 0.f;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float a = 0.f;
    for (int p = 0; p < splits; ++p)
      if (ml[2 * p + 1] > 0.f)
        a = fmaf(__expf(ml[2 * p] - m), acc[(size_t)p * d + e], a);
    out[row * d + e] = from_f32<T>(a * inv);
  }
}

template <typename T, int F, int G, int DM>
int launch(const void* q, const void* kc, const void* vc, const void* ksc,
           const void* vsc, const void* tables, const void* lens, void* out,
           float* ws_acc, float* ws_ml, int s_n, int hkv, int grp,
           int h_off, int bs, int d, int pages, int splits, int part,
           cudaStream_t stream) {
  using C = typename CacheType<T, F>::type;
  const int vec = d * (int)sizeof(C) % 16 == 0 ? 16 : 8;
  const size_t smem = smem_bytes<C, DM>(G, d);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, F, G, DM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hkv, s_n, splits);
  paged_decode_kernel<T, F, G, DM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(kc),
      static_cast<const C*>(vc), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), ws_acc, ws_ml,
      hkv, grp, h_off, bs, d, pages, part, vec, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

// the group's heads in pieces of 16, 8, 4, 2 and 1, largest first (one
// launch for the templated groups, a few for the rest), then the merge
template <typename T, int F, int DM>
int dispatch(const void* q, const void* kc, const void* vc, const void* ksc,
             const void* vsc, const void* tables, const void* lens,
             void* out, float* ws, int s_n, int hq, int hkv, int bs, int d,
             int pages, int splits, int part, cudaStream_t st) {
  const int grp = hq / hkv;
  float* ws_acc = ws;
  float* ws_ml = ws == nullptr ? nullptr
                               : ws + (size_t)s_n * hq * splits * d;
  int err = 0;
  for (int off = 0; off < grp && err == 0;) {
    const int left = grp - off;
    const int g = left >= 16 ? 16 : left >= 8 ? 8 : left >= 4 ? 4
                                                  : left >= 2 ? 2 : 1;
    switch (g) {
      case 16: err = launch<T, F, 16, DM>(q, kc, vc, ksc, vsc, tables, lens, out, ws_acc, ws_ml, s_n, hkv, grp, off, bs, d, pages, splits, part, st); break;
      case 8: err = launch<T, F, 8, DM>(q, kc, vc, ksc, vsc, tables, lens, out, ws_acc, ws_ml, s_n, hkv, grp, off, bs, d, pages, splits, part, st); break;
      case 4: err = launch<T, F, 4, DM>(q, kc, vc, ksc, vsc, tables, lens, out, ws_acc, ws_ml, s_n, hkv, grp, off, bs, d, pages, splits, part, st); break;
      case 2: err = launch<T, F, 2, DM>(q, kc, vc, ksc, vsc, tables, lens, out, ws_acc, ws_ml, s_n, hkv, grp, off, bs, d, pages, splits, part, st); break;
      default: err = launch<T, F, 1, DM>(q, kc, vc, ksc, vsc, tables, lens, out, ws_acc, ws_ml, s_n, hkv, grp, off, bs, d, pages, splits, part, st); break;
    }
    off += g;
  }
  if (err != 0 || splits == 1) return err;
  paged_decode_merge_kernel<T><<<dim3(hq, s_n), kThreads, 0, st>>>(
      ws_acc, ws_ml, static_cast<T*>(out), d, splits);
  return (int)cudaGetLastError();
}

template <typename T, int F>
int dispatch_d(const void* q, const void* kc, const void* vc,
               const void* ksc, const void* vsc, const void* tables,
               const void* lens, void* out, float* ws, int s_n, int hq,
               int hkv, int bs, int d, int pages, int splits, int part,
               cudaStream_t st) {
  if (d % 8 != 0 || d > 256 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (d <= 128)
    return dispatch<T, F, 128>(q, kc, vc, ksc, vsc, tables, lens, out, ws,
                               s_n, hq, hkv, bs, d, pages, splits, part, st);
  return dispatch<T, F, 256>(q, kc, vc, ksc, vsc, tables, lens, out, ws, s_n,
                             hq, hkv, bs, d, pages, splits, part, st);
}

// `splits` blocks of `part` tokens (a multiple of 64) cover each row of
// the table; with more than one split `ws` holds s_n * hq * splits *
// (d + 2) floats (the partials and their m, l)
template <int F>
int run(const void* q, const void* kc, const void* vc, const void* ksc,
        const void* vsc, const void* tables, const void* lens, void* out,
        int s_n, int hq, int hkv, int bs, int d, int pages, int dtype,
        int splits, int part, void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_n == 0) return 0;
  if (splits < 1 || splits > 65535 || part <= 0 || part % kPartStep != 0 ||
      (long long)splits * part < (long long)pages * bs ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, F>(q, kc, vc, ksc, vsc, tables, lens,
                                        out, w, s_n, hq, hkv, bs, d, pages,
                                        splits, part, st);
  if (dtype == 2)
    return dispatch_d<__half, F>(q, kc, vc, ksc, vsc, tables, lens, out, w,
                                 s_n, hq, hkv, bs, d, pages, splits, part,
                                 st);
  return dispatch_d<float, F>(q, kc, vc, ksc, vsc, tables, lens, out, w, s_n,
                              hq, hkv, bs, d, pages, splits, part, st);
}

}  // namespace
