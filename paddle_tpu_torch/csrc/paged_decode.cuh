// Paged flash-decode attention for Hopper (sm_90a), f32 accumulation: one
// query token per sequence against a block-paged KV cache read through a
// per-sequence block table. One kernel template, three cache formats:
// the model's dtype (bf16/f32, K7), int8 with one f32 scale per block, and
// int4 packed two tokens per byte with one f32 scale per block (K7q).
// This header holds the template and its dispatch (`run<F>`); each format
// is instantiated in a source of its own (paged_decode.cu,
// paged_decode_int8.cu, paged_decode_int4.cu), so the three build in
// parallel. Those sources say what each replaces.
//
// Layout: q [S, Hq, D] bf16 or f32; model-dtype caches [N, Hkv, bs, D] in
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
// ~2 flops per element, far below the ~295 flop/byte ridge.
//
// Design: one block of 128 threads per (kv head, sequence). The block
// loads its own block-table row and length (no scalar prefetch on this
// card) and walks the sequence in 64-token chunks, only up to its length.
// Each chunk's K and V rows are gathered through the table into shared
// memory with 16-byte cp.async copies, double-buffered: the copies of
// chunk c+1 are in flight while chunk c is computed, and each cache byte
// is read once for the whole GQA group, whose G query rows all live in
// the block. The int4 format gathers each token's packed row (two tokens
// share one; the second read of a row is served by L2) and picks the
// token's nibble in shared memory. Quantized formats keep each token's
// block scales in shared memory beside its row offset: a 64-token chunk
// spans several blocks, so the k scale multiplies each token's logit and
// the v scale each token's probability in P.V (the TPU kernel applied
// them per page). Scores: one warp per token, lanes splitting D, shuffle
// reduction. The online-softmax update: one warp per query head, two
// tokens per lane, running max/sum in shared memory. P.V: each thread owns
// G * D / 128 output elements, accumulated in f32 registers.
//
// Instantiations. A block holds G query heads of its kv head's group, G
// a template parameter in {1, 2, 4, 8, 16}, so the score partials and the
// output accumulators live in registers sized for it. A group of another
// size (3, 6, 7, 12, 32, ...) is cut into pieces of those sizes, largest
// first (7 = 4 + 2 + 1, 32 = 16 + 16), one launch each over the same
// cache: each piece reads the cache again (from L2 where it still holds
// it), the price of keeping every kernel's registers static. A single
// kernel with the group as a runtime value and registers sized for 16
// spilled and ran 5x slower than the templated one at G = 1. The largest
// head dim is a template parameter too (DM = 128 or 256), so the d <= 128
// kernels keep their registers; at DM 256 an f32 cache stages 32-token
// chunks (64 would need 270 KB of shared memory).
// Rows of a multiple of 16 bytes are copied 16 bytes at a time; 8-byte
// rows (an int8 or int4 row of d = 8 (mod 16) bytes) 8 bytes at a time.
//
// Known limit: with few sequences and long contexts only S * Hkv blocks
// run, each walking its whole sequence; splitting the sequence across
// blocks (split-K with a second merge pass) is the next step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

// cache formats
constexpr int kModel = 0;    // q's dtype
constexpr int kInt8 = 1;     // int8 codes, one scale per block
constexpr int kInt4 = 2;     // int4 codes, two tokens per byte

template <typename T, int F>
struct CacheType { using type = int8_t; };
template <typename T>
struct CacheType<T, kModel> { using type = T; };

// row padding (elements): 16 bytes for int8 rows, 8 elements otherwise;
// keeps every row 16-byte aligned for cp.async
template <typename C>
__host__ __device__ constexpr int row_pad() {
  return sizeof(C) == 1 ? 16 : 8;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one cache element as f32 (codes unscaled). `sh` selects the int4 nibble:
// 4 = low (first half of the block), 0 = high.
template <int F, typename C>
__device__ __forceinline__ float cache_value(C v, int sh) {
  if constexpr (F == kModel) {
    return to_f32(v);
  } else if constexpr (F == kInt8) {
    return (float)v;
  } else {
    return (float)((int)(int8_t)((uint8_t)v << sh) >> 4);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cache tokens per chunk: 64, or 32 for f32 rows of up to 256 elements
template <typename C, int DM>
__host__ __device__ constexpr int chunk_tokens() {
  return sizeof(C) == 4 && DM > 128 ? 32 : 64;
}

template <typename C>
size_t smem_bytes(int g, int d, int tok) {
  return 4 * (size_t)tok * (d + row_pad<C>()) * sizeof(C)  // K, V x 2
         + sizeof(long long) * 2 * tok                      // row offsets
         + sizeof(float) * 2 * 2 * tok                      // k, v scales
         + sizeof(int) * 2 * tok                            // nibble shifts
         + sizeof(float) * ((size_t)g * d + (size_t)g * tok + 3 * g);
}

// The block holds query heads [h_off, h_off + G) of its kv head's group
// of `grp`. `vec` is the copy width in bytes (16 or 8).
template <typename T, int F, int G, int DM>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,
                    const typename CacheType<T, F>::type* __restrict__ kc,
                    const typename CacheType<T, F>::type* __restrict__ vc,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out,
                    int hkv, int grp, int h_off, int bs, int d, int pages,
                    int vec, float scale) {
  using C = typename CacheType<T, F>::type;
  constexpr int kTok = chunk_tokens<C, DM>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ds = d + row_pad<C>();
  C* kbuf = reinterpret_cast<C*>(smem_raw);           // [2][kTok][ds]
  C* vbuf = kbuf + 2 * kTok * ds;                     // [2][kTok][ds]
  long long* offs = reinterpret_cast<long long*>(vbuf + 2 * kTok * ds);
  float* kss = reinterpret_cast<float*>(offs + 2 * kTok);  // [2][kTok]
  float* vss = kss + 2 * kTok;                             // [2][kTok]
  int* shs = reinterpret_cast<int*>(vss + 2 * kTok);       // [2][kTok]
  constexpr int g = G;
  const int hk = blockIdx.x;
  const int h0 = hk * grp + h_off;  // this block's first query head
  float* qs = reinterpret_cast<float*>(shs + 2 * kTok);    // [g][d]
  float* ps = qs + g * d;       // [g][kTok]: scores, then probabilities
  float* ms = ps + g * kTok;    // [g] running max
  float* ls = ms + g;           // [g] running sum
  float* as = ls + g;           // [g] rescale factor of the current chunk

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int s = blockIdx.y;
  const int hq = hkv * grp;
  const int len = min(lens[s], pages * bs);
  const int* tab = tables + (size_t)s * pages;
  const int rows = F == kInt4 ? bs / 2 : bs;  // stored rows per block
  const int vpr = d * (int)sizeof(C) / vec;   // vectors per row
  const int epv = vec / (int)sizeof(C);       // elements per vector
  const int nchunks = (len + kTok - 1) / kTok;

  // element offset, block scales and nibble of each token of chunk c,
  // into slot c & 1
  auto row_offsets = [&](int c) {
    if (tid < kTok) {
      const int pos = c * kTok + tid;
      const int slot = (c & 1) * kTok + tid;
      long long off = 0;
      float ks = 0.f, vs = 0.f;
      int sh = 4;
      if (pos < len) {
        const int blk = max(tab[pos / bs], 0);
        int t = pos % bs;
        if (F == kInt4) {
          sh = t < rows ? 4 : 0;
          t = t < rows ? t : t - rows;
        }
        off = (((long long)blk * hkv + hk) * rows + t) * d;
        if (F != kModel) {
          ks = kscale[blk];
          vs = vscale[blk];
        }
      }
      offs[slot] = off;
      kss[slot] = ks;
      vss[slot] = vs;
      shs[slot] = sh;
    }
  };
  auto fetch = [&](int c) {
    const int n = min(kTok, len - c * kTok);
    const long long* o = offs + (c & 1) * kTok;
    C* kd = kbuf + (c & 1) * kTok * ds;
    C* vd = vbuf + (c & 1) * kTok * ds;
    if (vec == 16) {
      for (int i = tid; i < n * vpr; i += kThreads) {
        const int t = i / vpr, e = (i - t * vpr) * epv;
        cp_async16(kd + t * ds + e, kc + o[t] + e);
        cp_async16(vd + t * ds + e, vc + o[t] + e);
      }
    } else {
      for (int i = tid; i < n * vpr; i += kThreads) {
        const int t = i / vpr, e = (i - t * vpr) * epv;
        cp_async8(kd + t * ds + e, kc + o[t] + e);
        cp_async8(vd + t * ds + e, vc + o[t] + e);
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d, c = i - gi * d;
    qs[i] = to_f32(q[((size_t)s * hq + h0 + gi) * d + c]) * scale;
  }
  if (tid < g) {
    ms[tid] = kNeg;
    ls[tid] = 0.f;
  }
  constexpr int kAcc = (G * DM + kThreads - 1) / kThreads;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  if (nchunks > 0) {
    row_offsets(0);
    __syncthreads();
    fetch(0);
  }
  for (int c = 0; c < nchunks; ++c) {
    const int n = min(kTok, len - c * kTok);
    if (c + 1 < nchunks) row_offsets(c + 1);
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; offsets of c+1 visible; c-1 done
    if (c + 1 < nchunks) fetch(c + 1);
    const C* kr0 = kbuf + (c & 1) * kTok * ds;
    const C* vr0 = vbuf + (c & 1) * kTok * ds;
    const float* ksc = kss + (c & 1) * kTok;
    const float* vsc = vss + (c & 1) * kTok;
    const int* shc = shs + (c & 1) * kTok;

    for (int t = warp; t < n; t += kWarps) {
      const C* kr = kr0 + t * ds;
      const int sh = shc[t];
      float part[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) part[gi] = 0.f;
      for (int e = lane; e < d; e += 32) {
        const float kv = cache_value<F>(kr[e], sh);
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          part[gi] = fmaf(qs[gi * d + e], kv, part[gi]);
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float p = part[gi];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        if (F != kModel) p *= ksc[t];
        if (lane == 0) ps[gi * kTok + t] = p;
      }
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += kWarps) {
      float* pr = ps + gi * kTok;
      const float s0 = lane < n ? pr[lane] : kNeg;
      const float s1 = kTok > 32 && lane + 32 < n ? pr[lane + 32] : kNeg;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mp = ms[gi];
      const float mn = fmaxf(mp, mx);
      const float p0 = lane < n ? __expf(s0 - mn) : 0.f;
      const float p1 = lane + 32 < n ? __expf(s1 - mn) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      // P.V weights: the v scale of each token's block folds in here
      pr[lane] = F != kModel ? p0 * vsc[lane] : p0;
      if (kTok > 32) pr[lane + 32] = F != kModel ? p1 * vsc[lane + 32] : p1;
      if (lane == 0) {
        const float alpha = __expf(mp - mn);
        as[gi] = alpha;
        ls[gi] = ls[gi] * alpha + sum;
        ms[gi] = mn;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < g * d) {
        const int gi = i / d, e = i - gi * d;
        const float* pr = ps + gi * kTok;
        float a = acc[j] * as[gi];
        for (int t = 0; t < n; ++t)
          a = fmaf(pr[t], cache_value<F>(vr0[t * ds + e], shc[t]), a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();  // ls is final (also when len == 0)

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < g * d) {
      const int gi = i / d, e = i - gi * d;
      const float l = ls[gi] == 0.f ? 1.f : ls[gi];
      out[((size_t)s * hq + h0 + gi) * d + e] = from_f32<T>(acc[j] / l);
    }
  }
}

template <typename T, int F, int G, int DM>
int launch(const void* q, const void* kc, const void* vc, const void* ksc,
           const void* vsc, const void* tables, const void* lens, void* out,
           int s_n, int hkv, int grp, int h_off, int bs, int d, int pages,
           cudaStream_t stream) {
  using C = typename CacheType<T, F>::type;
  const int vec = d * (int)sizeof(C) % 16 == 0 ? 16 : 8;
  const size_t smem = smem_bytes<C>(G, d, chunk_tokens<C, DM>());
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, F, G, DM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hkv, s_n);
  paged_decode_kernel<T, F, G, DM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(kc),
      static_cast<const C*>(vc), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), hkv, grp, h_off,
      bs, d, pages, vec, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

// the group's heads in pieces of 16, 8, 4, 2 and 1, largest first: one
// launch for the templated groups, a few for the rest
template <typename T, int F, int DM>
int dispatch(const void* q, const void* kc, const void* vc, const void* ksc,
             const void* vsc, const void* tables, const void* lens,
             void* out, int s_n, int hq, int hkv, int bs, int d, int pages,
             cudaStream_t st) {
  const int grp = hq / hkv;
  int err = 0;
  for (int off = 0; off < grp && err == 0;) {
    const int left = grp - off;
    const int g = left >= 16 ? 16 : left >= 8 ? 8 : left >= 4 ? 4
                                                  : left >= 2 ? 2 : 1;
    switch (g) {
      case 16: err = launch<T, F, 16, DM>(q, kc, vc, ksc, vsc, tables, lens, out, s_n, hkv, grp, off, bs, d, pages, st); break;
      case 8: err = launch<T, F, 8, DM>(q, kc, vc, ksc, vsc, tables, lens, out, s_n, hkv, grp, off, bs, d, pages, st); break;
      case 4: err = launch<T, F, 4, DM>(q, kc, vc, ksc, vsc, tables, lens, out, s_n, hkv, grp, off, bs, d, pages, st); break;
      case 2: err = launch<T, F, 2, DM>(q, kc, vc, ksc, vsc, tables, lens, out, s_n, hkv, grp, off, bs, d, pages, st); break;
      default: err = launch<T, F, 1, DM>(q, kc, vc, ksc, vsc, tables, lens, out, s_n, hkv, grp, off, bs, d, pages, st); break;
    }
    off += g;
  }
  return err;
}

template <typename T, int F>
int dispatch_d(const void* q, const void* kc, const void* vc,
               const void* ksc, const void* vsc, const void* tables,
               const void* lens, void* out, int s_n, int hq, int hkv, int bs,
               int d, int pages, cudaStream_t st) {
  if (d % 8 != 0 || d > 256 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (d <= 128)
    return dispatch<T, F, 128>(q, kc, vc, ksc, vsc, tables, lens, out, s_n,
                               hq, hkv, bs, d, pages, st);
  return dispatch<T, F, 256>(q, kc, vc, ksc, vsc, tables, lens, out, s_n, hq,
                             hkv, bs, d, pages, st);
}

template <int F>
int run(const void* q, const void* kc, const void* vc, const void* ksc,
        const void* vsc, const void* tables, const void* lens, void* out,
        int s_n, int hq, int hkv, int bs, int d, int pages, int dtype,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_n == 0) return 0;
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, F>(q, kc, vc, ksc, vsc, tables, lens,
                                        out, s_n, hq, hkv, bs, d, pages, st);
  return dispatch_d<float, F>(q, kc, vc, ksc, vsc, tables, lens, out, s_n,
                              hq, hkv, bs, d, pages, st);
}

}  // namespace
