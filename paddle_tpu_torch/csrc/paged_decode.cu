// Paged flash-decode attention for Hopper (sm_90a), bf16 or f32 caches,
// f32 accumulation: one query token per sequence against a block-paged
// KV cache read through a per-sequence block table.
//
// Replaces: paddle_tpu/ops/pallas_decode.py `_decode_kernel` (model-dtype
// caches, reached through `_paged_decode_x32` and
// `paged_decode_attention_raw`). The int8/int4 cache variants are not
// ported here.
//
// Layout: q [S, Hq, D]; k/v caches [N, Hkv, bs, D]; block_tables [S, P]
// int32 (entries < 0 are padding, clamped to block 0 as the TPU kernel
// does); seq_lens [S] int32; out [S, Hq, D] in q's dtype. The query heads
// [i*G, (i+1)*G) share kv head i (GQA, G = Hq / Hkv in {1, 2, 4, 8, 16}).
// D is a multiple of 8 and at most 128.
//
// What bounds it on the H100: memory. Each step reads every valid cache
// token once (2 * len * D * itemsize bytes per kv head) and does ~2 flops
// per byte read, far below the ~295 flop/byte ridge.
//
// Design: one block of 128 threads per (kv head, sequence). The block
// loads its own block-table row and length (no scalar prefetch on this
// card) and walks the sequence in 64-token chunks, only up to its length.
// Each chunk's K and V rows are gathered through the table into shared
// memory with 16-byte cp.async copies, double-buffered: the copies of
// chunk c+1 are in flight while chunk c is computed, and each cache byte
// is read once for the whole GQA group, whose G query rows all live in
// the block. Scores: one warp per token, lanes splitting D, shuffle
// reduction. The online-softmax update: one warp per query head, two
// tokens per lane, running max/sum in shared memory. P.V: each thread owns
// G * D / 128 output elements, accumulated in f32 registers.
//
// Known limit: with few sequences and long contexts only S * Hkv blocks
// run, each walking its whole sequence; splitting the sequence across
// blocks (split-K with a second merge pass) is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTok = 64;     // cache tokens per chunk
constexpr int kMaxD = 128;
constexpr int kPad = 8;      // row padding (elements), keeps rows 16-byte aligned
constexpr float kNeg = -1e30f;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
size_t smem_bytes(int g, int d) {
  return 4 * (size_t)kTok * (d + kPad) * sizeof(T)   // K, V x 2 buffers
         + sizeof(long long) * 2 * kTok               // row offsets x 2
         + sizeof(float) * ((size_t)g * d + (size_t)g * kTok + 3 * g);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out,
                    int hkv, int bs, int d, int pages, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ds = d + kPad;
  T* kbuf = reinterpret_cast<T*>(smem_raw);           // [2][kTok][ds]
  T* vbuf = kbuf + 2 * kTok * ds;                     // [2][kTok][ds]
  long long* offs = reinterpret_cast<long long*>(vbuf + 2 * kTok * ds);
  float* qs = reinterpret_cast<float*>(offs + 2 * kTok);  // [G][d]
  float* ps = qs + G * d;       // [G][kTok]: scores, then probabilities
  float* ms = ps + G * kTok;    // [G] running max
  float* ls = ms + G;           // [G] running sum
  float* as = ls + G;           // [G] rescale factor of the current chunk

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x;
  const int s = blockIdx.y;
  const int hq = hkv * G;
  const int len = min(lens[s], pages * bs);
  const int* tab = tables + (size_t)s * pages;
  const int vpr = d * (int)sizeof(T) / 16;   // 16-byte vectors per row
  const int epv = 16 / (int)sizeof(T);       // elements per vector
  const int nchunks = (len + kTok - 1) / kTok;

  // element offset of each token row of chunk c, into offs[c & 1]
  auto row_offsets = [&](int c) {
    if (tid < kTok) {
      const int pos = c * kTok + tid;
      long long off = 0;
      if (pos < len) {
        const int blk = max(tab[pos / bs], 0);
        off = (((long long)blk * hkv + hk) * bs + pos % bs) * d;
      }
      offs[(c & 1) * kTok + tid] = off;
    }
  };
  auto fetch = [&](int c) {
    const int n = min(kTok, len - c * kTok);
    const long long* o = offs + (c & 1) * kTok;
    T* kd = kbuf + (c & 1) * kTok * ds;
    T* vd = vbuf + (c & 1) * kTok * ds;
    for (int i = tid; i < n * vpr; i += kThreads) {
      const int t = i / vpr, e = (i - t * vpr) * epv;
      cp_async16(kd + t * ds + e, kc + o[t] + e);
      cp_async16(vd + t * ds + e, vc + o[t] + e);
    }
    cp_async_commit();
  };

  for (int i = tid; i < G * d; i += kThreads) {
    const int gi = i / d, c = i - gi * d;
    qs[i] = to_f32(q[((size_t)s * hq + hk * G + gi) * d + c]) * scale;
  }
  if (tid < G) {
    ms[tid] = kNeg;
    ls[tid] = 0.f;
  }
  constexpr int kAcc = (G * kMaxD + kThreads - 1) / kThreads;
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
    const T* kr0 = kbuf + (c & 1) * kTok * ds;
    const T* vr0 = vbuf + (c & 1) * kTok * ds;

    for (int t = warp; t < n; t += kWarps) {
      const T* kr = kr0 + t * ds;
      float part[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) part[gi] = 0.f;
      for (int e = lane; e < d; e += 32) {
        const float kv = to_f32(kr[e]);
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
        if (lane == 0) ps[gi * kTok + t] = p;
      }
    }
    __syncthreads();

    for (int gi = warp; gi < G; gi += kWarps) {
      float* pr = ps + gi * kTok;
      const float s0 = lane < n ? pr[lane] : kNeg;
      const float s1 = lane + 32 < n ? pr[lane + 32] : kNeg;
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
      pr[lane] = p0;
      pr[lane + 32] = p1;
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
      if (i < G * d) {
        const int gi = i / d, e = i - gi * d;
        const float* pr = ps + gi * kTok;
        float a = acc[j] * as[gi];
        for (int t = 0; t < n; ++t)
          a = fmaf(pr[t], to_f32(vr0[t * ds + e]), a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();  // ls is final (also when len == 0)

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * d) {
      const int gi = i / d, e = i - gi * d;
      const float l = ls[gi] == 0.f ? 1.f : ls[gi];
      out[((size_t)s * hq + hk * G + gi) * d + e] = from_f32<T>(acc[j] / l);
    }
  }
}

template <typename T, int G>
int launch(const void* q, const void* kc, const void* vc, const void* tables,
           const void* lens, void* out, int s_n, int hkv, int bs, int d,
           int pages, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(G, d);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hkv, s_n);
  paged_decode_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), hkv, bs, d, pages,
      1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc,
             const void* tables, const void* lens, void* out, int s_n,
             int hq, int hkv, int bs, int d, int pages, cudaStream_t st) {
  switch (hq / hkv) {
    case 1: return launch<T, 1>(q, kc, vc, tables, lens, out, s_n, hkv, bs, d, pages, st);
    case 2: return launch<T, 2>(q, kc, vc, tables, lens, out, s_n, hkv, bs, d, pages, st);
    case 4: return launch<T, 4>(q, kc, vc, tables, lens, out, s_n, hkv, bs, d, pages, st);
    case 8: return launch<T, 8>(q, kc, vc, tables, lens, out, s_n, hkv, bs, d, pages, st);
    case 16: return launch<T, 16>(q, kc, vc, tables, lens, out, s_n, hkv, bs, d, pages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() (0 = ok);
// the caller has checked shapes, dtypes, contiguity, 16-byte alignment of
// the caches, d % 8 == 0, d <= 128 and Hq / Hkv in {1, 2, 4, 8, 16}.
extern "C" int paged_decode_attention(const void* q, const void* kc,
                                      const void* vc, const void* tables,
                                      const void* lens, void* out, int s_n,
                                      int hq, int hkv, int bs, int d,
                                      int pages, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_n == 0) return 0;
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, kc, vc, tables, lens, out, s_n, hq,
                                   hkv, bs, d, pages, st);
  return dispatch<float>(q, kc, vc, tables, lens, out, s_n, hq, hkv, bs, d,
                         pages, st);
}
