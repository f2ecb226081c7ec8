// Fused RMSNorm and LayerNorm (with and without the residual add),
// rotary on Q and K, SwiGLU, and dropout + add, forward and backward, for
// Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_norm.py `_norm_fwd_kernel` (K3 forward,
// RMS and LayerNorm kinds, reached through `_norm_forward`),
// `_norm_bwd_kernel` (K3 backward, `_norm_backward`), `_rope_kernel` (K4,
// `_rope_apply`, both directions), `_swiglu_fwd_kernel` and
// `_swiglu_bwd_kernel` (K5, `_swiglu_call`), `_dropout_add_fwd_kernel`
// and `_dropout_add_bwd_kernel` (K6, `dropout_add_fused` and its VJP).
//
// Entry points (each returns cudaGetLastError(), 0 = ok):
//   fused_rms_norm_fwd    y = w * x_sum * rstd, s = x + res (add variant),
//                         rstd = 1 / sqrt(mean(x_sum^2) + eps) per row
//   fused_rms_norm_bwd    dx = rstd * (w*dy - xhat * mean(w*dy*xhat)) (+ ds),
//                         dw = sum over rows of dy * xhat, xhat = s * rstd
//   fused_layer_norm_fwd  y = (x_sum - mean) * rstd * w + b, s as above,
//                         mean and rstd = 1 / sqrt(var + eps) per row, with
//                         var = max(mean(x_sum^2) - mean^2, 0) as the TPU
//                         kernel takes it
//   fused_layer_norm_bwd  dx = rstd * (w*dy - mean(w*dy) - xhat *
//                         mean(w*dy*xhat)) (+ ds), dw = sum of dy * xhat,
//                         db = sum of dy, xhat = (s - mean) * rstd
//   rope_qk               neox rotation of Q and K in one launch; backward is
//                         the transpose (the partner index's sin)
//   swiglu_fwd            o = silu(g) * u
//   swiglu_bwd            dg = do * u * (sig + silu * (1 - sig)),
//                         du = do * silu
//   dropout_add_fwd       o = x * mask * scale + y (mask 0/1 in x's type)
//   dropout_add_bwd       dx = g * mask * scale (dy = g needs no kernel)
//
// Types: x, res, s, dx, ds (TX) are f32, bf16 or f16; y and dy (TY) are
// TX or f32 (an f32 norm that reads a bf16 or f16 stream, the way the
// reference's O2 autocast runs its f32 norm on upcast inputs; the upcast
// is exact, so it is the same function without the cast pass). The RMS
// kinds take w and write dw in TX; the LayerNorm kinds take w and b in
// f32 and write dw and db in f32 (the reference's O2 keeps LayerNorm
// weights f32; the caller casts the [H] vectors, and their gradients flow
// back through the cast). Every reduction and every product is f32 inside
// the kernel; each output is rounded once.
//
// What bounds them on the H100: device memory. Each does a few f32
// operations per element it moves (a norm ~6-9, SwiGLU ~10 with one exp,
// dropout + add 3), two orders of magnitude below the ~20 flop/byte at
// which the 67 TFLOP/s f32 pipes, let alone the tensor cores, would become
// the limit. So the design moves each input byte once and each output
// byte once:
//   - 16-byte vector loads and stores (8 bf16 or 4 f32 per access) when
//     the widths and pointers allow, one element at a time otherwise;
//   - K3 forward: one block per row, of as many threads as the row has
//     vectors (a multiple of 32, at most 256: hidden 768 in bf16 takes 96);
//     the f32 sum x (+ res) is kept in shared memory between the row's
//     sums and the scaled write, so x and res are read once; only rstd
//     (and the mean, for LayerNorm: 4 bytes each a row) is saved for the
//     backward. LayerNorm's two sums (x and x^2) come from the same pass.
//     A row of more than kFwdRowMax (32768) elements, whose f32 copy would
//     take more than 128 KB of shared memory, is read twice instead: the
//     second pass recomputes x (+ res) from device memory (the same f32
//     sum, bit for bit), mostly from L2;
//   - K3 backward: xhat is recomputed from s and the stats (no f32
//     [rows, H] activation is stored). dw (and db) are sums across rows,
//     which the TPU kernel carries in VMEM over its sequential row grid.
//     Here a row group of ceil(h / 1024) warps (one warp up to h = 1024,
//     GPT's and BERT's widths; two at LLaMA's 2048; twelve at MAX_HIDDEN)
//     takes one row at a time, 8 warps a block, one block on each SM, so
//     each SM works on several rows at once with no block-wide barrier
//     per row: a lane holds at most 32 elements of the row, and w and its
//     dw (db) partial for those columns stay in its registers across
//     every row its group takes; each group keeps three rows' s, dy (and
//     ds) in flight by cp.async into a ring in shared memory while it
//     reduces the oldest; a row's two sums are warp shuffles (and, in a
//     group of several warps, the warps' sums added in warp order behind
//     one named barrier of the group). The grid is one wave, each block a
//     contiguous row range; a block adds its groups' partials in group
//     order and writes one f32 partial row, and a second kernel of 192-
//     256 blocks at the main paths' widths, launched as a programmatic
//     dependent of the first (so its launch overlaps the first's end),
//     adds the partial rows in a fixed order. No float atomics, so the
//     result repeats from run to run. The add variant's dx + ds is added
//     in f32 before the one rounding. Rows of 16-byte vectors up to 12288
//     / 11264 elements (MAX_HIDDEN / MAX_HIDDEN_LN) take that row kernel.
//     Wider rows, and rows it does not take because they are not 16-byte
//     vectors (h not a multiple of 16 bytes' elements, or a pointer off 16
//     bytes: the one-element path), take the wide path (the caller passes
//     `coef`), a second pass over device memory: a first kernel, one
//     block per row, computes each row's sums mean(w*dy*xhat) (and
//     mean(w*dy)) into `coef`; a second one, whose blocks each own 2048
//     columns of a range of rows, recomputes xhat from s, writes dx and
//     keeps its columns' dw (db) partials in registers; the same
//     fixed-order sum adds the partials. s and dy are read twice, which a
//     row too wide for one pass cannot avoid without a grid-wide sync;
//   - K4: one thread rotates N adjacent pairs (d, d + D/2) of one head
//     row, reading each element of q, k and of the row's tables once;
//   - K5, K6: one thread per N adjacent elements. K6 reads the mask the
//     caller drew (the reference draws it outside its kernel too, and the
//     backward needs it).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

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
  return __float2half(x);
}

// N elements of T in one access (16 bytes when N = 16 / sizeof(T); 32
// bytes, two 16-byte accesses, for 8 f32 beside a 2-byte type)
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(pk.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_f32(T* p, const float (&in)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int i = 0; i < N; ++i) pk.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}


// sum over the block, the same value in every thread, added in a fixed
// order (warp shuffles, then the warps' sums in warp order). blockDim.x is
// a multiple of 32, at most kThreads.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += red[i];
  __syncthreads();  // red is written again by the next call
  return t;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// lets `kernel` take `bytes` of dynamic shared memory; the default limit
// of 48 KB counts the kernel's static shared memory too (at most 1 KB here)
cudaError_t smem_limit(const void* kernel, size_t bytes) {
  if (bytes + 1024 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// threads for a row of h elements read N at a time: one per vector,
// rounded up to whole warps, 32..kThreads
int row_threads(int h, int n) {
  const int t = ((h + n - 1) / n + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kThreads ? kThreads : t);
}

// ------------------------------------------------------------------ K3

// LAYER = false: RMS kind (w in TW = TX, no b, no mean); true: LayerNorm
// kind (w and b in TW = f32). One block per row; dynamic shared memory:
// the row's f32 sum [h], or none when WIDE (the second pass reads x and
// res again).
constexpr int kFwdRowMax = 32768;

template <typename TX, typename TY, typename TW, int N, bool LAYER,
          bool WIDE>
__global__ void __launch_bounds__(kThreads)
norm_fwd_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
                const TW* __restrict__ w, const TW* __restrict__ b,
                TY* __restrict__ y, TX* __restrict__ s,
                float* __restrict__ rstd, float* __restrict__ mean, int h,
                float eps) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  const size_t base = (size_t)blockIdx.x * h;
  float sum = 0.f, sq = 0.f;
  for (int c = threadIdx.x * N; c < h; c += blockDim.x * N) {
    float v[N];
    load_f32<TX, N>(x + base + c, v);
    if (res != nullptr) {
      float r[N];
      load_f32<TX, N>(res + base + c, r);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += r[i];
      store_f32<TX, N>(s + base + c, v);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (!WIDE) smem[c + i] = v[i];
      if constexpr (LAYER) sum += v[i];
      sq += v[i] * v[i];
    }
  }
  float mu = 0.f, var;
  if constexpr (LAYER) {
    mu = block_sum(sum, red) * (1.f / h);
    var = fmaxf(block_sum(sq, red) * (1.f / h) - mu * mu, 0.f);
  } else {
    var = block_sum(sq, red) * (1.f / h);
  }
  const float inv = rsqrtf(var + eps);
  for (int c = threadIdx.x * N; c < h; c += blockDim.x * N) {
    float wv[N], o[N], v[N];
    if constexpr (WIDE) {
      load_f32<TX, N>(x + base + c, v);
      if (res != nullptr) {
        float r[N];
        load_f32<TX, N>(res + base + c, r);
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] += r[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = smem[c + i];
    }
    load_f32<TW, N>(w + c, wv);
    if constexpr (LAYER) {
      float bv[N];
      load_f32<TW, N>(b + c, bv);
#pragma unroll
      for (int i = 0; i < N; ++i) o[i] = (v[i] - mu) * inv * wv[i] + bv[i];
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) o[i] = v[i] * inv * wv[i];
    }
    store_f32<TY, N>(y + base + c, o);
  }
  if (threadIdx.x == 0) {
    rstd[blockIdx.x] = inv;
    if constexpr (LAYER) mean[blockIdx.x] = mu;
  }
}

// K3 backward, the row kernel. A row group of `gwarps` = ceil(h /
// kGroupCols) warps (at most kMaxGroupWarps) takes one row at a time;
// lane j of the group holds the row's 16-byte vectors j, j + lanes, ...
// (at most kLaneElems elements), with w, and its dw (and db) partial, of
// those columns in registers for every row the group takes. A block holds
// max(1, kBlockWarps / gwarps) groups and owns rows [blockIdx.x * rpb, +
// rpb); its group g takes rows r0 + g, r0 + g + groups, ... Each group
// keeps `stages` rows in flight through a ring in shared memory, copied by
// cp.async while it reduces the current one: its s, dy (and ds) in the
// row's own order, and its rstd and mean once per lane. A lane copies s
// and ds for its own vectors; a warp copies its vectors' dy as whole
// 512-byte runs, so an f32 dy beside a 2-byte s (two pieces a vector) is
// read a line at a time, and its lanes read their pieces back after a
// warp sync. A row's two sums are warp shuffles, then, for a group of
// more than one warp, the warps' sums added in warp order after one named
// barrier of the group. At the end the block adds its groups' dw (db)
// partials in group order and writes one f32 partial row to `part`: row
// blockIdx.x (dw) and gridDim.x + blockIdx.x (db). On the H100, 4 to 12
// warps a block and 2 to 4 stages ran the main paths' shapes within 9% of
// each other, 8 warps and 3 stages within 4% of the fastest (PERF.md).
constexpr int kLaneElems = 32;
constexpr int kGroupCols = 32 * kLaneElems;
constexpr int kBlockWarps = 8;
constexpr int kMaxGroupWarps = 12;
constexpr int kStages = 3;
// dynamic shared memory a block may take (of the 227 KB, less the static
// exchange slots)
constexpr size_t kBwdSmem = 232448 - 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n (0..3) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 3)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the N elements of dy vector v (pieces v * Q .. v * Q + Q - 1)
template <typename TY, int N, int Q>
__device__ __forceinline__ void load_dy(const unsigned char* row, int v,
                                        float (&g)[N]) {
  constexpr int M = N / Q;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float t[M];
    load_f32<TY, M>(
        reinterpret_cast<const TY*>(row + (v * Q + q) * 16), t);
#pragma unroll
    for (int i = 0; i < M; ++i) g[q * M + i] = t[i];
  }
}

// bytes of one staged row: the row's rstd and mean, one copy per lane
// [lanes][2] f32; s [V][16 B]; dy [V * Q][16 B]; ds [V][16 B] (add
// variant), each in the row's own order
template <typename TX, typename TY>
__host__ __device__ size_t staged_row_bytes(int lanes, int h, bool add) {
  constexpr int Q = sizeof(TY) / sizeof(TX);
  return (size_t)lanes * 8 + (size_t)h * sizeof(TX) * (1 + Q + (add ? 1 : 0));
}

template <typename TX, typename TY, typename TW, bool LAYER>
__global__ void __launch_bounds__(kMaxGroupWarps * 32, 1)
norm_bwd_rows_kernel(const TX* __restrict__ s, const TW* __restrict__ w,
                     const float* __restrict__ rstd,
                     const float* __restrict__ mean,
                     const TY* __restrict__ dy, const TX* __restrict__ ds,
                     TX* __restrict__ dx, float* __restrict__ part, int rows,
                     int h, int rpb, int gwarps, int stages) {
  constexpr int N = 16 / sizeof(TX);
  constexpr int Q = sizeof(TY) / sizeof(TX);
  constexpr int U = kLaneElems / N;
  extern __shared__ __align__(16) unsigned char row_smem[];
  __shared__ float xch[2][kMaxGroupWarps][2];
  const int lanes = gwarps * 32;
  const int groups = blockDim.x / lanes;
  const int grp = threadIdx.x / lanes, j = threadIdx.x - grp * lanes;
  const int lane = threadIdx.x & 31;
  const int nv = h / N;
  const bool add = ds != nullptr;
  const size_t plane = (size_t)nv * 16;
  const size_t row_bytes = staged_row_bytes<TX, TY>(lanes, h, add);
  unsigned char* ring = row_smem + (size_t)grp * stages * row_bytes;

  float wv[U][N], aw[U][N], ab[U][N];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int v = j + u * lanes;
    float t[N];
    if (v < nv) {
      load_f32<TW, N>(w + (size_t)v * N, t);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) t[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      wv[u][i] = t[i];
      aw[u][i] = 0.f;
      ab[u][i] = 0.f;
    }
  }
  const int r0 = blockIdx.x * rpb;
  const int r1 = min(rows, r0 + rpb);
  const int first = r0 + grp;
  const int count = first < r1 ? (r1 - first + groups - 1) / groups : 0;

  // copy the group's k-th row into ring slot k % stages; one commit group
  // per call, empty past the last row, so the groups in flight count alike
  auto issue = [&](int k) {
    if (k < count) {
      const int r = first + k * groups;
      const size_t base = (size_t)r * h;
      unsigned char* p = ring + (size_t)(k % stages) * row_bytes;
      cp_async4(p + j * 8, rstd + r);
      if constexpr (LAYER) cp_async4(p + j * 8 + 4, mean + r);
      unsigned char* ps = p + (size_t)lanes * 8;
      const unsigned char* dyr =
          reinterpret_cast<const unsigned char*>(dy + base);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = j + u * lanes;
        if (v < nv) {
          cp_async16(ps + v * 16, s + base + (size_t)v * N);
          if (add)
            cp_async16(ps + plane * (1 + Q) + v * 16,
                       ds + base + (size_t)v * N);
        }
        // dy: the warp's 32 vectors of this u are Q * 512 contiguous
        // bytes; copy q takes the q-th 512 (16 bytes a lane), so each
        // copy reads whole lines (a vector's lane reads its pieces back
        // after a warp sync)
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int c = (v - lane) * Q + 32 * q + lane;   // piece of the row
          if (c < nv * Q)
            cp_async16(ps + plane + c * 16, dyr + (size_t)c * 16);
        }
      }
    }
    cp_async_commit();
  };

  for (int k = 0; k < stages - 1; ++k) issue(k);
  for (int k = 0; k < count; ++k) {
    __syncwarp();  // the warp is done with the slot issue() refills
    issue(k + stages - 1);
    cp_async_wait(stages - 1);
    __syncwarp();  // and sees the pieces its lanes copied
    const unsigned char* p = ring + (size_t)(k % stages) * row_bytes;
    const float rs = *reinterpret_cast<const float*>(p + j * 8);
    const float mu = LAYER ? *reinterpret_cast<const float*>(p + j * 8 + 4)
                           : 0.f;
    const unsigned char* ps = p + (size_t)lanes * 8;
    float part2 = 0.f, part1 = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = j + u * lanes;
      if (v < nv) {
        float sv[N], g[N];
        load_f32<TX, N>(reinterpret_cast<const TX*>(ps + v * 16), sv);
        load_dy<TY, N, Q>(ps + plane, v, g);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xhat = LAYER ? (sv[i] - mu) * rs : sv[i] * rs;
          const float wdy = g[i] * wv[u][i];
          part2 += wdy * xhat;
          aw[u][i] += g[i] * xhat;
          if constexpr (LAYER) {
            part1 += wdy;
            ab[u][i] += g[i];
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      part2 += __shfl_xor_sync(0xffffffffu, part2, o);
      if constexpr (LAYER) part1 += __shfl_xor_sync(0xffffffffu, part1, o);
    }
    if (gwarps > 1) {
      // the group's warps' sums, added in warp order; the slots alternate
      // by row, so a slot is written again only after every warp of the
      // group has passed the next row's barrier (and so read it)
      float(*x)[2] = xch[k & 1];
      if ((threadIdx.x & 31) == 0) {
        x[threadIdx.x >> 5][0] = part2;
        x[threadIdx.x >> 5][1] = part1;
      }
      group_sync(1 + grp, lanes);
      part2 = part1 = 0.f;
      for (int i = grp * gwarps; i < (grp + 1) * gwarps; ++i) {
        part2 += x[i][0];
        if constexpr (LAYER) part1 += x[i][1];
      }
    }
    const float c2 = part2 * (1.f / h);
    const float c1 = part1 * (1.f / h);
    const size_t base = (size_t)(first + k * groups) * h;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = j + u * lanes;
      if (v < nv) {
        float sv[N], g[N], d[N];
        load_f32<TX, N>(reinterpret_cast<const TX*>(ps + v * 16), sv);
        load_dy<TY, N, Q>(ps + plane, v, g);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xhat = LAYER ? (sv[i] - mu) * rs : sv[i] * rs;
          const float wdy = g[i] * wv[u][i];
          d[i] = LAYER ? rs * (wdy - c1 - xhat * c2) : rs * (wdy - xhat * c2);
        }
        if (add) {
          float e[N];
          load_f32<TX, N>(
              reinterpret_cast<const TX*>(ps + plane * (1 + Q) + v * 16), e);
#pragma unroll
          for (int i = 0; i < N; ++i) d[i] += e[i];
        }
        store_f32<TX, N>(dx + base + (size_t)v * N, d);
      }
    }
  }
  // the block's partial: the groups' registers through shared memory (the
  // ring, every copy landed and read), added in group order
  cp_async_wait(0);
  __syncthreads();
  float* red = reinterpret_cast<float*>(row_smem);  // [groups][h] dw, then db
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int v = j + u * lanes;
    if (v < nv) {
      store_f32<float, N>(red + (size_t)grp * h + v * N, aw[u]);
      if constexpr (LAYER)
        store_f32<float, N>(red + (size_t)(groups + grp) * h + v * N, ab[u]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    float t = 0.f, tb = 0.f;
    for (int g = 0; g < groups; ++g) {
      t += red[(size_t)g * h + c];
      if constexpr (LAYER) tb += red[(size_t)(groups + g) * h + c];
    }
    part[(size_t)blockIdx.x * h + c] = t;
    if constexpr (LAYER) part[((size_t)gridDim.x + blockIdx.x) * h + c] = tb;
  }
  // the sum kernel may be scheduled once every block is here (it waits
  // for this grid's end, and its writes, before it reads `part`)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Wide rows, pass 1: one block per row; coef[r] = mean(w*dy*xhat) and,
// for LayerNorm, coef[rows + r] = mean(w*dy).
template <typename TX, typename TY, typename TW, int N, bool LAYER>
__global__ void __launch_bounds__(kThreads)
norm_bwd_coef_kernel(const TX* __restrict__ s, const TW* __restrict__ w,
                     const float* __restrict__ rstd,
                     const float* __restrict__ mean,
                     const TY* __restrict__ dy, float* __restrict__ coef,
                     int rows, int h) {
  __shared__ float red[kThreads / 32];
  const int r = blockIdx.x;
  const size_t base = (size_t)r * h;
  const float rs = rstd[r];
  float mu = 0.f;
  if constexpr (LAYER) mu = mean[r];
  float part2 = 0.f, part1 = 0.f;
  for (int c = threadIdx.x * N; c < h; c += blockDim.x * N) {
    float sv[N], g[N], wv[N];
    load_f32<TX, N>(s + base + c, sv);
    load_f32<TY, N>(dy + base + c, g);
    load_f32<TW, N>(w + c, wv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xhat = LAYER ? (sv[i] - mu) * rs : sv[i] * rs;
      const float wdy = g[i] * wv[i];
      part2 += wdy * xhat;
      if constexpr (LAYER) part1 += wdy;
    }
  }
  const float c2 = block_sum(part2, red) * (1.f / h);
  float c1 = 0.f;
  if constexpr (LAYER) c1 = block_sum(part1, red) * (1.f / h);
  if (threadIdx.x == 0) {
    coef[r] = c2;
    if constexpr (LAYER) coef[rows + r] = c1;
  }
}

// Wide rows, pass 2: block (x, y) owns columns [x * kWideCols, + kWideCols)
// of rows [y * rpb, y * rpb + rpb); each thread kWideVec adjacent columns,
// its dw (db) partials in registers. The partials go to rows blockIdx.y
// (dw) and gridDim.y + blockIdx.y (db) of `part`.
constexpr int kWideVec = 8;
constexpr int kWideCols = kThreads * kWideVec;

template <typename TX, typename TY, typename TW, int N, bool LAYER>
__global__ void __launch_bounds__(kThreads)
norm_bwd_wide_kernel(const TX* __restrict__ s, const TW* __restrict__ w,
                     const float* __restrict__ rstd,
                     const float* __restrict__ mean,
                     const TY* __restrict__ dy, const TX* __restrict__ ds,
                     TX* __restrict__ dx, const float* __restrict__ coef,
                     float* __restrict__ part, int rows, int h, int rpb) {
  constexpr int kVecs = kWideVec / N;
  const int c0 = blockIdx.x * kWideCols + threadIdx.x * kWideVec;
  float wf[kWideVec], acc[kWideVec], accb[kWideVec];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int c = c0 + u * N;
    float wv[N];
    if (c < h) load_f32<TW, N>(w + c, wv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      wf[u * N + i] = c < h ? wv[i] : 0.f;
      acc[u * N + i] = accb[u * N + i] = 0.f;
    }
  }
  const int r0 = blockIdx.y * rpb;
  const int r1 = min(rows, r0 + rpb);
  for (int r = r0; r < r1; ++r) {
    const size_t base = (size_t)r * h;
    const float rs = rstd[r], c2 = coef[r];
    float mu = 0.f, c1 = 0.f;
    if constexpr (LAYER) {
      mu = mean[r];
      c1 = coef[rows + r];
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int c = c0 + u * N;
      if (c >= h) break;
      float sv[N], g[N], d[N];
      load_f32<TX, N>(s + base + c, sv);
      load_f32<TY, N>(dy + base + c, g);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xhat = LAYER ? (sv[i] - mu) * rs : sv[i] * rs;
        const float wdy = g[i] * wf[u * N + i];
        d[i] = LAYER ? rs * (wdy - c1 - xhat * c2) : rs * (wdy - xhat * c2);
        acc[u * N + i] += g[i] * xhat;
        if constexpr (LAYER) accb[u * N + i] += g[i];
      }
      if (ds != nullptr) {
        float e[N];
        load_f32<TX, N>(ds + base + c, e);
#pragma unroll
        for (int i = 0; i < N; ++i) d[i] += e[i];
      }
      store_f32<TX, N>(dx + base + c, d);
    }
  }
#pragma unroll
  for (int i = 0; i < kWideVec; ++i) {
    const int c = c0 + i;
    if (c >= h) break;
    part[(size_t)blockIdx.y * h + c] = acc[i];
    if constexpr (LAYER)
      part[((size_t)gridDim.y + blockIdx.y) * h + c] = accb[i];
  }
}

// dw (and db) = the `blocks` partial rows of `part` summed in a fixed
// order: sum i of the h (RMS) or 2h (LayerNorm: dw, then db from rows
// [blocks, 2 * blocks)) goes to block i / 8, whose 32 row groups each add
// every 32nd partial row, in row order, and whose first group adds the 32
// sums in group order. 8 sums a block, so the main paths' widths give 192
// (h = 768) to 256 blocks, more than the card's 132 SMs.
constexpr int kSumCols = 8;

template <typename TW, bool LAYER>
__global__ void __launch_bounds__(kThreads)
norm_bwd_sum_kernel(const float* __restrict__ part, TW* __restrict__ dw,
                    TW* __restrict__ db, int blocks, int h) {
  constexpr int kRowGroups = kThreads / kSumCols;
  __shared__ float red[kRowGroups][kSumCols];
  const int c = threadIdx.x % kSumCols, g = threadIdx.x / kSumCols;
  const int idx = blockIdx.x * kSumCols + c;
  const int nsum = LAYER ? 2 * h : h;
  const int which = idx >= h ? 1 : 0;
  const int col = idx - which * h;
  const float* p = part + (size_t)which * blocks * h + col;
  // launched early (programmatic dependent launch): wait until the grid
  // that wrote the partials has ended and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float t = 0.f;
  if (idx < nsum)
    for (int b = g; b < blocks; b += kRowGroups) t += p[(size_t)b * h];
  red[g][c] = t;
  __syncthreads();
  if (g == 0 && idx < nsum) {
    float u = 0.f;
    for (int i = 0; i < kRowGroups; ++i) u += red[i][c];
    (which ? db : dw)[col] = from_f32<TW>(u);
  }
}

template <typename TX, typename TY, typename TW, int N, bool LAYER,
          bool WIDE>
int norm_fwd_run(const void* x, const void* res, const void* w,
                 const void* b, void* y, void* s, void* rstd, void* mean,
                 int rows, int h, float eps, cudaStream_t st) {
  const size_t bytes = WIDE ? 0 : (size_t)h * sizeof(float);
  auto kernel = norm_fwd_kernel<TX, TY, TW, N, LAYER, WIDE>;
  cudaError_t err = smem_limit((const void*)kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows, row_threads(h, N), bytes, st>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(res),
      static_cast<const TW*>(w), static_cast<const TW*>(b),
      static_cast<TY*>(y), static_cast<TX*>(s), static_cast<float*>(rstd),
      static_cast<float*>(mean), h, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TY, typename TW, int N, bool LAYER>
int norm_fwd_launch(const void* x, const void* res, const void* w,
                    const void* b, void* y, void* s, void* rstd, void* mean,
                    int rows, int h, float eps, cudaStream_t st) {
  if (h > kFwdRowMax)
    return norm_fwd_run<TX, TY, TW, N, LAYER, true>(x, res, w, b, y, s, rstd,
                                                    mean, rows, h, eps, st);
  return norm_fwd_run<TX, TY, TW, N, LAYER, false>(x, res, w, b, y, s, rstd,
                                                   mean, rows, h, eps, st);
}

template <typename TW, bool LAYER>
int norm_bwd_sum(const void* part, void* dw, void* db, int blocks, int h,
                 cudaStream_t st) {
  const int nsum = LAYER ? 2 * h : h;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nsum + kSumCols - 1) / kSumCols);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, norm_bwd_sum_kernel<TW, LAYER>, static_cast<const float*>(part),
      static_cast<TW*>(dw), static_cast<TW*>(db), blocks, h);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the row kernel over `blocks` row ranges of `rpb` rows, then the sum;
// rows of 16-byte vectors (h a multiple of 16 / sizeof(TX), every pointer
// 16-byte aligned) up to kMaxGroupWarps * kGroupCols elements
template <typename TX, typename TY, typename TW, bool LAYER>
int norm_bwd_rows(const void* s, const void* w, const void* rstd,
                  const void* mean, const void* dy, const void* ds, void* dx,
                  void* dw, void* db, void* part, int rows, int h, int blocks,
                  int rpb, cudaStream_t st) {
  const int gwarps = (h + kGroupCols - 1) / kGroupCols;
  if (gwarps > kMaxGroupWarps) return (int)cudaErrorInvalidValue;
  const int groups = std::max(1, kBlockWarps / gwarps);
  const size_t row_bytes =
      staged_row_bytes<TX, TY>(32 * gwarps, h, ds != nullptr);
  const int stages =
      (int)std::min<size_t>(kStages, kBwdSmem / (groups * row_bytes));
  if (stages < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes =
      std::max(groups * stages * row_bytes,
               (size_t)groups * h * sizeof(float) * (LAYER ? 2 : 1));
  auto kernel = norm_bwd_rows_kernel<TX, TY, TW, LAYER>;
  cudaError_t err = smem_limit((const void*)kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, groups * gwarps * 32, bytes, st>>>(
      static_cast<const TX*>(s), static_cast<const TW*>(w),
      static_cast<const float*>(rstd), static_cast<const float*>(mean),
      static_cast<const TY*>(dy), static_cast<const TX*>(ds),
      static_cast<TX*>(dx), static_cast<float*>(part), rows, h, rpb, gwarps,
      stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return norm_bwd_sum<TW, LAYER>(part, dw, db, blocks, h, st);
}

// the wide path: row sums into coef f32 [2 * rows], then `blocks` row
// ranges of every 2048-column slab, then the sum
template <typename TX, typename TY, typename TW, int N, bool LAYER>
int norm_bwd_wide(const void* s, const void* w, const void* rstd,
                  const void* mean, const void* dy, const void* ds, void* dx,
                  void* dw, void* db, void* part, void* coef, int rows, int h,
                  int blocks, int rpb, cudaStream_t st) {
  norm_bwd_coef_kernel<TX, TY, TW, N, LAYER>
      <<<rows, row_threads(h, N), 0, st>>>(
          static_cast<const TX*>(s), static_cast<const TW*>(w),
          static_cast<const float*>(rstd), static_cast<const float*>(mean),
          static_cast<const TY*>(dy), static_cast<float*>(coef), rows, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_bwd_wide_kernel<TX, TY, TW, N, LAYER>
      <<<dim3((h + kWideCols - 1) / kWideCols, blocks), kThreads, 0, st>>>(
          static_cast<const TX*>(s), static_cast<const TW*>(w),
          static_cast<const float*>(rstd), static_cast<const float*>(mean),
          static_cast<const TY*>(dy), static_cast<const TX*>(ds),
          static_cast<TX*>(dx), static_cast<const float*>(coef),
          static_cast<float*>(part), rows, h, rpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return norm_bwd_sum<TW, LAYER>(part, dw, db, blocks, h, st);
}

// N = 16 bytes of TX when h allows it and every pointer is 16-byte
// aligned (an f32 TY or TW with a 2-byte TX then moves 32 bytes, two
// accesses)
template <bool LAYER, typename TX, typename TY>
int norm_fwd_typed(const void* x, const void* res, const void* w,
                   const void* b, void* y, void* s, void* rstd, void* mean,
                   int rows, int h, float eps, cudaStream_t st) {
  using TW = typename std::conditional<LAYER, float, TX>::type;
  constexpr int N = 16 / sizeof(TX);
  if (h % N == 0 && aligned16(x) && aligned16(res) && aligned16(w) &&
      aligned16(b) && aligned16(y) && aligned16(s))
    return norm_fwd_launch<TX, TY, TW, N, LAYER>(x, res, w, b, y, s, rstd,
                                                 mean, rows, h, eps, st);
  return norm_fwd_launch<TX, TY, TW, 1, LAYER>(x, res, w, b, y, s, rstd,
                                               mean, rows, h, eps, st);
}

// coef null: the row kernel, which takes rows of 16-byte vectors only
// (-2 otherwise: the caller sends other rows to the wide path); coef
// non-null: the wide path, 16 bytes of TX at a time where h and the
// pointers allow it, one element otherwise
template <bool LAYER, typename TX, typename TY>
int norm_bwd_typed(const void* s, const void* w, const void* rstd,
                   const void* mean, const void* dy, const void* ds,
                   void* dx, void* dw, void* db, void* part, void* coef,
                   int rows, int h, int blocks, int rpb, cudaStream_t st) {
  using TW = typename std::conditional<LAYER, float, TX>::type;
  constexpr int N = 16 / sizeof(TX);
  const bool vec = h % N == 0 && aligned16(s) && aligned16(w) &&
                   aligned16(dy) && aligned16(ds) && aligned16(dx);
  if (coef == nullptr) {
    if (!vec) return -2;
    return norm_bwd_rows<TX, TY, TW, LAYER>(s, w, rstd, mean, dy, ds, dx, dw,
                                            db, part, rows, h, blocks, rpb,
                                            st);
  }
  if (vec)
    return norm_bwd_wide<TX, TY, TW, N, LAYER>(s, w, rstd, mean, dy, ds, dx,
                                               dw, db, part, coef, rows, h,
                                               blocks, rpb, st);
  return norm_bwd_wide<TX, TY, TW, 1, LAYER>(s, w, rstd, mean, dy, ds, dx, dw,
                                             db, part, coef, rows, h, blocks,
                                             rpb, st);
}

// ------------------------------------------------------------------ K4

// rows = B * S * H head rows per tensor; thread i of the first half
// rotates q, of the second k. Tables [S, D] in T.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ cos_t, const T* __restrict__ sin_t,
            T* __restrict__ qo, T* __restrict__ ko, long long rows,
            int seq, int heads, int d, int backward) {
  const int dh = d / 2;
  const int per_row = dh / N;
  const long long per_tensor = rows * per_row;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * per_tensor) return;
  const bool is_k = i >= per_tensor;
  if (is_k) i -= per_tensor;
  const long long row = i / per_row;
  const int c = (int)(i % per_row) * N;
  const long long pos = (row / heads) % seq;
  const T* a = (is_k ? k : q) + row * d;
  T* o = (is_k ? ko : qo) + row * d;
  const T* ct = cos_t + pos * d;
  const T* stab = sin_t + pos * d;
  float a1[N], a2[N], c1[N], c2[N], s1[N], s2[N], o1[N], o2[N];
  load_f32<T, N>(a + c, a1);
  load_f32<T, N>(a + dh + c, a2);
  load_f32<T, N>(ct + c, c1);
  load_f32<T, N>(ct + dh + c, c2);
  load_f32<T, N>(stab + c, s1);
  load_f32<T, N>(stab + dh + c, s2);
  if (backward) {
    // g*cos + concat((g*sin)_2, -(g*sin)_1)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      o1[j] = a1[j] * c1[j] + a2[j] * s2[j];
      o2[j] = a2[j] * c2[j] - a1[j] * s1[j];
    }
  } else {
    // a*cos + concat(-a_2, a_1)*sin
#pragma unroll
    for (int j = 0; j < N; ++j) {
      o1[j] = a1[j] * c1[j] - a2[j] * s1[j];
      o2[j] = a2[j] * c2[j] + a1[j] * s2[j];
    }
  }
  store_f32<T, N>(o + c, o1);
  store_f32<T, N>(o + dh + c, o2);
}

template <typename T, int N>
int rope_launch(const void* q, const void* k, const void* cos,
                const void* sin, void* qo, void* ko, long long rows, int seq,
                int heads, int d, int backward, cudaStream_t st) {
  const long long work = 2 * rows * (d / 2 / N);
  const unsigned grid = (unsigned)((work + kThreads - 1) / kThreads);
  rope_kernel<T, N><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(cos), static_cast<const T*>(sin),
      static_cast<T*>(qo), static_cast<T*>(ko), rows, seq, heads, d,
      backward);
  return (int)cudaGetLastError();
}

template <typename T>
int rope_typed(const void* q, const void* k, const void* cos,
               const void* sin, void* qo, void* ko, long long rows, int seq,
               int heads, int d, int backward, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  if ((d / 2) % N == 0 && aligned16(q) && aligned16(k) && aligned16(cos) &&
      aligned16(sin) && aligned16(qo) && aligned16(ko))
    return rope_launch<T, N>(q, k, cos, sin, qo, ko, rows, seq, heads, d,
                             backward, st);
  return rope_launch<T, 1>(q, k, cos, sin, qo, ko, rows, seq, heads, d,
                           backward, st);
}

// ------------------------------------------------------------------ K5

__device__ __forceinline__ float sigmoid(float g) {
  return 1.f / (1.f + expf(-g));
}

// thread i: elements [i * N, i * N + N), the ragged tail one at a time
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
swiglu_fwd_kernel(const T* __restrict__ g, const T* __restrict__ u,
                  T* __restrict__ o, long long n) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * N;
  if (i0 + N <= n) {
    float gv[N], uv[N], ov[N];
    load_f32<T, N>(g + i0, gv);
    load_f32<T, N>(u + i0, uv);
#pragma unroll
    for (int j = 0; j < N; ++j) ov[j] = gv[j] * sigmoid(gv[j]) * uv[j];
    store_f32<T, N>(o + i0, ov);
  } else {
    for (long long i = i0; i < n; ++i) {
      const float gv = to_f32(g[i]);
      o[i] = from_f32<T>(gv * sigmoid(gv) * to_f32(u[i]));
    }
  }
}

__device__ __forceinline__ void swiglu_grad(float g, float u, float d,
                                            float& dg, float& du) {
  const float sig = sigmoid(g);
  const float silu = g * sig;
  dg = d * u * (sig + silu * (1.f - sig));
  du = d * silu;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_kernel(const T* __restrict__ g, const T* __restrict__ u,
                  const T* __restrict__ d_o, T* __restrict__ dg,
                  T* __restrict__ du, long long n) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * N;
  if (i0 + N <= n) {
    float gv[N], uv[N], dv[N], a[N], b[N];
    load_f32<T, N>(g + i0, gv);
    load_f32<T, N>(u + i0, uv);
    load_f32<T, N>(d_o + i0, dv);
#pragma unroll
    for (int j = 0; j < N; ++j) swiglu_grad(gv[j], uv[j], dv[j], a[j], b[j]);
    store_f32<T, N>(dg + i0, a);
    store_f32<T, N>(du + i0, b);
  } else {
    for (long long i = i0; i < n; ++i) {
      float a, b;
      swiglu_grad(to_f32(g[i]), to_f32(u[i]), to_f32(d_o[i]), a, b);
      dg[i] = from_f32<T>(a);
      du[i] = from_f32<T>(b);
    }
  }
}

template <typename T>
unsigned swiglu_grid(long long n, bool vec) {
  const int n_per = vec ? 16 / (int)sizeof(T) : 1;
  const long long threads = (n + n_per - 1) / n_per;
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <typename T>
int swiglu_fwd_typed(const void* g, const void* u, void* o, long long n,
                     cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = aligned16(g) && aligned16(u) && aligned16(o);
  const unsigned grid = swiglu_grid<T>(n, vec);
  if (vec)
    swiglu_fwd_kernel<T, N><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(u),
        static_cast<T*>(o), n);
  else
    swiglu_fwd_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(u),
        static_cast<T*>(o), n);
  return (int)cudaGetLastError();
}

template <typename T>
int swiglu_bwd_typed(const void* g, const void* u, const void* d_o,
                     void* dg, void* du, long long n, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = aligned16(g) && aligned16(u) && aligned16(d_o) &&
                   aligned16(dg) && aligned16(du);
  const unsigned grid = swiglu_grid<T>(n, vec);
  if (vec)
    swiglu_bwd_kernel<T, N><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(u),
        static_cast<const T*>(d_o), static_cast<T*>(dg),
        static_cast<T*>(du), n);
  else
    swiglu_bwd_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(u),
        static_cast<const T*>(d_o), static_cast<T*>(dg),
        static_cast<T*>(du), n);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------------ K6

// thread i: elements [i * N, i * N + N), the ragged tail one at a time
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
dropout_add_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const T* __restrict__ m, T* __restrict__ o,
                       float scale, long long n) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * N;
  if (i0 + N <= n) {
    float xv[N], yv[N], mv[N], ov[N];
    load_f32<T, N>(x + i0, xv);
    load_f32<T, N>(y + i0, yv);
    load_f32<T, N>(m + i0, mv);
#pragma unroll
    for (int j = 0; j < N; ++j) ov[j] = xv[j] * mv[j] * scale + yv[j];
    store_f32<T, N>(o + i0, ov);
  } else {
    for (long long i = i0; i < n; ++i)
      o[i] = from_f32<T>(to_f32(x[i]) * to_f32(m[i]) * scale + to_f32(y[i]));
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
dropout_add_bwd_kernel(const T* __restrict__ g, const T* __restrict__ m,
                       T* __restrict__ dx, float scale, long long n) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * N;
  if (i0 + N <= n) {
    float gv[N], mv[N], dv[N];
    load_f32<T, N>(g + i0, gv);
    load_f32<T, N>(m + i0, mv);
#pragma unroll
    for (int j = 0; j < N; ++j) dv[j] = gv[j] * mv[j] * scale;
    store_f32<T, N>(dx + i0, dv);
  } else {
    for (long long i = i0; i < n; ++i)
      dx[i] = from_f32<T>(to_f32(g[i]) * to_f32(m[i]) * scale);
  }
}

template <typename T>
int dropout_add_fwd_typed(const void* x, const void* y, const void* m,
                          void* o, float scale, long long n,
                          cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = aligned16(x) && aligned16(y) && aligned16(m) &&
                   aligned16(o);
  const unsigned grid = swiglu_grid<T>(n, vec);
  if (vec)
    dropout_add_fwd_kernel<T, N><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(m), static_cast<T*>(o), scale, n);
  else
    dropout_add_fwd_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(m), static_cast<T*>(o), scale, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dropout_add_bwd_typed(const void* g, const void* m, void* dx,
                          float scale, long long n, cudaStream_t st) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = aligned16(g) && aligned16(m) && aligned16(dx);
  const unsigned grid = swiglu_grid<T>(n, vec);
  if (vec)
    dropout_add_bwd_kernel<T, N><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(m),
        static_cast<T*>(dx), scale, n);
  else
    dropout_add_bwd_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(m),
        static_cast<T*>(dx), scale, n);
  return (int)cudaGetLastError();
}

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

// the type pair (x_dtype, y_dtype) -> the norm kernels' instantiation
template <bool LAYER>
int norm_fwd_entry(const void* x, const void* res, const void* w,
                   const void* b, void* y, void* s, void* rstd, void* mean,
                   int rows, int h, float eps, int x_dtype, int y_dtype,
                   cudaStream_t st) {
  if (rows == 0 || h == 0) return 0;
  if (x_dtype == y_dtype) {
    if (x_dtype == kF32)
      return norm_fwd_typed<LAYER, float, float>(x, res, w, b, y, s, rstd,
                                                 mean, rows, h, eps, st);
    if (x_dtype == kBF16)
      return norm_fwd_typed<LAYER, __nv_bfloat16, __nv_bfloat16>(
          x, res, w, b, y, s, rstd, mean, rows, h, eps, st);
    if (x_dtype == kF16)
      return norm_fwd_typed<LAYER, __half, __half>(x, res, w, b, y, s, rstd,
                                                   mean, rows, h, eps, st);
  } else if (y_dtype == kF32) {
    if (x_dtype == kBF16)
      return norm_fwd_typed<LAYER, __nv_bfloat16, float>(
          x, res, w, b, y, s, rstd, mean, rows, h, eps, st);
    if (x_dtype == kF16)
      return norm_fwd_typed<LAYER, __half, float>(x, res, w, b, y, s, rstd,
                                                  mean, rows, h, eps, st);
  }
  return -1;
}

template <bool LAYER>
int norm_bwd_entry(const void* s, const void* w, const void* rstd,
                   const void* mean, const void* dy, const void* ds,
                   void* dx, void* dw, void* db, void* part, void* coef,
                   int rows, int h, int blocks, int rpb, int x_dtype,
                   int y_dtype, cudaStream_t st) {
  if (rows == 0 || h == 0) return 0;
  if (x_dtype == y_dtype) {
    if (x_dtype == kF32)
      return norm_bwd_typed<LAYER, float, float>(
          s, w, rstd, mean, dy, ds, dx, dw, db, part, coef, rows, h, blocks,
          rpb, st);
    if (x_dtype == kBF16)
      return norm_bwd_typed<LAYER, __nv_bfloat16, __nv_bfloat16>(
          s, w, rstd, mean, dy, ds, dx, dw, db, part, coef, rows, h, blocks,
          rpb, st);
    if (x_dtype == kF16)
      return norm_bwd_typed<LAYER, __half, __half>(
          s, w, rstd, mean, dy, ds, dx, dw, db, part, coef, rows, h, blocks,
          rpb, st);
  } else if (y_dtype == kF32) {
    if (x_dtype == kBF16)
      return norm_bwd_typed<LAYER, __nv_bfloat16, float>(
          s, w, rstd, mean, dy, ds, dx, dw, db, part, coef, rows, h, blocks,
          rpb, st);
    if (x_dtype == kF16)
      return norm_bwd_typed<LAYER, __half, float>(
          s, w, rstd, mean, dy, ds, dx, dw, db, part, coef, rows, h, blocks,
          rpb, st);
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. The caller has
// checked shapes, contiguity and devices; x_dtype is that of x, res, s,
// dx and ds (and of w and dw for the RMS kinds; LayerNorm's w, b, dw and
// db are f32); y_dtype, that of y and dy, is x_dtype or 0. The return
// value is cudaGetLastError(); 0 = ok, -1 = a dtype pair the kernels do
// not take.

// x, res [rows, h] (res, s null for the plain norm); w [h]; y [rows, h];
// rstd [rows] f32. Dynamic shared memory: 4 * h bytes (none above 32768
// elements a row).
extern "C" int fused_rms_norm_fwd(const void* x, const void* res,
                                  const void* w, void* y, void* s,
                                  void* rstd, int rows, int h, float eps,
                                  int x_dtype, int y_dtype, void* stream) {
  return norm_fwd_entry<false>(x, res, w, nullptr, y, s, rstd, nullptr,
                               rows, h, eps, x_dtype, y_dtype,
                               static_cast<cudaStream_t>(stream));
}

// s [rows, h] (the saved input, or the summed stream of the add variant);
// dy [rows, h]; ds [rows, h] or null; dx [rows, h]; dw [h]; dw_part f32
// scratch [blocks, h], one partial row per block; block b owns rows [b *
// rpb, b * rpb + rpb). coef null: the row kernel (rows of 16-byte vectors
// up to 12288 elements; -2 for others), one block per SM of up to 227 KB
// of dynamic shared memory; coef f32 scratch [2 * rows]: the two-pass wide
// path (any row).
extern "C" int fused_rms_norm_bwd(const void* s, const void* w,
                                  const void* rstd, const void* dy,
                                  const void* ds, void* dx, void* dw,
                                  void* dw_part, void* coef, int rows, int h,
                                  int blocks, int rpb, int x_dtype,
                                  int y_dtype, void* stream) {
  return norm_bwd_entry<false>(s, w, rstd, nullptr, dy, ds, dx, dw, nullptr,
                               dw_part, coef, rows, h, blocks, rpb, x_dtype,
                               y_dtype, static_cast<cudaStream_t>(stream));
}

// as fused_rms_norm_fwd, with b [h] and w f32, and mean [rows] f32 out
extern "C" int fused_layer_norm_fwd(const void* x, const void* res,
                                    const void* w, const void* b, void* y,
                                    void* s, void* rstd, void* mean,
                                    int rows, int h, float eps, int x_dtype,
                                    int y_dtype, void* stream) {
  return norm_fwd_entry<true>(x, res, w, b, y, s, rstd, mean, rows, h, eps,
                              x_dtype, y_dtype,
                              static_cast<cudaStream_t>(stream));
}

// as fused_rms_norm_bwd, with w f32, mean [rows] f32, dw and db [h] f32
// and part f32 scratch [2 * blocks, h] (the dw partials, then the db
// ones).
extern "C" int fused_layer_norm_bwd(const void* s, const void* w,
                                    const void* rstd, const void* mean,
                                    const void* dy, const void* ds, void* dx,
                                    void* dw, void* db, void* part,
                                    void* coef, int rows, int h, int blocks,
                                    int rpb, int x_dtype, int y_dtype,
                                    void* stream) {
  return norm_bwd_entry<true>(s, w, rstd, mean, dy, ds, dx, dw, db, part,
                              coef, rows, h, blocks, rpb, x_dtype, y_dtype,
                              static_cast<cudaStream_t>(stream));
}

// q, k, qo, ko [B, S, H, D] contiguous, rows = B * S * H; cos, sin [S, D];
// D even. backward = 1 applies the transpose (the VJP of the rotation).
extern "C" int rope_qk(const void* q, const void* k, const void* cos,
                       const void* sin, void* qo, void* ko, long long rows,
                       int seq, int heads, int d, int backward, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0 || d == 0) return 0;
  if (dtype == kF32)
    return rope_typed<float>(q, k, cos, sin, qo, ko, rows, seq, heads, d,
                             backward, st);
  if (dtype == kBF16)
    return rope_typed<__nv_bfloat16>(q, k, cos, sin, qo, ko, rows, seq,
                                     heads, d, backward, st);
  if (dtype == kF16)
    return rope_typed<__half>(q, k, cos, sin, qo, ko, rows, seq, heads, d,
                              backward, st);
  return -1;
}

// g, u, o: n contiguous elements
extern "C" int swiglu_fwd(const void* g, const void* u, void* o, long long n,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (dtype == kF32) return swiglu_fwd_typed<float>(g, u, o, n, st);
  if (dtype == kBF16) return swiglu_fwd_typed<__nv_bfloat16>(g, u, o, n, st);
  if (dtype == kF16) return swiglu_fwd_typed<__half>(g, u, o, n, st);
  return -1;
}

// g, u, d_o, dg, du: n contiguous elements
extern "C" int swiglu_bwd(const void* g, const void* u, const void* d_o,
                          void* dg, void* du, long long n, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (dtype == kF32) return swiglu_bwd_typed<float>(g, u, d_o, dg, du, n, st);
  if (dtype == kBF16)
    return swiglu_bwd_typed<__nv_bfloat16>(g, u, d_o, dg, du, n, st);
  if (dtype == kF16) return swiglu_bwd_typed<__half>(g, u, d_o, dg, du, n, st);
  return -1;
}

// x, y, mask, o: n contiguous elements of one dtype; mask holds 0 or 1
extern "C" int dropout_add_fwd(const void* x, const void* y, const void* m,
                               void* o, float scale, long long n, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (dtype == kF32)
    return dropout_add_fwd_typed<float>(x, y, m, o, scale, n, st);
  if (dtype == kBF16)
    return dropout_add_fwd_typed<__nv_bfloat16>(x, y, m, o, scale, n, st);
  if (dtype == kF16)
    return dropout_add_fwd_typed<__half>(x, y, m, o, scale, n, st);
  return -1;
}

// g, mask, dx: n contiguous elements of one dtype
extern "C" int dropout_add_bwd(const void* g, const void* m, void* dx,
                               float scale, long long n, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (dtype == kF32)
    return dropout_add_bwd_typed<float>(g, m, dx, scale, n, st);
  if (dtype == kBF16)
    return dropout_add_bwd_typed<__nv_bfloat16>(g, m, dx, scale, n, st);
  if (dtype == kF16)
    return dropout_add_bwd_typed<__half>(g, m, dx, scale, n, st);
  return -1;
}
