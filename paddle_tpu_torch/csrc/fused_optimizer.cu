// Fused multi-tensor Adam / AdamW and Momentum updates for Hopper
// (sm_90a): one pass over a list of parameters.
//
// Replaces: no Pallas kernel. paddle_tpu runs these updates as XLA
// compositions: `fused_adam_step` / `_build_executor` (one jitted program
// over the whole parameter pytree, paddle_tpu/optimizer/fused.py :53-189),
// `fused_momentum_step` / `_build_momentum_executor` (:192-290), and the
// per-parameter `Adam._apply_one` / `Momentum._apply_one` of
// paddle_tpu/optimizer/__init__.py, which XLA fuses into one loop over
// memory each. Eager PyTorch would run that chain as ~20 kernels of a full
// pass each, so the port writes the loop by hand.
//
// Entry points (each returns cudaGetLastError(), 0 = ok; one launch each):
//   fused_adam      Adam (coupled decay, added to g) and AdamW (decoupled
//                   decay: the multiplicative shrink, or L1's
//                   newb - lr*coeff*sign(newb)), amsgrad, f32 master
//                   weights, an optional clip scale
//   fused_momentum  Momentum (coupled decay), nesterov, the same master,
//                   decay, per-tensor LR and clip options
//
// Arithmetic: the plain version's, op for op (ops/fused_optimizer.py
// `fused_adam_reference`, `fused_momentum_reference`, the loops of the
// per-parameter torch ops). Each op is one IEEE operation rounded to
// nearest (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`, `__fsqrt_rn`, and their
// f64 forms): nvcc contracts a*b + c into an FMA by default, which would
// change the low bits against the plain version's separate kernels, and
// the intrinsics are never contracted. The compute type C is f32 for f32,
// bf16 and f16 parameters and f64 for f64 ones; every scalar is made on
// the host as the plain version makes it (ops/fused_optimizer.py
// `adam_scalars`, `decay_values`) and passed as a double that C holds
// exactly. Each stored output is rounded once (round to nearest even):
// the moments to their accumulator type TM, the parameter to TP, the
// master weight kept in f32.
//
//   g    = g * scale rounded to TP (only with a clip scale)
//   g   += coeff * b (L2) or coeff * sign(b) (L1)     coupled decay only
//   m    = m * b1 + g * (1 - b1)
//   v    = v * b2 + (g * g) * (1 - b2)
//   vmax = max(vmax, v)                               amsgrad
//   step = ((m / bc1) * lr) / (sqrt((amsgrad ? vmax : v) / bc2) + eps)
//   new  = b * (1 - lr*coeff) (decoupled L2) or b - (lr*coeff) * sign(b)
//          (decoupled L1), or b; then new - step
// with b the master weight when there is one, else the parameter. Momentum:
//   g   += coeff * b (or coeff * sign(b));  vel = vel * mu + g;
//   upd  = nesterov ? g + vel * mu : vel;   new = b - lr * upd.
//
// Layout. One launch takes up to kMaxTensors tensors of one (TP, TM)
// pair. Their pointers, element counts, per-tensor LR and decay value
// travel in the kernel's parameters (`__grid_constant__`, ~31 KB: Hopper
// with CUDA >= 12.1 takes up to 32,764 bytes), so nothing is copied to the
// card before the launch and the grad pointers, which change every step,
// cost nothing to pass. The tensors are laid end to end in one virtual
// range, each starting at a multiple of the vector width N = 16 /
// sizeof(TP), cut into chunks of kChunk elements (fewer for a list too
// small to give every block one). The grid is as many blocks as the card
// holds at once (at most kMaxBlocksPerSm an SM), and block b takes chunks
// b, b + grid, ...; for each it finds the first tensor by a binary search
// of the starts and walks every tensor the chunk overlaps. A tensor whose
// pointers all lie on 16 bytes is read and written as N-element vectors
// (16 bytes of p and g; 32 of f32 moments or master beside a 2-byte TP),
// its ragged tail one element at a time; any other tensor one element at
// a time. Empty tensors never reach the kernel.
//
// What bounds it on the H100: device memory. Each element moves its p, g,
// m, v (and vmax, master) once each way and does ~12 f32 operations,
// orders of magnitude below the rate at which the f32 pipes would be the
// limit (LLaMA 1B under O2 with bf16 moments: 14 bytes a parameter, 16 GB
// a step, a bound of 4.8 ms at 3.35 TB/s). So the design reads and
// writes each byte once, in 16-byte accesses, with ~64 bytes of loads in
// flight per thread and kChunk elements a block (8 vectors a thread for
// 2-byte TP, 16 for f32), and one launch per dtype pair of the list.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 384;
constexpr long long kChunk = 16384;
constexpr long long kMinChunk = 2048;
// resident blocks an SM: more blocks streaming their arrays at once can
// cost device-memory throughput. At LLaMA 1B's bf16 list on the H100 (700
// W), Momentum's kernel (58 registers, room for 4) took 4.14 / 6.26 /
// 8.69 ms with at most 2 / 3 / 4 blocks an SM; Adam's (73 registers, room
// for 3) 7.01 / 6.40 / 6.41 over the whole list, but its launches of one
// tensor each, the training steps' per-parameter path, ran slower at 3
constexpr int kMaxBlocksPerSm = 2;

enum { kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3 };

struct ListArgs {
  long long start[kMaxTensors + 1];  // virtual offsets, multiples of N
  long long n[kMaxTensors];
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  void* m[kMaxTensors];     // Adam: moment1; Momentum: velocity
  void* v[kMaxTensors];     // Adam: moment2
  void* vmax[kMaxTensors];  // amsgrad: moment2_max; else null
  float* master[kMaxTensors];  // f32 master weight or null
  double lr[kMaxTensors];
  double wd[kMaxTensors];  // coupled: coeff; decoupled L2: 1 - lr*coeff;
                           // decoupled L1: lr*coeff
  unsigned char vec[kMaxTensors];
  // b1 is Momentum's mu
  double b1, omb1, b2, omb2, bc1, bc2, eps;
  const float* scale;  // clip scale (one f32 on the card) or null
  long long chunk;     // elements a block
  int count, decoupled, l1, nesterov;
};

// ---------------------------------------------------------- conversions

template <typename T>
struct Comp {
  using type = float;
};
template <>
struct Comp<double> {
  using type = double;
};

template <typename C>
__device__ __forceinline__ C to_c(float x) { return (C)x; }
template <typename C>
__device__ __forceinline__ C to_c(double x) { return (C)x; }
template <typename C>
__device__ __forceinline__ C to_c(__nv_bfloat16 x) {
  return (C)__bfloat162float(x);
}
template <typename C>
__device__ __forceinline__ C to_c(__half x) {
  return (C)__half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_c(float x);
template <>
__device__ __forceinline__ float from_c<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_c<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_c<__half>(float x) {
  return __float2half_rn(x);
}
template <typename T>
__device__ __forceinline__ T from_c(double x);
template <>
__device__ __forceinline__ double from_c<double>(double x) { return x; }
template <>
__device__ __forceinline__ float from_c<float>(double x) { return (float)x; }

// ------------------------------------------------- rounded operations

__device__ __forceinline__ float rn_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float rn_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float rn_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float rn_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float rn_sqrt(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double rn_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double rn_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double rn_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double rn_div(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ double rn_sqrt(double a) { return __dsqrt_rn(a); }

// torch.sign: 1, -1, or 0 (for +-0 and NaN)
template <typename C>
__device__ __forceinline__ C sgn(C x) {
  return (C)((C(0) < x) - (x < C(0)));
}

// torch.maximum: NaN if either is NaN
template <typename C>
__device__ __forceinline__ C nan_max(C a, C b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// ------------------------------------------------------------- the math

// coupled decay: g + coeff * b (L2) or g + coeff * sign(b) (L1)
template <typename C>
__device__ __forceinline__ C coupled(const ListArgs& a, C g, C b, C wd) {
  return rn_add(g, a.l1 ? rn_mul(sgn(b), wd) : rn_mul(b, wd));
}

// Adam / AdamW: updates m, v, x (vmax) and returns the new weight
template <typename C>
__device__ __forceinline__ C adam_math(const ListArgs& a, bool ams, C lr,
                                       C wd, C g, C b, C& m, C& v, C& x) {
  if (!a.decoupled && wd != C(0)) g = coupled(a, g, b, wd);
  m = rn_add(rn_mul(m, (C)a.b1), rn_mul(g, (C)a.omb1));
  v = rn_add(rn_mul(v, (C)a.b2), rn_mul(rn_mul(g, g), (C)a.omb2));
  C vv = v;
  if (ams) {
    x = nan_max(x, v);
    vv = x;
  }
  const C step = rn_div(rn_mul(rn_div(m, (C)a.bc1), lr),
                        rn_add(rn_sqrt(rn_div(vv, (C)a.bc2)), (C)a.eps));
  C nb = b;
  if (a.decoupled) nb = a.l1 ? rn_sub(nb, rn_mul(wd, sgn(nb))) : rn_mul(nb, wd);
  return rn_sub(nb, step);
}

// Momentum: updates vel and returns the new weight
template <typename C>
__device__ __forceinline__ C momentum_math(const ListArgs& a, C lr, C wd,
                                           C g, C b, C& vel) {
  if (wd != C(0)) g = coupled(a, g, b, wd);
  const C mu = (C)a.b1;
  vel = rn_add(rn_mul(vel, mu), g);
  const C upd = a.nesterov ? rn_add(g, rn_mul(vel, mu)) : vel;
  return rn_sub(b, rn_mul(lr, upd));
}

// W elements of T in one access (16 bytes for W = 16 / sizeof(T); 32
// bytes, two 16-byte accesses, for 8 f32 beside a 2-byte type)
template <typename T, int W>
struct alignas(sizeof(T) * W < 16 ? sizeof(T) * W : 16) Pack {
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ Pack<T, W> ld(const void* base, long long j) {
  return *(reinterpret_cast<const Pack<T, W>*>(static_cast<const T*>(base) +
                                               j));
}

template <typename T, int W>
__device__ __forceinline__ void st(void* base, long long j,
                                   const Pack<T, W>& pk) {
  *(reinterpret_cast<Pack<T, W>*>(static_cast<T*>(base) + j)) = pk;
}

// elements [j, j + W) of tensor t
template <typename TP, typename TM, int W, bool ADAM>
__device__ __forceinline__ void update(const ListArgs& a, int t, long long j,
                                       bool master, bool ams,
                                       typename Comp<TP>::type lr,
                                       typename Comp<TP>::type wd,
                                       typename Comp<TP>::type scale) {
  using C = typename Comp<TP>::type;
  const Pack<TP, W> gk = ld<TP, W>(a.g[t], j);
  Pack<TP, W> pk;
  Pack<float, W> mk;
  if (master) mk = ld<float, W>(a.master[t], j);
  else pk = ld<TP, W>(a.p[t], j);
  Pack<TM, W> m1 = ld<TM, W>(a.m[t], j), m2, mx;
  if (ADAM) m2 = ld<TM, W>(a.v[t], j);
  if (ams) mx = ld<TM, W>(a.vmax[t], j);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    C g = to_c<C>(gk.v[k]);
    if (a.scale) g = to_c<C>(from_c<TP>(rn_mul(g, scale)));
    const C b = master ? (C)mk.v[k] : to_c<C>(pk.v[k]);
    C nw;
    if (ADAM) {
      C m = to_c<C>(m1.v[k]), v = to_c<C>(m2.v[k]);
      C x = ams ? to_c<C>(mx.v[k]) : C(0);
      nw = adam_math<C>(a, ams, lr, wd, g, b, m, v, x);
      m1.v[k] = from_c<TM>(m);
      m2.v[k] = from_c<TM>(v);
      if (ams) mx.v[k] = from_c<TM>(x);
    } else {
      C vel = to_c<C>(m1.v[k]);
      nw = momentum_math<C>(a, lr, wd, g, b, vel);
      m1.v[k] = from_c<TM>(vel);
    }
    if (master) mk.v[k] = from_c<float>(nw);
    pk.v[k] = from_c<TP>(nw);
  }
  st<TM, W>(a.m[t], j, m1);
  if (ADAM) st<TM, W>(a.v[t], j, m2);
  if (ams) st<TM, W>(a.vmax[t], j, mx);
  if (master) st<float, W>(a.master[t], j, mk);
  st<TP, W>(a.p[t], j, pk);
}

// chunk [c0, c0 + a.chunk) of the list's range
template <typename TP, typename TM, int N, bool ADAM>
__device__ __forceinline__ void update_chunk(const ListArgs& a, long long c0,
                                             typename Comp<TP>::type scale) {
  using C = typename Comp<TP>::type;
  const long long c1 = c0 + a.chunk;
  // the last tensor that starts at or before c0
  int lo = 0, hi = a.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.start[mid] <= c0) lo = mid;
    else hi = mid - 1;
  }
  for (int t = lo; t < a.count && a.start[t] < c1; ++t) {
    const long long s = a.start[t], n = a.n[t];
    const long long b0 = c0 > s ? c0 - s : 0;   // a multiple of N
    const long long b1 = c1 - s < n ? c1 - s : n;
    if (b0 >= b1) continue;  // the padding after a tensor
    const C lr = (C)a.lr[t], wd = (C)a.wd[t];
    const bool master = a.master[t] != nullptr;
    const bool ams = ADAM && a.vmax[t] != nullptr;
    long long tail = b0;
    if (a.vec[t]) {
      const long long vend = b1 - (b1 - b0) % N;
      for (long long j = b0 + (long long)threadIdx.x * N; j < vend;
           j += (long long)kThreads * N)
        update<TP, TM, N, ADAM>(a, t, j, master, ams, lr, wd, scale);
      tail = vend;
    }
    for (long long j = tail + threadIdx.x; j < b1; j += kThreads)
      update<TP, TM, 1, ADAM>(a, t, j, master, ams, lr, wd, scale);
  }
}

// each block takes the chunks blockIdx.x, blockIdx.x + gridDim.x, ...
template <typename TP, typename TM, int N, bool ADAM>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const __grid_constant__ ListArgs a) {
  using C = typename Comp<TP>::type;
  const C scale = a.scale ? (C)*a.scale : C(1);
  const long long end = a.start[a.count];
  for (long long c0 = (long long)blockIdx.x * a.chunk; c0 < end;
       c0 += (long long)gridDim.x * a.chunk)
    update_chunk<TP, TM, N, ADAM>(a, c0, scale);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TP, typename TM, bool ADAM>
int launch(ListArgs& a, cudaStream_t st) {
  constexpr int N = 16 / sizeof(TP);
  long long off = 0;
  for (int t = 0; t < a.count; ++t) {
    a.start[t] = off;
    off += (a.n[t] + N - 1) / N * N;
    a.vec[t] = aligned16(a.p[t]) && aligned16(a.g[t]) && aligned16(a.m[t]) &&
               aligned16(a.v[t]) && aligned16(a.vmax[t]) &&
               aligned16(a.master[t]);
  }
  a.start[a.count] = off;
  // the grid: as many blocks as fit the card at once, at most
  // kMaxBlocksPerSm an SM, each walking chunks of kChunk elements; a list
  // too small to give every block a chunk takes smaller chunks (multiples
  // of kMinChunk), so that its blocks do not each walk many tensors
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_update_kernel<TP, TM, N, ADAM>, kThreads, 0);
  const long long grid =
      (long long)sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  long long chunk = (off + grid - 1) / grid;
  chunk = (chunk + kMinChunk - 1) / kMinChunk * kMinChunk;
  a.chunk = chunk < kChunk ? chunk : kChunk;
  const long long chunks = (off + a.chunk - 1) / a.chunk;
  fused_update_kernel<TP, TM, N, ADAM>
      <<<(unsigned)(chunks < grid ? chunks : grid), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// the (TP, TM) pairs the optimizers make: moments in the parameter's type,
// or in f32 beside a 2-byte parameter (multi_precision)
template <bool ADAM>
int dispatch(ListArgs& a, int p_dtype, int m_dtype, cudaStream_t st) {
  if (p_dtype == kF32 && m_dtype == kF32)
    return launch<float, float, ADAM>(a, st);
  if (p_dtype == kBF16 && m_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, ADAM>(a, st);
  if (p_dtype == kBF16 && m_dtype == kF32)
    return launch<__nv_bfloat16, float, ADAM>(a, st);
  if (p_dtype == kF16 && m_dtype == kF16)
    return launch<__half, __half, ADAM>(a, st);
  if (p_dtype == kF16 && m_dtype == kF32)
    return launch<__half, float, ADAM>(a, st);
  if (p_dtype == kF64 && m_dtype == kF64)
    return launch<double, double, ADAM>(a, st);
  return (int)cudaErrorInvalidValue;
}

// the list's pointers and per-tensor values into `a`; false when the list
// does not fit one launch
bool fill(ListArgs& a, int count, void* const* p, const void* const* g,
          void* const* m, void* const* v, void* const* vmax,
          void* const* master, const long long* n, const double* lr,
          const double* wd) {
  if (count <= 0 || count > kMaxTensors) return false;
  a.count = count;
  for (int t = 0; t < count; ++t) {
    if (n[t] <= 0) return false;
    a.p[t] = p[t];
    a.g[t] = g[t];
    a.m[t] = m[t];
    a.v[t] = v ? v[t] : nullptr;
    a.vmax[t] = vmax ? vmax[t] : nullptr;
    a.master[t] = master ? static_cast<float*>(master[t]) : nullptr;
    a.n[t] = n[t];
    a.lr[t] = lr[t];
    a.wd[t] = wd[t];
  }
  return true;
}

}  // namespace

extern "C" int fused_adam(int count, void* const* p, const void* const* g,
                          void* const* m, void* const* v,
                          void* const* vmax, void* const* master,
                          const long long* n, const double* lr,
                          const double* wd, int p_dtype, int m_dtype,
                          int decoupled, int l1, double b1, double omb1,
                          double b2, double omb2, double bc1, double bc2,
                          double eps, const float* scale, void* stream) {
  ListArgs a;
  if (!fill(a, count, p, g, m, v, vmax, master, n, lr, wd))
    return (int)cudaErrorInvalidValue;
  a.b1 = b1;
  a.omb1 = omb1;
  a.b2 = b2;
  a.omb2 = omb2;
  a.bc1 = bc1;
  a.bc2 = bc2;
  a.eps = eps;
  a.scale = scale;
  a.decoupled = decoupled;
  a.l1 = l1;
  a.nesterov = 0;
  return dispatch<true>(a, p_dtype, m_dtype,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int fused_momentum(int count, void* const* p,
                              const void* const* g, void* const* vel,
                              void* const* master, const long long* n,
                              const double* lr, const double* wd,
                              int p_dtype, int m_dtype, int l1, int nesterov,
                              double mu, const float* scale, void* stream) {
  ListArgs a;
  if (!fill(a, count, p, g, vel, nullptr, nullptr, master, n, lr, wd))
    return (int)cudaErrorInvalidValue;
  a.b1 = mu;
  a.omb1 = a.b2 = a.omb2 = a.bc1 = a.bc2 = a.eps = 0.0;
  a.scale = scale;
  a.decoupled = 0;
  a.l1 = l1;
  a.nesterov = nesterov;
  return dispatch<false>(a, p_dtype, m_dtype,
                         static_cast<cudaStream_t>(stream));
}
