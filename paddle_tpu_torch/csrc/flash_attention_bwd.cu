// Flash-attention backward for Hopper (sm_90a), bf16 or f32 in and out,
// f32 accumulation: dQ in one kernel, dK and dV in another. Four entry
// points over two kernel bodies in each dtype (bf16: flash_attention_tc.cuh;
// f32: flash_attention_tiles.cuh):
//  * flash_attention_bwd_dq / flash_attention_bwd_dkv (K2), non-varlen;
//  * flash_attention_varlen_bwd_dq / flash_attention_varlen_bwd_dkv (K2v):
//    the same with per-batch kv lengths.
//
// Replaces: paddle_tpu/ops/pallas_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel`, reached through `_flash_backward_x32` from the
// `_flash` custom VJP's backward rule (K2) and, with `has_lens`, from
// `_flash_varlen`'s (K2v).
//
// Layout: q, o, dO [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], contiguous; lse
// and delta = rowsum(dO * O) f32 [B, Hq, Sq] (lse as the forward kernel
// writes it; delta computed by the caller, as the reference computes it
// outside its kernels); kv_lens int32 [B] (K2v). With P = exp(S * scale -
// lse) and scale = 1/sqrt(D):
//   dS = P * (dO V^T - delta);  dQ = dS K scale;  dV = P^T dO;
//   dK = dS^T (Q scale).
// Causal masking aligns the last query row with the last key column
// (col <= row + Sk - Sq), as the forward does; K2v masks key columns >=
// kv_lens[b]. Masked probabilities are zeroed, not exponentiated against
// a mask value: a row that sees no key (a sequence of length 0) has lse =
// -1e30 and would otherwise add garbage. The dQ kernel never loads a kv
// tile past the length; the dK/dV kernel writes zeros for kv rows past it
// without visiting any q tile.
//
// What bounds it on the H100: per (query row, visible key) pair the five
// products do 10*D flops on the bytes of Q, K, V, O, dO, dQ, dK, dV (7*S*D
// values per head) plus lse and delta; a causal head at S = 1024, D = 128
// does ~367 flops per byte in bf16, above the card's ridge (~295), so the
// tensor-core rate bounds it there and the memory below S ~ 800. `scale`
// is the softmax scale, 1/sqrt(D) of the head dim before any padding the
// caller added.
//
// The two accumulations go to two kernels that need no atomics. dK/dV: one
// block per kv tile, kv head and batch, looping over the q heads of its
// GQA group and the q tiles that can see the tile, so the group's sum
// stays in registers and repeats from run to run (the reference repeats
// K/V and lets the VJP of jnp.repeat sum; the result is the same). dQ: one
// block per q tile, q head and batch, looping over kv tiles. Tiles
// entirely above the causal diagonal are never visited; the heaviest
// causal tiles are launched first.
//
// Routing is static, by dtype and head dim, with no fallback:
//  * bf16 K2 and K2v at d <= 128 run the tensor-core bodies (flash_attention_tc.cuh),
//    both with two warpgroups of 64 rows and TMA loads through a 2-stage
//    ring one visited tile ahead of the math. dQ: 128 q rows per block, Q
//    and dO held, K and V tiles streamed on their own barriers; S, dP and
//    dQ += dS K on wgmma, dS passing from accumulator to A operand in
//    registers, lse and delta in registers. dK/dV: 128 kv rows per block,
//    K and V held, Q and dO (with lse and delta) streamed; S^T, dP^T, dV
//    and dK on wgmma. K2v reads its batch row's length in the mask policy:
//    dQ stops at the length, a dK/dV block past it visits no q tile and
//    writes zeros, and every visited tile masks per element (the
//    reference's force_masked=has_lens). They take D a multiple of 8 (the
//    caller pads), 16-byte-aligned inputs and an lse/delta row stride that
//    is a multiple of 4 floats; anything else returns cudaErrorInvalidValue;
//  * f32 K2 and K2v, and both dtypes at 128 < d <= 256, run the
//    CUDA-core bodies (flash_attention_tiles.cuh: plain f32 FMAs, S and
//    dP recomputed in both kernels; exact f32 like the reference's f32
//    dots), instantiated at DM 128 (f32, d <= 128) and DM 256 (d > 128;
//    dK/dV then stages each q tile as two 32-row halves to fit in shared
//    memory).
// Interior tiles of K2 skip the per-element mask; K2v masks every tile it
// visits. A call with no keys writes dQ = 0 and one with no queries dK =
// dV = 0 from the entry, without a body.
#include "flash_attention_tc.cuh"

namespace {

int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, const int* kv_lens,
           int b, int hq, int hkv, int sq, int sk, int d, int causal,
           int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || sq == 0) return 0;
  if (sk == 0)
    return zero_fill(dq, (size_t)b * hq * sq * d * (dtype == 1 ? 2 : 4), st);
  const LenCausalMask::Args margs{kv_lens, causal};
  if (dtype == 1 && d <= kSmallD)
    return launch_bwd_dq_tc<LenCausalMask>(q, k, v, dout, lse, delta, dq,
                                           margs, b, hq, hkv, sq, sk, d,
                                           scale, st);
  if (dtype == 1)
    return launch_bwd_dq<__nv_bfloat16, LenCausalMask, kLargeD>(
        q, k, v, dout, lse, delta, dq, margs, b, hq, hkv, sq, sk, d, scale,
        st);
  if (d <= kSmallD)
    return launch_bwd_dq<float, LenCausalMask, kSmallD>(
        q, k, v, dout, lse, delta, dq, margs, b, hq, hkv, sq, sk, d, scale,
        st);
  return launch_bwd_dq<float, LenCausalMask, kLargeD>(
      q, k, v, dout, lse, delta, dq, margs, b, hq, hkv, sq, sk, d, scale, st);
}

int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            const int* kv_lens, int b, int hq, int hkv, int sq, int sk,
            int d, int causal, int dtype, int ls_stride, float scale,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || sk == 0) return 0;
  if (sq == 0) {
    const size_t bytes = (size_t)b * hkv * sk * d * (dtype == 1 ? 2 : 4);
    const int err = zero_fill(dk, bytes, st);
    return err != 0 ? err : zero_fill(dv, bytes, st);
  }
  const LenCausalMask::Args margs{kv_lens, causal};
  if (dtype == 1 && d <= kSmallD)
    return launch_bwd_dkv_tc<LenCausalMask>(q, k, v, dout, lse, delta, dk,
                                            dv, margs, b, hq, hkv, sq, sk, d,
                                            ls_stride, scale, st);
  if (dtype == 1)
    return launch_bwd_dkv<__nv_bfloat16, LenCausalMask, kLargeD>(
        q, k, v, dout, lse, delta, dk, dv, margs, b, hq, hkv, sq, sk, d,
        scale, st);
  if (d <= kSmallD)
    return launch_bwd_dkv<float, LenCausalMask, kSmallD>(
        q, k, v, dout, lse, delta, dk, dv, margs, b, hq, hkv, sq, sk, d,
        scale, st);
  return launch_bwd_dkv<float, LenCausalMask, kLargeD>(
      q, k, v, dout, lse, delta, dk, dv, margs, b, hq, hkv, sq, sk, d, scale,
      st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError()
// (0 = ok); the caller has checked shapes, dtypes, contiguity and
// d <= 256. bf16 dK/dV (K2 and K2v) at d <= 128 reads lse and delta by
// TMA as rows `ls_stride` floats apart (a multiple of 4, >= Sq; the
// CUDA-core bodies take Sq).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int b, int hq, int hkv,
                                      int sq, int sk, int d, int causal,
                                      int dtype, float scale, void* stream) {
  return bwd_dq(q, k, v, dout, lse, delta, dq, nullptr, b, hq, hkv, sq, sk,
                d, causal, dtype, scale, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int b, int hq,
                                       int hkv, int sq, int sk, int d,
                                       int causal, int dtype, int ls_stride,
                                       float scale, void* stream) {
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv, nullptr, b, hq, hkv, sq,
                 sk, d, causal, dtype, ls_stride, scale, stream);
}

// K2v: kv_lens int32 [B] on the device.
extern "C" int flash_attention_varlen_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* kv_lens, int b,
    int hq, int hkv, int sq, int sk, int d, int causal, int dtype,
    float scale, void* stream) {
  return bwd_dq(q, k, v, dout, lse, delta, dq,
                static_cast<const int*>(kv_lens), b, hq, hkv, sq, sk, d,
                causal, dtype, scale, stream);
}

extern "C" int flash_attention_varlen_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* kv_lens, int b, int hq, int hkv, int sq, int sk, int d,
    int causal, int dtype, int ls_stride, float scale, void* stream) {
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv,
                 static_cast<const int*>(kv_lens), b, hq, hkv, sq, sk, d,
                 causal, dtype, ls_stride, scale, stream);
}
