#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (H100): the port's main
path, end to end, through its hand-written kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. environment: the card's name and power limit;
  2. build: every CUDA kernel of the port, from the sources in the
     checkout (nvcc, sm_90a, one process per source, in parallel), and
     beside them a yardstick library of the CUDA-core bodies bf16 K9's
     forward and dK/dV ran before they moved onto the tensor cores
     (REPLACED_K9_SRC); then the tensor-core kernels' registers and
     spills from ptxas (K1/K2's and K9's; none may spill);
  3. kernels: each kernel at the main path's shapes (bf16; the int4
     dequant-matmul also at the f32 lm_head shape; the fused norm, rotary
     and SwiGLU kernels at the train step's shapes and dtypes, and at a
     ragged f32 size; the LayerNorm kinds of the fused norm (K3-LN) and
     dropout + add (K6) at the GPT and BERT steps' shapes, and the flash
     kernels at their head_dim 64), held against its plain PyTorch
     version on the same
     inputs, and timed (CUDA events, median of 30 after warm-up, device
     time only) beside the plain version, one PyTorch library call as a
     yardstick where one computes the same function, and the card's bound
     for the work; K1 (also at TRAIN's shape) and K2 dQ and dK/dV
     beside the same call through the varlen entry with every kv length
     = S (`varlen_full_ms`: K1v's and K2v's forced per-element masks, on
     the same tensor-core bodies). The quantized
     paged-decode kernels read caches written by the port's own
     int8/int4 prefill scatters. Beyond the main paths' shapes: K1 and
     K2 at head dim 256 (B1 H16 S1024 causal, the CUDA-core bodies), K7
     and K7q-int8 at GQA group 3 (48 query heads over 16) and at head
     dim 256, and K3 RMS at 4096 x 16384 (the backward's wide path);
  4. serve: LLaMA at the 1B geometry (hidden 2048, 20 layers, 16 heads,
     vocab 32000, bf16, random weights from seed 0) behind the paged
     ServingEngine (8 slots, 16-token blocks) answers 16 greedy requests;
     both kernels' launch counts must equal prefills x 20 and decode ticks
     x 20, and two requests' tokens are checked against a teacher-forced
     recompute through the plain attention functions;
  5. profile: device time of steady decode ticks by kernel kind, beside
     the host wall (torch.profiler);
  6. serve_q4: the same 16 requests with int4 weights and an int4 KV
     cache: every layer matmul and the lm_head through the dequant-matmul
     kernel ((prefills + ticks) x 141 launches), decode through the int4
     paged-decode kernel (ticks x 20), none through the model-dtype one;
     then serve_q8: 8 of them with int8 weights (plain torch: no
     dequant-matmul launch) and an int8 KV cache (ticks x 20 int8
     paged-decode launches). Two requests of each are replayed teacher-
     forced through the same step functions, one slot, with the plain
     versions of every kernel passed explicitly;
  7. profile_q4: phase 5 for the int4 engine;
  8. train: LLaMA at the 1B geometry (bf16 O2 via amp.decorate with bf16
     AdamW moments, AdamW lr 1e-4, random weights from seed 0) takes
     training steps on one batch of 4 x 1024 seeded ids, labels = ids,
     with FLAGS_pallas_fused_ops at its default (True). First one step's
     gradients through the kernels (K1 forward, K2 backward, the fused
     RMSNorm K3, rotary K4 and SwiGLU K5 both ways) are held against the
     same step through the plain compositions and the plain attention
     (`_layer_forward_prefill`, autograd of `flash_attention_reference`);
     then 6 steps, counted: K1 and both K2 kernels launch steps x 20
     times, K3 steps x 41 each way, K4 steps x 40, K5 steps x 20 each
     way; the losses are finite and fall;
  9. profile_train: one steady training step under torch.profiler, device
     time by kernel kind beside the host wall;
 10. train_unfused: the same model and batch with the flag False (the
     plain compositions; no K3-K5 launch), then the fused step again, so
     ms per step and peak memory of both come from one card in one run;
     no LLaMA phase launches K3-LN or K6;
 11. train_gpt: GPT-3 medium (vocab 50304, hidden 1024, 24 layers, 16
     heads; bf16 O2, AdamW lr 1e-4) on 4 x 1024 seeded ids, labels = ids:
     one step's gradients through the kernels held against the same step
     with no kernel of the path (the flag off, autograd of the plain
     attention), 6 counted steps with exact launches (K1 and both K2
     kernels 24 per step, K3-LN 49 each way, nothing else), one
     profiled step;
 12. train_bert: BERT-base sequence classification (vocab 30522, hidden
     768, 12 layers, dropout 0.1; bf16 O2, AdamW lr 2e-5) on 64 x 128
     seeded ids with binary labels: the same checks, with the dropout
     masks drawn alike on both sides, and exact launches (K1 and both K2
     kernels 12 per step, K3-LN 25 and K6 24 each way). No phase before
     this point launches a varlen (K1v/K2v) or FlashMask (K9) kernel;
 13. kernels of the last slice: K1v and K2v at the VARLEN batch, K9 at the
     FLASHMASK window and at S 4100 with random start rows, each against
     its plain version and timed as in phase 3, SDPA with the equivalent
     boolean mask as the yardstick, and K9's forward and dK/dV beside
     the bodies they replaced on the same inputs (`replaced_ms`);
 14. varlen: `flash_attn_unpadded` on 16 packed causal sequences of
     64..2048 tokens (np.random.RandomState(0); bucket 2048), LLaMA-1B's
     heads (16 x 128, bf16), forward and backward with loss = sum(out^2):
     gradients held against the plain versions, exactly one K1v and one
     of each K2v kernel and no K1/K2; `flash_attn_varlen_qkvpacked` and
     `memory_efficient_attention(cu_seqlens=...)` once each;
 15. flashmask: `flashmask_attention` as bench.py
     `bench_flashmask_longctx` drives it (B 1, S 8192, H 16, D 128, bf16,
     causal, a 1024-token window), forward and backward: the same checks
     with exactly one launch of each K9 kernel, then its time beside
     the same op with no window (every start row = S: causal, the same
     K9 body), which it must halve, and beside causal flash (K1 + K2) at
     the same shape.

The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}. Without a CUDA card it exits 1 and prints
no result.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core
#: rate, f32 rate outside the tensor cores, and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: the spin before each timed window: ~2 ms at the H100's ~2 GHz clock,
#: longer than any timed function takes to enqueue its kernels
SPIN_CYCLES = 4_000_000
#: kernel vs plain, both from the same bf16 inputs, compared in f32: the
#: kernel rounds its output to bf16 (2^-8 relative) where the plain
#: version rounds after an f32 softmax in another summation order
KERNEL_TOL = 2e-2
#: teacher-forced check: a generated token that is not the recompute's
#: argmax must lie within this many logits of it. Both sides run the
#: model in bf16 (residual stream, weights, matmul outputs) but reach the
#: logits by different paths (paged decode vs one full-sequence pass);
#: their logits differ by a few bf16 ulps of the ~1-magnitude hidden
#: state times ~0.6 logit scale over 20 layers — 0.1 bounds that with room
TIE_BOUND = 0.1
#: K2 (flash backward) vs its plain version, from the same bf16 inputs,
#: relative to each output's largest |value|: both sides accumulate dQ,
#: dK and dV in f32 from the same inputs and round each once to bf16, so
#: they differ by at most one bf16 ulp (2^-7 of a value's binade)
K2_TOL = 2 ** -7
#: TRAIN's gradient check: one step's bf16 gradients through K1/K2 vs the
#: same step through the plain attention (autograd of its plain forward),
#: per tensor, relative to its largest |value|. The two paths round
#: attention's gradients to bf16 at different points (the kernels once
#: from f32 sums over P recomputed from the lse, autograd after each op),
#: so they differ by about one bf16 ulp (2^-8 relative) per attention
#: call, and the difference passes on through the rest of the backward.
#: A CPU rehearsal of this check (3 layers, hidden 64, the plain versions
#: on both sides) gave 0.68%, 1.7 ulps. Adding as a random walk over 20
#: layers: sqrt(20 / 3) x 1.7 = 4.4 ulps; 16 ulps (2^-4) leaves room for
#: the largest of ~180 tensors. A kernel that drops a tile or mis-scales
#: a product moves gradients by far more; the kernel phase holds K2 itself
#: to one ulp (K2_TOL)
GRAD_TOL = 2 ** -4
#: the training phase: batch x sequence of seeded ids, counted steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6

#: the quantized serves' teacher-forced replays. Both sides use the same
#: quantized weights (identical packed bytes); they differ, as above, by
#: f32 summation order inside the kernels, rounded to bf16 (one ulp,
#: 2^-7 of a value's binade), and by what the quantized KV cache does
#: with such a difference: every append re-rounds its whole block, so an
#: element one bf16 ulp away can land on the other side of a rounding
#: boundary and store the neighbouring code. A code step is 1/127 of the
#: block's largest |value| for int8 — about one bf16 ulp of that value,
#: so int8 stays within SERVE's 0.1 — and 1/7 for int4, about 18 ulps.
#: A flip is then ~18x rarer (the ulp must straddle a boundary 18x
#: further apart) and 18x larger, so the summed square of the cache
#: perturbation grows ~18x and its rms ~sqrt(18) = 4.2x: 0.1 x 4.2 = 0.42,
#: rounded up to 0.5 for int4. The agreement floor drops with it: in the
#: bf16 SERVE check 2.8% of the tokens sat within 0.0117 of a tie (H100);
#: a ~4x wider tie band can cover ~11%, so at least 80% must be the
#: replay's argmax (a wrong kernel agrees on almost none).
TIE_BOUND_Q = {"int8": 0.1, "int4": 0.5}
AGREE_MIN_Q = {"int8": 0.9, "int4": 0.8}
#: kernel vs plain for the int4 dequant-matmul, relative to the largest
#: output (outputs grow with sqrt(K)): both sides accumulate in f32 and
#: round once, so bf16 outputs differ by at most one rounding each
#: (2^-8), f32 ones by the summation order
QMM_TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}
#: K7q vs its plain version: as KERNEL_TOL, plus the plain version rounds
#: the dequantized cache to bf16 before the softmax (the reference's XLA
#: composition does), the kernel keeps it in f32
KERNEL_TOL_Q = 3e-2

#: the fused norm, rotary and SwiGLU kernels (K3-K5) vs their plain
#: versions from the same inputs, relative to each output's largest
#: |value|: both compute in f32 and round each output once, so an f32
#: output differs by f32 rounding (1e-5), dw, a sum over 4096 rows taken
#: in another order, by more (1e-4), and a bf16 output by at most one
#: bf16 ulp (2^-7)
FUSED_TOL = {"float32": 1e-5, "dw_float32": 1e-4, "bfloat16": 2 ** -7}
#: the fused kernels' launch counters (none may launch while serving)
FUSED_KERNELS = ("fused_rms_norm_fwd", "fused_rms_norm_bwd", "rope_qk",
                 "swiglu_fwd", "swiglu_bwd")
#: TRAIN_UNFUSED's counted steps (and again for the fused step after it)
UNFUSED_STEPS = 4

#: the GPT and BERT paths' kernels, which no LLaMA phase may launch
LN_DROPOUT_KERNELS = ("fused_layer_norm_fwd", "fused_layer_norm_bwd",
                      "dropout_add_fwd", "dropout_add_bwd")
#: GPT-3 medium as bench.py `bench_gpt_medium_sharding` builds it
#: (GPTConfig's defaults, positions cut to the sequence), and its batch;
#: BERT-base (BertConfig's defaults) as `bench_bert(amp=True)` fine-tunes
#: it, and its batch
CFG_GPT = dict(vocab_size=50304, hidden_size=1024, num_hidden_layers=24,
               num_attention_heads=16, max_position_embeddings=1024)
GPT_BATCH, GPT_SEQ = 4, 1024
BERT_BATCH, BERT_SEQ = 64, 128

CFG_1B = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
              num_hidden_layers=20, num_attention_heads=16,
              max_position_embeddings=1024)


#: which body a flash-family kernel runs at bf16 (the summary's "body"):
#: the wgmma/TMA bodies of csrc/flash_attention_tc.cuh, or the f32-FMA
#: bodies of csrc/flash_attention_tiles.cuh
TC_BODY, CORE_BODY = "tensor cores", "cuda cores"


def _say(tag, obj):
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _time_ms(fn, flush=None, reps=30, warmup=5):
    """Median device time of fn() over `reps` launches (CUDA events).
    `flush` runs before each timed launch, outside the timed window. A
    spin kernel queued just before the window keeps the card busy while
    the host enqueues fn's kernels, so the host time of a wrapper (checks,
    allocation, the ctypes call) never shows up as device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def _nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _full_lens(b, s):
    """kv_lens = S for every batch row: the varlen entries then do K1's and
    K2's work on the same tensor-core bodies with every visited tile
    masked per element (`varlen_full_ms`)."""
    import torch

    return torch.full((b,), s, dtype=torch.int32, device="cuda")


def flash_case(b, hq, hkv, s, d=128, causal=True):
    """Flash forward at one prefill or train shape: parity, times, bound,
    and the time of the same call through the varlen entry with every
    length = S (`varlen_full_ms`: K1v's forced masks on the same body)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash_attention import (
        _tensor_core_route, flash_attention_fwd, flash_attention_reference)

    g = torch.Generator(device="cuda").manual_seed(s)
    q = torch.randn(b, hq, s, d, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    k = torch.randn(b, hkv, s, d, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    v = torch.randn(b, hkv, s, d, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert err < KERNEL_TOL and lse_err < 1e-3, (err, lse_err)
    pairs = s * (s + 1) // 2 if causal else s * s   # (row, col) pairs
    flops = 4 * b * hq * d * pairs
    full = _full_lens(b, s)
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) + 4 * b * hq * s
    bound, by = _bound_ms(flops, nbytes)
    body = TC_BODY if _tensor_core_route("flash_attention_fwd", q.dtype,
                                         False, d) else CORE_BODY
    rec = {"name": "flash_attention_fwd", "shape": [b, hq, hkv, s, d],
           "causal": causal, "body": body, "max_abs_err": err,
           "lse_max_abs_err": lse_err,
           "ms": _time_ms(lambda: flash_attention_fwd(q, k, v, causal)),
           "varlen_full_ms": _time_ms(lambda: flash_attention_fwd(
               q, k, v, causal, full)),
           "plain_ms": _time_ms(
               lambda: flash_attention_reference(q, k, v, causal)),
           "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=causal, enable_gqa=hq != hkv)),
           "bound_ms": bound, "bound_by": by}
    _say("KERNEL", rec)
    return rec


def _rel_errs(got, want):
    """(largest |got - want|, each output's error over its largest
    |value|) for tuples of tensors; every output must be finite."""
    import torch

    errs, rels = [], []
    for a, w in zip(got, want):
        assert torch.isfinite(a.float()).all(), a.shape
        err = (a.float() - w.float()).abs().max().item()
        errs.append(err)
        rels.append(err / w.float().abs().max().item())
    return max(errs), rels


def _bwd_records(rec, cases, args, reads, pairs, d, library,
                 varlen_full=()):
    """Hold each backward kernel of `cases` ((key, launch, plain, wrt,
    products, writes)) against its plain version on `args` (one bf16 ulp
    of each output's largest |value|), time both, and add its record under
    `key` in `rec`, beside `library(wrt)`, the bound of its products over
    `pairs` and its bytes (`reads` + writes), and `varlen_full[key]()`'s
    time (`varlen_full_ms`) where `varlen_full` has the key."""
    for key, launch, plain, wrt, products, writes in cases:
        got, want = launch(*args), plain(*args)
        got, want = (got, want) if key == "dkv" else ((got,), (want,))
        err, rels = _rel_errs(got, want)
        assert max(rels) <= K2_TOL, (key, rels)
        bound, by = _bound_ms(products * 2 * pairs * d, reads + writes)
        rec[key] = {
            "max_abs_err": err, "rel_err": rels,
            "ms": _time_ms(lambda: launch(*args)),
            "plain_ms": _time_ms(lambda: plain(*args)),
            "library_ms": _time_ms(lambda: library(wrt)),
            "bound_ms": bound, "bound_by": by}
        if key in varlen_full:
            rec[key]["varlen_full_ms"] = _time_ms(varlen_full[key])


def flash_bwd_case(b, hq, hkv, s, d=128, causal=True):
    """Flash backward (K2) at one training shape, from the same bf16
    inputs (o and lse from K1, delta = rowsum(dO * O) as the wrapper
    computes it). Each kernel ("dq", "dkv") is held against its own plain
    version and timed beside it, beside SDPA's backward asked for the same
    gradients (its forward untimed), and beside its own bound: the
    products it does (dQ: QK^T, dO V^T, dS K; dK/dV: those two, P^T dO and
    dS^T Q) and the bytes it moves. "whole" is the wrapper (delta, then
    both kernels) against the plain backward and SDPA's full backward,
    with the bound of the five products the backward needs. Each
    kernel's record also times the same call through its varlen entry with
    every length = S (`varlen_full_ms`: K2v's forced masks on the same
    tensor-core body)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash_attention import (
        _bwd_delta, _launch_bwd_dkv, _launch_bwd_dq, flash_attention_bwd,
        flash_attention_bwd_dkv_reference, flash_attention_bwd_dq_reference,
        flash_attention_bwd_reference, flash_attention_fwd)

    g = torch.Generator(device="cuda").manual_seed(100 + s)
    q, do = (torch.randn(b, hq, s, d, device="cuda", generator=g,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, device="cuda", generator=g,
                        dtype=torch.bfloat16) for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    delta = _bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, causal)
    full = _full_lens(b, s)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                         enable_gqa=hq != hkv)
    pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
    q_bytes, kv_bytes = 2 * b * hq * s * d, 2 * b * hkv * s * d   # bf16
    # every kernel reads q, dO, k, v (bf16) and lse, delta (f32)
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * b * hq * s
    rec = {"name": "flash_attention_bwd", "shape": [b, hq, hkv, s, d],
           "causal": causal, "tol": K2_TOL,
           "body": TC_BODY if d <= 128 else CORE_BODY}
    _bwd_records(
        rec, (("dq", _launch_bwd_dq, flash_attention_bwd_dq_reference,
               (ql,), 3, q_bytes),
              ("dkv", _launch_bwd_dkv, flash_attention_bwd_dkv_reference,
               (kl, vl), 4, 2 * kv_bytes)),
        args, reads, pairs, d,
        lambda wrt: torch.autograd.grad(out, wrt, do, retain_graph=True),
        {"dq": lambda: _launch_bwd_dq(*args, full),
         "dkv": lambda: _launch_bwd_dkv(*args, full)})
    # the wrapper, which the train step runs: also reads o
    err, rels = _rel_errs(flash_attention_bwd(q, k, v, o, lse, do, causal),
                          flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                        causal))
    assert max(rels) <= K2_TOL, ("whole", rels)
    bound, by = _bound_ms(5 * 2 * pairs * d,
                          reads + q_bytes + q_bytes + 2 * kv_bytes)
    rec["whole"] = {
        "max_abs_err": err, "rel_err": rels,
        "ms": _time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal)),
        "plain_ms": _time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal)),
        "library_ms": _time_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True)),
        "bound_ms": bound, "bound_by": by}
    _say("KERNEL", rec)
    return rec


def decode_case(seqs=8, heads=16, d=128, bs=16, max_len=1024, kv_heads=None,
                tag="serve"):
    """Paged decode at the serving shape: 8 sequences, ragged lengths up
    to the context, tables shuffled over the whole pool, `heads` query
    heads over `kv_heads` cache heads (default: as many). The L2 cache is
    flushed before each timed launch: in serving, one layer's pool slice
    is evicted by the other 19 layers between two of its decode calls."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.paged_decode import (
        paged_decode_attention, paged_decode_attention_reference)

    kv_heads = heads if kv_heads is None else kv_heads
    rs = np.random.RandomState(0)
    pages = max_len // bs
    blocks = 1 + seqs * pages
    g = torch.Generator(device="cuda").manual_seed(1)
    kc = torch.randn(blocks, kv_heads, bs, d, device="cuda", generator=g,
                     dtype=torch.bfloat16)
    vc = torch.randn_like(kc)
    q = torch.randn(seqs, heads, d, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    lens_np = rs.randint(1, max_len + 1, (seqs,)).astype("int32")
    tables_np = (1 + rs.permutation(seqs * pages)).reshape(
        seqs, pages).astype("int32")
    tables = torch.from_numpy(tables_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    out = paged_decode_attention(q, kc, vc, tables, lens)
    ref = paged_decode_attention_reference(q, kc, vc, tables, lens)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all()
    assert err < KERNEL_TOL, err
    # SDPA yardstick over the pages gathered beforehand (the gather is
    # not timed): dense [S, H, T, D] K/V plus a length mask
    t = pages * bs
    kd = kc[tables.long()].permute(0, 2, 1, 3, 4).reshape(seqs, kv_heads, t,
                                                          d)
    vd = vc[tables.long()].permute(0, 2, 1, 3, 4).reshape(seqs, kv_heads, t,
                                                          d)
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    tokens = int(lens_np.sum())
    flops = 4 * tokens * heads * d
    pages_read = int(np.ceil(lens_np / bs).sum())   # table entries used
    nbytes = 2 * (2 * tokens * kv_heads * d + 2 * seqs * heads * d) \
        + 4 * (pages_read + seqs)
    bound, by = _bound_ms(flops, nbytes)
    rec = {"name": "paged_decode_attention", "case": tag,
           "shape": [seqs, heads, kv_heads, d, bs, pages],
           "lens": lens_np.tolist(), "max_abs_err": err,
           "ms": _time_ms(lambda: paged_decode_attention(
               q, kc, vc, tables, lens), flush),
           "plain_ms": _time_ms(lambda: paged_decode_attention_reference(
               q, kc, vc, tables, lens), flush),
           "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
               q[:, :, None], kd, vd, attn_mask=mask,
               enable_gqa=heads != kv_heads), flush),
           "bound_ms": bound, "bound_by": by}
    _say("KERNEL", rec)
    return rec


def qmm_case(m, k, n, dtype="bfloat16"):
    """The int4 dequant-matmul at one [m, k] @ [k, n] shape of the serve:
    parity, times, bound. The L2 cache is flushed before each timed launch:
    in serving a layer's weight is evicted by the other layers' weights
    between two of its calls."""
    import torch
    from paddle_tpu_torch.ops.quantized import (
        dequant_int4, quant_matmul_raw, quant_matmul_reference, quantize_int4)

    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(m * 7 + k + n)
    x = torch.randn(m, k, device="cuda", generator=g, dtype=tdt)
    w = torch.randn(k, n, device="cuda", generator=g,
                    dtype=torch.bfloat16) * 0.02
    packed, scale = quantize_int4(w)
    out = quant_matmul_raw(x, packed, scale, k)
    ref = quant_matmul_reference(x, packed, scale, k)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    assert torch.isfinite(out.float()).all()
    assert rel <= QMM_TOL[dtype], (m, k, n, dtype, rel)
    w_deq = dequant_int4(packed, scale, k, tdt)       # yardstick's weight
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    size = 2 if dtype == "bfloat16" else 4
    nbytes = k // 2 * n + 4 * n + m * k * size + m * n * size
    bound, by = _bound_ms(2 * m * k * n, nbytes,
                          PEAK_BF16_FLOPS if dtype == "bfloat16"
                          else PEAK_F32_FLOPS)
    rec = {"name": "quant_matmul", "shape": [m, k, n], "dtype": dtype,
           "max_abs_err": err, "rel_err": rel, "tol": QMM_TOL[dtype],
           "ms": _time_ms(lambda: quant_matmul_raw(x, packed, scale, k),
                          flush),
           "plain_ms": _time_ms(
               lambda: quant_matmul_reference(x, packed, scale, k), flush),
           "library_ms": _time_ms(lambda: torch.matmul(x, w_deq), flush),
           "bound_ms": bound, "bound_by": by}
    _say("KERNEL", rec)
    return rec


def quant_decode_case(fmt, seqs=8, heads=16, d=128, bs=16, max_len=1024,
                      kv_heads=None, tag="serve"):
    """The int8 or int4 paged decode at decode_case's shapes (same lengths
    and tables), over caches written by the port's own prefill scatter —
    so the per-block scales are the ones serving makes."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.paged_decode import (
        KERNEL_NAMES, paged_decode_attention,
        paged_decode_attention_reference)
    from paddle_tpu_torch.ops.quantized import int4_unpack
    from paddle_tpu_torch.text import paged_cache

    kv_heads = heads if kv_heads is None else kv_heads
    rs = np.random.RandomState(0)
    pages = max_len // bs
    blocks = 1 + seqs * pages
    lens_np = rs.randint(1, max_len + 1, (seqs,)).astype("int32")
    tables_np = (1 + rs.permutation(seqs * pages)).reshape(
        seqs, pages).astype("int32")
    tables = torch.from_numpy(tables_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    cache = paged_cache.PagedKVCache(1, blocks, kv_heads, bs, d, fmt, "cuda")
    scatter = getattr(paged_cache, f"scatter_prefill_{fmt}")
    g = torch.Generator(device="cuda").manual_seed(2)
    for i in range(seqs):
        for c, sc in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
            kv = torch.randn(1, max_len, kv_heads, d, device="cuda",
                             generator=g, dtype=torch.bfloat16)
            scatter(c, sc, kv, int(lens_np[i]), tables[i], bs)
    q = torch.randn(seqs, heads, d, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    int4 = fmt == "int4"
    args = (q, cache.k[0], cache.v[0], tables, lens, cache.k_scale[0],
            cache.v_scale[0])
    out = paged_decode_attention(*args, kv_int4=int4)
    ref = paged_decode_attention_reference(*args, kv_int4=int4)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all()
    assert err < KERNEL_TOL_Q, (fmt, err)
    # SDPA yardstick over pages gathered and dequantized beforehand (not
    # timed): dense bf16 [S, H, T, D] K/V plus a length mask
    t = pages * bs

    def dense(c, sc):
        x = c[0][tables.long()]                  # [S, P, H, rows, D]
        if int4:
            x = int4_unpack(x, bs, axis=-2)
        x = (x.float() * sc[0][tables.long()][:, :, None, None, None])
        return x.to(torch.bfloat16).permute(0, 2, 1, 3, 4).reshape(
            seqs, kv_heads, t, d)

    kd, vd = dense(cache.k, cache.k_scale), dense(cache.v, cache.v_scale)
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    tokens = int(lens_np.sum())
    pages_read = int(np.ceil(lens_np / bs).sum())   # table entries used
    elem = 0.5 if int4 else 1.0
    nbytes = 2 * tokens * kv_heads * d * elem + 2 * (2 * seqs * heads * d) \
        + 4 * (pages_read + seqs) + 2 * 4 * pages_read       # + scales
    bound, by = _bound_ms(4 * tokens * heads * d, nbytes)
    rec = {"name": KERNEL_NAMES[fmt], "case": tag,
           "shape": [seqs, heads, kv_heads, d, bs, pages],
           "lens": lens_np.tolist(), "max_abs_err": err,
           "tol": KERNEL_TOL_Q,
           "ms": _time_ms(lambda: paged_decode_attention(
               *args, kv_int4=int4), flush),
           "plain_ms": _time_ms(lambda: paged_decode_attention_reference(
               *args, kv_int4=int4), flush),
           "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
               q[:, :, None], kd, vd, attn_mask=mask,
               enable_gqa=heads != kv_heads), flush),
           "bound_ms": bound, "bound_by": by}
    _say("KERNEL", rec)
    return rec


def _fused_record(name, case, shape, got, want, sums, fn, plain,
                  library, nbytes, flops):
    """Hold one fused kernel's outputs `got` against its plain version's
    `want` (FUSED_TOL by output dtype; the outputs at indices `sums` are
    sums over rows, dw or db), time
    the kernel, its plain version and `library` (None: no single PyTorch
    call computes the function) with the L2 flushed before each launch
    (at these shapes the inputs come from earlier kernels of the step and
    exceed the 50 MB L2 together), print the KERNEL line and return it."""
    import torch

    errs, rels = [], []
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype and a.shape == w.shape, (name, case, i)
        assert torch.isfinite(a.float()).all(), (name, case, i)
        err = (a.float() - w.float()).abs().max().item()
        rel = err / w.float().abs().max().item()
        key = str(a.dtype).replace("torch.", "")
        tol = FUSED_TOL["dw_" + key if i in sums
                        and key == "float32" else key]
        assert rel <= tol, (name, case, i, rel, tol)
        errs.append(err)
        rels.append(rel)
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    bound, by = _bound_ms(flops, nbytes, PEAK_F32_FLOPS)
    rec = {"name": name, "case": case, "shape": list(shape),
           "max_abs_err": max(errs), "rel_err": rels,
           "ms": _time_ms(fn, flush), "plain_ms": _time_ms(plain, flush),
           "library_ms": None if library is None
           else _time_ms(library, flush),
           "bound_ms": bound, "bound_by": by}
    _say("KERNEL", rec)
    return rec


def fused_norm_cases(rows, h, tag, x_dtype="bfloat16", y_dtype="float32"):
    """K3 forward and backward at [rows, h]: the plain norm (x_dtype in,
    y_dtype out: the train step's input and final norms read the bf16
    stream and write f32) and the add variant (x_dtype in and out: the
    post-attention norm). The library yardstick is F.rms_norm on f32
    copies of the inputs (made outside the timing), and autograd through
    it for the backward; nothing in PyTorch computes the add variant in
    one call. Returns {case: record}."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_norm import (
        fused_rms_norm_bwd, fused_rms_norm_fwd, rms_norm_bwd_reference,
        rms_norm_fwd_reference)

    xdt, ydt = getattr(torch, x_dtype), getattr(torch, y_dtype)
    xb, yb = torch.finfo(xdt).bits // 8, torch.finfo(ydt).bits // 8
    g = torch.Generator(device="cuda").manual_seed(rows + h)
    x, res, ds = (torch.randn(rows, h, device="cuda", generator=g,
                              dtype=xdt) for _ in range(3))
    w = torch.randn(h, device="cuda", generator=g, dtype=xdt)
    dy = torch.randn(rows, h, device="cuda", generator=g, dtype=ydt)
    dya = dy.to(xdt)
    eps, n = 1e-6, rows * h
    out = {}
    # forward, plain norm: read x, w; write y, rstd
    got = fused_rms_norm_fwd(x, None, w, eps, ydt)
    want = rms_norm_fwd_reference(x, None, w, eps, ydt)
    xf, wf = x.float(), w.float()
    out["fwd"] = _fused_record(
        "fused_rms_norm_fwd", f"{tag} rms {x_dtype}->{y_dtype}", (rows, h),
        (got[0], got[2]), (want[0], want[2]), (),
        lambda: fused_rms_norm_fwd(x, None, w, eps, ydt),
        lambda: rms_norm_fwd_reference(x, None, w, eps, ydt),
        lambda: F.rms_norm(xf, (h,), wf, eps),
        xb * n + xb * h + yb * n + 4 * rows, 4 * n)
    rstd = got[2]
    # forward, add variant: read x, res, w; write y, s, rstd
    got = fused_rms_norm_fwd(x, res, w, eps)
    want = rms_norm_fwd_reference(x, res, w, eps)
    out["fwd_add"] = _fused_record(
        "fused_rms_norm_fwd", f"{tag} add+rms {x_dtype}", (rows, h), got,
        want, (), lambda: fused_rms_norm_fwd(x, res, w, eps),
        lambda: rms_norm_fwd_reference(x, res, w, eps), None,
        2 * xb * n + xb * h + 2 * xb * n + 4 * rows, 5 * n)
    s_add, rstd_add = got[1], got[2]
    # backward, plain norm: read s (= x), dy, w, rstd; write dx, dw
    xl = xf.clone().requires_grad_()
    wl = wf.clone().requires_grad_()
    yl = F.rms_norm(xl, (h,), wl, eps)
    dyf = dy.float()
    out["bwd"] = _fused_record(
        "fused_rms_norm_bwd", f"{tag} rms {x_dtype}<-{y_dtype}", (rows, h),
        fused_rms_norm_bwd(x, w, rstd, dy),
        rms_norm_bwd_reference(x, w, rstd, dy), (1,),
        lambda: fused_rms_norm_bwd(x, w, rstd, dy),
        lambda: rms_norm_bwd_reference(x, w, rstd, dy),
        lambda: torch.autograd.grad(yl, (xl, wl), dyf, retain_graph=True),
        xb * n + yb * n + xb * h + 4 * rows + xb * n + xb * h, 8 * n)
    # backward, add variant: read s, dy, ds, w, rstd; write dsum, dw
    out["bwd_add"] = _fused_record(
        "fused_rms_norm_bwd", f"{tag} add+rms {x_dtype}", (rows, h),
        fused_rms_norm_bwd(s_add, w, rstd_add, dya, ds),
        rms_norm_bwd_reference(s_add, w, rstd_add, dya, ds), (1,),
        lambda: fused_rms_norm_bwd(s_add, w, rstd_add, dya, ds),
        lambda: rms_norm_bwd_reference(s_add, w, rstd_add, dya, ds), None,
        3 * xb * n + xb * h + 4 * rows + xb * n + xb * h, 9 * n)
    return out


def rope_cases(b, s, heads, d, tag, dtype="bfloat16"):
    """K4 at q, k [b, s, heads, d] with random [s, d] tables (the
    backward reads the partner index's sin), both directions. Nothing in
    PyTorch rotates in one call. Returns {"fwd": ..., "bwd": ...}."""
    import torch
    from paddle_tpu_torch.ops.fused_norm import rope_qk, rope_qk_reference

    dt = getattr(torch, dtype)
    eb = torch.finfo(dt).bits // 8
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q, k = (torch.randn(b, s, heads, d, device="cuda", generator=gen,
                        dtype=dt) for _ in range(2))
    cos, sin = (torch.randn(s, d, device="cuda", generator=gen, dtype=dt)
                for _ in range(2))
    n = b * s * heads * d
    out = {}
    for key, bwd in (("fwd", False), ("bwd", True)):
        out[key] = _fused_record(
            "rope_qk", f"{tag} {key} {dtype}", (b, s, heads, d),
            rope_qk(q, k, cos, sin, bwd),
            rope_qk_reference(q, k, cos, sin, bwd), (),
            lambda bwd=bwd: rope_qk(q, k, cos, sin, bwd),
            lambda bwd=bwd: rope_qk_reference(q, k, cos, sin, bwd), None,
            4 * eb * n + 2 * eb * s * d, 2 * 3 * n)
    return out


def swiglu_cases(rows, cols, tag, dtype="bfloat16"):
    """K5 forward and backward at [rows, cols]. Nothing in PyTorch
    computes silu(g) * u (or its two gradients) in one call. Returns
    {"fwd": ..., "bwd": ...}."""
    import torch
    from paddle_tpu_torch.ops.fused_norm import (
        swiglu_bwd, swiglu_bwd_reference, swiglu_fwd, swiglu_fwd_reference)

    dt = getattr(torch, dtype)
    eb = torch.finfo(dt).bits // 8
    gen = torch.Generator(device="cuda").manual_seed(rows + cols)
    g, u, do = (torch.randn(rows, cols, device="cuda", generator=gen,
                            dtype=dt) for _ in range(3))
    n = rows * cols
    return {
        "fwd": _fused_record(
            "swiglu_fwd", f"{tag} {dtype}", (rows, cols),
            (swiglu_fwd(g, u),), (swiglu_fwd_reference(g, u),), (),
            lambda: swiglu_fwd(g, u), lambda: swiglu_fwd_reference(g, u),
            None, 3 * eb * n, 6 * n),
        "bwd": _fused_record(
            "swiglu_bwd", f"{tag} {dtype}", (rows, cols),
            swiglu_bwd(g, u, do), swiglu_bwd_reference(g, u, do), (),
            lambda: swiglu_bwd(g, u, do),
            lambda: swiglu_bwd_reference(g, u, do), None, 5 * eb * n,
            12 * n)}


def layer_norm_cases(rows, h, tag, add=True):
    """K3-LN forward and backward at [rows, h], as the train steps run
    them: the plain norm reads the bf16 stream and writes f32 with f32
    weight and bias (O2's BLACK_LIST norm), its backward reads an f32 dy;
    the add variant (GPT's ln_2) is bf16 in and out, its weight and bias
    bf16 values held in f32. The library yardstick is F.layer_norm on f32
    copies of the inputs (made outside the timing), and autograd through
    it for the backward; nothing in PyTorch computes the add variant in
    one call. Returns {case: record}."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_norm import (
        fused_layer_norm_bwd, fused_layer_norm_fwd, layer_norm_bwd_reference,
        layer_norm_fwd_reference)

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(rows + h + 1)
    x, res, ds, dya = (torch.randn(rows, h, device="cuda", generator=g,
                                   dtype=bf) for _ in range(4))
    w, b = (torch.randn(h, device="cuda", generator=g) for _ in range(2))
    dy = torch.randn(rows, h, device="cuda", generator=g)
    eps, n = 1e-5, rows * h
    out = {}
    # forward, plain norm: read x, w, b; write y (f32), rstd, mean
    got = fused_layer_norm_fwd(x, None, w, b, eps, torch.float32)
    want = layer_norm_fwd_reference(x, None, w, b, eps, torch.float32)
    xf = x.float()
    out["fwd"] = _fused_record(
        "fused_layer_norm_fwd", f"{tag} ln bfloat16->float32", (rows, h),
        (got[0], got[2], got[3]), (want[0], want[2], want[3]), (),
        lambda: fused_layer_norm_fwd(x, None, w, b, eps, torch.float32),
        lambda: layer_norm_fwd_reference(x, None, w, b, eps, torch.float32),
        lambda: F.layer_norm(xf, (h,), w, b, eps),
        2 * n + 8 * h + 4 * n + 8 * rows, 7 * n)
    stats = got[2], got[3]
    # backward, plain norm: read x, dy (f32), w, rstd, mean; write dx, dw,
    # db
    xl = xf.clone().requires_grad_()
    wl, bl = (t.clone().requires_grad_() for t in (w, b))
    yl = F.layer_norm(xl, (h,), wl, bl, eps)
    out["bwd"] = _fused_record(
        "fused_layer_norm_bwd", f"{tag} ln bfloat16<-float32", (rows, h),
        fused_layer_norm_bwd(x, w, *stats, dy),
        layer_norm_bwd_reference(x, w, *stats, dy), (1, 2),
        lambda: fused_layer_norm_bwd(x, w, *stats, dy),
        lambda: layer_norm_bwd_reference(x, w, *stats, dy),
        lambda: torch.autograd.grad(yl, (xl, wl, bl), dy, retain_graph=True),
        2 * n + 4 * n + 4 * h + 8 * rows + 2 * n + 8 * h, 11 * n)
    if not add:
        return out
    wb, bb = w.to(bf).float(), b.to(bf).float()
    # forward, add variant: read x, res, w, b; write y, s, rstd, mean
    got = fused_layer_norm_fwd(x, res, wb, bb, eps)
    want = layer_norm_fwd_reference(x, res, wb, bb, eps)
    out["fwd_add"] = _fused_record(
        "fused_layer_norm_fwd", f"{tag} add+ln bfloat16", (rows, h), got,
        want, (), lambda: fused_layer_norm_fwd(x, res, wb, bb, eps),
        lambda: layer_norm_fwd_reference(x, res, wb, bb, eps), None,
        2 * 2 * n + 8 * h + 2 * 2 * n + 8 * rows, 8 * n)
    s_add, stats = got[1], (got[2], got[3])
    # backward, add variant: read s, dy, ds, w, rstd, mean; write dsum,
    # dw, db
    out["bwd_add"] = _fused_record(
        "fused_layer_norm_bwd", f"{tag} add+ln bfloat16", (rows, h),
        fused_layer_norm_bwd(s_add, wb, *stats, dya, ds),
        layer_norm_bwd_reference(s_add, wb, *stats, dya, ds), (1, 2),
        lambda: fused_layer_norm_bwd(s_add, wb, *stats, dya, ds),
        lambda: layer_norm_bwd_reference(s_add, wb, *stats, dya, ds), None,
        3 * 2 * n + 4 * h + 8 * rows + 2 * n + 8 * h, 12 * n)
    return out


def dropout_add_cases(rows, cols, tag, p=0.1):
    """K6 forward and backward at [rows, cols] bf16, with a mask drawn as
    the train step draws it. The forward's library yardstick is
    torch.addcmul(y, x, mask, value=scale); nothing in PyTorch is the
    backward alone in one call. Returns {"fwd": ..., "bwd": ...}."""
    import torch
    from paddle_tpu_torch.ops.fused_norm import (
        dropout_add_bwd, dropout_add_bwd_reference, dropout_add_fwd,
        dropout_add_fwd_reference)

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(rows + cols)
    x, y, g = (torch.randn(rows, cols, device="cuda", generator=gen,
                           dtype=bf) for _ in range(3))
    mask = torch.empty(rows, cols, device="cuda", dtype=bf).bernoulli_(
        1.0 - p, generator=gen)
    scale = 1.0 / (1.0 - p)
    n = rows * cols
    return {
        "fwd": _fused_record(
            "dropout_add_fwd", f"{tag} bfloat16", (rows, cols),
            (dropout_add_fwd(x, y, mask, scale),),
            (dropout_add_fwd_reference(x, y, mask, scale),), (),
            lambda: dropout_add_fwd(x, y, mask, scale),
            lambda: dropout_add_fwd_reference(x, y, mask, scale),
            lambda: torch.addcmul(y, x, mask, value=scale), 4 * 2 * n,
            3 * n),
        "bwd": _fused_record(
            "dropout_add_bwd", f"{tag} bfloat16", (rows, cols),
            (dropout_add_bwd(g, mask, scale),),
            (dropout_add_bwd_reference(g, mask, scale),), (),
            lambda: dropout_add_bwd(g, mask, scale),
            lambda: dropout_add_bwd_reference(g, mask, scale), None,
            3 * 2 * n, 2 * n)}


def _requests(vocab):
    """The serve's 16 requests: prompts of 64-512 tokens, 32-128 new
    tokens each (seeded)."""
    rs = np.random.RandomState(0)
    return [(rs.randint(0, vocab, (int(rs.randint(64, 513)),)),
             int(rs.randint(32, 129))) for _ in range(16)]


def _serve_run(model, reqs, tag, **engine_kw):
    """Warm an engine up, then drive `reqs` through a fresh one with every
    launch count set to 0 just before and read just after. Prints the
    `tag` line; returns (engine, request ids, results, counts)."""
    import torch
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops import _cuda_common

    # warm-up engine (cuBLAS handles, allocator pools); not counted
    warm = ServingEngine(model, max_slots=8, kv_block_size=16, **engine_kw)
    warm.add_request(reqs[0][0][:64], max_new_tokens=4)
    warm.run()
    del warm

    eng = ServingEngine(model, max_slots=8, kv_block_size=16, **engine_kw)
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda_common.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda_common.launch_counts()

    st = eng.stats()
    vocab = model.config.vocab_size
    for rid, (p, n) in zip(rids, reqs):
        toks = done[rid]
        assert len(toks) == n and eng.finish_reasons[rid] == "length", rid
        assert ((toks >= 0) & (toks < vocab)).all(), rid
    assert st["requests_completed"] == len(reqs)
    assert st["kv_pool_free"] == st["kv_pool_blocks"] - 1
    ttft = sorted(st["ttft_s"])
    _say(tag, {
        "requests": len(reqs), "prompt_tokens": st["prefill_tokens"],
        "decode_tokens": st["decode_tokens"], "decode_ticks": st["steps"],
        "wall_s": wall,
        "decode_tok_per_s": st["decode_tokens"] / st["decode_time_s"],
        "decode_ms_per_tick": 1e3 * st["decode_time_s"] / st["steps"],
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p95_s": float(np.percentile(ttft, 95)),
        "prefill_time_s": st["prefill_time_s"],
        "slot_utilization": st["slot_utilization"],
        "kv_pool_blocks": st["kv_pool_blocks"],
        "weight_quant": st["weight_quant"],
        "kv_cache_mode": st["kv_cache_mode"],
        "param_bytes": st["param_bytes"], "kv_hbm_bytes": st["kv_hbm_bytes"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts})
    return eng, rids, done, counts


def serve():
    """The main path: 16 greedy requests through the paged engine at the
    1B geometry. Returns the model and the launch counts of the counted
    run."""
    import torch
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    from paddle_tpu_torch.text.generation import (_layer_forward_prefill,
                                                  _logits)
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**CFG_1B)
    torch.manual_seed(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    model.requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    _say("MODEL", {"params": n_params, "init_s": time.perf_counter() - t0})

    reqs = _requests(cfg.vocab_size)
    eng, rids, done, counts = _serve_run(model, reqs, "SERVE")
    st = eng.stats()
    layers = cfg.num_hidden_layers
    assert counts["flash_attention_fwd"] == len(reqs) * layers, counts
    assert counts["paged_decode_attention"] == st["steps"] * layers, counts
    assert all(counts[n] == 0 for n in FUSED_KERNELS), counts

    # teacher-forced greedy check through the PLAIN attention functions
    params, spec = eng.params, eng.spec
    cos, sin = params["rope_cos"], params["rope_sin"]
    agree = total = 0
    worst = 0.0
    with torch.no_grad():
        for rid in rids[:2]:
            prompt, n = reqs[rid]
            gen = done[rid]
            ids = np.concatenate([prompt, gen[:-1]])
            x = params["embed"][torch.from_numpy(ids).cuda()[None]]
            for lw in params["layers"]:
                x, _ = _layer_forward_prefill(
                    x, lw, spec, cos, sin,
                    attention=flash_attention_reference)
            lg = _logits(x[0, len(prompt) - 1:], params, spec)   # [n, V]
            assert lg.shape == (n, cfg.vocab_size)
            hit, gap = _held_to(lg, gen)
            agree += hit
            total += n
            worst = max(worst, gap)
    _say("TEACHER_FORCED", {"requests": 2, "tokens": total,
                            "argmax_agreement": agree / total,
                            "max_logit_gap": worst, "tie_bound": TIE_BOUND})
    assert worst < TIE_BOUND, worst
    assert agree / total >= 0.9, agree / total
    return model, counts


def _held_to(logits, gen):
    """(how many generated tokens are the logits' argmax, the largest gap
    between the argmax's logit and the generated token's)."""
    import torch

    assert torch.isfinite(logits).all()
    top = logits.argmax(dim=-1)
    g = torch.from_numpy(gen).to(logits.device)
    gap = (logits.gather(1, top[:, None]) - logits.gather(1, g[:, None]))
    return int((top == g).sum()), float(gap.max())


def _replay(eng, prompt, gen):
    """Teacher-forced replay of one served request through the engine's
    own step functions, one slot, in a fresh cache of the engine's mode,
    with the PLAIN version of every kernel passed explicitly. Returns the
    f32 logits [len(gen), V] that chose each generated token."""
    import torch
    from paddle_tpu_torch.inference.engine import _decode_step, _prefill_step
    from paddle_tpu_torch.jit.api import default_buckets
    from paddle_tpu_torch.ops._cuda_common import ceil_to
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    from paddle_tpu_torch.ops.paged_decode import \
        paged_decode_attention_reference
    from paddle_tpu_torch.ops.quantized import quant_matmul_reference
    from paddle_tpu_torch.text.paged_cache import PagedKVCache, blocks_for

    spec, bs, mode = eng.spec, eng.block_size, eng.kv_mode
    s = len(prompt)
    need = blocks_for(s + len(gen), bs)
    cache = PagedKVCache(spec.num_layers, 1 + need, spec.num_kv_heads, bs,
                         spec.head_dim, mode, "cuda")
    row = torch.zeros(eng.pages, dtype=torch.int32, device="cuda")
    row[:need] = torch.arange(1, 1 + need, dtype=torch.int32)
    bucket = max(min(ceil_to(default_buckets(s), bs), eng.max_model_len),
                 ceil_to(s, bs))
    ids = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
    ids[0, :s] = torch.from_numpy(prompt).cuda()
    plain = dict(qmm=quant_matmul_reference)
    out = [_prefill_step(spec, bs, mode, eng.params, cache, ids, s, row,
                         attention=flash_attention_reference, **plain)]
    for i, tok in enumerate(gen[:-1]):
        out.append(_decode_step(
            spec, bs, mode, eng.params, cache,
            torch.tensor([int(tok)], device="cuda"),
            torch.tensor([s + i], device="cuda"), row[None],
            decode_attention=paged_decode_attention_reference, **plain))
    return torch.cat(out)


def serve_quant(model, weight_quant, kv_cache_dtype, n_requests, tag):
    """The quantized path: `n_requests` of the serve's requests through an
    engine with quantized weights and KV cache; launch counts checked per
    kernel, two requests replayed teacher-forced through the plain
    versions. Returns the launch counts of the counted run."""
    from paddle_tpu_torch.ops.paged_decode import KERNEL_NAMES

    cfg = model.config
    reqs = _requests(cfg.vocab_size)[:n_requests]
    eng, rids, done, counts = _serve_run(model, reqs, tag,
                                         weight_quant=weight_quant,
                                         kv_cache_dtype=kv_cache_dtype)
    st = eng.stats()
    layers = cfg.num_hidden_layers
    prefills, ticks = len(reqs), st["steps"]
    # per prefill and per decode tick: 7 layer matmuls x 20 + the lm_head
    per_step = 7 * layers + 1
    want_qmm = (prefills + ticks) * per_step if weight_quant == "int4" else 0
    assert counts["quant_matmul"] == want_qmm, counts
    assert counts[KERNEL_NAMES[kv_cache_dtype]] == ticks * layers, counts
    assert counts["flash_attention_fwd"] == prefills * layers, counts
    for fmt, name in KERNEL_NAMES.items():
        if fmt != kv_cache_dtype:
            assert counts[name] == 0, counts
    assert all(counts[n] == 0 for n in FUSED_KERNELS), counts

    agree = total = 0
    worst = 0.0
    for rid in rids[:2]:
        prompt, n = reqs[rid]
        gen = done[rid]
        lg = _replay(eng, prompt, gen)
        assert lg.shape == (n, cfg.vocab_size)
        hit, gap = _held_to(lg, gen)
        agree += hit
        total += n
        worst = max(worst, gap)
    bound = TIE_BOUND_Q[kv_cache_dtype]
    _say(tag + "_TEACHER_FORCED", {
        "requests": 2, "tokens": total, "argmax_agreement": agree / total,
        "max_logit_gap": worst, "tie_bound": bound,
        "agreement_floor": AGREE_MIN_Q[kv_cache_dtype]})
    assert worst < bound, worst
    assert agree / total >= AGREE_MIN_Q[kv_cache_dtype], agree / total
    return counts


def profile_decode(model, ticks=10, tag="PROFILE", **engine_kw):
    """Where a decode tick's time goes: torch.profiler over `ticks` steady
    decode ticks of 8 slots (256-token prompts), device time by kernel
    kind beside the host wall. Not part of the counted run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import ServingEngine

    eng = ServingEngine(model, max_slots=8, kv_block_size=16, **engine_kw)
    rs = np.random.RandomState(1)
    for _ in range(8):
        eng.add_request(rs.randint(0, model.config.vocab_size, (256,)),
                        max_new_tokens=ticks + 8)
    for _ in range(4):                  # admit + prefill all 8, warm ticks
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = {"quant_matmul": 0.0, "paged_decode": 0.0, "gemm": 0.0,
             "other": 0.0}
    per_kernel = {}
    launched = 0
    for e in prof.key_averages():
        # device events only: CPU ops also report the time of the
        # kernels they launched, which would count it twice
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        launched += e.count
        low = e.key.lower()
        kind = ("quant_matmul" if "qmm_" in low else
                "paged_decode" if "paged_decode" in low else
                "gemm" if any(w in low for w in ("nvjet", "gemm", "gemv",
                                                 "xmma", "cutlass"))
                else "other")
        kinds[kind] += us / 1e3 / ticks
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3 / ticks
    device_ms = sum(kinds.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    _say(tag, {
        "ticks": ticks, "slots": 8, "wall_ms_per_tick": 1e3 * wall / ticks,
        "device_ms_per_tick": device_ms,
        "device_busy_share": device_ms / (1e3 * wall / ticks),
        "device_ops_per_tick": launched / ticks,   # kernels + copies
        "device_ms_per_tick_by_kind": kinds,
        "top_kernels_ms_per_tick": [[k[:60], v] for k, v in top]})


def _train_model():
    """The 1B model decorated O2 (bf16 params, bf16 AdamW moments) with
    its optimizer, and the seeded batch."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**CFG_1B)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg, device="cuda")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                              master_weight=False)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    return model, opt, ids


def _plain_attention_loss(model, ids):
    """The model's loss (`model(ids, labels=ids)` at the 1B vocab: the
    fused-CE branch) through the plain compositions alone: every layer is
    `_layer_forward_prefill` (RMSNorm, rotary and SwiGLU composed in
    torch, as with FLAGS_pallas_fused_ops off) with its attention the
    plain forward, differentiated by autograd instead of K2, and the final
    norm is the composition too. No kernel of the model runs."""
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_linear_cross_entropy
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    from paddle_tpu_torch.text.generation import (_layer_forward_prefill,
                                                  _layer_weights, _rms_norm)

    m = model.model
    x = m.embed_tokens(ids)
    for layer in m.layers:
        x = _layer_forward_prefill(x, _layer_weights(layer), layer.spec,
                                   m.rope_cos, m.rope_sin,
                                   attention=flash_attention_reference)[0]
    return fused_linear_cross_entropy(_rms_norm(x, m.norm.weight, m.norm.eps),
                                      model.lm_head.weight.T, ids)


def _grad_check(model, loss_fn, plain_loss_fn, tag, seed=1234):
    """One step's gradients through the kernels (`loss_fn`) vs the same
    step with no kernel of the path (`plain_loss_fn`; no update), each
    side from the default generators seeded alike (so BERT's dropout
    masks match); the plain side must launch no kernel. Prints `tag`."""
    import torch
    from paddle_tpu_torch.ops import _cuda_common

    torch.manual_seed(seed)
    loss = loss_fn()
    loss.backward()
    kern = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    _cuda_common.reset_launch_counts()
    torch.manual_seed(seed)
    plain_loss = plain_loss_fn()
    plain_loss.backward()
    torch.cuda.synchronize()
    stray = {n: c for n, c in _cuda_common.launch_counts().items() if c}
    assert not stray, stray
    plain = {n: p.grad for n, p in model.named_parameters()}
    checked, worst, worst_name = 0, 0.0, None
    for n, w in plain.items():
        if kern[n] is None:     # unused (BERT's token types without ids)
            assert w is None, n
            continue
        a, w = kern[n].float(), w.float()
        assert torch.isfinite(a).all(), n
        # BERT's key bias gets no gradient in exact arithmetic (a query
        # row's softmax ignores a shift common to its keys): its gradient
        # is rounding on both sides, held to its key weight's scale
        scale = plain[n[:-4] + "weight"] if n.endswith("key.bias") else w
        rel = (a - w).abs().max().item() / scale.float().abs().max().item()
        checked += 1
        if rel > worst:
            worst, worst_name = rel, n
    model.zero_grad(set_to_none=True)
    del kern, plain
    rec = {"loss": loss.item(), "plain_loss": plain_loss.item(),
           "tensors": checked, "max_rel_err": worst,
           "worst_tensor": worst_name, "tol": GRAD_TOL}
    _say(tag, rec)
    assert worst <= GRAD_TOL, rec
    # the plain side is the model's own function, its arithmetic aside
    assert abs(rec["loss"] - rec["plain_loss"]) <= GRAD_TOL * rec["loss"], rec


def _timed_steps(model, opt, ids, steps, labels=None, reseed=None):
    """`steps` training steps (labels = ids unless given) from a zeroed
    peak-memory counter and zeroed launch counts: (losses, step walls in
    s, peak GB, launch counts). `reseed`, when given, reseeds the default
    generators before each step, so that every step draws the same
    dropout masks and the losses compare the updates alone."""
    import torch
    from paddle_tpu_torch.ops import _cuda_common

    labels = ids if labels is None else labels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda_common.reset_launch_counts()
    losses, walls = [], []
    for _ in range(steps):
        if reseed is not None:
            torch.manual_seed(reseed)
        t1 = time.perf_counter()
        losses.append(_train_step(model, opt, ids, labels).item())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    return (losses, walls, torch.cuda.max_memory_allocated() / 1e9,
            _cuda_common.launch_counts())


def train():
    """The training path (FLAGS_pallas_fused_ops on, its default): the
    gradient check, then TRAIN_STEPS counted steps. Returns (model,
    optimizer, ids, launch counts)."""
    import torch
    from paddle_tpu_torch.core.flags import flag

    assert flag("FLAGS_pallas_fused_ops") is True
    t0 = time.perf_counter()
    model, opt, ids = _train_model()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    _grad_check(model, lambda: model(ids, labels=ids),
                lambda: _plain_attention_loss(model, ids),
                "TRAIN_GRAD_CHECK")
    layers = model.config.num_hidden_layers
    losses, walls, peak, counts = _timed_steps(model, opt, ids, TRAIN_STEPS)
    steady = walls[1:]
    ms = 1e3 * statistics.median(steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    _say("TRAIN", {
        "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": TRAIN_STEPS, "setup_s": time.perf_counter() - t0,
        "ms_per_step_median": ms,
        "ms_per_step_min": 1e3 * min(steady),
        "ms_per_step_max": 1e3 * max(steady),
        "first_step_ms": 1e3 * walls[0],
        "tokens_per_s": tokens / (ms / 1e3),
        "achieved_tflops": 6 * n_params * tokens / (ms / 1e3) / 1e12,
        "max_memory_allocated_gb": peak, "losses": losses,
        "launches": counts})
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    # per step: K1, K2, K5 once per layer (each way); K3 twice per layer
    # and once for the final norm, each way; K4 once per layer each way
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers, "swiglu_fwd": layers,
            "swiglu_bwd": layers, "fused_rms_norm_fwd": 2 * layers + 1,
            "fused_rms_norm_bwd": 2 * layers + 1, "rope_qk": 2 * layers}
    for name, per_step in want.items():
        assert counts[name] == TRAIN_STEPS * per_step, (name, counts)
    return model, opt, ids, counts


def train_unfused(model, opt, ids):
    """TRAIN's model and batch with FLAGS_pallas_fused_ops off (the plain
    compositions), UNFUSED_STEPS counted steps, then as
    many fused steps again, so fused and unfused step times and peak
    memory come from one card in one run (fused, unfused, fused)."""
    from paddle_tpu_torch.core.flags import set_flags

    layers = model.config.num_hidden_layers
    set_flags({"FLAGS_pallas_fused_ops": False})
    try:
        losses, walls, peak, counts = _timed_steps(model, opt, ids,
                                                   UNFUSED_STEPS)
    finally:
        set_flags({"FLAGS_pallas_fused_ops": True})
    f_losses, f_walls, f_peak, f_counts = _timed_steps(model, opt, ids,
                                                       UNFUSED_STEPS)
    ms = 1e3 * statistics.median(walls[1:])
    _say("TRAIN_UNFUSED", {
        "steps": UNFUSED_STEPS, "ms_per_step_median": ms,
        "ms_per_step_min": 1e3 * min(walls[1:]),
        "ms_per_step_max": 1e3 * max(walls[1:]),
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
        "max_memory_allocated_gb": peak, "losses": losses,
        "launches": counts,
        "fused_again_ms_per_step_median": 1e3 * statistics.median(
            f_walls[1:]),
        "fused_again_ms_per_step_min": 1e3 * min(f_walls[1:]),
        "fused_again_ms_per_step_max": 1e3 * max(f_walls[1:]),
        "fused_again_max_memory_allocated_gb": f_peak,
        "fused_again_losses": f_losses})
    assert all(np.isfinite(losses + f_losses)), (losses, f_losses)
    assert all(counts[n] == 0 for n in FUSED_KERNELS), counts
    assert all(c[n] == 0 for c in (counts, f_counts)
               for n in LN_DROPOUT_KERNELS), (counts, f_counts)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] == UNFUSED_STEPS * layers, counts
    assert f_counts["rope_qk"] == UNFUSED_STEPS * 2 * layers, f_counts


def _train_step(model, opt, ids, labels):
    loss = model(ids, labels=labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def _kernel_kind(key):
    """The kind of a device kernel, by its (demangled) name. The norm
    kernels carry their kind as a template argument (`true` = LayerNorm);
    the dw finish is LayerNorm's when its output is f32 (the RMS kinds
    write a bf16 dw on the train paths)."""
    low = key.lower()
    layer = ", true>" in low
    for frag, kind in (("norm_fwd_kernel",
                        "layer_norm_fwd" if layer else "rms_norm_fwd"),
                       ("norm_bwd_kernel",
                        "layer_norm_bwd" if layer else "rms_norm_bwd"),
                       ("dw_finish_kernel<float>", "layer_norm_bwd"),
                       ("dw_finish_kernel", "rms_norm_bwd"),
                       ("rope_kernel", "rope"),
                       ("swiglu_fwd_kernel", "swiglu_fwd"),
                       ("swiglu_bwd_kernel", "swiglu_bwd"),
                       ("dropout_add_fwd_kernel", "dropout_add_fwd"),
                       ("dropout_add_bwd_kernel", "dropout_add_bwd"),
                       ("flash_bwd_dq", "flash_bwd_dq"),
                       ("flash_bwd_dkv", "flash_bwd_dkv"),
                       ("flash_fwd", "flash_fwd")):
        if frag in low:
            return kind
    if any(w in low for w in ("nvjet", "gemm", "gemv", "xmma", "cutlass")):
        return "gemm"
    return "other"


def profile_train(step, tag="PROFILE_TRAIN"):
    """Where a training step's time goes: torch.profiler over one steady
    `step()` (which returns the loss), device time by kernel kind beside
    the host wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = dict.fromkeys(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rms_norm_fwd",
         "rms_norm_bwd", "layer_norm_fwd", "layer_norm_bwd", "rope",
         "swiglu_fwd", "swiglu_bwd", "dropout_add_fwd", "dropout_add_bwd",
         "gemm", "other"), 0.0)
    per_kernel, spans = {}, {}
    launched = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if getattr(e, "is_user_annotation", False):
            # a range around kernels already counted (torch.optim wraps
            # step() in one, "Optimizer.step#AdamW.step"): its span only
            spans[e.key] = us / 1e3
            continue
        launched += e.count
        kinds[_kernel_kind(e.key)] += us / 1e3
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3
    device_ms = sum(kinds.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    _say(tag, {
        "loss": loss.item(), "wall_ms": 1e3 * wall, "device_ms": device_ms,
        "device_busy_share": device_ms / (1e3 * wall),
        "device_ops_per_step": launched, "device_ms_by_kind": kinds,
        "annotated_spans_ms": spans,
        "top_kernels_ms": [[k[:60], v] for k, v in top]})


def _plain_path(loss_fn):
    """`loss_fn` run with no kernel of the path: FLAGS_pallas_fused_ops
    off (the norms and dropout + add composed in torch) and
    nn.functional's attention replaced, for the duration, by autograd of
    the plain flash forward. Returns the wrapped function."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_reference

    def plain_sdpa(q, k, v, attn_mask=None, is_causal=False):
        assert attn_mask is None
        o, _ = flash_attention_reference(q.transpose(1, 2),
                                         k.transpose(1, 2),
                                         v.transpose(1, 2), is_causal)
        return o.transpose(1, 2)

    def run():
        kernel_sdpa = PF.scaled_dot_product_attention
        set_flags({"FLAGS_pallas_fused_ops": False})
        PF.scaled_dot_product_attention = plain_sdpa
        try:
            return loss_fn()
        finally:
            PF.scaled_dot_product_attention = kernel_sdpa
            set_flags({"FLAGS_pallas_fused_ops": True})

    return run


def _counted_train(tag, model, opt, ids, labels, units, want, reseed=None):
    """TRAIN_STEPS counted steps (`_timed_steps`). Prints `tag` with ms
    per step (median of steps 2..), `units` ((name, count per step)) per
    second and peak memory; asserts finite, falling losses and launches of
    exactly `want` per step for every kernel (0 for the others). Returns
    the counts."""
    losses, walls, peak, counts = _timed_steps(model, opt, ids, TRAIN_STEPS,
                                               labels, reseed)
    steady = walls[1:]
    ms = 1e3 * statistics.median(steady)
    name, per_step = units
    n_params = sum(p.numel() for p in model.parameters())
    _say(tag, {
        "params": n_params, "batch": list(ids.shape), "steps": TRAIN_STEPS,
        "ms_per_step_median": ms, "ms_per_step_min": 1e3 * min(steady),
        "ms_per_step_max": 1e3 * max(steady),
        "first_step_ms": 1e3 * walls[0],
        f"{name}_per_s": per_step / (ms / 1e3),
        "achieved_tflops": 6 * n_params * ids.numel() / (ms / 1e3) / 1e12,
        "max_memory_allocated_gb": peak, "losses": losses,
        "launches": counts})
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    got = {n: c for n, c in counts.items() if c}
    assert got == {n: TRAIN_STEPS * c for n, c in want.items()}, (got, want)
    return counts


def train_gpt():
    """TRAIN_GPT: GPT-3 medium (bench.py `bench_gpt_medium_sharding`:
    bf16 O2 with bf16 AdamW moments, AdamW lr 1e-4 with the multi-tensor
    switch, random weights from seed 0) on one batch of 4 x 1024 seeded
    ids, labels = ids, FLAGS_pallas_fused_ops on: the gradient check, the
    counted steps, one profiled step. Returns the launch counts."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**CFG_GPT)
    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                use_multi_tensor=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                              master_weight=False)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ))).cuda()
    torch.cuda.synchronize()
    _say("TRAIN_GPT_SETUP", {"seconds": time.perf_counter() - t0})
    _grad_check(model, lambda: model(ids, labels=ids),
                _plain_path(lambda: model(ids, labels=ids)),
                "TRAIN_GPT_GRAD_CHECK")
    layers = cfg.num_hidden_layers
    # per step: K1 and both K2 kernels once per layer; K3-LN for ln_1 and
    # ln_2 of every block and ln_f, each way
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            "fused_layer_norm_fwd": 2 * layers + 1,
            "fused_layer_norm_bwd": 2 * layers + 1}
    counts = _counted_train("TRAIN_GPT", model, opt, ids, ids,
                            ("tokens", ids.numel()), want)
    profile_train(lambda: _train_step(model, opt, ids, ids),
                  "PROFILE_TRAIN_GPT")
    return counts


def train_bert():
    """TRAIN_BERT: BERT-base sequence classification (bench.py
    `bench_bert(amp=True)`: bf16 O2 with bf16 AdamW moments, AdamW lr
    2e-5, random weights from seed 0, hidden dropout 0.1) on one batch of
    64 x 128 seeded ids with binary labels, FLAGS_pallas_fused_ops on: the
    gradient check (dropout masks alike on both sides), the counted steps
    (each step's masks drawn alike), one profiled step. Returns the launch
    counts."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import (BertConfig,
                                              BertForSequenceClassification)

    cfg = BertConfig()
    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = BertForSequenceClassification(cfg, device="cuda")
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                              master_weight=False)
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, 30000,
                                      (BERT_BATCH, BERT_SEQ))).cuda()
    labels = torch.from_numpy(rs.randint(0, 2, (BERT_BATCH,))).cuda()
    torch.cuda.synchronize()
    _say("TRAIN_BERT_SETUP", {"seconds": time.perf_counter() - t0})
    _grad_check(model, lambda: model(ids, labels=labels),
                _plain_path(lambda: model(ids, labels=labels)),
                "TRAIN_BERT_GRAD_CHECK")
    layers = cfg.num_hidden_layers
    # per step: K1 and both K2 kernels once per layer; K3-LN for the
    # embeddings' norm and two per layer, each way; K6 twice per layer,
    # each way
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            "fused_layer_norm_fwd": 2 * layers + 1,
            "fused_layer_norm_bwd": 2 * layers + 1,
            "dropout_add_fwd": 2 * layers, "dropout_add_bwd": 2 * layers}
    counts = _counted_train("TRAIN_BERT", model, opt, ids, labels,
                            ("sequences", BERT_BATCH), want, reseed=4321)
    profile_train(lambda: _train_step(model, opt, ids, labels),
                  "PROFILE_TRAIN_BERT")
    return counts


#: the varlen slice: a packed batch of 16 causal sequences with lengths
#: from np.random.RandomState(0) in 64..2048 (bucket 2048), LLaMA-1B's
#: head geometry (16 heads of 128), bf16
VARLEN_SEQS, VARLEN_MIN, VARLEN_MAX = 16, 64, 2048
#: FlashMask as bench.py `bench_flashmask_longctx` drives it: B 1, H 16,
#: S 8192, D 128, bf16, causal, key column j hidden from rows
#: i >= min(j + 1024, S): a 1024-token sliding window
FM_SEQ, FM_WINDOW = 8192, 1024
#: the six kernels of the varlen and FlashMask paths, which no earlier
#: phase may launch
VARLEN_KERNELS = ("flash_attention_varlen_fwd",
                  "flash_attention_varlen_bwd_dq",
                  "flash_attention_varlen_bwd_dkv")
FM_KERNELS = ("flashmask_fwd", "flashmask_bwd_dq", "flashmask_bwd_dkv")


def _varlen_lengths():
    return np.random.RandomState(0).randint(VARLEN_MIN, VARLEN_MAX + 1,
                                            VARLEN_SEQS)


def _fm_window_starts(s=FM_SEQ, heads=16, b=1):
    import torch

    st = torch.clamp(torch.arange(s, device="cuda") + FM_WINDOW, max=s)
    return st.to(torch.int32).expand(b, heads, s).contiguous()


def varlen_cases():
    """K1v and K2v at the VARLEN phase's padded batch (16 sequences, bucket
    2048, H 16, D 128, bf16, causal), each held against its plain version
    and timed beside it, beside SDPA with the equivalent boolean mask
    (forward; autograd for that kernel's gradients), and beside its bound
    over the pairs this batch needs: valid query rows x the keys each
    sees (sum of len (len + 1) / 2 per head), and the bytes of the valid
    tokens. dO is zero on padded rows, as the gather-back's backward
    leaves it. Returns {"fwd": rec, "bwd": rec}."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.jit.api import default_buckets
    from paddle_tpu_torch.ops.flash_attention import (
        _bwd_delta, _launch_bwd_dkv, _launch_bwd_dq, _mask,
        flash_attention_bwd_dkv_reference, flash_attention_bwd_dq_reference,
        flash_attention_fwd, flash_attention_reference)

    lens = _varlen_lengths()
    b, h, d = VARLEN_SEQS, 16, 128
    s = default_buckets(int(lens.max()))
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=g,
                               dtype=torch.bfloat16) for _ in range(4))
    kv_lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    valid = (torch.arange(s, device="cuda")[None, :] < kv_lens[:, None])
    do = do * valid[:, None, :, None]
    vis = _mask(s, s, q.device, True, kv_lens)          # [B, 1, S, S]
    pairs = h * int((lens * (lens + 1) // 2).sum())
    tokens = int(lens.sum())
    q_bytes = kv_bytes = 2 * tokens * h * d             # bf16, valid rows
    o, lse = flash_attention_fwd(q, k, v, True, kv_lens)
    ro, rlse = flash_attention_reference(q, k, v, True, kv_lens)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert err < KERNEL_TOL and lse_err < 1e-3, (err, lse_err)
    bound, by = _bound_ms(4 * d * pairs,
                          2 * q_bytes + 2 * kv_bytes + 4 * tokens * h)
    del ro, rlse
    fwd = {"name": "flash_attention_varlen_fwd", "shape": [b, h, h, s, d],
           "lengths": lens.tolist(), "causal": True, "body": TC_BODY,
           "max_abs_err": err,
           "lse_max_abs_err": lse_err,
           "ms": _time_ms(lambda: flash_attention_fwd(q, k, v, True,
                                                      kv_lens)),
           "plain_ms": _time_ms(lambda: flash_attention_reference(
               q, k, v, True, kv_lens)),
           "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=vis)),
           "bound_ms": bound, "bound_by": by}
    _say("KERNEL", fwd)
    delta = _bwd_delta(o, do)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=vis)
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * tokens * h
    bwd = {"name": "flash_attention_varlen_bwd", "shape": [b, h, h, s, d],
           "causal": True, "tol": K2_TOL}
    _bwd_records(
        bwd, (("dq", _launch_bwd_dq, flash_attention_bwd_dq_reference,
               (ql,), 3, q_bytes),
              ("dkv", _launch_bwd_dkv, flash_attention_bwd_dkv_reference,
               (kl, vl), 4, 2 * kv_bytes)),
        (q, k, v, do, lse, delta, True, kv_lens), reads, pairs, d,
        lambda wrt: torch.autograd.grad(out, wrt, do, retain_graph=True))
    _say("KERNEL", bwd)
    return {"fwd": fwd, "bwd": bwd}


#: the bodies bf16 K9's forward and dK/dV ran before they moved onto the
#: tensor cores: the CUDA-core forward and dK/dV of
#: csrc/flash_attention_tiles.cuh at the largest head dim 128 with the
#: start-row mask (the templates and arguments the parent's
#: csrc/flashmask_attention.cu instantiated), built from the checkout's
#: header into a yardstick library of their own. The KERNEL lines time
#: them beside K9 on the same inputs (`replaced_ms`); the port never
#: calls them.
REPLACED_K9_SRC = r"""
#include "flash_attention_tiles.cuh"

namespace {
StartRowMask::Args margs(const void* st, const void* lo, const void* hi,
                         int causal) {
  return StartRowMask::Args{static_cast<const int*>(st),
                            static_cast<const int*>(lo),
                            static_cast<const int*>(hi), causal};
}
}  // namespace

extern "C" int replaced_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, const void* st,
                            const void* lo, const void* hi, int b, int h,
                            int sq, int sk, int d, int causal,
                            void* stream) {
  return launch_fwd<__nv_bfloat16, StartRowMask, kSmallD>(
      q, k, v, o, lse, margs(st, lo, hi, causal), b, h, h, sq, sk, d,
      1.0f / sqrtf((float)d), static_cast<cudaStream_t>(stream));
}

extern "C" int replaced_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                const void* st, const void* lo,
                                const void* hi, int b, int h, int sq, int sk,
                                int d, int causal, void* stream) {
  return launch_bwd_dkv<__nv_bfloat16, StartRowMask, kSmallD>(
      q, k, v, dout, lse, delta, dk, dv, margs(st, lo, hi, causal), b, h, h,
      sq, sk, d, 1.0f / sqrtf((float)d), static_cast<cudaStream_t>(stream));
}
"""


def start_replaced_build():
    """Start nvcc on REPLACED_K9_SRC (the port's own flags, the csrc
    headers) beside the kernels' build; returns (process, library)."""
    from paddle_tpu_torch.ops import _cuda_common

    os.makedirs(_cuda_common.BUILD_DIR, exist_ok=True)
    src = os.path.join(_cuda_common.BUILD_DIR, "k9_replaced.cu")
    with open(src, "w") as f:
        f.write(REPLACED_K9_SRC)
    lib = os.path.join(_cuda_common.BUILD_DIR, "k9_replaced.so")
    proc = subprocess.Popen(
        [_cuda_common._nvcc(), *_cuda_common.NVCC_FLAGS, "-I",
         _cuda_common.CSRC_DIR, "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, lib


def replaced_library(proc, lib):
    """The loaded yardstick library once its build has ended."""
    log, _ = proc.communicate()
    assert proc.returncode == 0, log.decode(errors="replace")
    so = ctypes.CDLL(lib)
    for fn, n_ptrs in ((so.replaced_fwd, 8), (so.replaced_bwd_dkv, 11)):
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return so


def flashmask_cases(s, starts, tag, replaced, b=1, h=16, d=128):
    """K9's three kernels at one shape (bf16, causal) with the start rows
    `starts(s, h)` ([1, h, s] int32): each against its plain version,
    timed beside it, beside SDPA with the equivalent boolean mask
    (autograd for a backward kernel's gradients), and beside its bound
    over the visible pairs these start rows leave (the sum over columns
    j of min(start[j], S) - j) and the bytes of Q, K, V, O (dO, dQ, dK,
    dV), lse, delta and the start rows. The tile bounds are computed
    once, untimed (the wrapper's prep). The forward and dK/dV are also
    timed against the bodies they replaced (`replaced`, the library of
    `replaced_library`), on the same inputs, each of those held to the
    plain version too. Returns {"fwd": rec, "bwd": rec}."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash_attention import _bwd_delta
    from paddle_tpu_torch.ops.flashmask import (
        _fm_mask, _launch_bwd_dkv, _launch_bwd_dq, _launch_fwd,
        flashmask_attention_reference, flashmask_bwd_dkv_reference,
        flashmask_bwd_dq_reference, tensor_core_route, tile_bounds)

    g = torch.Generator(device="cuda").manual_seed(s)
    q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=g,
                               dtype=torch.bfloat16) for _ in range(4))
    start = starts(s, h)
    smin, smax = tile_bounds(start, s)
    cols = torch.arange(s, device="cuda")
    pairs = int((start.clamp(max=s) - cols).clamp(min=0).sum().item())
    vis = _fm_mask(s, s, start, True)
    fm = (start, smin, smax, True)
    o, lse = _launch_fwd(q, k, v, *fm)
    ro, rlse = flashmask_attention_reference(q, k, v, start, True)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert err < KERNEL_TOL and lse_err < 1e-3, (err, lse_err)
    stream = torch.cuda.current_stream().cuda_stream
    mask_ptrs = (start.data_ptr(), smin.data_ptr(), smax.data_ptr())

    def replaced_fwd():
        o_ = torch.empty_like(q)
        lse_ = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
        code = replaced.replaced_fwd(q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), o_.data_ptr(),
                                     lse_.data_ptr(), *mask_ptrs, b, h, s, s,
                                     d, 1, stream)
        assert code == 0, code
        return o_, lse_

    def body(name):
        return TC_BODY if tensor_core_route(name, q.dtype, d) else CORE_BODY

    rep_err = (replaced_fwd()[0].float() - ro.float()).abs().max().item()
    assert rep_err < KERNEL_TOL, rep_err
    del ro, rlse
    q_bytes = kv_bytes = 2 * b * h * s * d
    st_bytes = 4 * b * h * s
    bound, by = _bound_ms(4 * d * pairs, 2 * q_bytes + 2 * kv_bytes
                          + 4 * b * h * s + st_bytes)
    fwd = {"name": "flashmask_fwd", "case": tag, "shape": [b, h, s, d],
           "causal": True, "visible_pairs": pairs,
           "causal_pairs": b * h * s * (s + 1) // 2,
           "body": body("flashmask_fwd"), "replaced_body": CORE_BODY,
           "max_abs_err": err, "lse_max_abs_err": lse_err,
           "ms": _time_ms(lambda: _launch_fwd(q, k, v, *fm)),
           "replaced_ms": _time_ms(replaced_fwd),
           "plain_ms": _time_ms(lambda: flashmask_attention_reference(
               q, k, v, start, True)),
           "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=vis)),
           "bound_ms": bound, "bound_by": by}
    _say("KERNEL", fwd)
    delta = _bwd_delta(o, do)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=vis)
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * b * h * s + st_bytes
    bwd = {"name": "flashmask_bwd", "case": tag, "shape": [b, h, s, d],
           "causal": True, "tol": K2_TOL}

    def fm_dq(q_, k_, v_, do_, lse_, delta_, causal, *_):
        return _launch_bwd_dq(q_, k_, v_, do_, lse_, delta_, *fm)

    def fm_dkv(q_, k_, v_, do_, lse_, delta_, causal, *_):
        return _launch_bwd_dkv(q_, k_, v_, do_, lse_, delta_, *fm)

    def plain_dq(q_, k_, v_, do_, lse_, delta_, causal, *_):
        return flashmask_bwd_dq_reference(q_, k_, v_, do_, lse_, delta_,
                                          start, causal)

    def plain_dkv(q_, k_, v_, do_, lse_, delta_, causal, *_):
        return flashmask_bwd_dkv_reference(q_, k_, v_, do_, lse_, delta_,
                                           start, causal)

    def replaced_dkv():
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        code = replaced.replaced_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *mask_ptrs, b, h, s, s, d, 1, stream)
        assert code == 0, code
        return dk, dv

    _bwd_records(
        bwd, (("dq", fm_dq, plain_dq, (ql,), 3, q_bytes),
              ("dkv", fm_dkv, plain_dkv, (kl, vl), 4, 2 * kv_bytes)),
        (q, k, v, do, lse, delta, True), reads, pairs, d,
        lambda wrt: torch.autograd.grad(out, wrt, do, retain_graph=True))
    _, rels = _rel_errs(replaced_dkv(), plain_dkv(q, k, v, do, lse, delta,
                                                  True))
    assert max(rels) <= K2_TOL, ("replaced dkv", rels)
    bwd["dq"]["body"] = body("flashmask_bwd_dq")
    bwd["dkv"] |= {"body": body("flashmask_bwd_dkv"),
                   "replaced_body": CORE_BODY,
                   "replaced_ms": _time_ms(replaced_dkv)}
    _say("KERNEL", bwd)
    return {"fwd": fwd, "bwd": bwd}


def _api_grad_check(tag, run, plain_run, leaves):
    """Forward + backward of loss = sum(out^2) (f32) through the kernels
    (`run()`, counted from zero) and through the plain versions
    (`plain_run()`, which must launch nothing), each gradient within
    KERNEL_TOL of its largest |value|. Returns (counts, record)."""
    import torch
    from paddle_tpu_torch.ops import _cuda_common

    def grads(fn):
        out = fn()
        loss = out.float().square().sum()
        return out, torch.autograd.grad(loss, leaves)

    _cuda_common.reset_launch_counts()
    plain_out, plain = grads(plain_run)
    torch.cuda.synchronize()
    stray = {n: c for n, c in _cuda_common.launch_counts().items() if c}
    assert not stray, stray
    _cuda_common.reset_launch_counts()
    out, got = grads(run)
    torch.cuda.synchronize()
    counts = _cuda_common.launch_counts()
    err, rels = _rel_errs((out, *got), (plain_out, *plain))
    rec = {"out_shape": list(out.shape), "max_abs_err": err,
           "rel_err": rels, "tol": KERNEL_TOL}
    assert max(rels) <= KERNEL_TOL, (tag, rec)
    return counts, rec


def _exact(counts, want):
    got = {n: c for n, c in counts.items() if c}
    assert got == want, (got, want)


def varlen_phase():
    """VARLEN: `flash_attn_unpadded` on the packed batch of `varlen_cases`
    (16 causal sequences, 64..2048 tokens, H 16, D 128, bf16), forward
    and backward with loss = sum(out^2): gradients held against the same
    loss through the plain versions (the raw op replaced, for the
    duration, by autograd of the plain forward); launches exactly one K1v
    and one of each K2v kernel, no K1/K2. Then `flash_attn_varlen_qkvpacked`
    and the incubate `memory_efficient_attention(cu_seqlens=...)` once each
    (forward, no grad: one K1v each). Prints VARLEN with ms per forward +
    backward (CUDA events, median of 30). Returns the phase's counts."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import \
        memory_efficient_attention
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.nn.functional import extended
    from paddle_tpu_torch.ops import _cuda_common
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_reference

    lens = _varlen_lengths()
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    total, mx = int(cu[-1]), int(lens.max())
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(total, 16, 128, device="cuda", generator=g,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    cu_t = torch.from_numpy(cu).cuda()

    def run():
        return PF.flash_attn_unpadded(q, k, v, cu_t, cu_t, mx, mx,
                                      causal=True)[0]

    def plain_raw(q_, k_, v_, kv_lens, causal=False):
        return flash_attention_reference(q_, k_, v_, causal, kv_lens)[0]

    def plain_run():
        kernel_raw = extended.flash_attention_varlen_raw
        extended.flash_attention_varlen_raw = plain_raw
        try:
            return run()
        finally:
            extended.flash_attention_varlen_raw = kernel_raw

    counts, rec = _api_grad_check("VARLEN", run, plain_run, (q, k, v))
    _exact(counts, dict.fromkeys(VARLEN_KERNELS, 1))
    with torch.no_grad():
        packed = PF.flash_attn_varlen_qkvpacked(
            torch.stack([q, k, v], dim=1), cu_t, cu_t, mx, mx,
            causal=True)[0]
        mea = memory_efficient_attention(q, k, v, cu_seqlens_q=cu_t,
                                         cu_seqlens_k=cu_t, max_seqlen_q=mx,
                                         max_seqlen_k=mx, causal=True)
        torch.cuda.synchronize()
    counts = _cuda_common.launch_counts()
    _exact(counts, {VARLEN_KERNELS[0]: 3, VARLEN_KERNELS[1]: 1,
                    VARLEN_KERNELS[2]: 1})
    assert torch.equal(packed, mea) and packed.shape == q.shape
    do = torch.randn(q.shape, device="cuda", generator=g,
                     dtype=torch.bfloat16)
    ms = _time_ms(lambda: torch.autograd.grad(run(), (q, k, v), do))
    _say("VARLEN", {"sequences": len(lens), "tokens": total,
                    "max_seqlen": mx, "heads": 16, "head_dim": 128,
                    "grad_check": rec, "launches": counts,
                    "fwd_bwd_ms": ms})
    return counts


def flashmask_phase():
    """FLASHMASK: `flashmask_attention` at bench_flashmask_longctx's shape
    (B 1, S 8192, H 16, D 128, bf16, causal, [1, 1, S, 1] start rows of a
    1024-token window, broadcast from Hm = 1 to H), forward and backward
    with loss = sum(out^2): gradients held against the same loss through
    the plain versions; exactly one launch of each K9 kernel, no K1/K2.
    Then forward + backward timed (CUDA events, median of 30) beside the
    same op with every start row = S (causal with no window: the same K9
    tile body, with no tile skipped by the window), which it must take
    less than half of (the visible work is 4.3x smaller): the ratio
    measures the block skipping alone. Causal flash (K1 + K2 through
    `scaled_dot_product_attention`) at the same shape is timed and
    printed beside them. Returns the phase's counts."""
    import torch
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.nn.functional import extended
    from paddle_tpu_torch.ops import _cuda_common
    from paddle_tpu_torch.ops.flashmask import flashmask_attention_reference

    s, h, d = FM_SEQ, 16, 128
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(1, s, h, d, device="cuda", generator=g,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    idx = _fm_window_starts(s, heads=1)[..., None]     # [1, 1, S, 1]

    def run():
        return PF.flashmask_attention(q, k, v, idx, causal=True)

    def plain_raw(q_, k_, v_, start_rows, causal=False):
        return flashmask_attention_reference(q_, k_, v_, start_rows,
                                             causal)[0]

    def plain_run():
        kernel_raw = extended.flashmask_attention_raw
        extended.flashmask_attention_raw = plain_raw
        try:
            return run()
        finally:
            extended.flashmask_attention_raw = kernel_raw

    counts, rec = _api_grad_check("FLASHMASK", run, plain_run, (q, k, v))
    _exact(counts, dict.fromkeys(FM_KERNELS, 1))
    do = torch.randn(q.shape, device="cuda", generator=g,
                     dtype=torch.bfloat16)
    fm_ms = _time_ms(lambda: torch.autograd.grad(run(), (q, k, v), do))
    no_window = torch.full_like(idx, s)
    _cuda_common.reset_launch_counts()
    causal_fm_ms = _time_ms(lambda: torch.autograd.grad(
        PF.flashmask_attention(q, k, v, no_window, causal=True),
        (q, k, v), do))
    causal_counts = _cuda_common.launch_counts()
    assert all(causal_counts[n] > 0 for n in FM_KERNELS) and not \
        causal_counts["flash_attention_fwd"], causal_counts
    _cuda_common.reset_launch_counts()
    flash_ms = _time_ms(lambda: torch.autograd.grad(
        PF.scaled_dot_product_attention(q, k, v, is_causal=True),
        (q, k, v), do))
    flash_counts = _cuda_common.launch_counts()
    assert flash_counts["flash_attention_fwd"] > 0 and not any(
        flash_counts[n] for n in FM_KERNELS), flash_counts
    ratio = fm_ms / causal_fm_ms
    _say("FLASHMASK", {"shape": [1, s, h, d], "window": FM_WINDOW,
                       "grad_check": rec, "launches": counts,
                       "fwd_bwd_ms": fm_ms,
                       "no_window_fwd_bwd_ms": causal_fm_ms,
                       "causal_flash_fwd_bwd_ms": flash_ms, "ratio": ratio})
    assert ratio < 0.5, ratio
    return counts


#: the tensor-core kernels, each built at padded head dims 64 and 128:
#: with LenCausalMask (K1/K1v, K2/K2v) all three, with StartRowMask (K9)
#: the forward and dK/dV
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
              "flash_bwd_dkv_tc_kernel")
TC_SOURCES = {"csrc/flash_attention_fwd.cu": 2,
              "csrc/flash_attention_bwd.cu": 4,
              "csrc/flashmask_attention.cu": 4}


def tc_usage():
    """PTXAS: registers, stack and spills of the tensor-core kernels (bf16
    K1/K1v, K2/K2v dQ and K2/K2v dK/dV at each padded head dim; the
    varlen entries instantiate the same kernels; K9's forward and dK/dV
    at each padded head dim), from the build's `-Xptxas -v` output, and
    any ptxas line on their wgmma pipeline (a serialized pipeline is
    slow, not wrong). Their accumulators live in registers: none may
    spill, and each source holds the count of TC_SOURCES."""
    from paddle_tpu_torch.ops import _cuda_common

    usage, notes = {}, []
    for rel, want in TC_SOURCES.items():
        found = 0
        for name, use in _cuda_common.ptxas_usage(rel).items():
            for kernel in TC_KERNELS:
                if kernel in name:
                    dp = 64 if "ILi64E" in name else 128
                    mask = "StartRowMask" if "StartRowMask" in name \
                        else "LenCausalMask"
                    usage[f"{kernel}<{dp}, {mask}>"] = use
                    found += 1
        assert found == want, (rel, found)
        with open(f"{_cuda_common._lib_path(rel)}.log") as f:
            notes += [ln.strip() for ln in f if "wgmma" in ln]
    _say("PTXAS", usage)
    if notes:
        _say("PTXAS_WGMMA", notes)
    assert len(usage) == sum(TC_SOURCES.values()), usage
    spilled = {k: u for k, u in usage.items()
               if u.get("spill_stores") or u.get("spill_loads")
               or u.get("stack")}
    assert not spilled, spilled


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import _cuda_common

    device_name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"DEVICE {device_name} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    replaced_build = start_replaced_build()
    _cuda_common.build_kernels()
    replaced = replaced_library(*replaced_build)
    _say("BUILD", {"seconds": time.perf_counter() - t0,
                   "kernels": sorted(_cuda_common.KERNEL_SOURCES)})
    tc_usage()
    phases = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()

    flash = [flash_case(1, 16, 16, s) for s in (128, 500, 512, 1024)]
    flash.append(flash_case(1, 16, 4, 512))
    # K1 at the shape the LLaMA train step launches it
    flash_train = flash_case(TRAIN_BATCH, 16, 16, TRAIN_SEQ)
    # K2 at the train shape, a GQA case and a ragged length
    bwd = [flash_bwd_case(TRAIN_BATCH, 16, 16, TRAIN_SEQ),
           flash_bwd_case(1, 16, 4, 512), flash_bwd_case(1, 16, 16, 500)]
    dec = decode_case()
    # the 1B serve's int4 matmuls: decode (M = 8 slots) q/k/v/o,
    # gate/up, down; the f32 lm_head; one prefill bucket (M = 512)
    qmm = [qmm_case(8, 2048, 2048), qmm_case(8, 2048, 5504),
           qmm_case(8, 5504, 2048), qmm_case(8, 2048, 32000, "float32"),
           qmm_case(512, 2048, 5504)]
    dec_q = {fmt: quant_decode_case(fmt) for fmt in ("int8", "int4")}
    # K3-K5 at the train step's shapes (rows 4 x 1024, hidden 2048,
    # intermediate 5504, q/k [4, 1024, 16, 128], bf16) and a ragged f32 size
    rows = TRAIN_BATCH * TRAIN_SEQ
    norm = fused_norm_cases(rows, CFG_1B["hidden_size"], "train")
    rope = rope_cases(TRAIN_BATCH, TRAIN_SEQ, 16, 128, "train")
    swi = swiglu_cases(rows, CFG_1B["intermediate_size"], "train")
    fused_norm_cases(66, 64, "tiny", "float32", "float32")
    rope_cases(2, 33, 4, 16, "tiny", "float32")
    swiglu_cases(66, 128, "tiny", "float32")
    # K3-LN and K6 at the GPT and BERT train steps' shapes (GPT 4 x 1024
    # rows of 1024, both kinds; BERT 64 x 128 rows of 768), a ragged size;
    # K1/K2 at head_dim 64: GPT causal B4 H16 S1024, BERT non-causal B64
    # H12 S128
    ln_gpt = layer_norm_cases(GPT_BATCH * GPT_SEQ, CFG_GPT["hidden_size"],
                              "gpt")
    ln_bert = layer_norm_cases(BERT_BATCH * BERT_SEQ, 768, "bert", add=False)
    layer_norm_cases(66, 80, "tiny")
    drop = dropout_add_cases(BERT_BATCH * BERT_SEQ, 768, "bert")
    dropout_add_cases(3, 37, "tiny")
    flash64 = {"gpt": flash_case(GPT_BATCH, 16, 16, GPT_SEQ, 64),
               "bert": flash_case(BERT_BATCH, 12, 12, BERT_SEQ, 64,
                                  causal=False)}
    bwd64 = {"gpt": flash_bwd_case(GPT_BATCH, 16, 16, GPT_SEQ, 64),
             "bert": flash_bwd_case(BERT_BATCH, 12, 12, BERT_SEQ, 64,
                                    causal=False)}
    # shapes the reference's kernels take beyond the main paths': K1/K2 at
    # head dim 256 (B1 H16 S1024 causal, the CUDA-core bodies), K7 / K7q-
    # int8 at GQA group 3 (48 query heads over 16) and at head dim 256,
    # and K3 RMS at hidden 16384 (the backward's wide path)
    flash256 = flash_case(1, 16, 16, 1024, 256)
    bwd256 = flash_bwd_case(1, 16, 16, 1024, 256)
    dec_wide = {"group 3": decode_case(heads=48, kv_heads=16, tag="group 3"),
                "d256": decode_case(d=256, tag="d256")}
    dec_q_wide = {tag: quant_decode_case("int8", tag=tag, **kw)
                  for tag, kw in (("group 3", {"heads": 48, "kv_heads": 16}),
                                  ("d256", {"d": 256}))}
    norm_wide = fused_norm_cases(4096, 16384, "wide")
    phases["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, counts = serve()
    profile_decode(model)
    counts_q4 = serve_quant(model, "int4", "int4", 16, "SERVE_Q4")
    counts_q8 = serve_quant(model, "int8", "int8", 8, "SERVE_Q8")
    profile_decode(model, tag="PROFILE_Q4", weight_quant="int4",
                   kv_cache_dtype="int4")
    del model                     # the serving weights; TRAIN builds its own
    torch.cuda.empty_cache()
    phases["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tmodel, opt, ids, counts_train = train()
    profile_train(lambda: _train_step(tmodel, opt, ids, ids))
    train_unfused(tmodel, opt, ids)
    for cnt in (counts, counts_q4, counts_q8, counts_train):
        assert all(cnt[n] == 0 for n in LN_DROPOUT_KERNELS), cnt
    del tmodel, opt, ids
    torch.cuda.empty_cache()
    phases["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts_gpt = train_gpt()
    torch.cuda.empty_cache()
    counts_bert = train_bert()
    for cnt in (counts, counts_q4, counts_q8, counts_train, counts_gpt,
                counts_bert):
        assert all(cnt[n] == 0 for n in VARLEN_KERNELS + FM_KERNELS), cnt
    torch.cuda.empty_cache()
    phases["train_gpt_bert"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # K1v/K2v at the VARLEN batch; K9 at the FLASHMASK window and at a
    # ragged S with random start rows (straddling tiles everywhere)
    varlen = varlen_cases()
    fm = flashmask_cases(FM_SEQ, _fm_window_starts, "window", replaced)
    g = torch.Generator(device="cuda").manual_seed(3)
    flashmask_cases(4100, lambda s, h: torch.randint(
        1, s + 1, (1, h, s), device="cuda", generator=g,
        dtype=torch.int32), "random", replaced)
    torch.cuda.empty_cache()
    counts_varlen = varlen_phase()
    torch.cuda.empty_cache()
    counts_fm = flashmask_phase()
    phases["attention_apis"] = time.perf_counter() - t0
    _say("PHASES", {"seconds": phases})

    main_flash = flash[2]                  # S = 512, a prefill bucket
    paged_src = "paddle_tpu_torch/csrc/paged_decode.cu"
    paged_tpu = "paddle_tpu/ops/pallas_decode.py:71"
    summary = []
    # each kernel's launches come from the run of its own path
    for rec, src, replaces, cnt in (
            (main_flash, "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             "paddle_tpu/ops/pallas_attention.py:104", counts),
            (dec, paged_src, paged_tpu, counts),
            (dec_q["int8"], paged_src.replace(".cu", "_int8.cu"), paged_tpu,
             counts_q8),
            (dec_q["int4"], paged_src.replace(".cu", "_int4.cu"), paged_tpu,
             counts_q4),
            (qmm[1], "paddle_tpu_torch/csrc/quant_matmul.cu",
             "paddle_tpu/ops/quantized.py:144", counts_q4)):
        summary.append({
            "name": rec["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": cnt[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
            | {k: rec[k] for k in ("varlen_full_ms", "body") if k in rec})
    # K1 at TRAIN's shape, launched by TRAIN's steps
    summary.append({
        "name": flash_train["name"], "case": "train", "route": "cuda",
        "body": flash_train["body"],
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_attention.py:104",
        "launches": counts_train[flash_train["name"]],
        "max_abs_err": flash_train["max_abs_err"], "ms": flash_train["ms"],
        "varlen_full_ms": flash_train["varlen_full_ms"],
        "plain_ms": flash_train["plain_ms"],
        "bound_ms": flash_train["bound_ms"],
        "bound_by": flash_train["bound_by"],
        "library_ms": flash_train["library_ms"]})
    # K2's two kernels at the train shape, each with its own numbers
    for kname, key, line in (("flash_attention_bwd_dq", "dq", 263),
                             ("flash_attention_bwd_dkv", "dkv", 314)):
        rec = bwd[0][key]
        summary.append({
            "name": kname, "route": "cuda", "body": TC_BODY,
            "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
            "launches": counts_train[kname],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "varlen_full_ms": rec["varlen_full_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    # K3-K5 at the train step's shapes, one row per case; launches are the
    # entry point's count over TRAIN's counted steps (all its cases)
    for rec, line in ((norm["fwd"], 118), (norm["fwd_add"], 118),
                      (norm["bwd"], 160), (norm["bwd_add"], 160),
                      (rope["fwd"], 409), (rope["bwd"], 409),
                      (swi["fwd"], 509), (swi["bwd"], 515)):
        summary.append({
            "name": rec["name"], "case": rec["case"], "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_norm.cu",
            "replaces": f"paddle_tpu/ops/pallas_norm.py:{line}",
            "launches": counts_train[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    # K3-LN and K6 at the GPT and BERT shapes: launches from the phase
    # whose shape the row times (all its cases of the entry point)
    for rec, line, cnt in ((ln_gpt["fwd"], 118, counts_gpt),
                           (ln_gpt["fwd_add"], 118, counts_gpt),
                           (ln_gpt["bwd"], 160, counts_gpt),
                           (ln_gpt["bwd_add"], 160, counts_gpt),
                           (ln_bert["fwd"], 118, counts_bert),
                           (ln_bert["bwd"], 160, counts_bert),
                           (drop["fwd"], 573, counts_bert),
                           (drop["bwd"], 580, counts_bert)):
        summary.append({
            "name": rec["name"], "case": rec["case"], "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_norm.cu",
            "replaces": f"paddle_tpu/ops/pallas_norm.py:{line}",
            "launches": cnt[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    # K1 and K2 at head_dim 64, each from its own phase
    for key, cnt in (("gpt", counts_gpt), ("bert", counts_bert)):
        rec = flash64[key]
        summary.append({
            "name": rec["name"], "case": f"{key} d64", "route": "cuda",
            "body": rec["body"],
            "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "paddle_tpu/ops/pallas_attention.py:104",
            "launches": cnt[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "varlen_full_ms": rec["varlen_full_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        for kname, part, line in (("flash_attention_bwd_dq", "dq", 263),
                                  ("flash_attention_bwd_dkv", "dkv", 314)):
            rec = bwd64[key][part]
            summary.append({
                "name": kname, "case": f"{key} d64", "route": "cuda",
                "body": TC_BODY,
                "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
                "launches": cnt[kname],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "varlen_full_ms": rec["varlen_full_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]})
    # K1v/K2v from VARLEN, K9 from FLASHMASK (with the time of the body
    # each K9 kernel replaced, where it replaced one)
    for rec, src, line, cnt in (
            (varlen["fwd"] | {"body": TC_BODY}, "flash_attention_fwd.cu",
             104, counts_varlen),
            (varlen["bwd"]["dq"] | {"name": "flash_attention_varlen_bwd_dq",
                                    "body": TC_BODY},
             "flash_attention_bwd.cu", 263, counts_varlen),
            (varlen["bwd"]["dkv"]
             | {"name": "flash_attention_varlen_bwd_dkv", "body": TC_BODY},
             "flash_attention_bwd.cu", 314, counts_varlen),
            (fm["fwd"], "flashmask_attention.cu", 856, counts_fm),
            (fm["bwd"]["dq"] | {"name": "flashmask_bwd_dq"},
             "flashmask_attention.cu", 1017, counts_fm),
            (fm["bwd"]["dkv"] | {"name": "flashmask_bwd_dkv"},
             "flashmask_attention.cu", 1072, counts_fm)):
        summary.append({
            "name": rec["name"], "route": "cuda", "body": rec["body"],
            "source": f"paddle_tpu_torch/csrc/{src}",
            "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
            "launches": cnt[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
            | {k: rec[k] for k in ("replaced_ms", "replaced_body")
               if k in rec})
    # the shapes beyond the main paths' (no path runs these shapes:
    # launches is the entry's count on the path named in launches_path,
    # at that path's shapes)
    attn = "paddle_tpu/ops/pallas_attention.py"
    for rec, src, replaces, cnt, path, name in (
            (flash256, "flash_attention_fwd.cu", f"{attn}:104", counts_train,
             "TRAIN", "flash_attention_fwd"),
            (bwd256["dq"] | {"body": bwd256["body"]},
             "flash_attention_bwd.cu", f"{attn}:263", counts_train, "TRAIN",
             "flash_attention_bwd_dq"),
            (bwd256["dkv"] | {"body": bwd256["body"]},
             "flash_attention_bwd.cu", f"{attn}:314", counts_train, "TRAIN",
             "flash_attention_bwd_dkv"),
            (dec_wide["group 3"], "paged_decode.cu", paged_tpu, counts,
             "SERVE", "paged_decode_attention"),
            (dec_wide["d256"], "paged_decode.cu", paged_tpu, counts, "SERVE",
             "paged_decode_attention"),
            (dec_q_wide["group 3"], "paged_decode_int8.cu", paged_tpu,
             counts_q8, "SERVE_Q8", "paged_decode_attention_int8"),
            (dec_q_wide["d256"], "paged_decode_int8.cu", paged_tpu,
             counts_q8, "SERVE_Q8", "paged_decode_attention_int8"),
            (norm_wide["fwd"], "fused_norm.cu",
             "paddle_tpu/ops/pallas_norm.py:118", counts_train, "TRAIN",
             "fused_rms_norm_fwd"),
            (norm_wide["bwd"], "fused_norm.cu",
             "paddle_tpu/ops/pallas_norm.py:160", counts_train, "TRAIN",
             "fused_rms_norm_bwd")):
        summary.append({
            "name": name, "case": rec.get("case") or "d256",
            "route": "cuda", "source": f"paddle_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": cnt[name],
            "launches_path": path,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
            | {k: rec[k] for k in ("body",) if k in rec})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
