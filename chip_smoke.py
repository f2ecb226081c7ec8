#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (H100): the port's main
path, end to end, through its hand-written kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. environment: the card's name and power limit;
  2. build: every CUDA kernel of the port, from the sources in the
     checkout (nvcc, sm_90a, one process per source, in parallel); then
     the tensor-core kernels' registers and spills from ptxas (K1/K2's
     and K9's; none may spill), those of the paged-decode kernels the
     serve paths launch, those of the int4 dequant-matmul's (K8) bodies
     and those of the fused-norm backward's row kernel and its dw / db
     sum (none may spill), and those of the fused optimizer pass (no
     spill, no stack frame);
  3. kernels: each kernel at the main path's shapes (bf16; the int4
     dequant-matmul (K8) at the serve's three layer shapes for decode (M
     8) and prefill (M 64 and 512), each bf16 case also on the CUDA-core
     body bf16 ran before (`replaced_ms`, the same C entry), and at the
     f32 lm_head shape (M 1 and 8); the fused norm, rotary
     and SwiGLU kernels at the train step's shapes and dtypes, and at a
     ragged f32 size; the LayerNorm kinds of the fused norm (K3-LN) and
     dropout + add (K6) at the GPT and BERT steps' shapes, and the flash
     kernels at their head_dim 64), held against its plain PyTorch
     version on the same
     inputs, and timed (CUDA events, median of 30 after warm-up, device
     time only) beside the plain version, one PyTorch library call as a
     yardstick where one computes the same function, and the card's bound
     for the work (the norms, forward and backward, also by their kernels'
     own device time with the L2 flushed by a write and by a read, the
     backward's second kernel's share of it, and by events with the L2
     flushed by a read; the backward beside its launch plan); K1 at
     the training shapes (TRAIN's, GPT's and BERT's) as the training
     paths call it, with o's rounding residual (`flash_case`), timed
     beside the call without it; K1 (also at TRAIN's shape) and K2 dQ
     and dK/dV beside the same call through the varlen entry with every kv length
     = S (`varlen_full_ms`: K1v's and K2v's forced per-element masks, on
     the same tensor-core bodies). The quantized
     paged-decode kernels read caches written by the port's own
     int8/int4 prefill scatters; K7 also at two long contexts of a
     4096-token table (the split-K case), and each decode kernel must
     give the same bits twice. Beyond the main paths' shapes: K1 and
     K2 at head dim 256 (B1 H16 S1024 causal, the CUDA-core bodies), K7
     and K7q-int8 at GQA group 3 (48 query heads over 16) and at head
     dim 256, and K3 RMS at 4096 x 16384 (the backward's wide path);
  3b. optim: the fused Adam pass (`fused_adam`) over each training
     path's parameter list as O2 leaves it (LLaMA 1B; GPT-3 medium's bf16
     and f32 groups; BERT-base's), AdamW with TRAIN's lr and decay, and
     the Momentum pass (`fused_momentum`, nesterov) over LLaMA's, each
     held bit for bit against its plain version on copies of the same
     inputs and timed beside it and `torch._fused_adamw_` (torch's rule,
     a yardstick of time) or `torch._fused_sgd_`; then AdamW and Momentum
     with use_multi_tensor=True take OPTIM_STEPS steps over LLaMA's list
     through `opt.step()`: one launch a step each;
  4. serve: LLaMA at the 1B geometry (hidden 2048, 20 layers, 16 heads,
     vocab 32000, bf16, random weights from seed 0) behind the paged
     ServingEngine (8 slots, 16-token blocks) answers 16 greedy requests;
     every decode tick, prefill and chunk of every serve phase replays a
     CUDA graph the engine captured at its key's first call, and each
     serve line gives the graphs captured by site, their capture wall
     and ms a decode tick over the ticks that captured nothing
     (`decode_ms_per_tick_steady`). Both kernels' launch counts must
     equal prefills x 20 and decode ticks x 20 (a replay counts the
     launches its capture made), and two requests' tokens are checked
     against a teacher-forced recompute through the plain attention
     functions; SERVE_WARM sends the same requests through the same
     engine again (no capture; the tokens must repeat). SERVE and the
     phases after it up to SERVE_PREFIX pass prefix_cache=False and
     chunked_prefill_tokens=0 (whole-prompt prefill), so their lines stay
     comparable with the runs before the prefix cache;
  5. profile: device time of steady decode ticks (graph replays) by
     kernel kind (the paged decode's splits and merge among them),
     beside the host wall (torch.profiler);
  6. serve_q4: the same 16 requests with int4 weights and an int4 KV
     cache: every layer matmul and the lm_head through the dequant-matmul
     kernel ((prefills + ticks) x 141 launches), decode through the int4
     paged-decode kernel (ticks x 20), none through the model-dtype one;
     then serve_q8: 8 of them with int8 weights (plain torch: no
     dequant-matmul launch) and an int8 KV cache (ticks x 20 int8
     paged-decode launches). Two requests of each are replayed teacher-
     forced through the same step functions, one slot, with the plain
     versions of every kernel passed explicitly;
  7. profile_q4: phase 5 for the int4 engine; profile_prefill: device
     time of one 512-token prefill by kernel kind, bf16 beside int4;
  7b. serve_prefix: the engine at its defaults (prefix cache on,
     256-token chunks; 8 slots, 16-token blocks, bf16) serves a
     shared-prefix stream: 24 requests behind one 448-token system prompt
     with unique 16-96-token suffixes, 2 repeating earlier requests' whole
     prompts (copy-on-write) and a follow-up turn (request 0's prompt +
     completion + 32 tokens); request 0 runs alone to its first token,
     then the rest are queued. Prefix hits must be > 0, the pool must
     account for every block (free + cached = blocks - 1, every refcount
     0), K1 must launch layers x (requests on the whole-prompt path) and
     K7 decode ticks x layers, and two cached requests are checked
     teacher-forced through the plain attention. SERVE_PREFIX_OFF runs the
     same stream with the cache off (its greedy agreement with the cache-on
     run is printed, not asserted); SERVE_PREFIX_Q4 six requests with int4
     weights and an int4 KV cache (K8 inside the chunk program, the int4
     chunk scatter); profile_chunk: device time of single chunks (a cold
     prompt's first and last 256-token chunk, a 64-token suffix behind a
     cached prefix) by kernel kind beside the host wall;
  7c. serve_graph_eager: SERVE's requests and SERVE_PREFIX's stream
     through engines that run the same programs eagerly (`_capture =
     False`): the greedy tokens and every launch count must equal the
     graph engines', and ms a tick, ms a chunk and TTFT of both print side
     by side (SERVE_EAGER, SERVE_PREFIX_EAGER, SERVE_GRAPH_EAGER);
  7d. serve_graph_steady: an 8-slot engine at its defaults warms every
     bucket of its stream, finish_warmup(), then at least 20 steady
     ticks capture nothing;
  8. train: on a clean device (a garbage collection, the cache emptied,
     no serving engine alive; every TRAIN* line prints the memory
     allocated at its start, which may exceed the phase's own parameters,
     gradients and optimizer state by ALLOC_SLACK_GB at most), LLaMA at
     the 1B geometry (bf16 O2 via amp.decorate with bf16 AdamW moments,
     AdamW lr 1e-4, random weights from seed 0, the chunked fused CE)
     takes training steps on one batch of 4 x 1024 seeded ids, labels =
     ids, with FLAGS_pallas_fused_ops at its default (True). First one step's
     gradients through the kernels (K1 forward, K2 backward, the fused
     RMSNorm K3, rotary K4 and SwiGLU K5 both ways) are held against the
     same step through the plain compositions and the plain attention
     (`_layer_forward_prefill`, autograd of `flash_attention_reference`);
     then 6 steps, counted: K1 and both K2 kernels launch steps x 20
     times, K3 steps x 41 each way, K4 steps x 40, K5 steps x 20 each
     way, the AdamW pass steps x 183 (one launch a parameter); the losses
     are finite and fall;
  9. profile_train: one steady training step under torch.profiler, device
     time by kernel kind beside the host wall;
 10. train_unfused: the same model and batch with the flag False (the
     plain compositions; no K3-K5 launch), then the fused step again, so
     ms per step and peak memory of both come from one card in one run;
     no LLaMA phase launches K3-LN or K6;
 10b. train_recompute: bench.py `bench_llama_1b`'s configuration, TRAIN's
     with use_recompute=True, at the granularities flash_resident, full
     and mlp, a model each from seed 0 on a clean device: flash_resident
     takes the gradient check against the plain side and prints its
     largest difference from the same model's step without recompute;
     each takes 6 counted steps with exact launches (`_llama_launches`:
     K1 20 a step under flash_resident and mlp, 40 under full), falling
     losses, and flash_resident's peak must lie below TRAIN's; then one
     profiled step each (PROFILE_TRAIN_RECOMPUTE_<GRANULARITY>);
 10c. ce_chunk: the fused linear cross-entropy alone, forward +
     backward, at LLaMA 1B's head (the vocab path, 5 slices of 6400) and
     GPT-3 medium's (the token path, 1024-token chunks), bf16, against
     its unchunked plain version: ms, peak memory and error (CE_TOL);
 11. train_gpt: GPT-3 medium (vocab 50304, hidden 1024, 24 layers, 16
     heads; bf16 O2, AdamW lr 1e-4) on 4 x 1024 seeded ids, labels = ids:
     one step's gradients through the kernels held against the same step
     with no kernel of the path (the flag off, autograd of the plain
     attention), 6 counted steps with exact launches (K1 and both K2
     kernels 24 per step, K3-LN 49 each way, the fused AdamW pass twice,
     one launch per dtype group, nothing else), one profiled step;
 12. train_bert: BERT-base sequence classification (vocab 30522, hidden
     768, 12 layers, dropout 0.1; bf16 O2, AdamW lr 2e-5) on 64 x 128
     seeded ids with binary labels: the same checks, with the dropout
     masks drawn alike on both sides, and exact launches (K1 and both K2
     kernels 12 per step, K3-LN 25 and K6 24 each way, the AdamW pass
     once per parameter with a gradient). No phase before
     this point launches a varlen (K1v/K2v) or FlashMask (K9) kernel;
 13. kernels of the last slice: K1v and K2v at the VARLEN batch, K9 at the
     FLASHMASK window and at S 4100 with random start rows, each against
     its plain version and timed as in phase 3, SDPA with the equivalent
     boolean mask as the yardstick;
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
     the same shape;
 16. static: first AMP_MODE_COST (TRAIN's eager bench step with the
     models under the AMP mode at O2 against suspended, in turns, at
     1 x 128 and 4 x 1024); then the training steps as bench.py writes
     them, each step function under `jit.to_static(share_discovery=
     True)` with `auto_cast` inside and backward, step, clear_grad after
     it, primed
     twice at 1 x 128 (BERT 2 x 128; warm-up and discovery), then
     TRAIN_STEPS steps at the big batch, the first of which captures the
     big key's CUDA graph and every one replays it; beside the same step
     run eagerly from the same weights and batch (primed alike): the
     losses within STATIC_TOL (bit-identical expected), the launches of
     every replay equal to the eager step's and exact per step, one
     graph and no break, ms a step, tokens (sequences) per second, the
     busy share of one profiled replay, the capture seconds, the peak
     memory and what was allocated at the start, each beside the eager
     step's. STATIC_TRAIN (TRAIN's configuration), STATIC_RECOMPUTE
     (flash_resident, bench.py `bench_llama_1b`), STATIC_GPT
     (`bench_gpt_medium_sharding`'s step without group_sharded_parallel),
     STATIC_BERT (`bench_bert(amp=True)`; each step's dropout masks from
     one seed on both sides, then two replays of a captured dropout must
     draw different masks), and TRAIN_O1 (`bench_llama_train(amp=False)`:
     the 168M LLaMA with f32 parameters under auto_cast(O1, bf16),
     8 x 1024: first the per-op dtype count of one forward, matmuls in
     bf16, norms and the loss in f32, and one step's gradients against
     the plain versions within GRAD_TOL);
 17. train_f16_scaler: TRAIN_O1's model under auto_cast(O1, float16) with
     GradScaler(init_loss_scaling=2**15), eagerly and captured: K1 and K2
     run in f16 (F7); a non-finite gradient injected at the third big step
     is skipped eagerly and masked in the graph (the reference's traced
     branch), the scale halves in both and the scalers' state dicts
     agree. Phase 3 also holds F7's float16 kernels (K1, K2, K1v, K2v,
     K9, K7 on the CUDA-core bodies) against their plain versions
     (F16_TOL) with their times and bounds;
 18. tensor_ops: the Tensor API (`paddle_tpu_torch.Tensor` and its ops)
     on the card. Every row (418) of the port's op table
     (paddle_tpu_torch/ops/op_table*.py), on its own seeded numpy
     inputs, on CUDA Tensors: the fp32 forward against the row's numpy
     `ref` and against the same row on the CPU at the row's tolerances,
     the bf16 forward against the fp32 one at TENSOR_BF16_TOL, and for a
     differentiable row the fp32 gradient of out.sum() against the CPU
     gradient at the row's tolerances; every output and gradient on the
     card. One line: rows, passed, the failures with their max error,
     seconds; any failure fails the run;
 19. dygraph: one LLaMA 1B decoder layer at full width (hidden 2048, 16
     heads x 128, intermediate 5504, batch 4 x 1024, bf16, the model's
     rope tables) written on the Tensor surface (rms_norm, matmuls,
     reshape, rotary_position_embedding, scaled_dot_product_attention,
     fused_add_rms_norm, swiglu, add), its nine Parameters carried from
     layer 0 of TRAIN's model (seed 0, O2): one step's gradients against
     the same layer's `LlamaDecoderLayer.forward` on torch tensors within
     GRAD_TOL of each tensor's largest |value|, launches exact (K1 1, K2
     1 + 1, K3 2 + 2, K4 1 + 1, K5 1 + 1, fused_adam 9 a step) over
     DYGRAPH_STEPS AdamW steps whose loss falls; ms a step (median of
     steps 2..) beside the torch layer's step, the host's ms by part of
     the step (forward, backward, optimizer, clear_grad issued without a
     sync, then the wait for the card; the two surfaces' steps
     alternating) and the card's ops a step, each beside the torch
     layer's, and the wrapper's host cost (µs an op
     over a chain of 200 adds on 16-element CUDA Tensors beside the same
     chain on torch tensors); then DYGRAPH_STATIC, the
     same step under jit.to_static: one graph, no break, losses within
     STATIC_TOL of the eager steps', launches per replay equal to the
     eager step's, replay ms and capture seconds;
 20. nn_quickstart: the README's quick start on `paddle_tpu_torch.nn`
     at its own width (Sequential of Linear 784 -> 256, ReLU, Linear 256
     -> 10; AdamW 1e-3; F.cross_entropy; one seeded batch of 64): 20
     steps eagerly and the same 20 under jit.to_static from the same
     seed: the losses fall, one key, one graph and no break, captured
     losses within STATIC_TOL of the eager ones;
 21. nn_transformer: BERT-base's encoder as nn layers
     (nn.TransformerEncoder of 12 nn.TransformerEncoderLayer(768, 12,
     3072, dropout 0.1, GELU, attn_dropout 0), post-LN) at TRAIN_BERT's
     64 x 128 tokens, amp.decorate O2 bf16 (the LayerNorms f32), AdamW
     2e-5, an MSE loss against a seeded target: one step's gradients
     through the kernels against the plain path within GRAD_TOL of each
     tensor's largest |value|; the state_dict through paddle.save /
     paddle.load bit for bit on the card; then 6 steps eagerly and the
     same under jit.to_static (`_static_phase`: the dropout masks drawn
     alike, captured losses within STATIC_TOL, ms a step eager and
     captured, device ms, busy share, peak memory) with exact launches a
     step: K1 12, K2 12 + 12, K3-LN 24 + 24 (post-LN adds the residual
     outside the norm, so the plain kind), fused_adam one a parameter,
     K6 none;
 22. incubate_fused: each kernel path of incubate.nn.functional
     (`fused_rms_norm` with and without `residual` at 4096 x 2048 bf16,
     `fused_layer_norm` at 8192 x 768, `fused_rotary_position_embedding`
     at 4 x 1024 x 16 x 128, `swiglu` at 4096 x 5504,
     `fused_dropout_add` at 8192 x 768), forward and backward: exactly one
     launch of K3 / K3-LN / K4 / K5 / K6 each way by the counters, the
     outputs and gradients within FUSED_TOL of the kernels' plain
     versions;
 23. signal: `signal.stft` / `istft` over 16 signals of 160,000 samples
     (n_fft 512, hop 160, Hann): the round trip, the card's spectrum
     against the CPU's and `fft.fft` / `rfft` / `fft2` against the CPU's,
     within SIGNAL_TOL; the ms of each transform;
 24. models_layer: LLaMA 1B, GPT-3 medium and BERT-base as `nn.Layer`s:
     state_dict keys and shapes by the reference's naming rule, every
     parameter a Tensor API `Parameter`, the O2 bf16 state through
     paddle.save / paddle.load bit for bit, the parameter bytes; with the
     Layer models' numbers of the earlier phases (STATIC_TRAIN / _GPT /
     _BERT captured device ms, SERVE's steady ms a tick, CE_CHUNK_LLAMA's
     ms, TRAIN's peak GB);
 25. host_dispatch: what the Layer models' Python dispatch costs the
     host in TRAIN_GPT's and TRAIN_BERT's eager steps (their models,
     batches and optimizers): the step's host ms by part with the op
     boundary on the models' inner forwards, alternated with the same
     step with it taken off them; one `nn.Linear` and one `nn.LayerNorm`
     call's host µs on torch tensors under the O2 rule against the call
     beneath it (`F.linear`, K3-LN's wrapper), with the number of `nn`
     layer calls in one forward.

The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}. Without a CUDA card it exits 1 and prints
no result.

`python3 chip_smoke.py --host-parts DIR` runs one measurement alone on
the port's package under DIR (this checkout, or an unpacked older one):
the eager steps of TRAIN, TRAIN_GPT and TRAIN_BERT, alternated, with
each step's host ms by part and the garbage collector's collections
(the HOST_PARTS line), so that two trees' host time compares in one
call.
"""
import gc
import json
import os
import re
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
#: a residual `flash_case`'s fields that its kernels-line entries carry
RESIDUAL_KEYS = ("no_residual_ms", "residual_mean_abs_err",
                 "residual_max_abs_err", "rounded_mean_abs_err")
#: the training phase: batch x sequence of seeded ids, counted steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6
#: TRAIN_RECOMPUTE's granularities, bench.py `bench_llama_1b`'s first
#: rung (flash_resident at batch 4) first
RECOMPUTE_GRANS = ("flash_resident", "full", "mlp")
#: device memory a training phase may find allocated at its start beyond
#: the allocator's blocks of its own parameters, buffers, gradients and
#: optimizer state: torch's cuBLAS workspaces, 32 MiB per stream that ran
#: a GEMM (three such blocks before every training phase on an H100:
#: 0.10 GB), the ids and small per-stream buffers. The serve phases'
#: engines and anything they leave behind must be gone by then (a
#: dropped engine's KV pool alone is gigabytes)
ALLOC_SLACK_GB = 0.15
#: CE_CHUNK: the chunked loss vs its unchunked plain version from the
#: same bf16 inputs. The loss within 1e-4 relative (the same exact bf16
#: products summed in f32 in another order); dH and dW in bf16 within
#: 2^-7 of each tensor's largest |value|: each side rounds its f32 result
#: once to bf16 (2^-8 relative), and the token path also rounds dlogits
#: to bf16 before its two GEMMs, as the reference does (2^-9 relative per
#: term, random in sign over >= 1024 terms)
CE_TOL = {"loss": 1e-4, "grad": 2 ** -7}

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
#: K7 / K7q vs their plain versions from the same inputs, relative to each
#: sequence's largest |output| (a long context's outputs are averages of
#: ~1/sqrt(length) size, a short one's of the values' size; a sequence of
#: length 0 must give exactly 0). Both sides sum in f32 and round once to
#: bf16, so K7 differs by at most one bf16 ulp (2^-7 of a value's
#: binade); K7q's plain version also rounds the dequantized cache to bf16
#: before the softmax (the reference's XLA composition does) where the
#: kernel keeps it in f32: one more ulp (2^-6). One of 16 partitions of a
#: 4096-token context dropped moves its sequence by ~14x 2^-6
DECODE_TOL = {"model": 2 ** -7, "int8": 2 ** -6, "int4": 2 ** -6}

#: the fused norm, rotary and SwiGLU kernels (K3-K5) vs their plain
#: versions from the same inputs, relative to each output's largest
#: |value|: both compute in f32 and round each output once, so an f32
#: output differs by f32 rounding (1e-5), dw, a sum over 4096 rows taken
#: in another order, by more (1e-4), and a bf16 output by at most one
#: bf16 ulp (2^-7)
FUSED_TOL = {"float32": 1e-5, "dw_float32": 1e-4, "bfloat16": 2 ** -7}
#: SIGNAL: the STFT round trip, the card's spectrum against the CPU's and
#: the fft rows' (relative to the largest |value|)
SIGNAL_TOL = 1e-4
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
#: the serves before SERVE_PREFIX: the prefix cache off, prompts prefilled
#: whole (the engine's settings before it had either)
WHOLE_PROMPT = dict(prefix_cache=False, chunked_prefill_tokens=0)
#: SERVE_PREFIX's system prompt, shared by its requests (28 full blocks)
PREFIX_SYSTEM_TOKENS = 448


#: which body a flash-family kernel runs at bf16 (the summary's "body"):
#: the wgmma/TMA bodies of csrc/flash_attention_tc.cuh, or the f32-FMA
#: bodies of csrc/flash_attention_tiles.cuh
TC_BODY, CORE_BODY = "tensor cores", "cuda cores"


#: every line printed by `_say`, by tag (MODELS_LAYER reads earlier
#: phases' numbers from here)
_LINES = {}


def _say(tag, obj):
    _LINES[tag] = obj
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


def _decode_rel_err(out, ref):
    """The largest of each sequence's max |out - ref| over its max |ref|
    (inf where a sequence of output 0 gets anything else)."""
    diff = (out.float() - ref.float()).abs().flatten(1).amax(1)
    top = ref.float().abs().flatten(1).amax(1)
    return (diff / top).nan_to_num(nan=0.0).max().item()


def _host_us(fn, reps=200):
    """Host time of one fn() in µs, without synchronising: a wrapper's
    checks, allocations and launches (the card runs behind)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


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


def flash_case(b, hq, hkv, s, d=128, causal=True, residual=False):
    """Flash forward at one prefill or train shape: parity, times, bound,
    and the time of the same call through the varlen entry with every
    length = S (`varlen_full_ms`: K1v's forced masks on the same body).
    With `residual` (the training paths' variant, whose o's rounding
    residual the backward's delta takes): o and lse as without it, the
    residual within half a bf16 ulp of o, and on values spread 2^-6
    around a common row (where the rounding of o shows in the delta) o +
    o_res within a quarter of o's mean distance from the plain version's
    f32 O (its o + o_res: the tensor-core body's own O multiplies P
    rounded to bf16, which leaves about an eighth); `ms`, `plain_ms` and the bound are then the
    residual variant's (its bytes count the residual's write), and
    `no_residual_ms` times the call without it."""
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
    if residual:
        o2, lse2, res = flash_attention_fwd(q, k, v, causal, residual=True)
        assert torch.equal(o2, o) and torch.equal(lse2, lse)
        assert (res.float().abs() <= 2 ** -8 * o.float().abs()).all()
        vn = (v[:, :, :1].float() + 2 ** -6 * v.float()).to(v.dtype)
        on, _, rn = flash_attention_fwd(q, k, vn, causal, residual=True)
        ron, _, rrn = flash_attention_reference(q, k, vn, causal,
                                                residual=True)
        o32 = ron.float() + rrn.float()
        res_err = (on.float() + rn.float() - o32).abs()
        rounded_err = (on.float() - o32).abs().mean().item()
        assert res_err.mean().item() <= rounded_err / 4, \
            (res_err.mean().item(), rounded_err)
        bound, by = _bound_ms(flops, nbytes + 2 * b * hq * s * d)
        rec |= {
            "no_residual_ms": rec["ms"],
            "ms": _time_ms(lambda: flash_attention_fwd(q, k, v, causal,
                                                       residual=True)),
            "plain_ms": _time_ms(lambda: flash_attention_reference(
                q, k, v, causal, residual=True)),
            "bound_ms": bound, "bound_by": by,
            "residual_mean_abs_err": res_err.mean().item(),
            "residual_max_abs_err": res_err.max().item(),
            "rounded_mean_abs_err": rounded_err}
        del o2, lse2, res, vn, on, rn, ron, rrn, o32, res_err
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
    is evicted by the other 19 layers between two of its decode calls.
    Each sequence is held to DECODE_TOL; two calls must give the same bits
    (the split partials merge in split order); `splits` and `part` are
    `decode_splits`' choice, `host_us` the wrapper's host time per call."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.paged_decode import (
        decode_splits, paged_decode_attention,
        paged_decode_attention_reference)

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
    rel = _decode_rel_err(out, ref)
    assert torch.isfinite(out.float()).all()
    assert rel <= DECODE_TOL["model"], (tag, rel)
    assert torch.equal(out, paged_decode_attention(q, kc, vc, tables, lens))
    splits, part = decode_splits(
        pages, bs, seqs, kv_heads,
        torch.cuda.get_device_properties(0).multi_processor_count)
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
           "lens": lens_np.tolist(), "splits": splits, "part": part,
           "max_abs_err": err, "rel_err": rel, "tol": DECODE_TOL["model"],
           "ms": _time_ms(lambda: paged_decode_attention(
               q, kc, vc, tables, lens), flush),
           "plain_ms": _time_ms(lambda: paged_decode_attention_reference(
               q, kc, vc, tables, lens), flush),
           "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
               q[:, :, None], kd, vd, attn_mask=mask,
               enable_gqa=heads != kv_heads), flush),
           "bound_ms": bound, "bound_by": by,
           "host_us": _host_us(lambda: paged_decode_attention(
               q, kc, vc, tables, lens))}
    _say("KERNEL", rec)
    return rec


def qmm_case(m, k, n, dtype="bfloat16"):
    """The int4 dequant-matmul at one [m, k] @ [k, n] shape of the serve:
    parity, two calls bit for bit, times, bound. The L2 cache is flushed
    before each timed launch: in serving a layer's weight is evicted by
    the other layers' weights between two of its calls. A bf16 case is
    also timed on the CUDA-core body bf16 ran before it moved onto the
    tensor cores (the same C entry with tile_m 0 and that body's K split:
    `replaced_ms`), held to the plain version too."""
    import torch
    from paddle_tpu_torch.ops.quantized import (
        _core_splits, _launch, dequant_int4, kernel_route, quant_matmul_raw,
        quant_matmul_reference, quantize_int4, tc_tile_m)

    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(m * 7 + k + n)
    x = torch.randn(m, k, device="cuda", generator=g, dtype=tdt)
    w = torch.randn(k, n, device="cuda", generator=g,
                    dtype=torch.bfloat16) * 0.02
    packed, scale = quantize_int4(w)
    out = quant_matmul_raw(x, packed, scale, k)
    again = quant_matmul_raw(x, packed, scale, k)
    ref = quant_matmul_reference(x, packed, scale, k)
    torch.cuda.synchronize()
    top = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / top
    assert torch.isfinite(out.float()).all()
    assert rel <= QMM_TOL[dtype], (m, k, n, dtype, rel)
    assert torch.equal(out, again), (m, k, n, dtype, "repeat")
    body = kernel_route(k, tdt)
    w_deq = dequant_int4(packed, scale, k, tdt)       # yardstick's weight
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    size = 2 if dtype == "bfloat16" else 4
    nbytes = k // 2 * n + 4 * n + m * k * size + m * n * size
    bound, by = _bound_ms(2 * m * k * n, nbytes,
                          PEAK_BF16_FLOPS if dtype == "bfloat16"
                          else PEAK_F32_FLOPS)
    rec = {"name": "quant_matmul", "shape": [m, k, n], "dtype": dtype,
           "body": body, "tile_m": tc_tile_m(m) if body == TC_BODY else None,
           "max_abs_err": err, "rel_err": rel, "tol": QMM_TOL[dtype],
           "ms": _time_ms(lambda: quant_matmul_raw(x, packed, scale, k),
                          flush),
           "plain_ms": _time_ms(
               lambda: quant_matmul_reference(x, packed, scale, k), flush),
           "library_ms": _time_ms(lambda: torch.matmul(x, w_deq), flush),
           "bound_ms": bound, "bound_by": by}
    if body == TC_BODY:
        old = torch.empty_like(out)
        splits = _core_splits(m, k, n)
        _launch(x, packed, scale, old, k, 0, *splits)
        torch.cuda.synchronize()
        rep = (old.float() - ref.float()).abs().max().item() / top
        assert rep <= QMM_TOL[dtype], ("replaced", m, k, n, rep)
        rec |= {"replaced_body": CORE_BODY, "replaced_ms": _time_ms(
            lambda: _launch(x, packed, scale, old, k, 0, *splits), flush)}
    _say("KERNEL", rec)
    return rec


def quant_decode_case(fmt, seqs=8, heads=16, d=128, bs=16, max_len=1024,
                      kv_heads=None, tag="serve"):
    """The int8 or int4 paged decode at decode_case's shapes (same lengths
    and tables), over caches written by the port's own prefill scatter —
    so the per-block scales are the ones serving makes. Two calls must
    give the same bits."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.paged_decode import (
        KERNEL_NAMES, decode_splits, paged_decode_attention,
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
    rel = _decode_rel_err(out, ref)
    assert torch.isfinite(out.float()).all()
    assert rel <= DECODE_TOL[fmt], (fmt, tag, rel)
    assert torch.equal(out, paged_decode_attention(*args, kv_int4=int4))
    splits, part = decode_splits(
        pages, bs, seqs, kv_heads,
        torch.cuda.get_device_properties(0).multi_processor_count)
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
           "lens": lens_np.tolist(), "splits": splits, "part": part,
           "max_abs_err": err, "rel_err": rel, "tol": DECODE_TOL[fmt],
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
                  library, nbytes, flops, extra=None):
    """Hold one fused kernel's outputs `got` against its plain version's
    `want` (FUSED_TOL by output dtype; the outputs at indices `sums` are
    sums over rows, dw or db), time
    the kernel, its plain version and `library` (None: no single PyTorch
    call computes the function) with the L2 flushed before each launch
    (at these shapes the inputs come from earlier kernels of the step and
    exceed the 50 MB L2 together), print the KERNEL line (with `extra`'s
    fields) and return it."""
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
           "bound_ms": bound, "bound_by": by} | (extra or {})
    _say("KERNEL", rec)
    return rec


def _own_time(fn, key, per_call):
    """A norm kernel's own time, for the KERNEL line of `fn` (a call that
    launches `per_call` kernels whose names contain `key`):
    `kernel_ms`, their device time a call (torch.profiler: it leaves out
    the launch latency the events see) with the L2 flushed by a write, as
    `_time_ms` is timed; `kernel_ms_l2_clean` with the L2 flushed by a
    read (clean lines: no write-back of the flush's lines during the
    call), of which `sum_ms_l2_clean` is the backward's dw / db sum
    kernel's; and `ms_l2_clean`, the call timed by events with the L2
    flushed by a read. A profiler pass that recorded other than reps x
    per_call such kernels (the profiler drops some now and then) is taken
    again, up to three times; then the time is None, beside the counts it
    recorded (`kernels_recorded`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dirty = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    clean = torch.ones(24 << 20, device="cuda")
    sink = torch.empty((), device="cuda")

    def read_flush():
        torch.sum(clean, 0, out=sink)

    reps = 10
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    recorded = {}

    def kernel_ms(flush, tag):
        """{kernel name: device ms a call} over `reps` flushed calls, or
        None when no pass recorded reps x per_call kernels"""
        recorded[tag] = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    flush()
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if key in e.key and e.self_device_time_total]
            recorded[tag].append(sum(e.count for e in events))
            if recorded[tag][-1] == reps * per_call:
                return {e.key: e.self_device_time_total / reps / 1e3
                        for e in events}
        return None

    on_dirty = kernel_ms(dirty.zero_, "dirty")
    on_clean = kernel_ms(read_flush, "clean")
    sums = [v for k, v in (on_clean or {}).items() if "norm_bwd_sum" in k]
    out = {"kernel_ms": sum(on_dirty.values()) if on_dirty else None,
           "kernel_ms_l2_clean": sum(on_clean.values()) if on_clean
           else None,
           "ms_l2_clean": _time_ms(fn, read_flush)}
    if sums:
        out["sum_ms_l2_clean"] = sum(sums)
    if on_dirty is None or on_clean is None:
        out["kernels_recorded"] = recorded | {"want": reps * per_call}
    return out


def _fwd_extra(fn):
    """The norm forward's KERNEL-line extras: its kernel's own time
    (`_own_time`; one kernel a call)."""
    return _own_time(fn, "norm_fwd", 1)


def _bwd_extra(layer, fn, s, w, dy, ds=None):
    """The norm backward's KERNEL-line extras for `fn`, a call on s, w, dy
    (and ds): `plan`, the launch plan the wrapper takes for those tensors
    on this card, and its kernels' own time (`_own_time`: the row kernel
    and the dw / db sum, or the wide path's three kernels)."""
    import torch
    from paddle_tpu_torch.ops import fused_norm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    top = fused_norm.MAX_HIDDEN_LN if layer else fused_norm.MAX_HIDDEN
    plan = fused_norm.norm_bwd_plan_for(s, w, dy, ds, top, sms)
    return {"plan": plan._asdict()} | _own_time(
        fn, "norm_bwd", 2 if plan.route == "rows" else 3)


#: the norms' `_own_time` fields that their rows of the `kernels` line
#: carry: the times measured in this run (the backward's plan stays on its
#: KERNEL lines)
_BWD_MEASURED = ("kernel_ms", "kernel_ms_l2_clean", "sum_ms_l2_clean",
                 "ms_l2_clean", "kernels_recorded")


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
        xb * n + xb * h + yb * n + 4 * rows, 4 * n,
        _fwd_extra(lambda: fused_rms_norm_fwd(x, None, w, eps, ydt)))
    rstd = got[2]
    # forward, add variant: read x, res, w; write y, s, rstd
    got = fused_rms_norm_fwd(x, res, w, eps)
    want = rms_norm_fwd_reference(x, res, w, eps)
    out["fwd_add"] = _fused_record(
        "fused_rms_norm_fwd", f"{tag} add+rms {x_dtype}", (rows, h), got,
        want, (), lambda: fused_rms_norm_fwd(x, res, w, eps),
        lambda: rms_norm_fwd_reference(x, res, w, eps), None,
        2 * xb * n + xb * h + 2 * xb * n + 4 * rows, 5 * n,
        _fwd_extra(lambda: fused_rms_norm_fwd(x, res, w, eps)))
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
        xb * n + yb * n + xb * h + 4 * rows + xb * n + xb * h, 8 * n,
        _bwd_extra(False, lambda: fused_rms_norm_bwd(x, w, rstd, dy),
                   x, w, dy))
    # backward, add variant: read s, dy, ds, w, rstd; write dsum, dw
    out["bwd_add"] = _fused_record(
        "fused_rms_norm_bwd", f"{tag} add+rms {x_dtype}", (rows, h),
        fused_rms_norm_bwd(s_add, w, rstd_add, dya, ds),
        rms_norm_bwd_reference(s_add, w, rstd_add, dya, ds), (1,),
        lambda: fused_rms_norm_bwd(s_add, w, rstd_add, dya, ds),
        lambda: rms_norm_bwd_reference(s_add, w, rstd_add, dya, ds), None,
        3 * xb * n + xb * h + 4 * rows + xb * n + xb * h, 9 * n,
        _bwd_extra(False,
                   lambda: fused_rms_norm_bwd(s_add, w, rstd_add, dya, ds),
                   s_add, w, dya, ds))
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
        2 * n + 8 * h + 4 * n + 8 * rows, 7 * n,
        _fwd_extra(lambda: fused_layer_norm_fwd(x, None, w, b, eps,
                                                torch.float32)))
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
        2 * n + 4 * n + 4 * h + 8 * rows + 2 * n + 8 * h, 11 * n,
        _bwd_extra(True, lambda: fused_layer_norm_bwd(x, w, *stats, dy),
                   x, w, dy))
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
        2 * 2 * n + 8 * h + 2 * 2 * n + 8 * rows, 8 * n,
        _fwd_extra(lambda: fused_layer_norm_fwd(x, res, wb, bb, eps)))
    s_add, stats = got[1], (got[2], got[3])
    # backward, add variant: read s, dy, ds, w, rstd, mean; write dsum,
    # dw, db
    out["bwd_add"] = _fused_record(
        "fused_layer_norm_bwd", f"{tag} add+ln bfloat16", (rows, h),
        fused_layer_norm_bwd(s_add, wb, *stats, dya, ds),
        layer_norm_bwd_reference(s_add, wb, *stats, dya, ds), (1, 2),
        lambda: fused_layer_norm_bwd(s_add, wb, *stats, dya, ds),
        lambda: layer_norm_bwd_reference(s_add, wb, *stats, dya, ds), None,
        3 * 2 * n + 4 * h + 8 * rows + 2 * n + 8 * h, 12 * n,
        _bwd_extra(True,
                   lambda: fused_layer_norm_bwd(s_add, wb, *stats, dya, ds),
                   s_add, wb, dya, ds))
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


def _tick_timer(eng):
    """Wrap the engine's decode tick; returns the list it fills with each
    tick's (host wall s, whether the tick captured a graph)."""
    ticks = []
    decode = eng._decode

    def timed(active):
        before = sum(eng._captures)
        t0 = time.perf_counter()
        out = decode(active)
        ticks.append((time.perf_counter() - t0,
                      sum(eng._captures) > before))
        return out

    eng._decode = timed
    return ticks


def _graph_fields(eng, ticks):
    """A serve line's program fields: the graphs the engine captured, by
    site, their capture wall (dry run, capture, instantiation), and ms a
    decode tick over the ticks that captured nothing (`steady`)."""
    st = eng._graph_stats()
    steady = [w for w, captured in ticks if not captured]
    return {"graphs": eng._capture,
            "graphs_captured": st["graphs_captured"],
            "capture_s": st["capture_s"],
            "capture_s_by_site": st["capture_s_by_site"],
            "decode_ticks_steady": len(steady),
            "decode_ms_per_tick_steady": 1e3 * float(np.mean(steady))
            if steady else None}


def _serve_run(model, reqs, tag, eager=False, **engine_kw):
    """Warm an engine up, then drive `reqs` through a fresh one with every
    launch count set to 0 just before and read just after; `eager` runs
    the fresh one's programs without graphs. Prints the `tag` line;
    returns (engine, request ids, results, counts, the line)."""
    import torch
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops import _cuda_common

    # warm-up engine (kernel builds, cuBLAS handles, allocator pools); not
    # counted. Graphs are per engine: the counted one captures its own
    warm = ServingEngine(model, max_slots=8, kv_block_size=16, **engine_kw)
    warm.add_request(reqs[0][0][:64], max_new_tokens=4)
    warm.run()
    del warm

    eng = ServingEngine(model, max_slots=8, kv_block_size=16, **engine_kw)
    eng._capture = eng._capture and not eager
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
    ticks = _tick_timer(eng)
    gc.collect()     # engines an earlier phase dropped (timers make cycles)
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
    rec = {
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
        **_graph_fields(eng, ticks),
        "launches": counts}
    _say(tag, rec)
    return eng, rids, done, counts, rec


def _warm_pass(eng, reqs, rids, done, tag):
    """The same requests once more through the same engine, every key of
    theirs captured already: the graphs' numbers without a capture. The
    tokens must repeat and nothing may be captured. Prints the `tag`
    line and returns it."""
    import torch

    ticks = _tick_timer(eng)
    n_ttft, captures = len(eng.ttfts), sum(eng._captures)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert [out[r].tolist() for r in again] == [done[r].tolist()
                                                for r in rids]
    assert sum(eng._captures) == captures, eng._captures
    ttft = sorted(eng.ttfts[n_ttft:])
    rec = {"requests": len(reqs), "wall_s": wall, "decode_ticks": len(ticks),
           "decode_ms_per_tick": 1e3 * float(np.mean([w for w, _ in ticks])),
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p95_s": float(np.percentile(ttft, 95)),
           "captures": sum(eng._captures) - captures,
           "tokens_repeat": True}
    _say(tag, rec)
    return rec


def serve():
    """The main path: 16 greedy requests through the paged engine at the
    1B geometry, every tick and prefill a replayed CUDA graph, then the
    same requests again through the same engine (SERVE_WARM: no capture).
    Returns the model, the launch counts of the counted run and the run's
    record (requests, lines, counts, tokens)."""
    import torch
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**CFG_1B)
    torch.manual_seed(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    for p in model.parameters():
        p.stop_gradient = True
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    _say("MODEL", {"params": n_params, "init_s": time.perf_counter() - t0})

    reqs = _requests(cfg.vocab_size)
    eng, rids, done, counts, rec = _serve_run(model, reqs, "SERVE",
                                              **WHOLE_PROMPT)
    st = eng.stats()
    layers = cfg.num_hidden_layers
    assert counts["flash_attention_fwd"] == len(reqs) * layers, counts
    assert counts["paged_decode_attention"] == st["steps"] * layers, counts
    assert all(counts[n] == 0 for n in FUSED_KERNELS), counts

    _teacher_forced(eng, [(reqs[rid][0], done[rid]) for rid in rids[:2]],
                    "TEACHER_FORCED")
    warm = _warm_pass(eng, reqs, rids, done, "SERVE_WARM")
    return model, counts, {"reqs": reqs, "rec": rec, "warm": warm,
                           "counts": counts,
                           "tokens": [done[r].tolist() for r in rids]}


def _teacher_forced(eng, items, tag):
    """Teacher-forced greedy check through the PLAIN attention functions:
    each (prompt, generated tokens) pair recomputed in one full-sequence
    bf16 pass (`_layer_forward_prefill` with the plain flash attention);
    each generated token must be the recompute's argmax or within
    TIE_BOUND logits of it, and 90% must be the argmax."""
    import torch
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    from paddle_tpu_torch.text.generation import (_layer_forward_prefill,
                                                  _logits)

    params, spec = eng.params, eng.spec
    vocab = params["embed"].shape[0]
    cos, sin = params["rope_cos"], params["rope_sin"]
    agree = total = 0
    worst = 0.0
    with torch.no_grad():
        for prompt, gen in items:
            n = len(gen)
            ids = np.concatenate([prompt, gen[:-1]])
            x = params["embed"][torch.from_numpy(ids).cuda()[None]]
            for lw in params["layers"]:
                x, _ = _layer_forward_prefill(
                    x, lw, spec, cos, sin,
                    attention=flash_attention_reference)
            lg = _logits(x[0, len(prompt) - 1:], params, spec)   # [n, V]
            assert lg.shape == (n, vocab)
            hit, gap = _held_to(lg, gen)
            agree += hit
            total += n
            worst = max(worst, gap)
    _say(tag, {"requests": len(items), "tokens": total,
               "argmax_agreement": agree / total, "max_logit_gap": worst,
               "tie_bound": TIE_BOUND})
    assert worst < TIE_BOUND, worst
    assert agree / total >= 0.9, agree / total


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
    eng, rids, done, counts, _ = _serve_run(model, reqs, tag,
                                         weight_quant=weight_quant,
                                         kv_cache_dtype=kv_cache_dtype,
                                         **WHOLE_PROMPT)
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
    decode ticks of 8 slots (256-token prompts; each tick a graph replay,
    its key captured in the unprofiled ticks before), device time by
    kernel kind beside the host wall (the profiler attributes the
    kernels a graph replays). Not part of the counted run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import ServingEngine

    eng = ServingEngine(model, max_slots=8, kv_block_size=16,
                        **WHOLE_PROMPT, **engine_kw)
    rs = np.random.RandomState(1)
    for _ in range(8):
        eng.add_request(rs.randint(0, model.config.vocab_size, (256,)),
                        max_new_tokens=ticks + 8)
    for _ in range(4):                  # admit + prefill all 8, warm ticks
        eng.step()
    torch.cuda.synchronize()
    captures = sum(eng._captures)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert sum(eng._captures) == captures
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
        "ticks": ticks, "slots": 8, "graphs": eng._capture,
        "wall_ms_per_tick": 1e3 * wall / ticks,
        "device_ms_per_tick": device_ms,
        "device_busy_share": device_ms / (1e3 * wall / ticks),
        "device_ops_per_tick": launched / ticks,   # kernels + copies
        "device_ms_per_tick_by_kind": kinds,
        "paged_decode_ms_per_tick": kinds["paged_decode"],
        "top_kernels_ms_per_tick": [[k[:60], v] for k, v in top]})


def _prefix_stream(vocab, n_shared, repeats):
    """SERVE_PREFIX's requests (seeded): `n_shared` prompts behind one
    PREFIX_SYSTEM_TOKENS-token system prompt, each with a unique suffix of
    16-96 tokens (requests 3 and 7: a multiple of 16, so that a request
    repeating one hits every block of its prompt) and 32-64 new tokens;
    with `repeats`, two more requests repeating requests 3's and 7's whole
    prompts (the copy-on-write path)."""
    rs = np.random.RandomState(5)
    system = rs.randint(0, vocab, (PREFIX_SYSTEM_TOKENS,))
    reqs = []
    for i in range(n_shared):
        n = 16 * int(rs.randint(1, 7)) if i in (3, 7) \
            else int(rs.randint(16, 97))
        reqs.append((np.concatenate([system, rs.randint(0, vocab, (n,))]),
                     int(rs.randint(32, 65))))
    if repeats:
        reqs += [(reqs[i][0].copy(), int(rs.randint(32, 65))) for i in (3, 7)]
    return reqs


def _whole_prompt_path(eng, req):
    """Whether the engine prefilled `req` whole (K1) at admission: a
    cache-cold prompt of at most chunk_tokens tokens (the engine's rule)."""
    return req.cached_len == 0 and (eng.chunk_tokens <= 0
                                    or req.prompt.size <= eng.chunk_tokens)


def _drive_prefix(eng, reqs, follow_up=None):
    """Request 0 alone until its first token (its prompt's blocks are then
    in the cache), then the rest queued; with `follow_up`, once request 0
    has finished, one more request with prompt follow_up(request 0's
    tokens) and 32-64 new tokens. Returns the engine's Request objects
    (admission records: cached_len, prompt) in request-id order, with
    every request finished."""
    eng.add_request(reqs[0][0], max_new_tokens=reqs[0][1])
    objs = [eng._waiting[-1]]
    while not objs[0].tokens:
        eng.step()
    for p, n in reqs[1:]:
        eng.add_request(p, max_new_tokens=n)
        objs.append(eng._waiting[-1])
    pending = follow_up is not None
    while eng.has_work() or pending:
        eng.step()
        if pending and objs[0].finished:
            eng.add_request(follow_up(np.asarray(objs[0].tokens)),
                            max_new_tokens=48)
            objs.append(eng._waiting[-1])
            pending = False
    return objs


def _prefix_run(model, reqs, tag, follow_up=None, eager=False, **engine_kw):
    """Warm an engine up on a shared-prefix pair, then drive `reqs`
    (`_drive_prefix`) through a fresh engine at the engine's defaults
    (+ `engine_kw`; `eager`: its programs without graphs), every launch
    count set to 0 just before and read just after, each chunk timed by
    host wall and CUDA events. Checks the pool accounting and the exact
    launch counts; prints the `tag` line. Returns (engine, Request
    objects, counts, the line)."""
    import torch
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops import _cuda_common
    from paddle_tpu_torch.ops.paged_decode import KERNEL_NAMES

    warm = ServingEngine(model, max_slots=8, kv_block_size=16, **engine_kw)
    _drive_prefix(warm, [(p, 4) for p, _ in reqs[:2]])
    del warm

    eng = ServingEngine(model, max_slots=8, kv_block_size=16, **engine_kw)
    eng._capture = eng._capture and not eager
    chunks = []
    run_chunk = eng._run_chunk

    def timed_chunk(slot, req, state):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        before = sum(eng._captures)
        t0 = time.perf_counter()
        ev[0].record()
        tok = run_chunk(slot, req, state)
        ev[1].record()
        chunks.append((time.perf_counter() - t0, ev,
                       sum(eng._captures) > before))
        return tok

    eng._run_chunk = timed_chunk
    tick_walls = _tick_timer(eng)
    gc.collect()     # engines an earlier phase dropped (timers make cycles)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda_common.reset_launch_counts()
    t0 = time.perf_counter()
    objs = _drive_prefix(eng, reqs, follow_up)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda_common.launch_counts()

    st = eng.stats()
    pc = eng.prefix_cache
    vocab = model.config.vocab_size
    for r in objs:
        assert r.finish_reason == "length", r.rid
        toks = eng.completed[r.rid]
        assert len(toks) == r.max_new_tokens, r.rid
        assert ((toks >= 0) & (toks < vocab)).all(), r.rid
    assert st["requests_completed"] == len(objs)
    # every block is free or cached at refcount 0
    assert st["kv_pool_free"] + pc.evictable == st["kv_pool_blocks"] - 1
    assert pc.referenced_blocks == 0
    assert all(pc.refcount(b) == 0 for b in range(st["kv_pool_blocks"]))
    assert not eng._slot_chunk and not any(eng._slot_extra_refs)
    if not eng.prefix_cache_enabled:
        assert st["prefix_cached_blocks"] == 0 == st["prefix_blocks_hit"]
    # exact launches, from the engine's own records
    layers = model.config.num_hidden_layers
    whole = sum(_whole_prompt_path(eng, r) for r in objs)
    ticks = st["steps"]
    assert counts["flash_attention_fwd"] == whole * layers, counts
    assert counts[KERNEL_NAMES[eng.kv_mode]] == ticks * layers, counts
    for fmt, name in KERNEL_NAMES.items():
        if fmt != eng.kv_mode:
            assert counts[name] == 0, counts
    # int4: 7 layer matmuls a layer in every chunk, prefill and tick, the
    # lm_head once a tick and once a request (its first token)
    want_qmm = (7 * layers * (st["prefill_chunks"] + ticks + whole)
                + ticks + len(objs)) if eng.weight_quant == "int4" else 0
    assert counts["quant_matmul"] == want_qmm, counts
    assert all(counts[n] == 0 for n in FUSED_KERNELS), counts
    assert all(counts[n] == 0 for n in
               ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")), counts

    host_ms = [1e3 * w for w, _, _ in chunks]
    event_ms = [ev[0].elapsed_time(ev[1]) for _, ev, _ in chunks]
    steady = [i for i, (_, _, captured) in enumerate(chunks) if not captured]
    ttft = st["ttft_s"]
    hits, missed = st["prefix_blocks_hit"], st["prefix_blocks_missed"]
    prompt_tokens = sum(int(r.prompt.size) for r in objs)
    rec = {
        "requests": len(objs), "prompt_tokens": prompt_tokens,
        "prefill_tokens_computed": st["prefill_tokens"],
        "prefill_chunks": st["prefill_chunks"],
        "whole_prompt_prefills": whole,
        "prefix_blocks_hit": hits, "prefix_blocks_missed": missed,
        "hit_share": hits / max(hits + missed, 1),
        "prefix_cached_blocks": st["prefix_cached_blocks"],
        "prefix_evictions": st["prefix_evictions"],
        "copy_on_write_requests": sum(r.cached_len == r.prompt.size - 1
                                      for r in objs),
        "decode_tokens": st["decode_tokens"], "decode_ticks": ticks,
        "wall_s": wall,
        "decode_ms_per_tick": 1e3 * st["decode_time_s"] / ticks,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p95_s": float(np.percentile(ttft, 95)),
        "chunk_host_ms_median": float(np.median(host_ms)),
        "chunk_host_ms_mean": float(np.mean(host_ms)),
        "chunk_event_ms_median": float(np.median(event_ms)),
        "chunk_event_ms_mean": float(np.mean(event_ms)),
        "chunks_steady": len(steady),
        "chunk_host_ms_median_steady": float(np.median(
            [host_ms[i] for i in steady])) if steady else None,
        "chunk_event_ms_median_steady": float(np.median(
            [event_ms[i] for i in steady])) if steady else None,
        "slot_utilization": st["slot_utilization"],
        "weight_quant": st["weight_quant"],
        "kv_cache_mode": st["kv_cache_mode"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        **_graph_fields(eng, tick_walls),
        "launches": counts}
    _say(tag, rec)
    return eng, objs, counts, rec


def serve_prefix(model):
    """SERVE_PREFIX, SERVE_PREFIX_OFF and SERVE_PREFIX_Q4 (module
    docstring, phase 7b). Returns their launch counts and SERVE_PREFIX's
    run: its requests, follow-up prompt, line, launch counts and
    tokens."""
    cfg = model.config
    reqs = _prefix_stream(cfg.vocab_size, 24, repeats=True)
    turn = np.random.RandomState(6).randint(0, cfg.vocab_size, (32,))
    follow = {}

    def follow_up(first):
        follow["prompt"] = np.concatenate([reqs[0][0], first, turn])
        return follow["prompt"]

    eng, objs, counts, rec = _prefix_run(model, reqs, "SERVE_PREFIX",
                                         follow_up)
    st = eng.stats()
    assert st["prefix_blocks_hit"] > 0, st
    cow = objs[len(reqs) - 2:len(reqs)]
    assert all(r.cached_len == r.prompt.size - 1 for r in cow), \
        [(r.cached_len, r.prompt.size) for r in cow]
    assert objs[-1].cached_len >= reqs[0][0].size, objs[-1].cached_len
    # teacher-forced: a request served through a cache hit and a
    # copy-on-write repeat
    _teacher_forced(eng, [(r.prompt, eng.completed[r.rid])
                          for r in (objs[1], cow[0])],
                    "SERVE_PREFIX_TEACHER_FORCED")

    off, objs_off, counts_off, _ = _prefix_run(
        model, reqs, "SERVE_PREFIX_OFF", lambda _: follow["prompt"],
        prefix_cache=False)
    same = total = whole = first = 0
    diverge = []
    for a, b in zip(objs, objs_off):
        x, y = eng.completed[a.rid], off.completed[b.rid]
        assert np.array_equal(a.prompt, b.prompt)
        same += int((x == y).sum())
        total += len(x)
        whole += bool(np.array_equal(x, y))
        first += bool(x[0] == y[0])
        if not np.array_equal(x, y):
            diverge.append(int(np.argmax(x != y)))
    _say("SERVE_PREFIX_AGREEMENT", {
        "tokens": total, "greedy_agreement": same / total,
        "requests_identical": whole, "requests": len(objs),
        "first_tokens_equal": first,
        "first_divergence_index_median": float(np.median(diverge))
        if diverge else None})

    _, _, counts_q4, _ = _prefix_run(
        model, _prefix_stream(cfg.vocab_size, 6, repeats=False),
        "SERVE_PREFIX_Q4", weight_quant="int4", kv_cache_dtype="int4")
    return ({"SERVE_PREFIX": counts, "SERVE_PREFIX_OFF": counts_off,
             "SERVE_PREFIX_Q4": counts_q4},
            {"reqs": reqs, "follow": follow["prompt"], "rec": rec,
             "counts": counts,
             "tokens": [eng.completed[r.rid].tolist() for r in objs]})


def serve_graph_eager(model, served, prefixed):
    """SERVE_GRAPH_EAGER: SERVE's 16 requests (bf16, whole prompt) and
    SERVE_PREFIX's stream through engines that run the same programs
    eagerly (`_capture = False`: the port before its graphs), against the
    graph engines' runs of the same phases in this process. The greedy
    tokens must be identical (the same kernels on the same inputs) and so
    must every kernel's launch count (a replay counts what its capture
    launched). Prints SERVE_EAGER and SERVE_PREFIX_EAGER as their graph
    lines, then the times side by side."""
    eng, rids, done, counts, rec = _serve_run(
        model, served["reqs"], "SERVE_EAGER", eager=True, **WHOLE_PROMPT)
    assert all(p.graph is None for p in eng._programs.values())
    tokens = [done[r].tolist() for r in rids]
    del eng
    peng, objs, pcounts, prec = _prefix_run(
        model, prefixed["reqs"], "SERVE_PREFIX_EAGER",
        lambda _: prefixed["follow"], eager=True)
    ptokens = [peng.completed[r.rid].tolist() for r in objs]
    del peng
    same = [a == b for a, b in zip(tokens, served["tokens"])]
    psame = [a == b for a, b in zip(ptokens, prefixed["tokens"])]
    g, w, pg = served["rec"], served["warm"], prefixed["rec"]
    _say("SERVE_GRAPH_EAGER", {
        "serve_requests_identical": sum(same), "serve_requests": len(same),
        "prefix_requests_identical": sum(psame),
        "prefix_requests": len(psame),
        "launches_equal": counts == served["counts"]
        and pcounts == prefixed["counts"],
        "decode_ms_per_tick": {
            "eager": rec["decode_ms_per_tick"],
            "graph": g["decode_ms_per_tick"],
            "graph_steady": g["decode_ms_per_tick_steady"],
            "graph_warm": w["decode_ms_per_tick"]},
        "ttft_p50_s": {"eager": rec["ttft_p50_s"], "graph": g["ttft_p50_s"],
                       "graph_warm": w["ttft_p50_s"]},
        "ttft_p95_s": {"eager": rec["ttft_p95_s"], "graph": g["ttft_p95_s"],
                       "graph_warm": w["ttft_p95_s"]},
        "wall_s": {"eager": rec["wall_s"], "graph": g["wall_s"],
                   "graph_warm": w["wall_s"]},
        "max_memory_allocated_gb": {
            "eager": rec["max_memory_allocated_gb"],
            "graph": g["max_memory_allocated_gb"]},
        "prefix_decode_ms_per_tick": {
            "eager": prec["decode_ms_per_tick"],
            "graph": pg["decode_ms_per_tick"],
            "graph_steady": pg["decode_ms_per_tick_steady"]},
        "prefix_chunk_host_ms_median": {
            "eager": prec["chunk_host_ms_median"],
            "graph": pg["chunk_host_ms_median"],
            "graph_steady": pg["chunk_host_ms_median_steady"]},
        "prefix_chunk_event_ms_median": {
            "eager": prec["chunk_event_ms_median"],
            "graph_steady": pg["chunk_event_ms_median_steady"]},
        "prefix_ttft_p50_s": {"eager": prec["ttft_p50_s"],
                              "graph": pg["ttft_p50_s"]},
        "prefix_ttft_p95_s": {"eager": prec["ttft_p95_s"],
                              "graph": pg["ttft_p95_s"]},
        "prefix_max_memory_allocated_gb": {
            "eager": prec["max_memory_allocated_gb"],
            "graph": pg["max_memory_allocated_gb"]},
        "graph_capture_s": {"serve": g["capture_s"],
                            "serve_prefix": pg["capture_s"]}})
    assert all(same), same
    assert all(psame), psame
    assert counts == served["counts"], (counts, served["counts"])
    assert pcounts == prefixed["counts"], (pcounts, prefixed["counts"])


def serve_graph_steady(model, tag="SERVE_GRAPH_STEADY"):
    """The counterpart of the reference's zero-compile check
    (tests/test_obs.py): an engine at its defaults with 8 slots serves 8
    requests of 200 tokens with 2, 5, ..., 23 new tokens (prompt bucket
    256, decode buckets 8, 4, 2 and 1), finish_warmup(), then 8 more with
    24 new tokens: at least 20 steady ticks, zero captures, no new key."""
    from paddle_tpu_torch.inference import ServingEngine

    eng = ServingEngine(model, max_slots=8, kv_block_size=16)
    vocab = model.config.vocab_size
    rs = np.random.RandomState(8)
    for n in range(8):
        eng.add_request(rs.randint(0, vocab, (200,)), max_new_tokens=2 + 3 * n)
    eng.run()
    eng.finish_warmup()
    keys = set(eng._programs)
    for _ in range(8):
        eng.add_request(rs.randint(0, vocab, (200,)), max_new_tokens=24)
    ticks = _tick_timer(eng)
    steps = 0
    while eng.has_work() and steps < 30:
        eng.step()
        steps += 1
    st = eng._graph_stats()
    _say(tag, {"steps": steps, "decode_ticks": len(ticks),
               "captures_after_warmup": st["captures_after_warmup"],
               "new_keys": len(set(eng._programs) - keys),
               "graphs_captured": st["graphs_captured"],
               "capture_s_by_site": st["capture_s_by_site"],
               "decode_ms_per_tick": 1e3 * float(np.mean(
                   [w for w, _ in ticks]))})
    assert len(ticks) >= 20, len(ticks)
    assert st["captures_after_warmup"] == 0, st
    assert set(eng._programs) == keys


def profile_chunk(model, tag="PROFILE_CHUNK"):
    """Where a chunk's time goes: torch.profiler over single engine steps
    that each run one chunk and no decode tick (max_new_tokens 1), at the
    engine's defaults: a cold 512-token prompt's first chunk (256 tokens,
    no logits) and last chunk (256 tokens, the lm_head and the first
    token), then a 64-token suffix behind its first 448 tokens, cached;
    device ms by kernel kind beside the host wall, after one unprofiled
    round of the same steps (which captures their graphs). Not part of
    the counted run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import ServingEngine

    eng = ServingEngine(model, max_slots=8, kv_block_size=16)
    vocab = model.config.vocab_size
    rs = np.random.RandomState(7)
    rec = {}
    for profiled in (False, True):
        cold = rs.randint(0, vocab, (512,))
        hit = np.concatenate([cold[:PREFIX_SYSTEM_TOKENS],
                              rs.randint(0, vocab, (64,))])
        steps = (("first_chunk_256", cold), ("last_chunk_256", None),
                 ("hit_suffix_64", hit))
        for name, prompt in steps:
            if prompt is not None:
                eng.add_request(prompt, max_new_tokens=1)
            torch.cuda.synchronize()
            if not profiled:
                eng.step()
                continue
            captures = sum(eng._captures)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            assert sum(eng._captures) == captures
            kinds = {"gemm": 0.0, "softmax": 0.0, "index_copy": 0.0,
                     "other": 0.0}
            ops = 0
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                ops += e.count
                low = e.key.lower()
                kind = ("gemm" if any(w in low for w in (
                    "nvjet", "gemm", "gemv", "xmma", "cutlass")) else
                    "softmax" if "softmax" in low else
                    "index_copy" if any(w in low for w in (
                        "index", "copy", "gather", "scatter", "cat"))
                    else "other")
                kinds[kind] += e.self_device_time_total / 1e3
            device_ms = sum(kinds.values())
            rec[name] = {"wall_ms": 1e3 * wall, "device_ms": device_ms,
                         "device_busy_share": device_ms / (1e3 * wall),
                         "device_ops": ops, "device_ms_by_kind": kinds}
    st = eng.stats()
    assert st["requests_completed"] == 4 and st["steps"] == 0, st
    assert st["prefill_chunks"] == 6 and st["prefix_blocks_hit"] >= 56, st
    _say(tag, rec)


def _train_model(**cfg_kw):
    """The 1B model (with `cfg_kw` on top of CFG_1B) decorated O2 (bf16
    params, bf16 AdamW moments) with its optimizer, and the seeded
    batch."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**CFG_1B, **cfg_kw)
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
    plain forward, differentiated by autograd instead of K2, the final
    norm is the composition too, and the loss the unchunked plain
    version. No kernel of the model runs. Under `amp.auto_cast` the plain
    attention and loss are the reference's ops "scaled_dot_product_attention"
    and "fused_linear_cross_entropy", as the kernels' paths are."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_linear_cross_entropy_reference
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    from paddle_tpu_torch.text.generation import (_layer_forward_prefill,
                                                  _layer_weights, _rms_norm)

    from paddle_tpu_torch.amp import amp_op

    def attention(q, k, v, causal=True):
        return amp_op("scaled_dot_product_attention",
                      flash_attention_reference, q, k, v, causal)

    m = model.model
    cos, sin = model.rope_tables()
    x = torch.nn.functional.embedding(ids, m.embed_tokens.weight._data)
    for layer in m.layers:
        x = _layer_forward_prefill(x, _layer_weights(layer), layer.spec,
                                   cos, sin, attention=attention)[0]
    return amp_op("fused_linear_cross_entropy",
                  fused_linear_cross_entropy_reference,
                  _rms_norm(x, m.norm.weight._data, m.norm._epsilon),
                  model.lm_head.weight._data, ids)


def _grad_check(model, loss_fn, plain_loss_fn, tag, seed=1234):
    """One step's gradients through the kernels (`loss_fn`) vs the same
    step with no kernel of the path (`plain_loss_fn`; no update), each
    side from the default generators seeded alike (so BERT's dropout
    masks match); the plain side must launch no kernel. Prints `tag`.
    Returns the number of parameters that get a gradient."""
    import torch
    from paddle_tpu_torch.ops import _cuda_common

    def grads():
        return {n: getattr(p, "_data", p).grad
                for n, p in model.named_parameters()}

    def clear():
        if hasattr(model, "clear_gradients"):       # an nn.Layer
            model.clear_gradients()
        else:
            model.zero_grad(set_to_none=True)

    torch.manual_seed(seed)
    loss = loss_fn()
    loss.backward()
    kern = grads()
    clear()
    _cuda_common.reset_launch_counts()
    torch.manual_seed(seed)
    plain_loss = plain_loss_fn()
    plain_loss.backward()
    torch.cuda.synchronize()
    stray = {n: c for n, c in _cuda_common.launch_counts().items() if c}
    assert not stray, stray
    plain = grads()
    checked, worst, worst_name = 0, 0.0, None
    for n, w in plain.items():
        if kern[n] is None:     # unused (BERT's token types without ids)
            assert w is None, n
            continue
        a, w = kern[n].float(), w.float()
        assert torch.isfinite(a).all(), n
        # the key bias (BERT's key, nn.MultiHeadAttention's k_proj) gets
        # no gradient in exact arithmetic (a query row's softmax ignores a
        # shift common to its keys): its gradient is rounding on both
        # sides, held to its key weight's scale
        scale = plain[n[:-4] + "weight"] if n.endswith(
            ("key.bias", "k_proj.bias")) else w
        rel = (a - w).abs().max().item() / scale.float().abs().max().item()
        checked += 1
        if rel > worst:
            worst, worst_name = rel, n
    clear()
    del kern, plain
    rec = {"loss": loss.item(), "plain_loss": plain_loss.item(),
           "tensors": checked, "max_rel_err": worst,
           "worst_tensor": worst_name, "tol": GRAD_TOL}
    _say(tag, rec)
    assert worst <= GRAD_TOL, rec
    # the plain side is the model's own function, its arithmetic aside
    assert abs(rec["loss"] - rec["plain_loss"]) <= GRAD_TOL * rec["loss"], rec
    return checked


def _own_tensors(model, opt):
    """The model's parameters, buffers and gradients and the optimizer's
    state: what a training phase itself holds between steps."""
    import torch

    params = [getattr(p, "_data", p) for p in model.parameters()]
    tensors = [t for p in params for t in (p, p.grad) if t is not None] \
        + [getattr(b, "_data", b) for b in model.buffers()]
    return tensors + [t for st in opt.state.values() for t in st.values()
                      if isinstance(t, torch.Tensor)]


def _memory_at_start(own, top=8):
    """The device memory allocated now, split by the allocator's snapshot
    into the blocks that `own`'s storages start and the rest: {
    "allocated_at_start_gb", "own_gb", "other_allocated_mb_largest" (the
    sizes of the largest other blocks in MiB, largest first)}."""
    import torch

    starts = {t.untyped_storage().data_ptr() for t in own}
    mine, other = 0, []
    for seg in torch.cuda.memory_snapshot():
        for b in seg["blocks"]:
            if b["state"] != "active_allocated":
                continue
            if b["address"] in starts:
                mine += b["size"]
            else:
                other.append(b["size"])
    return {"allocated_at_start_gb": torch.cuda.memory_allocated() / 1e9,
            "own_gb": mine / 1e9,
            "other_allocated_mb_largest": [
                n / 2 ** 20 for n in sorted(other, reverse=True)[:top]]}


def _clean_device():
    """Before a training phase: collect garbage (a serve phase's engines
    hold timers, which make reference cycles), hand cached blocks back,
    and check that no serving engine is alive."""
    import torch
    from paddle_tpu_torch.inference import ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    alive = sum(isinstance(o, ServingEngine) for o in gc.get_objects())
    assert alive == 0, f"{alive} serving engines still alive"


def _timed_steps(model, opt, ids, steps, labels=None, reseed=None):
    """`steps` training steps (labels = ids unless given) from a zeroed
    peak-memory counter and zeroed launch counts: (losses, step walls in
    s, peak GB, launch counts, {"allocated_at_start_gb", "own_gb",
    "other_allocated_mb_largest"}). What is allocated at the start may
    exceed the allocator's blocks of the phase's own parameters, buffers,
    gradients and optimizer state (`_own_tensors`) by ALLOC_SLACK_GB at
    most.
    `reseed`, when given, reseeds the default generators before each
    step, so that every step draws the same dropout masks and the losses
    compare the updates alone."""
    import torch
    from paddle_tpu_torch.ops import _cuda_common

    labels = ids if labels is None else labels
    torch.cuda.synchronize()
    start = _memory_at_start(_own_tensors(model, opt))
    assert start["allocated_at_start_gb"] <= start["own_gb"] \
        + ALLOC_SLACK_GB, start
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
            _cuda_common.launch_counts(), start)


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
    with_grads = _grad_check(model, lambda: model(ids, labels=ids),
                             lambda: _plain_attention_loss(model, ids),
                             "TRAIN_GRAD_CHECK")
    layers = model.config.num_hidden_layers
    losses, walls, peak, counts, at_start = _timed_steps(model, opt, ids,
                                                         TRAIN_STEPS)
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
        **at_start,
        "max_memory_allocated_gb": peak, "losses": losses,
        "launches": counts})
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    want = _llama_launches(None, layers, with_grads)
    for name, per_step in want.items():
        assert counts[name] == TRAIN_STEPS * per_step, (name, counts)
    return model, opt, ids, counts, peak


def _llama_launches(granularity, layers, with_grads):
    """{kernel: launches per step} of the 1B LLaMA step (flag on) under a
    recompute granularity (None: no recompute). Without recompute: K1,
    both K2 kernels and K5 once per layer (each way); K3 twice per layer
    and once for the final norm, each way; K4 once per layer each way;
    the AdamW update once per parameter (the per-parameter path). A
    recomputed layer ("full", "flash_resident") runs its forward again in
    the backward: K3 twice, K4 and K5 once more per layer, and K1 once
    more under "full" (the flash_resident policy keeps K1's o and lse).
    "mlp" recomputes the MLP half only: its post-attention norm (the
    plain RMS kind; the fused add+norm does not run) and K5's forward
    once more per layer."""
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers, "swiglu_fwd": layers,
            "swiglu_bwd": layers, "fused_rms_norm_fwd": 2 * layers + 1,
            "fused_rms_norm_bwd": 2 * layers + 1, "rope_qk": 2 * layers,
            "fused_adam": with_grads}
    if granularity in ("full", "flash_resident"):
        want.update(fused_rms_norm_fwd=4 * layers + 1, rope_qk=3 * layers,
                    swiglu_fwd=2 * layers)
    if granularity == "full":
        want["flash_attention_fwd"] = 2 * layers
    if granularity == "mlp":
        want.update(fused_rms_norm_fwd=3 * layers + 1, swiglu_fwd=2 * layers)
    return want


def train_unfused(model, opt, ids):
    """TRAIN's model and batch with FLAGS_pallas_fused_ops off (the plain
    compositions), UNFUSED_STEPS counted steps, then as
    many fused steps again, so fused and unfused step times and peak
    memory come from one card in one run (fused, unfused, fused)."""
    from paddle_tpu_torch.core.flags import set_flags

    layers = model.config.num_hidden_layers
    set_flags({"FLAGS_pallas_fused_ops": False})
    try:
        losses, walls, peak, counts, at_start = _timed_steps(
            model, opt, ids, UNFUSED_STEPS)
    finally:
        set_flags({"FLAGS_pallas_fused_ops": True})
    f_losses, f_walls, f_peak, f_counts, _ = _timed_steps(model, opt, ids,
                                                          UNFUSED_STEPS)
    ms = 1e3 * statistics.median(walls[1:])
    _say("TRAIN_UNFUSED", {
        "steps": UNFUSED_STEPS, "ms_per_step_median": ms,
        "ms_per_step_min": 1e3 * min(walls[1:]),
        "ms_per_step_max": 1e3 * max(walls[1:]),
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
        **at_start,
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
    kernels carry their kind as a template argument (LAYER: `true` =
    LayerNorm), the forward's fifth (norm_fwd_kernel<TX, TY, TW, N,
    LAYER, WIDE>), every backward kernel's last (norm_bwd_rows_kernel,
    norm_bwd_sum_kernel, and the wide path's norm_bwd_coef_kernel and
    norm_bwd_wide_kernel). The fused optimizer pass
    (fused_update_kernel) is "optimizer"."""
    low = key.lower()
    norm = re.search(r"norm_(fwd|bwd)_\w*<([^()]*)>", low)
    if norm:
        args = [a.strip() for a in norm.group(2).split(",")]
        layer = args[4 if norm.group(1) == "fwd" else -1] == "true"
        return ("layer_norm_" if layer else "rms_norm_") + norm.group(1)
    for frag, kind in (("fused_update_kernel", "optimizer"),
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
    the host wall. Returns the printed record."""
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
         "optimizer", "gemm", "other"), 0.0)
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
    rec = {
        "loss": loss.item(), "wall_ms": 1e3 * wall, "device_ms": device_ms,
        "device_busy_share": device_ms / (1e3 * wall),
        "device_ops_per_step": launched, "device_ms_by_kind": kinds,
        "annotated_spans_ms": spans,
        "top_kernels_ms": [[k[:60], v] for k, v in top]}
    _say(tag, rec)
    return rec


def _plain_path(loss_fn):
    """`loss_fn` run with no kernel of the path: FLAGS_pallas_fused_ops
    off (the norms and dropout + add composed in torch) and
    nn.functional's attention replaced, for the duration, by autograd of
    the plain flash forward. Returns the wrapped function."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.flash_attention import \
        flash_attention_reference

    def plain_sdpa(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False,
                   training=True):
        assert attn_mask is None and (dropout_p == 0.0 or not training)
        raw = [getattr(t, "_data", t) for t in (q, k, v)]
        o, _ = flash_attention_reference(*(t.transpose(1, 2) for t in raw),
                                         is_causal)
        o = o.transpose(1, 2)
        # the Tensor API's layers (nn.MultiHeadAttention) pass Tensors
        return type(q)._wrap(o) if hasattr(q, "_data") else o

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


def _counted_train(tag, model, opt, ids, labels, units, want, reseed=None,
                   extra=None):
    """TRAIN_STEPS counted steps (`_timed_steps`). Prints `tag` (with the
    fields of `extra` first) with ms per step (median of steps 2..),
    `units` ((name, count per step)) per second, the memory allocated at
    the start and the peak; asserts finite, falling losses and launches
    of exactly `want` per step for every kernel (0 for the others).
    Returns (counts, peak GB)."""
    losses, walls, peak, counts, at_start = _timed_steps(
        model, opt, ids, TRAIN_STEPS, labels, reseed)
    steady = walls[1:]
    ms = 1e3 * statistics.median(steady)
    name, per_step = units
    n_params = sum(p.numel() for p in model.parameters())
    _say(tag, {
        **(extra or {}),
        "params": n_params, "batch": list(ids.shape), "steps": TRAIN_STEPS,
        "ms_per_step_median": ms, "ms_per_step_min": 1e3 * min(steady),
        "ms_per_step_max": 1e3 * max(steady),
        "first_step_ms": 1e3 * walls[0],
        f"{name}_per_s": per_step / (ms / 1e3),
        "achieved_tflops": 6 * n_params * ids.numel() / (ms / 1e3) / 1e12,
        **at_start,
        "max_memory_allocated_gb": peak, "losses": losses,
        "launches": counts})
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    got = {n: c for n, c in counts.items() if c}
    assert got == {n: TRAIN_STEPS * c for n, c in want.items()}, (got, want)
    return counts, peak


def _recompute_diff(model, ids, seed=1234):
    """The largest difference, relative to each tensor's largest |value|,
    between one step's gradients with the model's recompute and the same
    model's step without it (both through the kernels; no update)."""
    import torch

    grads = []
    for use in (True, False):
        model.config.use_recompute = use
        torch.manual_seed(seed)
        model(ids, labels=ids).backward()
        grads.append({n: p.grad._data for n, p in model.named_parameters()})
        model.clear_gradients()
    model.config.use_recompute = True
    worst = max((a - grads[1][n]).abs().max().item()
                / grads[1][n].float().abs().max().item()
                for n, a in grads[0].items())
    del grads
    return worst


def train_recompute():
    """TRAIN_RECOMPUTE: bench.py `bench_llama_1b`'s configuration (the 1B
    model, bf16 O2, AdamW lr 1e-4, batch 4 x 1024, the chunked fused CE,
    FLAGS_pallas_fused_ops on) with `use_recompute=True` at each of
    RECOMPUTE_GRANS, each on its own model built from seed 0 on a clean
    device, TRAIN_STEPS counted steps each with exact launches
    (`_llama_launches`) and one profiled step. flash_resident first takes
    the gradient check against the plain side and prints its largest
    difference from the same model's step without recompute. Returns
    {granularity: (launch counts, peak GB)}."""
    import torch

    out = {}
    for gran in RECOMPUTE_GRANS:
        _clean_device()
        t0 = time.perf_counter()
        model, opt, ids = _train_model(use_recompute=True,
                                       recompute_granularity=gran)
        torch.cuda.synchronize()
        extra = {"granularity": gran, "setup_s": time.perf_counter() - t0}
        with_grads = len(list(model.parameters()))
        if gran == "flash_resident":
            with_grads = _grad_check(
                model, lambda: model(ids, labels=ids),
                lambda: _plain_attention_loss(model, ids),
                "TRAIN_RECOMPUTE_GRAD_CHECK")
            extra["max_rel_diff_from_no_recompute"] = _recompute_diff(
                model, ids)
            assert extra["max_rel_diff_from_no_recompute"] <= GRAD_TOL
        want = _llama_launches(gran, model.config.num_hidden_layers,
                               with_grads)
        out[gran] = _counted_train(
            "TRAIN_RECOMPUTE", model, opt, ids, ids,
            ("tokens", ids.numel()), want, extra=extra)
        profile_train(lambda: _train_step(model, opt, ids, ids),
                      f"PROFILE_TRAIN_RECOMPUTE_{gran.upper()}")
        del model, opt, ids
    _clean_device()
    return out


def ce_chunk(reps=10):
    """CE_CHUNK: the loss alone, forward + backward, at LLaMA 1B's head
    ([4096, 2048] x [2048, 32000]: the vocab path, 5 slices of 6400) and
    GPT-3 medium's ([4096, 1024] x [1024, 50304]: the token path,
    1024-token chunks), bf16 hidden states and head weights from seed 0
    (weight [H, V], the layout the models pass: `lm_head.weight`),
    beside the unchunked plain version on the same inputs: ms (`_time_ms`,
    median of `reps` after two warm-ups), peak device memory
    above the inputs, and the chunked side's error against the plain side
    (CE_TOL)."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_linear_cross_entropy, fused_linear_cross_entropy_reference)
    from paddle_tpu_torch.incubate.nn.functional.fused_loss import \
        _best_chunk

    for tag, hid, vocab in (("llama", CFG_1B["hidden_size"],
                             CFG_1B["vocab_size"]),
                            ("gpt", CFG_GPT["hidden_size"],
                             CFG_GPT["vocab_size"])):
        n = TRAIN_BATCH * TRAIN_SEQ
        g = torch.Generator(device="cuda").manual_seed(0)
        h = (torch.randn(n, hid, device="cuda", generator=g)
             .bfloat16().requires_grad_(True))
        w = (torch.randn(hid, vocab, device="cuda", generator=g) * 0.02
             ).bfloat16().requires_grad_(True)
        lab = torch.randint(0, vocab, (n,), device="cuda", generator=g)
        rec = {"shape": [n, hid, vocab],
               "path": "vocab" if _best_chunk(vocab, 8192) else "tokens",
               "vocab_chunk": _best_chunk(vocab, 8192)}
        results = {}
        for side, fn in (("chunked", fused_linear_cross_entropy),
                         ("plain", fused_linear_cross_entropy_reference)):
            def step():
                h.grad = w.grad = None
                loss = fn(h, w, lab)
                loss.backward()
                return loss

            step()
            step()
            h.grad = w.grad = None
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss = step()
            torch.cuda.synchronize()
            rec[f"{side}_peak_above_inputs_gb"] = (
                torch.cuda.max_memory_allocated() - base) / 1e9
            results[side] = (loss.item(), h.grad.float(), w.grad.float())
            rec[f"{side}_ms"] = _time_ms(step, reps=reps, warmup=0)
        (lc, dhc, dwc), (lp, dhp, dwp) = results["chunked"], results["plain"]
        rec.update(loss=lc, plain_loss=lp,
                   loss_rel_err=abs(lc - lp) / abs(lp),
                   dh_rel_err=((dhc - dhp).abs().max()
                               / dhp.abs().max()).item(),
                   dw_rel_err=((dwc - dwp).abs().max()
                               / dwp.abs().max()).item(), tol=CE_TOL)
        _say(f"CE_CHUNK_{tag.upper()}", rec)
        assert rec["loss_rel_err"] <= CE_TOL["loss"], rec
        assert max(rec["dh_rel_err"], rec["dw_rel_err"]) <= CE_TOL["grad"], \
            rec
        del h, w, lab, results, dhc, dwc, dhp, dwp
        torch.cuda.empty_cache()


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
    # ln_2 of every block and ln_f, each way; the fused AdamW update once
    # per dtype of the parameters (bf16, and the LayerNorms' f32)
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            "fused_layer_norm_fwd": 2 * layers + 1,
            "fused_layer_norm_bwd": 2 * layers + 1,
            "fused_adam": len({p.dtype for p in model.parameters()})}
    counts, _ = _counted_train("TRAIN_GPT", model, opt, ids, ids,
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
    with_grads = _grad_check(model, lambda: model(ids, labels=labels),
                             _plain_path(lambda: model(ids, labels=labels)),
                             "TRAIN_BERT_GRAD_CHECK")
    layers = cfg.num_hidden_layers
    # per step: K1 and both K2 kernels once per layer; K3-LN for the
    # embeddings' norm and two per layer, each way; K6 twice per layer,
    # each way; the AdamW update once per parameter with a gradient
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            "fused_layer_norm_fwd": 2 * layers + 1,
            "fused_layer_norm_bwd": 2 * layers + 1,
            "dropout_add_fwd": 2 * layers, "dropout_add_bwd": 2 * layers,
            "fused_adam": with_grads}
    counts, _ = _counted_train("TRAIN_BERT", model, opt, ids, labels,
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


def flashmask_cases(s, starts, tag, b=1, h=16, d=128):
    """K9's three kernels at one shape (bf16, causal) with the start rows
    `starts(s, h)` ([1, h, s] int32): each against its plain version,
    timed beside it, beside SDPA with the equivalent boolean mask
    (autograd for a backward kernel's gradients), and beside its bound
    over the visible pairs these start rows leave (the sum over columns
    j of min(start[j], S) - j) and the bytes of Q, K, V, O (dO, dQ, dK,
    dV), lse, delta and the start rows. The tile bounds are computed
    once, untimed (the wrapper's prep). Returns {"fwd": rec, "bwd":
    rec}."""
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

    def body(name):
        return TC_BODY if tensor_core_route(name, q.dtype, d) else CORE_BODY

    del ro, rlse
    q_bytes = kv_bytes = 2 * b * h * s * d
    st_bytes = 4 * b * h * s
    bound, by = _bound_ms(4 * d * pairs, 2 * q_bytes + 2 * kv_bytes
                          + 4 * b * h * s + st_bytes)
    fwd = {"name": "flashmask_fwd", "case": tag, "shape": [b, h, s, d],
           "causal": True, "visible_pairs": pairs,
           "causal_pairs": b * h * s * (s + 1) // 2,
           "body": body("flashmask_fwd"),
           "max_abs_err": err, "lse_max_abs_err": lse_err,
           "ms": _time_ms(lambda: _launch_fwd(q, k, v, *fm)),
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

    _bwd_records(
        bwd, (("dq", fm_dq, plain_dq, (ql,), 3, q_bytes),
              ("dkv", fm_dkv, plain_dkv, (kl, vl), 4, 2 * kv_bytes)),
        (q, k, v, do, lse, delta, True), reads, pairs, d,
        lambda wrt: torch.autograd.grad(out, wrt, do, retain_graph=True))
    bwd["dq"]["body"] = body("flashmask_bwd_dq")
    bwd["dkv"]["body"] = body("flashmask_bwd_dkv")
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


#: the tensor-core kernels, each built at padded head dims 64 and 128,
#: all three with LenCausalMask (K1/K1v, K2/K2v) and with StartRowMask
#: (K9)
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
              "flash_bwd_dkv_tc_kernel")
TC_SOURCES = {"csrc/flash_attention_fwd.cu": 2,
              "csrc/flash_attention_bwd.cu": 4,
              "csrc/flashmask_attention.cu": 6}


def tc_usage():
    """PTXAS: registers, stack and spills of the tensor-core kernels (bf16
    K1/K1v, K2/K2v dQ and K2/K2v dK/dV at each padded head dim; the
    varlen entries instantiate the same kernels; K9's forward, dQ and
    dK/dV at each padded head dim), from the build's `-Xptxas -v` output, and
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


#: the paged-decode instantiations the serve paths launch (bf16, G 1, DM
#: 128) in each cache format's source, and the merge kernel
DECODE_SOURCES = {"model": ("csrc/paged_decode.cu", 0),
                  "int8": ("csrc/paged_decode_int8.cu", 1),
                  "int4": ("csrc/paged_decode_int4.cu", 2)}


def decode_usage():
    """PTXAS_DECODE: registers, stack and spills of the split kernel the
    serve paths launch in each cache format (bf16, one query head per kv
    head, largest head dim 128) and of its merge kernel; neither may
    spill. Other instantiations are printed by count of spilling ones."""
    from paddle_tpu_torch.ops import _cuda_common

    usage, spilling = {}, 0
    for fmt, (rel, f) in DECODE_SOURCES.items():
        for name, use in _cuda_common.ptxas_usage(rel).items():
            if f"paged_decode_kernelI13__nv_bfloat16Li{f}ELi1ELi128E" in name:
                usage[f"{fmt} split<bf16, G 1, DM 128>"] = use
            elif "paged_decode_merge_kernelI13__nv_bfloat16" in name:
                usage[f"{fmt} merge<bf16>"] = use
            elif use.get("spill_stores") or use.get("spill_loads"):
                spilling += 1
    _say("PTXAS_DECODE", {"main_path": usage,
                          "other_instantiations_spilling": spilling})
    assert len(usage) == 2 * len(DECODE_SOURCES), usage
    spilled = {k: u for k, u in usage.items()
               if u.get("spill_stores") or u.get("spill_loads")}
    assert not spilled, spilled


def qmm_usage():
    """PTXAS_K8: registers, stack and spills of K8's kernels (the
    tensor-core body at each token tile; the CUDA-core body and its split
    pass in f32 and bf16), and ptxas's lines on the tensor-core body's
    wgmma pipeline (a serialized pipeline is slow, not wrong). None may
    spill."""
    from paddle_tpu_torch.ops import _cuda_common

    rel = "csrc/quant_matmul.cu"
    usage = {}
    for name, use in _cuda_common.ptxas_usage(rel).items():
        tile = re.search(r"qmm_tc_kernelILi(\d+)E", name)
        dt = "bf16" if "bfloat16" in name else "f32"
        if tile:
            usage[f"qmm_tc_kernel<{tile.group(1)}>"] = use
        elif "qmm_kernel" in name or "qmm_finish" in name:
            usage[f"{'qmm_kernel' if 'qmm_kernel' in name else 'qmm_finish'}"
                  f"<{dt}>"] = use
    with open(f"{_cuda_common._lib_path(rel)}.log") as f:
        notes = [ln.strip() for ln in f if "wgmma" in ln]
    _say("PTXAS_K8", {"kernels": usage, "wgmma_notes": notes})
    assert len(usage) == 8, usage
    spilled = {k: u for k, u in usage.items()
               if u.get("spill_stores") or u.get("spill_loads")
               or u.get("stack")}
    assert not spilled, spilled


#: the mangled template arguments of the norm backward's kernels
_MANGLED = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32",
            "Lb0E": "rms", "Lb1E": "ln"}


def norm_usage():
    """PTXAS_NORM: registers, stack and spills of the fused-norm
    backward's row kernel (each dtype pair of s and dy, each kind) and of
    its fixed-order dw / db sum. Their w, dw and db live in registers:
    none may spill."""
    from paddle_tpu_torch.ops import _cuda_common

    usage = {}
    for name, use in _cuda_common.ptxas_usage("csrc/fused_norm.cu").items():
        kernel = re.search(r"(norm_bwd_(?:rows|sum)_kernel)I(\w+?)EEv", name)
        if kernel:
            args = []
            for a in re.findall(r"13__nv_bfloat16|6__half|S\d*_|Lb[01]E|f",
                                kernel.group(2)):
                # S<n>_: the 2-byte type named before it (f32 is never one)
                args.append(args[0] if a.startswith("S") else _MANGLED[a])
            usage[f"{kernel.group(1)}<{', '.join(args)}>"] = use
    _say("PTXAS_NORM", usage)
    # the row kernel: 5 dtype pairs x 2 kinds; the sum: RMS in f32, bf16,
    # f16, LayerNorm in f32
    assert len(usage) == 14, usage
    spilled = {k: u for k, u in usage.items()
               if u.get("spill_stores") or u.get("spill_loads")
               or u.get("stack")}
    assert not spilled, spilled


def optim_usage():
    """PTXAS_OPTIM: registers, stack and spills of the fused optimizer
    pass (fused_update_kernel, Adam and Momentum, each (parameter, state)
    dtype pair). Its per-tensor table stays in the parameter space
    (__grid_constant__): a stack frame would mean a local copy of it, and
    none may spill."""
    from paddle_tpu_torch.ops import _cuda_common

    usage = {name: use for name, use in _cuda_common.ptxas_usage(
        "csrc/fused_optimizer.cu").items() if "fused_update_kernel" in name}
    _say("PTXAS_OPTIM", usage)
    assert len(usage) == 12, usage          # 6 dtype pairs x 2 updates
    bad = {k: u for k, u in usage.items() if u.get("spill_stores")
           or u.get("spill_loads") or u.get("stack")}
    assert not bad, bad


#: the optimizer's hyperparameters in OPTIM (TRAIN's AdamW: lr 1e-4,
#: decay 0.01; Momentum 0.9, nesterov)
OPTIM_LR, OPTIM_WD, OPTIM_STEPS = 1e-4, 0.01, 4


def _o2_params(name):
    """A training path's parameter list as `amp.decorate(..., "O2")`
    leaves it, [(shape, dtype)], from its model built on the meta device
    (no memory, no init)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models import (
        BertConfig, BertForSequenceClassification, GPTConfig,
        GPTForCausalLM, LlamaConfig, LlamaForCausalLM)

    build = {"llama": lambda: LlamaForCausalLM(LlamaConfig(**CFG_1B),
                                               device="meta"),
             "gpt": lambda: GPTForCausalLM(GPTConfig(**CFG_GPT),
                                           device="meta"),
             "bert": lambda: BertForSequenceClassification(BertConfig(),
                                                           device="meta")}
    model = amp.decorate(build[name](), level="O2", dtype="bfloat16")
    return [(tuple(p.shape), p._data.dtype) for p in model.parameters()]


def _optim_tensors(shapes, dtype, seed, states):
    """Seeded parameters (~0.02), gradients (~1e-3) and `states` state
    lists in `dtype` on the card: a first moment (~1e-3), then second
    moments (>= 0, ~1e-6)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def make(scale, positive=False):
        out = []
        for shape in shapes:
            t = (torch.rand if positive else torch.randn)(
                shape, device="cuda", generator=g, dtype=dtype)
            out.append(t.mul_(scale))
        return out

    return (make(0.02), make(1e-3),
            [make(1e-3)] + [make(1e-6, True) for _ in range(states - 1)])


def _clone_all(*lists):
    return [[t.clone() for t in ts] for ts in lists]


def optim_case(tag, shapes, dtype, momentum=False):
    """fused_adam (AdamW: TRAIN's lr and decay, step 1, the learning rate
    and bias corrections read on the device as the optimizers pass them)
    or fused_momentum (nesterov) over one dtype group of a training path's parameter list
    under O2 (state in the parameters' dtype, no master weights, as
    TRAIN* run): one call against its plain version on copies of the same
    inputs, bit for bit; then timed (L2 flushed before each launch) beside
    the plain version and the yardstick: `torch._fused_adamw_` (torch's
    rule, eps outside the bias-corrected root: not the port's function,
    so not `library_ms`) for Adam; `torch._fused_sgd_` with dampening 0,
    which computes Paddle's velocity rule, as `library_ms` for
    Momentum."""
    import torch
    from paddle_tpu_torch.ops import fused_optimizer as fo

    n = len(shapes)
    ps, gs, st = _optim_tensors(shapes, dtype, len(shapes) + 7,
                                1 if momentum else 2)
    # the optimizers' call: the learning rate and the bias corrections on
    # the device (`_lr_t`, and Adam's from `_step_t` at step 1)
    lrs, coeffs = [1.0] * n, [OPTIM_WD] * n
    lr_t = torch.full((), OPTIM_LR, dtype=torch.float32, device="cuda")
    if momentum:
        kw = dict(momentum=0.9, nesterov=True, lr=lr_t)

        def kernel(p, s_):
            fo.fused_momentum(p, gs, s_[0], None, lrs, coeffs, **kw)

        def plain(p, s_):
            fo.fused_momentum_reference(p, gs, s_[0], None, lrs, coeffs,
                                        **kw)
    else:
        kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=True,
                  lr=lr_t, bc=fo.bias_corrections(
                      fo.betas_tensor(0.9, 0.999, "cuda"), 1))

        def kernel(p, s_):
            fo.fused_adam(p, gs, s_[0], s_[1], None, None, lrs, coeffs, **kw)

        def plain(p, s_):
            fo.fused_adam_reference(p, gs, s_[0], s_[1], None, None, lrs,
                                    coeffs, **kw)
    kp, ks = ps, st
    pp, *ps_ = _clone_all(ps, *st)
    kernel(kp, ks)
    plain(pp, ps_)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(kp + sum(ks, []), pp + sum(ps_, [])):
        assert torch.equal(a.view(-1).view(torch.uint8),
                           b.view(-1).view(torch.uint8)), tag
        err = max(err, (a.float() - b.float()).abs().max().item())
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    ms = _time_ms(lambda: kernel(kp, ks), flush)
    plain_ms = _time_ms(lambda: plain(pp, ps_), flush, reps=5, warmup=1)
    del pp, ps_
    yp, *ys = _clone_all(ps, *st)
    if momentum:
        yard = lambda: torch._fused_sgd_(   # noqa: E731
            yp, gs, ys[0], weight_decay=OPTIM_WD, momentum=0.9, lr=OPTIM_LR,
            dampening=0.0, nesterov=True, maximize=False,
            is_first_step=False)
    else:
        steps = [torch.zeros((), device="cuda") for _ in yp]
        yard = lambda: torch._fused_adamw_(   # noqa: E731
            yp, gs, ys[0], ys[1], [], steps, lr=OPTIM_LR, beta1=0.9,
            beta2=0.999, weight_decay=OPTIM_WD, eps=1e-8, amsgrad=False,
            maximize=False)
    yard_ms = _time_ms(yard, flush)
    del yp, ys
    numel = sum(p.numel() for p in ps)
    eb = ps[0].element_size()
    # read p, g and the state; write p and the state
    moved = (2 + len(st)) * eb * numel + (1 + len(st)) * eb * numel
    bound, by = _bound_ms((7 if momentum else 15) * numel, moved,
                          PEAK_F32_FLOPS)
    rec = {"name": "fused_momentum" if momentum else "fused_adam",
           "case": tag, "tensors": n, "elements": numel,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by}
    if momentum:
        rec |= {"library_ms": yard_ms, "library": "torch._fused_sgd_"}
    else:
        rec |= {"library_ms": None, "torch_fused_adamw_ms": yard_ms}
    _say("KERNEL", rec)
    return rec


def optim_steps(shapes):
    """The optimizers' own entry points at LLaMA 1B's O2 parameter list
    (bf16, seeded gradients): OPTIM_STEPS steps of AdamW(use_multi_tensor=
    True) and of Momentum(use_multi_tensor=True, use_nesterov=True), each
    from zeroed launch counts: one launch a step (one dtype pair) and no
    other kernel, finite parameters. Prints OPTIM_STEP with ms per step
    (host clock, synchronized). Returns {optimizer: launch counts}."""
    import torch
    from paddle_tpu_torch.ops import _cuda_common
    from paddle_tpu_torch.optimizer import AdamW, Momentum

    counts, rec = {}, {}
    for name, make, kernel in (
            ("AdamW", lambda ps: AdamW(learning_rate=OPTIM_LR, parameters=ps,
                                       weight_decay=OPTIM_WD,
                                       use_multi_tensor=True), "fused_adam"),
            ("Momentum", lambda ps: Momentum(
                learning_rate=OPTIM_LR, parameters=ps, use_nesterov=True,
                weight_decay=OPTIM_WD, use_multi_tensor=True),
             "fused_momentum")):
        ps, gs, _ = _optim_tensors(shapes, torch.bfloat16, 11, 1)
        params = [torch.nn.Parameter(p) for p in ps]
        opt = make(params)
        walls = []
        torch.cuda.synchronize()
        _cuda_common.reset_launch_counts()
        for _ in range(OPTIM_STEPS):
            for p, g in zip(params, gs):
                p.grad = g
            t0 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts[name] = _cuda_common.launch_counts()
        launched = {k: c for k, c in counts[name].items() if c}
        assert launched == {kernel: OPTIM_STEPS}, launched
        assert all(torch.isfinite(p).all() for p in params)
        rec[name] = {"tensors": len(params), "steps": OPTIM_STEPS,
                     "ms_per_step_median": 1e3 * statistics.median(
                         walls[1:]),
                     "first_step_ms": 1e3 * walls[0], "launches": launched}
        del params, opt, ps, gs
        torch.cuda.empty_cache()
    _say("OPTIM_STEP", rec)
    return counts


def optim_phase():
    """OPTIM: fused_adam over LLaMA 1B's, GPT-3 medium's (its two dtype
    groups) and BERT-base's parameter lists under O2, fused_momentum over
    LLaMA's, each against its plain version (`optim_case`); then the
    optimizers' entry points (`optim_steps`). Returns (records, counts)."""
    import torch

    lists = {name: _o2_params(name) for name in ("llama", "gpt", "bert")}
    recs = {}
    for name, plist in lists.items():
        for dtype in dict.fromkeys(dt for _, dt in plist):
            shapes = [s for s, dt in plist if dt == dtype]
            tag = f"{name} O2 {str(dtype).replace('torch.', '')}"
            recs[tag] = optim_case(tag, shapes, dtype)
            torch.cuda.empty_cache()
    llama = [s for s, _ in lists["llama"]]
    recs["llama O2 bfloat16 momentum"] = optim_case(
        "llama O2 bfloat16 nesterov", llama, torch.bfloat16, momentum=True)
    torch.cuda.empty_cache()
    return recs, optim_steps(llama)


def profile_prefill(model, tag="PROFILE_PREFILL"):
    """Where one 512-token prefill's device time goes, bf16 weights
    beside int4 (and an int4 KV cache): torch.profiler over one engine
    step that admits and prefills a 512-token prompt with max_new_tokens
    1 (no decode tick), after one such step to warm up; device ms by
    kernel kind beside the host wall. Not part of the counted run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import ServingEngine

    rs = np.random.RandomState(2)
    rec = {"prompt_tokens": 512}
    for name, kw in (("bf16", {}), ("int4", {"weight_quant": "int4",
                                             "kv_cache_dtype": "int4"})):
        eng = ServingEngine(model, max_slots=8, kv_block_size=16,
                            **WHOLE_PROMPT, **kw)
        for profiled in (False, True):
            eng.add_request(rs.randint(0, model.config.vocab_size, (512,)),
                            max_new_tokens=1)
            torch.cuda.synchronize()
            if not profiled:
                eng.step()
                continue
            captures = sum(eng._captures)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            assert sum(eng._captures) == captures
        assert eng.stats()["requests_completed"] == 2
        kinds = {"quant_matmul": 0.0, "flash": 0.0, "gemm": 0.0,
                 "other": 0.0}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            low = e.key.lower()
            kind = ("quant_matmul" if "qmm_" in low else
                    "flash" if "flash" in low else
                    "gemm" if any(w in low for w in ("nvjet", "gemm", "gemv",
                                                     "xmma", "cutlass"))
                    else "other")
            kinds[kind] += e.self_device_time_total / 1e3
        rec[name] = {"device_ms": sum(kinds.values()),
                     "device_ms_by_kind": kinds, "wall_ms": 1e3 * wall}
    _say(tag, rec)



#: F7's float16 kernels vs their plain versions from the same f16 inputs,
#: relative to each output's largest |value|: both sides sum in f32 and
#: round each output once to f16 (2^-11 relative), so they differ by one
#: f16 ulp (2^-10 of a value's binade); 2^-9 leaves a rounding of room
F16_TOL = 2 ** -9


def _f16_row(name, case, got, want, run, plain, library, flops, nbytes):
    """One float16 KERNEL line: the kernel's outputs `got` held against
    the plain version's `want` (F16_TOL of each output's largest |value|),
    the kernel, the plain version and the library call timed, the bound
    of `flops` f16 products over the card's f16 tensor-core peak (the
    least time the card could take; the CUDA-core body runs f32 FMAs) and
    of `nbytes`."""
    err, rels = _rel_errs(got, want)
    assert max(rels) <= F16_TOL, (name, case, rels)
    bound, by = _bound_ms(flops, nbytes)
    rec = {"name": name, "case": case, "dtype": "float16",
           "body": CORE_BODY, "max_abs_err": err, "rel_err": rels,
           "tol": F16_TOL, "ms": _time_ms(run), "plain_ms": _time_ms(plain),
           "library_ms": None if library is None else _time_ms(library),
           "bound_ms": bound, "bound_by": by}
    _say("KERNEL", rec)
    return rec


def f16_cases():
    """F7: the flash family and the paged decode in float16 (the
    CUDA-core bodies) at the main paths' shapes: K1 and K2 (dQ, dK/dV) at
    LLaMA 1B's train shape (B4 H16 S1024 D128) and GPT-3 medium's (D64),
    K1v / K2v at a packed batch of 4 ragged sequences (bucket 1024), K9
    at S 4096 with a 1024-token window, K7 at the serve shape with f16
    caches. Returns [rec, ...]."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash_attention import (
        _bwd_delta, _launch_bwd_dkv, _launch_bwd_dq,
        flash_attention_bwd_dkv_reference, flash_attention_bwd_dq_reference,
        flash_attention_fwd, flash_attention_reference)
    from paddle_tpu_torch.ops.flashmask import (flashmask_attention_reference,
                                                flashmask_bwd, flashmask_fwd)
    from paddle_tpu_torch.ops.paged_decode import (
        paged_decode_attention, paged_decode_attention_reference)

    f16 = torch.float16
    g = torch.Generator(device="cuda").manual_seed(16)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g, dtype=f16)

    rows = []
    for tag, d in (("llama", 128), ("gpt", 64)):
        b, h, s = TRAIN_BATCH, 16, TRAIN_SEQ
        q, k, v, do = (randn(b, h, s, d) for _ in range(4))
        pairs = b * h * s * (s + 1) // 2
        io = 2 * b * h * s * d                  # one f16 [B, H, S, D]
        o, lse = flash_attention_fwd(q, k, v, True)
        ro, rlse = flash_attention_reference(q, k, v, True)
        assert (lse - rlse).abs().max().item() < 1e-3
        rows.append(_f16_row(
            "flash_attention_fwd", f"f16 {tag} d{d}", (o,), (ro,),
            lambda: flash_attention_fwd(q, k, v, True),
            lambda: flash_attention_reference(q, k, v, True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            4 * d * pairs, 4 * io + 4 * b * h * s))
        args = (q, k, v, do, lse, _bwd_delta(o, do), True)
        rows.append(_f16_row(
            "flash_attention_bwd_dq", f"f16 {tag} d{d}",
            (_launch_bwd_dq(*args),),
            (flash_attention_bwd_dq_reference(*args),),
            lambda: _launch_bwd_dq(*args),
            lambda: flash_attention_bwd_dq_reference(*args), None,
            6 * d * pairs, 5 * io + 8 * b * h * s))
        rows.append(_f16_row(
            "flash_attention_bwd_dkv", f"f16 {tag} d{d}",
            _launch_bwd_dkv(*args), flash_attention_bwd_dkv_reference(*args),
            lambda: _launch_bwd_dkv(*args),
            lambda: flash_attention_bwd_dkv_reference(*args), None,
            8 * d * pairs, 6 * io + 8 * b * h * s))
        del q, k, v, do, o, lse, ro, rlse, args
    # K1v / K2v: 4 ragged causal sequences in a 1024 bucket
    lens = np.array([1024, 700, 333, 64])
    b, h, s, d = len(lens), 16, 1024, 128
    q, k, v, do = (randn(b, h, s, d) for _ in range(4))
    kv_lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    pairs = h * int((lens * (lens + 1) // 2).sum())
    io = 2 * h * d * int(lens.sum())
    o, lse = flash_attention_fwd(q, k, v, True, kv_lens)
    ro, _ = flash_attention_reference(q, k, v, True, kv_lens)
    rows.append(_f16_row(
        "flash_attention_varlen_fwd", "f16 varlen", (o,), (ro,),
        lambda: flash_attention_fwd(q, k, v, True, kv_lens),
        lambda: flash_attention_reference(q, k, v, True, kv_lens), None,
        4 * d * pairs, 4 * io))
    args = (q, k, v, do, lse, _bwd_delta(o, do), True, kv_lens)
    rows.append(_f16_row(
        "flash_attention_varlen_bwd_dq", "f16 varlen",
        (_launch_bwd_dq(*args),), (flash_attention_bwd_dq_reference(*args),),
        lambda: _launch_bwd_dq(*args),
        lambda: flash_attention_bwd_dq_reference(*args), None,
        6 * d * pairs, 5 * io))
    rows.append(_f16_row(
        "flash_attention_varlen_bwd_dkv", "f16 varlen",
        _launch_bwd_dkv(*args), flash_attention_bwd_dkv_reference(*args),
        lambda: _launch_bwd_dkv(*args),
        lambda: flash_attention_bwd_dkv_reference(*args), None,
        8 * d * pairs, 6 * io))
    del q, k, v, do, o, lse, ro, args
    # K9: S 4096, H 16, D 128, causal, a 1024-token window
    b, h, s, d = 1, 16, 4096, 128
    q, k, v, do = (randn(b, h, s, d) for _ in range(4))
    start = torch.clamp(torch.arange(s, device="cuda") + FM_WINDOW,
                        max=s).to(torch.int32).expand(b, h, s).contiguous()
    pairs = b * h * int((start[0, 0].long()
                         - torch.arange(s, device="cuda")).sum())
    io = 2 * b * h * s * d
    o, lse = flashmask_fwd(q, k, v, start, True)
    ro, _ = flashmask_attention_reference(q, k, v, start, True)
    rows.append(_f16_row(
        "flashmask_fwd", "f16 window", (o,), (ro,),
        lambda: flashmask_fwd(q, k, v, start, True),
        lambda: flashmask_attention_reference(q, k, v, start, True), None,
        4 * d * pairs, 4 * io))
    from paddle_tpu_torch.ops.flashmask import \
        flashmask_attention_bwd_reference
    rows.append(_f16_row(
        "flashmask_bwd", "f16 window",
        flashmask_bwd(q, k, v, o, lse, do, start, True),
        flashmask_attention_bwd_reference(q, k, v, o, lse, do, start, True),
        lambda: flashmask_bwd(q, k, v, o, lse, do, start, True),
        lambda: flashmask_attention_bwd_reference(q, k, v, o, lse, do,
                                                  start, True), None,
        10 * d * pairs, 8 * io))
    del q, k, v, do, o, lse, ro
    # K7 at the serve shape with f16 caches
    seqs, heads, d, bs, max_len = 8, 16, 128, 16, 1024
    rs = np.random.RandomState(0)
    pages = max_len // bs
    kc = randn(1 + seqs * pages, heads, bs, d)
    vc = randn(1 + seqs * pages, heads, bs, d)
    qd = randn(seqs, heads, d)
    lens_np = rs.randint(1, max_len + 1, (seqs,)).astype("int32")
    tables = torch.from_numpy((1 + rs.permutation(seqs * pages)).reshape(
        seqs, pages).astype("int32")).cuda()
    lens_t = torch.from_numpy(lens_np).cuda()
    tokens = int(lens_np.sum())
    out = paged_decode_attention(qd, kc, vc, tables, lens_t)
    assert out.dtype == f16
    rows.append(_f16_row(
        "paged_decode_attention", "f16 serve", (out,),
        (paged_decode_attention_reference(qd, kc, vc, tables, lens_t),),
        lambda: paged_decode_attention(qd, kc, vc, tables, lens_t),
        lambda: paged_decode_attention_reference(qd, kc, vc, tables, lens_t),
        None, 4 * tokens * heads * d,
        2 * (2 * tokens * heads * d + 2 * seqs * heads * d)))
    torch.cuda.empty_cache()
    return rows


#: STATIC_*: the captured step's losses vs the eager step's from the same
#: weights and batch, relative (the same kernels on the same inputs in
#: the same order: bit-identical is expected)
STATIC_TOL = 1e-3
#: the 168M LLaMA of bench.py `bench_llama_train` (amp=False: O1 with f32
#: parameters) and its batch
CFG_168M = dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
                num_hidden_layers=8, num_attention_heads=16,
                max_position_embeddings=1024)
O1_BATCH, O1_SEQ = 8, 1024
#: the bench steps' priming batch (bench.py primes every step at 1 x 128;
#: BERT at 2 x 128) and the steps each phase takes at the big batch
PRIME = (1, 128)


def _bench_step(model, opt, level, dtype="bfloat16", scaler=None,
                poison=None, labels=None):
    """The bench's train step body (bench.py `_llama_step`): the forward
    under auto_cast(level), then backward, step, clear_grad; with a
    GradScaler, the scaled form (`poison`, a device scalar, multiplies
    the loss: inf injects a non-finite gradient)."""
    from paddle_tpu_torch import amp

    def step(x, y=None):
        with amp.auto_cast(enable=True, dtype=dtype, level=level):
            loss = model(x, labels=x if y is None else y)
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss * poison).backward()
            scaler.step(opt)
            scaler.update()
        opt.clear_grad()
        return loss

    return step


def _step_series(step, prime, big, steps, between=None):
    """Two priming calls, then `steps` timed calls at the big batch
    (synchronized); `between(i)` runs before big call i. Returns (losses,
    walls in s, launch counts of the big calls, peak GB over them)."""
    import torch
    from paddle_tpu_torch.ops import _cuda_common

    for _ in range(2):
        step(*prime)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda_common.reset_launch_counts()
    losses, walls = [], []
    for i in range(steps):
        if between is not None:
            between(i)
        t1 = time.perf_counter()
        losses.append(step(*big).item())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    return (losses, walls, _cuda_common.launch_counts(),
            torch.cuda.max_memory_allocated() / 1e9)


def _static_phase(tag, build, prime, big, units, want, level="O2",
                  dtype="bfloat16", reseed=None, make_step=None):
    """One bench step eagerly and under to_static(share_discovery=True),
    each on a model `build()` makes from seed 0 on a clean device:
    primed twice at `prime`, then TRAIN_STEPS steps at `big` (the first
    captures the big key's graph straight from the priming discovery).
    Holds the captured losses to the eager ones (STATIC_TOL), the launches
    of every replay to the eager step's and to `want` per step, one graph
    and no break; prints ms a step (median of steps 2..), `units` per
    second, the busy share of one profiled replay, the capture seconds,
    the peak memory and what was allocated at the start, beside the eager
    step's. Returns (launch counts of the captured steps, model, opt,
    step) with the captured model still alive. `make_step(model, opt,
    level, dtype)` builds the step (the bench's, `_bench_step`, by
    default)."""
    import torch
    from paddle_tpu_torch import jit

    runs = {}
    for mode in ("eager", "static"):
        _clean_device()
        model, opt = build()
        step = (make_step or _bench_step)(model, opt, level, dtype)
        if mode == "static":
            step = jit.to_static(step, share_discovery=True)
        torch.cuda.synchronize()
        start = _memory_at_start(_own_tensors(model, opt))

        def between(i):
            if reseed is not None:
                torch.manual_seed(reseed)

        losses, walls, counts, peak = _step_series(step, prime, big,
                                                   TRAIN_STEPS, between)
        ms = 1e3 * statistics.median(walls[1:])
        runs[mode] = {"losses": losses, "ms_per_step_median": ms,
                      "ms_per_step_min": 1e3 * min(walls[1:]),
                      "first_step_ms": 1e3 * walls[0],
                      f"{units[0]}_per_s": units[1] / (ms / 1e3),
                      "max_memory_allocated_gb": peak, **start,
                      "launches": counts}
        if mode == "eager":
            del model, opt, step
    name, per = units
    prof = profile_train(lambda: step(*big), f"PROFILE_{tag}")
    rep = step.graph_break_report()
    specs = list(step._cache.values())
    eager, static = runs["eager"], runs["static"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(static["losses"],
                                                   eager["losses"]))
    rec = {"prime": list(prime[0].shape), "batch": list(big[0].shape),
           "steps": TRAIN_STEPS, **static,
           "eager": {k: v for k, v in eager.items() if k != "launches"},
           "max_rel_loss_gap": gap,
           "bit_identical": static["losses"] == eager["losses"],
           "graphs": rep["graphs"], "breaks": len(rep["break_sites"]),
           "keys": len(step._state),
           "capture_s": [s.captured.capture_s for s in specs
                         if s.captured is not None],
           "device_busy_share": prof["device_busy_share"],
           "profiled_wall_ms": prof["wall_ms"],
           "profiled_device_ms": prof["device_ms"]}
    _say(tag, rec)
    assert rep["graphs"] == 1 and not rep["break_sites"] \
        and not rep["segmented"], rep
    assert gap <= STATIC_TOL, rec
    assert all(np.isfinite(static["losses"])), rec
    assert static["launches"] == eager["launches"], rec
    got = {n: c for n, c in static["launches"].items() if c}
    assert got == {n: TRAIN_STEPS * c for n, c in want.items()}, (got, want)
    return static["launches"], model, opt, step


def _llama_build(**cfg_kw):
    def build():
        model, opt, _ = _train_model(**cfg_kw)
        return model, opt
    return build


def _ids(vocab, shape, seed=0):
    import torch
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, shape)).cuda()


def static_train():
    """STATIC_TRAIN (TRAIN's configuration) and STATIC_RECOMPUTE (bench.py
    `bench_llama_1b`'s flash_resident) as bench.py `_llama_step` writes
    the step. Returns {tag: launch counts}."""
    prime = (_ids(CFG_1B["vocab_size"], PRIME, 1),)
    big = (_ids(CFG_1B["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ)),)
    layers = CFG_1B["num_hidden_layers"]
    out = {}
    for tag, kw, gran in (("STATIC_TRAIN", {}, None),
                          ("STATIC_RECOMPUTE",
                           {"use_recompute": True,
                            "recompute_granularity": "flash_resident"},
                           "flash_resident")):
        n_params = 9 * layers + 3
        counts, model, opt, step = _static_phase(
            tag, _llama_build(**kw), prime, big,
            ("tokens", TRAIN_BATCH * TRAIN_SEQ),
            _llama_launches(gran, layers, n_params))
        out[tag] = counts
        del model, opt, step
    _clean_device()
    return out


def static_gpt():
    """STATIC_GPT: GPT-3 medium as bench.py `bench_gpt_medium_sharding`
    writes its step (AdamW lr 1e-4, use_multi_tensor=True, O2; without
    `group_sharded_parallel`), primed at 1 x 128, 4 x 1024."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import GPTConfig, GPTForCausalLM

    def build():
        torch.manual_seed(0)
        model = GPTForCausalLM(GPTConfig(**CFG_GPT), device="cuda")
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    use_multi_tensor=True)
        return amp.decorate(model, opt, level="O2", dtype="bfloat16",
                            master_weight=False)

    layers = CFG_GPT["num_hidden_layers"]
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            "fused_layer_norm_fwd": 2 * layers + 1,
            "fused_layer_norm_bwd": 2 * layers + 1, "fused_adam": 2}
    counts, model, opt, step = _static_phase(
        "STATIC_GPT", build, (_ids(CFG_GPT["vocab_size"], PRIME, 1),),
        (_ids(CFG_GPT["vocab_size"], (GPT_BATCH, GPT_SEQ)),),
        ("tokens", GPT_BATCH * GPT_SEQ), want)
    del model, opt, step
    _clean_device()
    return counts


def static_bert():
    """STATIC_BERT: BERT-base as bench.py `bench_bert(amp=True)` writes its
    step (AdamW lr 2e-5, O2, 64 x 128 primed at 2 x 128), every step's
    dropout masks drawn from one seed on both sides; then the captured
    step's dropout draws new masks at each replay (the graph registers the
    default generator): two replays of a captured dropout give different
    masks."""
    import torch
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import (BertConfig,
                                              BertForSequenceClassification)

    cfg = BertConfig()

    def build():
        torch.manual_seed(0)
        model = BertForSequenceClassification(cfg, device="cuda")
        opt = AdamW(learning_rate=2e-5, parameters=model.parameters())
        return amp.decorate(model, opt, level="O2", dtype="bfloat16",
                            master_weight=False)

    rs = np.random.RandomState(0)
    big = (_ids(30000, (BERT_BATCH, BERT_SEQ)),
           torch.from_numpy(rs.randint(0, 2, (BERT_BATCH,))).cuda())
    prime = (_ids(30000, (2, BERT_SEQ), 1),
             torch.from_numpy(rs.randint(0, 2, (2,))).cuda())
    layers = cfg.num_hidden_layers
    with_grads = sum(1 for n, _ in BertForSequenceClassification(
        cfg, device="meta").named_parameters()
        if "token_type" not in n)
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            "fused_layer_norm_fwd": 2 * layers + 1,
            "fused_layer_norm_bwd": 2 * layers + 1,
            "dropout_add_fwd": 2 * layers, "dropout_add_bwd": 2 * layers,
            "fused_adam": with_grads}
    counts, model, opt, step = _static_phase(
        "STATIC_BERT", build, prime, big, ("sequences", BERT_BATCH), want,
        reseed=4321)
    drop = jit.to_static(lambda x: model.dropout(x))
    ones = torch.ones(BERT_BATCH, cfg.hidden_size, device="cuda",
                      dtype=torch.bfloat16)
    masks = [drop(ones) != 0 for _ in range(4)]
    differ = not torch.equal(masks[2], masks[3])
    kept = masks[3].float().mean().item()
    _say("STATIC_BERT_DROPOUT", {"graphs": drop.graph_break_report()["graphs"],
                                 "replay_masks_differ": differ,
                                 "kept_share": kept,
                                 "p": cfg.hidden_dropout_prob})
    assert differ and abs(kept - (1 - cfg.hidden_dropout_prob)) < 0.01
    del model, opt, step, drop
    _clean_device()
    return counts


def _o1_build(seed=0):
    def build():
        import torch
        from paddle_tpu_torch.optimizer import AdamW
        from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

        torch.manual_seed(seed)
        model = LlamaForCausalLM(LlamaConfig(**CFG_168M), device="cuda")
        return model, AdamW(learning_rate=1e-4,
                            parameters=model.parameters())
    return build


def train_o1():
    """TRAIN_O1: bench.py `bench_llama_train(amp=False)`'s 168M LLaMA with
    f32 parameters under auto_cast(O1, bfloat16), AdamW lr 1e-4, 8 x 1024
    primed at 1 x 128: the per-op dtype count of one forward (matmuls in
    bf16; norms and the loss in f32), one step's gradients through the
    kernels against the same step through the plain versions (GRAD_TOL of
    each tensor's largest |value|), then the step eagerly and captured
    (`_static_phase`). Returns the captured steps' launch counts."""
    import torch
    from paddle_tpu_torch import amp

    vocab, layers = CFG_168M["vocab_size"], CFG_168M["num_hidden_layers"]
    big = (_ids(vocab, (O1_BATCH, O1_SEQ)),)
    _clean_device()
    model, opt = _o1_build()()
    ids = big[0]
    with amp.debugging.collect_operator_stats() as stats:
        with amp.auto_cast(enable=True, dtype="bfloat16", level="O1"):
            loss = model(ids, labels=ids)
    del loss

    def o1(fn):
        def run():
            with amp.auto_cast(enable=True, dtype="bfloat16", level="O1"):
                return fn()
        return run

    with_grads = _grad_check(model, o1(lambda: model(ids, labels=ids)),
                             o1(lambda: _plain_attention_loss(model, ids)),
                             "TRAIN_O1_GRAD_CHECK")
    _say("TRAIN_O1_OP_DTYPES", stats)
    assert set(stats["linear"]) == {"bfloat16"}, stats
    assert set(stats["scaled_dot_product_attention"]) == {"bfloat16"}, stats
    for op in ("rms_norm", "fused_linear_cross_entropy"):
        assert set(stats[op]) == {"float32"}, stats
    del model, opt
    counts, model, opt, step = _static_phase(
        "TRAIN_O1", _o1_build(), (_ids(vocab, PRIME, 1),), big,
        ("tokens", O1_BATCH * O1_SEQ),
        _llama_launches(None, layers, with_grads), level="O1")
    del model, opt, step
    _clean_device()
    return counts


def train_f16_scaler():
    """TRAIN_F16_SCALER: TRAIN_O1's model and batch under auto_cast(O1,
    float16) with GradScaler(init_loss_scaling=2**15): K1 and K2 run in
    f16 (F7). Eagerly and captured, primed twice at 1 x 128, then 4 steps,
    one with an injected non-finite gradient (the loss times inf), one
    more: eagerly the injected step is skipped (the parameters stay), in
    the graph the reference's traced branch runs the update on zeroed
    gradients (the parameters move with the moments); the scale halves in
    both, the scalers' state dicts agree, and the losses before the
    injection agree. Returns the captured run's launch counts."""
    import torch
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.ops import _cuda_common

    vocab = CFG_168M["vocab_size"]
    prime = (_ids(vocab, PRIME, 1),)
    big = (_ids(vocab, (O1_BATCH, O1_SEQ)),)
    runs = {}
    for mode in ("eager", "static"):
        _clean_device()
        model, opt = _o1_build()()
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15, device="cuda")
        poison = torch.ones((), device="cuda")
        step = _bench_step(model, opt, "O1", "float16", scaler, poison)
        if mode == "static":
            step = jit.to_static(step, share_discovery=True)
        start = _memory_at_start(_own_tensors(model, opt))
        with amp.debugging.collect_operator_stats() as stats:
            for _ in range(2):
                step(*prime)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda_common.reset_launch_counts()
        losses, walls, scales, moved = [], [], [], []
        for i in range(4):
            poison.fill_(float("inf") if i == 2 else 1.0)
            before = model.lm_head.weight._data.detach().clone()
            t1 = time.perf_counter()
            losses.append(step(*big).item())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            scales.append(scaler.get_loss_scaling().item())
            moved.append(not torch.equal(before, model.lm_head.weight._data))
        runs[mode] = {"losses": losses, "walls_ms": [1e3 * w for w in walls],
                      "ms_per_step_median": 1e3 * statistics.median(
                          walls[1:]),
                      "tokens_per_s": O1_BATCH * O1_SEQ
                      / statistics.median(walls[1:]),
                      "max_memory_allocated_gb":
                      torch.cuda.max_memory_allocated() / 1e9, **start,
                      "scales": scales, "params_moved": moved,
                      "state_dict_scale": float(
                          scaler.state_dict()["scale"]),
                      "step_t": opt._step_t.item(),
                      "launches": _cuda_common.launch_counts(),
                      "attention_dtypes": stats.get(
                          "scaled_dot_product_attention")}
        poison.fill_(1.0)
        prof = profile_train(lambda: step(*big),
                             f"PROFILE_TRAIN_F16_SCALER_{mode.upper()}")
        runs[mode]["device_busy_share"] = prof["device_busy_share"]
        if mode == "static":
            rep = step.graph_break_report()
            runs[mode].update(graphs=rep["graphs"],
                              breaks=len(rep["break_sites"]),
                              capture_s=[s_.captured.capture_s for s_ in
                                         step._cache.values()])
        del model, opt, step, scaler
    eager, static = runs["eager"], runs["static"]
    _say("TRAIN_F16_SCALER", {"init_loss_scaling": 2.0 ** 15,
                              "injected_step": 2, **runs})
    assert eager["attention_dtypes"] and set(eager["attention_dtypes"]) \
        == {"float16"}, eager
    for run in (eager, static):
        assert run["scales"] == [2.0 ** 15] * 2 + [2.0 ** 14] * 2, run
        assert run["launches"]["flash_attention_fwd"] > 0, run
    assert eager["params_moved"] == [True, True, False, True], eager
    assert static["params_moved"] == [True] * 4, static
    assert static["graphs"] == 1 and static["breaks"] == 0, static
    assert eager["state_dict_scale"] == static["state_dict_scale"]
    assert max(abs(a - b) / abs(b) for a, b in zip(
        static["losses"][:3], eager["losses"][:3])) <= STATIC_TOL
    _clean_device()
    return static["launches"]


def amp_mode_cost(steps=5):
    """AMP_MODE_COST: what the AMP mode would cost TRAIN's eager step if
    the models ran their forward under it at O2 instead of suspending it
    (`amp.SUSPEND_O2_IN_MODELS`): the bench step (auto_cast(O2) inside)
    on TRAIN's model, `steps` steps an arm in turns (suspended, on, on,
    suspended), at the priming batch 1 x 128, where the step's wall is
    its host time (the device idles between its small kernels), and at
    TRAIN's 4 x 1024: ms a step (median) of each arm and the share the
    difference is of the suspended step."""
    import torch
    from paddle_tpu_torch import amp

    _clean_device()
    model, opt, ids = _train_model()
    step = _bench_step(model, opt, "O2")
    rec = {}
    old = amp.SUSPEND_O2_IN_MODELS
    try:
        for tag, x in (("host_bound_1x128", _ids(CFG_1B["vocab_size"],
                                                 PRIME, 1)),
                       ("train_4x1024", ids)):
            step(x)
            torch.cuda.synchronize()
            walls = {True: [], False: []}
            for suspend in (True, False, False, True):
                amp.SUSPEND_O2_IN_MODELS = suspend
                for _ in range(steps):
                    t1 = time.perf_counter()
                    loss = step(x)
                    torch.cuda.synchronize()
                    walls[suspend].append(time.perf_counter() - t1)
                    assert np.isfinite(loss.item())
            off = 1e3 * statistics.median(walls[True])
            on = 1e3 * statistics.median(walls[False])
            rec[tag] = {"ms_per_step_suspended": off,
                        "ms_per_step_mode_on": on,
                        "extra_share": (on - off) / off,
                        "ms_suspended_quartiles": np.percentile(
                            1e3 * np.array(walls[True]), [25, 75]).tolist(),
                        "ms_mode_on_quartiles": np.percentile(
                            1e3 * np.array(walls[False]), [25, 75]).tolist()}
    finally:
        amp.SUSPEND_O2_IN_MODELS = old
    _say("AMP_MODE_COST", {"steps_per_arm": 2 * steps, **rec})
    del model, opt, ids, step
    _clean_device()

# ------------------------------------------------------- the Tensor surface

#: a row's bf16 forward against its fp32 one (tests/test_op_table_sweep.py)
TENSOR_BF16_TOL = 5e-2
#: DYGRAPH's eager steps, and DYGRAPH_STATIC's calls (2 eager priming
#: calls, then the captured step)
DYGRAPH_STEPS = 6
#: the DYGRAPH step's launches per step
DYGRAPH_LAUNCHES = {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                    "flash_attention_bwd_dkv": 1, "fused_rms_norm_fwd": 2,
                    "fused_rms_norm_bwd": 2, "rope_qk": 2, "swiglu_fwd": 1,
                    "swiglu_bwd": 1, "fused_adam": 9}


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def _row_run(pt, spec, arrays, place, bf16=False, grads=False):
    """Row `spec` on `arrays` (numpy) at `place`: (output Tensor, the
    gradients of out.sum() or None)."""
    pt.set_device(place)
    skip = set(spec.int_inputs) | set(spec.no_grad_inputs)
    ts = []
    for i, a in enumerate(arrays):
        t = pt.to_tensor(a)
        if bf16 and i not in spec.int_inputs:
            t = t.astype("bfloat16")
        if grads and i not in skip:
            t.stop_gradient = False
        ts.append(t)
    out = _first(spec.fn(*ts, **spec.kwargs))
    if not grads:
        return out, None
    out.sum().backward()
    gs = [t.grad for i, t in enumerate(ts) if i not in skip]
    return out, [None if g is None else g.numpy().astype("float64")
                 for g in gs]


def _close(got, want, rtol, atol, what):
    """Assert np.allclose; returns the max abs error."""
    got = np.asarray(got, dtype="float64")
    want = np.asarray(want, dtype="float64")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.nanmax(np.abs(got - want))) if got.size else 0.0
    assert np.allclose(got, want, rtol=rtol, atol=atol, equal_nan=True), \
        f"{what}: max abs err {err}"
    return err


def _tensor_row(pt, spec):
    """One op-table row on the card (phase 18); returns its max error
    against the CPU."""
    arrays = spec.sample_inputs(seed=0)
    out, _ = _row_run(pt, spec, arrays, "gpu")
    assert out._data.device.type == "cuda", "output left the card"
    cpu, _ = _row_run(pt, spec, arrays, "cpu")
    got = out.numpy().astype("float64")
    err = _close(got, cpu.numpy(), spec.rtol, spec.atol, "fp32 vs cpu")
    if spec.ref is not None:
        _close(got, spec.ref(*arrays), spec.rtol, spec.atol, "fp32 vs ref")
    if spec.bf16:
        a2 = spec.sample_inputs(seed=2)
        o32, _ = _row_run(pt, spec, a2, "gpu")
        ob, _ = _row_run(pt, spec, a2, "gpu", bf16=True)
        assert ob._data.device.type == "cuda"
        _close(ob.numpy(), o32.numpy(), TENSOR_BF16_TOL, TENSOR_BF16_TOL,
               "bf16 vs fp32")
    if spec.diff:
        a1 = spec.sample_inputs(seed=1)
        _, gg = _row_run(pt, spec, a1, "gpu", grads=True)
        _, gc_ = _row_run(pt, spec, a1, "cpu", grads=True)
        for g, c in zip(gg, gc_):
            assert (g is None) == (c is None), "gradient on one side only"
            if g is not None:
                err = max(err, _close(g, c, spec.rtol, spec.atol,
                                      "grad vs cpu"))
    return err


def tensor_ops():
    """Phase 18 (module note). Returns the number of rows."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import op_table

    op_table.ensure_populated()
    t0 = time.perf_counter()
    failed, worst = {}, 0.0
    for name, spec in sorted(op_table.OPS.items()):
        try:
            worst = max(worst, _tensor_row(pt, spec))
        except Exception as e:             # reported, then the run fails
            failed[name] = f"{type(e).__name__}: {e}"[:300]
    pt.set_device("gpu")
    rows = len(op_table.OPS)
    _say("TENSOR_OPS", {"rows": rows, "passed": rows - len(failed),
                        "failed": failed, "deferred": len(op_table.DEFERRED),
                        "max_abs_err_vs_cpu": worst,
                        "seconds": time.perf_counter() - t0,
                        "device": _nvidia_smi()})
    assert not failed, failed
    return rows


def _dygraph_layer():
    """TRAIN's model cut to one layer (its layer 0 is TRAIN's: the same
    seed and init order), O2: (layer, cos, sin, config)."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**dict(CFG_1B, num_hidden_layers=1))
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg, device="cuda")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    model, _ = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                            master_weight=False)
    cos, sin = model.rope_tables()
    return model.model.layers[0], cos, sin, cfg


def _layer_weights(layer, grads=False):
    """The layer's nine weights (or their gradients) in the Tensor
    surface's order, torch tensors (the matmul weights [in, out], the
    layer's own layout)."""
    a, m = layer.self_attn, layer.mlp
    ws = [layer.input_layernorm.weight, a.q_proj.weight, a.k_proj.weight,
          a.v_proj.weight, a.o_proj.weight,
          layer.post_attention_layernorm.weight, m.gate_proj.weight,
          m.up_proj.weight, m.down_proj.weight]
    return [(w.grad if grads else w.detach())._data for w in ws]


def _dygraph_params(pt, weights):
    """Parameters holding copies of `weights`."""
    return [pt.to_tensor(w.contiguous(), stop_gradient=False)
            for w in weights]


def _dygraph_forward(pt, params, x, cos, sin, cfg):
    """The decoder layer on the Tensor surface -> the loss."""
    import paddle_tpu_torch.nn.functional as F

    n1, wq, wk, wv, wo, n2, wg, wu, wd = params
    b, s, h = x.shape
    heads = cfg.num_attention_heads
    hd = h // heads
    y = F.rms_norm(x, n1, cfg.rms_norm_eps)
    q = pt.matmul(y, wq).reshape([b, s, heads, hd])
    k = pt.matmul(y, wk).reshape([b, s, heads, hd])
    v = pt.matmul(y, wv).reshape([b, s, heads, hd])
    q, k = F.rotary_position_embedding(q, k, cos[None, :s, None, :],
                                       sin[None, :s, None, :])
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    a = pt.matmul(o.reshape([b, s, heads * hd]), wo)
    y2, x2 = F.fused_add_rms_norm(a, x, n2, cfg.rms_norm_eps)
    out = pt.add(x2, pt.matmul(F.swiglu(pt.matmul(y2, wg),
                                        pt.matmul(y2, wu)), wd))
    return (out.astype("float32") ** 2).mean()


def _dygraph_step(pt, params, opt, cos, sin, cfg):
    def step(x):
        loss = _dygraph_forward(pt, params, x, cos, sin, cfg)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return step


def _timed(step, x, n):
    """n synchronized calls: (losses, walls in s, launch counts)."""
    import torch
    from paddle_tpu_torch.ops import _cuda_common

    _cuda_common.reset_launch_counts()
    losses, walls = [], []
    for _ in range(n):
        t1 = time.perf_counter()
        losses.append(step(x).detach().item())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    return losses, walls, _cuda_common.launch_counts()


def _host_ms_by_part(surfaces, reps=8):
    """Where a step's host time goes, for each of `surfaces` ({surface:
    parts}, a part (name, fn) with fn taking the previous part's result):
    the parts issued back to back without synchronising, so the card runs
    behind, then the wait for the card, and the whole step. The
    surfaces' steps alternate, so that the shared host's drift falls on
    each alike. Medians over `reps` steps each, in ms."""
    import torch

    walls = {k: {n: [] for n, _ in parts} | {"wait_for_card": [],
                                             "step": []}
             for k, parts in surfaces.items()}
    for _ in range(reps):
        for k, parts in surfaces.items():
            torch.cuda.synchronize()
            state = None
            t0 = time.perf_counter()
            for n, fn in parts:
                t = time.perf_counter()
                state = fn(state)
                walls[k][n].append(time.perf_counter() - t)
            t = time.perf_counter()
            torch.cuda.synchronize()
            walls[k]["wait_for_card"].append(time.perf_counter() - t)
            walls[k]["step"].append(time.perf_counter() - t0)
    return {k: {n: 1e3 * statistics.median(v) for n, v in w.items()}
            for k, w in walls.items()}


def _step_parts(forward, opt):
    """A training step as _host_ms_by_part's parts."""
    def backward(loss):
        loss.backward()

    return [("forward", lambda _: forward()), ("backward", backward),
            ("optimizer", lambda _: opt.step()),
            ("clear_grad", lambda _: opt.clear_grad())]


def dygraph():
    """Phase 19 (module note). Returns the eager step's launch counts."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops import _cuda_common
    from paddle_tpu_torch.optimizer import AdamW

    _clean_device()
    pt.set_device("gpu")
    layer, cos, sin, cfg = _dygraph_layer()
    g = torch.Generator(device="cuda").manual_seed(5)
    xr = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.hidden_size, device="cuda",
                     generator=g).to(torch.bfloat16)
    x = pt.Tensor._wrap(xr)
    init = [w.clone() for w in _layer_weights(layer)]

    # one step's gradients against the torch layer's
    params = _dygraph_params(pt, init)
    _cuda_common.reset_launch_counts()
    loss = _dygraph_forward(pt, params, x, cos, sin, cfg)
    loss.backward()
    counts_fb = _cuda_common.launch_counts()
    ref_loss = (layer(xr, cos, sin).float() ** 2).mean()
    ref_loss.backward()
    rel, identical = [], True
    for p, rg in zip(params, _layer_weights(layer, grads=True)):
        d = (p.grad._data.float() - rg.float()).abs().max().item()
        rel.append(d / rg.float().abs().max().item())
        identical = identical and torch.equal(p.grad._data, rg)
    layer.clear_gradients()

    # DYGRAPH_STEPS AdamW steps on fresh copies, and the torch layer's
    params = _dygraph_params(pt, init)
    opt = AdamW(learning_rate=1e-4, parameters=params)
    eager_step = _dygraph_step(pt, params, opt, cos, sin, cfg)
    losses, walls, counts = _timed(eager_step, x, DYGRAPH_STEPS)
    ref_opt = AdamW(learning_rate=1e-4, parameters=layer.parameters())

    def ref_step(v):
        lv = (layer(v._data, cos, sin).float() ** 2).mean()
        lv.backward()
        ref_opt.step()
        ref_opt.clear_grad()
        return lv

    ref_losses, ref_walls, _ = _timed(ref_step, x, DYGRAPH_STEPS)
    # where a step's time goes, each surface (after the counted steps):
    # the host's parts, then the card's kernels
    host = _host_ms_by_part({
        "tensor": _step_parts(
            lambda: _dygraph_forward(pt, params, x, cos, sin, cfg), opt),
        "torch": _step_parts(
            lambda: (layer(xr, cos, sin).float() ** 2).mean(), ref_opt)})
    prof = profile_train(lambda: eager_step(x), "PROFILE_DYGRAPH")
    ref_prof = profile_train(lambda: ref_step(x), "PROFILE_DYGRAPH_TORCH")
    a16 = pt.to_tensor(np.ones(16, "float32"))
    r16 = torch.ones(16, device="cuda")

    def chain(v):
        def run():
            y = v
            for _ in range(200):
                y = y + v
            return y

        return run

    host_us = _host_us(chain(a16), reps=20) / 200
    host_us_torch = _host_us(chain(r16), reps=20) / 200
    ms = 1e3 * statistics.median(walls[1:])
    rec = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "hidden": cfg.hidden_size,
           "heads": cfg.num_attention_heads,
           "intermediate": cfg.intermediate_size, "dtype": "bfloat16",
           "grad_max_diff_rel": max(rel), "grad_rel_by_param": rel,
           "grad_bit_identical": identical, "grad_tol": GRAD_TOL,
           "losses": losses, "torch_layer_losses": ref_losses,
           "ms_per_step_median": ms,
           "torch_layer_ms_per_step_median": 1e3 * statistics.median(
               ref_walls[1:]),
           "host_ms_by_part": host["tensor"],
           "torch_layer_host_ms_by_part": host["torch"],
           "device_ms": prof["device_ms"],
           "device_busy_share": prof["device_busy_share"],
           "device_ops_per_step": prof["device_ops_per_step"],
           "torch_layer_device_ops_per_step": ref_prof[
               "device_ops_per_step"],
           "torch_layer_device_ms": ref_prof["device_ms"],
           "torch_layer_device_busy_share": ref_prof["device_busy_share"],
           "host_us_per_op": host_us, "torch_host_us_per_op": host_us_torch,
           "launches_forward_backward": counts_fb,
           "launches": counts, "device": _nvidia_smi()}
    _say("DYGRAPH", rec)
    assert max(rel) <= GRAD_TOL, rec
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], rec
    got = {n: c for n, c in counts.items() if c}
    assert got == {n: DYGRAPH_STEPS * c for n, c in
                   DYGRAPH_LAUNCHES.items()}, (got, DYGRAPH_LAUNCHES)
    del ref_opt

    # the same step under to_static, from the same weights
    _clean_device()
    params = _dygraph_params(pt, init)
    opt = AdamW(learning_rate=1e-4, parameters=params)
    step = jit.to_static(_dygraph_step(pt, params, opt, cos, sin, cfg))
    s_losses, s_walls, s_counts = _timed(step, x, DYGRAPH_STEPS)
    rep = step.graph_break_report()
    specs = list(step._cache.values())
    gap = max(abs(a - b) / abs(b) for a, b in zip(s_losses, losses))
    per_step = {n: c // DYGRAPH_STEPS for n, c in counts.items() if c}
    s_got = {n: c for n, c in s_counts.items() if c}
    srec = {"losses": s_losses, "eager_losses": losses,
            "max_rel_loss_gap": gap, "bit_identical": s_losses == losses,
            "graphs": rep["graphs"], "breaks": len(rep["break_sites"]),
            "replay_ms_median": 1e3 * statistics.median(s_walls[3:]),
            "eager_ms_per_step_median": ms,
            "capture_s": [s.captured.capture_s for s in specs
                          if s.captured is not None],
            "launches": s_counts, "device": _nvidia_smi()}
    _say("DYGRAPH_STATIC", srec)
    assert rep["graphs"] == 1 and not rep["break_sites"] \
        and not rep["segmented"], rep
    assert gap <= STATIC_TOL, srec
    assert s_got == {n: DYGRAPH_STEPS * c for n, c in per_step.items()}, \
        (s_got, per_step)
    del step, opt, params, layer, init
    _clean_device()
    return counts


#: NN_QUICKSTART: the README's quick start at its own width (784 -> 256
#: -> 10, AdamW 1e-3, F.cross_entropy), on one seeded batch
QS_BATCH, QS_STEPS = 64, 20
#: NN_TRANSFORMER: BERT-base's encoder as nn layers (12 layers of d 768,
#: 12 heads, FFN 3072, GELU, post-LN, dropout 0.1, no attention dropout)
NN_LAYERS, NN_D, NN_HEADS, NN_FFN = 12, 768, 12, 3072


def nn_quickstart():
    """Phase 20 (module note). Returns the captured run's record."""
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import jit

    pt.set_device("gpu")
    rs = np.random.RandomState(0)
    x = pt.to_tensor(rs.randn(QS_BATCH, 784).astype("float32"))
    y = pt.to_tensor(rs.randint(0, 10, (QS_BATCH,)))

    def run(static):
        pt.seed(0)
        net = nn.Sequential(nn.Linear(784, 256), nn.ReLU(),
                            nn.Linear(256, 10))
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters())

        def train_step(x, y):
            loss = F.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        step = jit.to_static(train_step) if static else train_step
        losses, walls = [], []
        for _ in range(QS_STEPS):
            t1 = time.perf_counter()
            losses.append(float(step(x, y)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        return losses, walls, step

    eager, ewalls, _ = run(False)
    static, swalls, step = run(True)
    rep = step.graph_break_report()
    gap = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(static, eager))
    rec = {"widths": [784, 256, 10], "batch": QS_BATCH, "steps": QS_STEPS,
           "losses": static, "eager_losses": eager,
           "max_rel_loss_gap": gap, "bit_identical": static == eager,
           "graphs": rep["graphs"], "breaks": len(rep["break_sites"]),
           "keys": len(step._cache),
           "ms_per_step_median": 1e3 * statistics.median(swalls[3:]),
           "eager_ms_per_step_median": 1e3 * statistics.median(ewalls[3:]),
           "device": _nvidia_smi()}
    _say("NN_QUICKSTART", rec)
    assert all(np.isfinite(static)) and static[-1] < 0.5 * static[0], rec
    assert eager[-1] < 0.5 * eager[0], rec
    assert rep["graphs"] == 1 and not rep["break_sites"] \
        and len(step._cache) == 1, rec
    assert gap <= STATIC_TOL, rec
    return rec


def _nn_encoder_step(model, opt, level, dtype):
    """NN_TRANSFORMER's step: the encoder under auto_cast(level), an MSE
    loss against a fixed target, then backward, step, clear_grad."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp

    def step(x, y):
        with amp.auto_cast(enable=True, dtype=dtype, level=level):
            loss = F.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return step


def nn_transformer():
    """Phase 21 (module note). Returns the captured steps' launch
    counts."""
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp

    pt.set_device("gpu")

    def build():
        pt.seed(0)
        enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
            NN_D, NN_HEADS, NN_FFN, dropout=0.1, activation="gelu",
            attn_dropout=0.0), NN_LAYERS)
        opt = pt.optimizer.AdamW(learning_rate=2e-5,
                                 parameters=enc.parameters())
        return amp.decorate(enc, opt, level="O2", dtype="bfloat16")

    def data(batch, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return tuple(pt.Tensor._wrap(torch.randn(
            batch, BERT_SEQ, NN_D, device="cuda", generator=g))
            for _ in range(2))

    big, prime = data(BERT_BATCH, 0), data(2, 1)
    # one step's gradients through the kernels against the plain path
    _clean_device()
    enc, opt = build()
    dtypes = {str(p.dtype) for n, p in enc.named_parameters()
              if "norm" not in n}
    norm_dtypes = {str(p.dtype) for n, p in enc.named_parameters()
                   if "norm" in n}
    assert dtypes == {"bfloat16"} and norm_dtypes == {"float32"}, \
        (dtypes, norm_dtypes)

    def loss_fn():
        with amp.auto_cast(enable=True, dtype="bfloat16", level="O2"):
            return F.mse_loss(enc(big[0]), big[1])

    with_grads = _grad_check(enc, loss_fn, _plain_path(loss_fn),
                             "NN_TRANSFORMER_GRAD_CHECK")
    assert with_grads == len(enc.parameters()) == 16 * NN_LAYERS
    # the state_dict through paddle.save / paddle.load, bit for bit
    sd = enc.state_dict()
    back, rt = _save_load(sd, "encoder")
    enc.set_state_dict(back)
    _say("NN_TRANSFORMER_STATE_DICT", {
        "tensors": len(sd), "bytes": rt["file_bytes"],
        "save_s": rt["save_s"], "bit_exact": rt["bit_exact"]})
    assert rt["bit_exact"]
    del enc, opt, back, sd
    # 6 steps eager, then the same step under to_static
    want = {"flash_attention_fwd": NN_LAYERS,
            "flash_attention_bwd_dq": NN_LAYERS,
            "flash_attention_bwd_dkv": NN_LAYERS,
            "fused_layer_norm_fwd": 2 * NN_LAYERS,
            "fused_layer_norm_bwd": 2 * NN_LAYERS,
            "fused_adam": 16 * NN_LAYERS}
    counts, enc, opt, step = _static_phase(
        "NN_TRANSFORMER", build, prime, big, ("sequences", BERT_BATCH), want,
        reseed=4321, make_step=_nn_encoder_step)
    assert all(counts[n] == 0 for n in ("dropout_add_fwd",
                                        "dropout_add_bwd"))
    del enc, opt, step
    _clean_device()
    return counts

#: INCUBATE_FUSED: (name, the kernel its forward launches, the kernel
#: its backward launches) of each kernel path of incubate.nn.functional
INCUBATE_KERNELS = {
    "fused_rms_norm": ("fused_rms_norm_fwd", "fused_rms_norm_bwd"),
    "fused_rms_norm residual": ("fused_rms_norm_fwd", "fused_rms_norm_bwd"),
    "fused_layer_norm": ("fused_layer_norm_fwd", "fused_layer_norm_bwd"),
    "fused_rotary_position_embedding": ("rope_qk", "rope_qk"),
    "swiglu": ("swiglu_fwd", "swiglu_bwd"),
    "fused_dropout_add": ("dropout_add_fwd", "dropout_add_bwd"),
}


def _incubate_cases():
    """{name: (call, inputs, the inputs that take a gradient)} at the main
    paths' shapes: K3 at TRAIN's norm (4096 x 2048 bf16, with and without
    the residual), K3-LN and K6 at BERT's (8192 x 768), K4 at TRAIN's q /
    k (4 x 1024 x 16 x 128), K5 at TRAIN's MLP (4096 x 5504)."""
    import torch
    from paddle_tpu_torch.incubate.nn import functional as IF

    g = torch.Generator(device="cuda").manual_seed(22)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device="cuda", generator=g, dtype=dtype)

    rows, h = TRAIN_BATCH * TRAIN_SEQ, CFG_1B["hidden_size"]
    ln_rows, ln_h = BERT_BATCH * BERT_SEQ, 768
    d = 128
    pos = torch.arange(TRAIN_SEQ, device="cuda", dtype=torch.float32)
    inv = 1.0 / 10000.0 ** (torch.arange(0, d, 2, device="cuda") / d)
    ang = torch.cat([pos[:, None] * inv[None]] * 2, -1)[None, :, None, :]
    cos, sin = ang.cos().bfloat16(), ang.sin().bfloat16()
    q_shape = (TRAIN_BATCH, TRAIN_SEQ, 16, d)
    return {
        "fused_rms_norm": (
            lambda x, w: IF.fused_rms_norm(x, w, epsilon=1e-6)[:1],
            (rnd(rows, h), rnd(h)), (0, 1)),
        "fused_rms_norm residual": (
            lambda x, r, w: IF.fused_rms_norm(x, w, epsilon=1e-6,
                                              residual=r),
            (rnd(rows, h), rnd(rows, h), rnd(h)), (0, 1, 2)),
        "fused_layer_norm": (
            lambda x, w, b: IF.fused_layer_norm(x, w, b, 1e-12)[:1],
            (rnd(ln_rows, ln_h), rnd(ln_h, dtype=torch.float32),
             rnd(ln_h, dtype=torch.float32)), (0, 1, 2)),
        "fused_rotary_position_embedding": (
            lambda q, k, c, s: IF.fused_rotary_position_embedding(
                q, k, sin=s, cos=c),
            (rnd(*q_shape), rnd(*q_shape), cos, sin), (0, 1)),
        "swiglu": (lambda a, b: (IF.swiglu(a, b),),
                   (rnd(rows, CFG_1B["intermediate_size"]),
                    rnd(rows, CFG_1B["intermediate_size"])), (0, 1)),
        "fused_dropout_add": (
            lambda x, y: (IF.fused_dropout_add(x, y, p=0.1),),
            (rnd(ln_rows, ln_h), rnd(ln_rows, ln_h)), (0, 1)),
    }


def _run_case(fn, inputs, grad_ix, douts=None, seed=7):
    """(outputs, the gradients of the inputs at `grad_ix`, douts) of one
    forward and backward of fn on copies of `inputs` (the default
    generators seeded with `seed` first, so dropout draws one mask);
    douts are drawn on the first call, the same after."""
    import torch

    leaves = [t.detach().clone().requires_grad_(i in grad_ix)
              for i, t in enumerate(inputs)]
    torch.manual_seed(seed)
    outs = fn(*leaves)
    if douts is None:
        g = torch.Generator(device=outs[0].device).manual_seed(seed)
        douts = [torch.randn(o.shape, generator=g, device=o.device,
                             dtype=o.dtype) for o in outs]
    torch.autograd.backward(outs, [d.to(o.device) for d, o in
                                   zip(douts, outs)])
    return ([o.detach() for o in outs],
            [leaves[i].grad for i in grad_ix], douts)


def incubate_fused():
    """INCUBATE_FUSED: each kernel path of incubate.nn.functional, forward
    and backward, at the main paths' shapes (`_incubate_cases`): exactly
    one launch of its forward kernel in the forward and of its backward
    kernel in the backward, by the counters, and nothing else; its
    outputs and gradients against the kernels' plain versions (the same
    call on CPU copies of the inputs; K6 against the flag-off
    composition on the card, which draws the same mask) within FUSED_TOL
    of each tensor's largest |value| at the case's input dtype (every
    case reads a bf16 stream), as the KERNEL lines hold the kernels; the forward's ms (events) beside the plain side's on the
    card. Returns the launch counts of the counted calls."""
    import torch
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.ops import _cuda_common

    total = {}
    for name, (fn, inputs, grad_ix) in _incubate_cases().items():
        fwd, bwd = INCUBATE_KERNELS[name]
        leaves = [t.detach().clone().requires_grad_(i in grad_ix)
                  for i, t in enumerate(inputs)]
        torch.cuda.synchronize()
        _cuda_common.reset_launch_counts()
        torch.manual_seed(7)
        outs = fn(*leaves)
        torch.cuda.synchronize()
        got_fwd = {n: c for n, c in _cuda_common.launch_counts().items()
                   if c}
        g = torch.Generator(device="cuda").manual_seed(7)
        douts = [torch.randn(o.shape, generator=g, device="cuda",
                             dtype=o.dtype) for o in outs]
        _cuda_common.reset_launch_counts()
        torch.autograd.backward(outs, douts)
        torch.cuda.synchronize()
        got_bwd = {n: c for n, c in _cuda_common.launch_counts().items()
                   if c}
        assert got_fwd == {fwd: 1} and got_bwd == {bwd: 1}, (
            name, got_fwd, got_bwd)
        for cnt in (got_fwd, got_bwd):
            for n, c in cnt.items():
                total[n] = total.get(n, 0) + c
        outs = [o.detach() for o in outs]
        grads = [leaves[i].grad for i in grad_ix]
        if name == "fused_dropout_add":
            set_flags({"FLAGS_pallas_fused_ops": False})
            try:
                _cuda_common.reset_launch_counts()
                pouts, pgrads, _ = _run_case(fn, inputs, grad_ix, douts)
                torch.cuda.synchronize()
                assert not any(_cuda_common.launch_counts().values())
                plain_ms = _time_ms(lambda: fn(*inputs))
            finally:
                set_flags({"FLAGS_pallas_fused_ops": True})
            plain_side = "flag-off composition, card"
        else:
            pouts, pgrads, _ = _run_case(fn, [t.cpu() for t in inputs],
                                         grad_ix, [d.cpu() for d in douts])
            plain_side = "plain version, CPU"
            plain_ms = None
        rels = []
        for i, (a, w) in enumerate(zip(outs + grads, pouts + pgrads)):
            assert a.dtype == w.dtype and a.shape == w.shape, (name, i)
            assert torch.isfinite(a.float()).all(), (name, i)
            w = w.to(a.device)
            rel = ((a.float() - w.float()).abs().max()
                   / w.float().abs().max()).item()
            # the case's input precision (a bf16 stream normed into an f32
            # output rounds to bf16 on the way); a weight's gradient sums
            # over rows: the KERNEL lines' dw tol in f32
            key = str(inputs[0].dtype).replace("torch.", "")
            tol = FUSED_TOL["dw_float32" if key == "float32" and i >= len(
                outs) and a.dim() == 1 else key]
            assert rel <= tol, (name, i, rel, tol)
            rels.append(rel)
        rec = {"name": name, "kernels": [fwd, bwd],
               "shapes": [list(t.shape) for t in inputs],
               "dtypes": [str(t.dtype).replace("torch.", "")
                          for t in inputs],
               "launches_forward": got_fwd, "launches_backward": got_bwd,
               "rel_err": rels, "max_rel_err": max(rels),
               "plain_side": plain_side, "ms": _time_ms(lambda: fn(*inputs)),
               "plain_ms_card": plain_ms}
        _say("INCUBATE_FUSED", rec)
        del leaves, outs, grads, pouts, pgrads, douts
    torch.cuda.empty_cache()
    return total


def signal_phase():
    """SIGNAL: `signal.stft` / `istft` at a speech front end's size (16
    signals of 160,000 samples, 10 s at 16 kHz, f32; n_fft 512, hop 160,
    a Hann window): istft(stft(x)) gives x back within SIGNAL_TOL of its
    largest |value|, the card's spectrum equals the same call on the CPU
    within SIGNAL_TOL of the spectrum's largest |value|, and `fft.fft`,
    `rfft` and `fft2` on the card equal the CPU's likewise; the ms of each
    transform (events)."""
    import torch
    from paddle_tpu_torch import fft, signal

    g = torch.Generator(device="cuda").manual_seed(16000)
    x = torch.randn(16, 160000, device="cuda", generator=g)
    win = torch.from_numpy(np.hanning(512).astype("float32")).cuda()
    kw = dict(n_fft=512, hop_length=160, window=win)
    spec = signal.stft(x, **kw)
    back = signal.istft(spec, length=x.shape[-1], **kw)
    cpu_spec = signal.stft(x.cpu(), n_fft=512, hop_length=160,
                           window=win.cpu())

    def rel(a, b):
        b = b.to(a.device)
        return ((a - b).abs().max() / b.abs().max()).item()

    xs = x.reshape(16 * 400, 400)
    rows = {"fft": rel(fft.fft(x), fft.fft(x.cpu())),
            "rfft": rel(fft.rfft(x), fft.rfft(x.cpu())),
            "fft2": rel(fft.fft2(xs), fft.fft2(xs.cpu()))}
    rec = {"signals": list(x.shape), "n_fft": 512, "hop": 160,
           "spectrum": list(spec.shape), "spectrum_dtype": str(spec.dtype),
           "round_trip_rel_err": rel(back, x),
           "card_vs_cpu_rel_err": rel(spec, cpu_spec),
           "fft_card_vs_cpu_rel_err": rows, "tol": SIGNAL_TOL,
           "stft_ms": _time_ms(lambda: signal.stft(x, **kw), reps=10),
           "istft_ms": _time_ms(lambda: signal.istft(
               spec, length=x.shape[-1], **kw), reps=10),
           "rfft_ms": _time_ms(lambda: fft.rfft(x), reps=10),
           "device": _nvidia_smi()}
    _say("SIGNAL", rec)
    assert list(spec.shape) == [16, 257, 1001] \
        and spec.dtype == torch.complex64, rec
    assert max(rec["round_trip_rel_err"], rec["card_vs_cpu_rel_err"],
               *rows.values()) <= SIGNAL_TOL, rec
    del x, spec, back, cpu_spec
    torch.cuda.empty_cache()


def models_layer():
    """MODELS_LAYER: LLaMA 1B, GPT-3 medium and BERT-base built on the
    card as `nn.Layer`s (seed 0): their state_dict keys and shapes equal
    the reference's naming rule for the config
    (`convert.state_dict_shapes`, held against paddle_tpu's models in the
    CPU tests), every parameter the Tensor API's `Parameter`; then O2
    bf16 (`amp.decorate`), the state dict through paddle.save /
    paddle.load bit for bit, and the parameter bytes. The line also
    carries the Layer models' numbers from the earlier phases: the
    captured device ms of STATIC_TRAIN / _GPT / _BERT, SERVE's steady ms
    a tick, CE_CHUNK_LLAMA's ms and TRAIN's peak GB."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models import (
        BertConfig, BertForSequenceClassification, GPTConfig,
        GPTForCausalLM, LlamaConfig, LlamaForCausalLM)
    from paddle_tpu_torch.text.models.convert import state_dict_shapes

    out = {}
    for name, cfg, build in (
            ("llama_1b", LlamaConfig(**CFG_1B), LlamaForCausalLM),
            ("gpt3_medium", GPTConfig(**CFG_GPT), GPTForCausalLM),
            ("bert_base", BertConfig(), BertForSequenceClassification)):
        _clean_device()
        torch.manual_seed(0)
        model = build(cfg, device="cuda")
        sd = model.state_dict()
        keys_match = [(k, v.shape) for k, v in sd.items()] \
            == state_dict_shapes(cfg)
        all_params = all(isinstance(p, pt.Parameter)
                         for p in model.parameters())
        amp.decorate(model, level="O2", dtype="bfloat16")
        sd = model.state_dict()
        back, rt = _save_load(sd, name)
        dtypes = {}
        for p in model.parameters():
            dtypes[str(p.dtype)] = dtypes.get(str(p.dtype), 0) + 1
        out[name] = {
            "tensors": len(sd), "keys_and_shapes_match": keys_match,
            "all_parameters": all_params, "o2_dtypes": dtypes,
            "parameter_bytes": sum(p._data.numel() * p._data.element_size()
                                   for p in model.parameters()), **rt}
        assert keys_match and all_params and rt["bit_exact"], (name,
                                                               out[name])
        del model, sd, back
    _clean_device()
    out["from_phases"] = {
        "static_train_device_ms": _LINES["STATIC_TRAIN"][
            "profiled_device_ms"],
        "static_gpt_device_ms": _LINES["STATIC_GPT"]["profiled_device_ms"],
        "static_bert_device_ms": _LINES["STATIC_BERT"][
            "profiled_device_ms"],
        "serve_decode_ms_per_tick_steady": _LINES["SERVE"][
            "decode_ms_per_tick_steady"],
        "ce_chunk_llama_ms": _LINES["CE_CHUNK_LLAMA"]["chunked_ms"],
        "train_max_memory_allocated_gb": _LINES["TRAIN"][
            "max_memory_allocated_gb"]}
    out["device"] = _nvidia_smi()
    _say("MODELS_LAYER", out)


def _inner_forwards(classes, unwrapped):
    """Set each class's `forward` to the function beneath its op boundary
    (`unwrapped`) or back to the boundary's wrapper."""
    for cls, wrapped in classes:
        cls.forward = wrapped.__wrapped__ if unwrapped else wrapped


def _eager_train(name):
    """(model, opt, ids, labels) of the eager step of TRAIN (`llama_1b`),
    TRAIN_GPT (`gpt3_medium`) or TRAIN_BERT (`bert_base`): the model from
    seed 0, decorated O2 bf16 with its AdamW (bf16 moments), the batch
    from RandomState(0). Only calls that the port's models have had since
    they were first ported, so that it builds an older tree's too."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text import models as M

    rs = np.random.RandomState(0)
    torch.manual_seed(0)
    if name == "llama_1b":
        model = M.LlamaForCausalLM(M.LlamaConfig(**CFG_1B), device="cuda")
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        ids = rs.randint(0, CFG_1B["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ))
        labels = None
    elif name == "gpt3_medium":
        model = M.GPTForCausalLM(M.GPTConfig(**CFG_GPT), device="cuda")
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    use_multi_tensor=True)
        ids = rs.randint(0, CFG_GPT["vocab_size"], (GPT_BATCH, GPT_SEQ))
        labels = None
    else:
        model = M.BertForSequenceClassification(M.BertConfig(),
                                                device="cuda")
        opt = AdamW(learning_rate=2e-5, parameters=model.parameters())
        ids = rs.randint(0, 30000, (BERT_BATCH, BERT_SEQ))
        labels = torch.from_numpy(rs.randint(0, 2, (BERT_BATCH,))).cuda()
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                              master_weight=False)
    ids = torch.from_numpy(ids).cuda()
    return model, opt, ids, ids if labels is None else labels


def host_dispatch(reps=8):
    """HOST_DISPATCH: phase 25 (module note). The models' inner layers
    are called with torch tensors only, so the forward beneath the
    boundary computes the same step."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.ops import fused_norm
    from paddle_tpu_torch.text.models import bert as bert_mod
    from paddle_tpu_torch.text.models import gpt as gpt_mod

    inner_classes = {
        "gpt3_medium": (gpt_mod.GPTAttention, gpt_mod.GPTBlock),
        "bert_base": (bert_mod.BertEmbeddings, bert_mod.BertSelfAttention,
                      bert_mod.BertLayer, bert_mod.BertModel)}
    out = {}
    for name, classes in inner_classes.items():
        _clean_device()
        model, opt, ids, y = _eager_train(name)
        inner = [(c, c.forward) for c in classes]

        def fwd(unwrapped):
            def run():
                _inner_forwards(inner, unwrapped)
                try:
                    return model(ids, labels=y)
                finally:
                    _inner_forwards(inner, False)
            return run

        for _ in range(2):                      # warm up both ways
            for unwrapped in (False, True):
                fwd(unwrapped)().backward()
                opt.step()
                opt.clear_grad()
        parts = _host_ms_by_part(
            {"boundary_on_inner_forwards": _step_parts(fwd(False), opt),
             "boundary_off_inner_forwards": _step_parts(fwd(True), opt)},
            reps)
        counts = {}
        hooks = [sub.register_forward_pre_hook(
            lambda layer, _, k=type(sub).__name__: counts.__setitem__(
                k, counts.get(k, 0) + 1))
            for sub in model.sublayers()
            if isinstance(sub, (nn.Linear, nn.LayerNorm, nn.Embedding,
                                nn.Dropout))]
        with torch.no_grad():
            model(ids, labels=y)
        for h in hooks:
            h.remove()
        lin = next(s for s in model.sublayers() if isinstance(s, nn.Linear))
        ln = next(s for s in model.sublayers()
                  if isinstance(s, nn.LayerNorm))
        x = torch.randn(8, lin.weight.shape[0], device="cuda",
                        dtype=torch.bfloat16)
        wt, b = lin.weight._data.t(), getattr(lin.bias, "_data", None)
        with torch.no_grad(), amp.model_scope(model):
            per_call = {
                "linear_layer_us": _host_us(lambda: lin(x)),
                "linear_torch_us": _host_us(lambda: F.linear(x, wt, b)),
                "layer_norm_layer_us": _host_us(lambda: ln(x)),
                "layer_norm_torch_us": _host_us(
                    lambda: fused_norm.layer_norm_raw(
                        x, ln.weight._data, ln.bias._data, ln._epsilon,
                        torch.float32))}
        out[name] = {"host_ms_by_part": parts, "nn_calls_per_forward":
                     counts, **per_call}
        del model, opt, ids
    _clean_device()
    out["device"] = _nvidia_smi()
    _say("HOST_DISPATCH", out)


def host_parts(reps=8):
    """HOST_PARTS (`python3 chip_smoke.py --host-parts DIR`, the port's
    package imported from DIR): the eager steps of TRAIN, TRAIN_GPT and
    TRAIN_BERT (`_eager_train`), alternated, each step's host ms by part
    (`_host_ms_by_part`: forward, backward, optimizer and clear_grad
    issued without synchronising, then the wait for the card), with the
    garbage collector's collections by generation over the timed steps
    and the objects it tracks, and the Python function calls one forward
    of each model makes (`sys.setprofile`, with the eight functions
    called most); so that two trees' host time compares part by part in
    one call. Prints the HOST_PARTS line and the card."""
    import gc as _gc

    import torch
    from paddle_tpu_torch.ops import _cuda_common

    _cuda_common.build_kernels()
    steps = {}
    for name in ("llama_1b", "gpt3_medium", "bert_base"):
        model, opt, ids, y = _eager_train(name)

        def forward(model=model, ids=ids, y=y):
            return model(ids, labels=y)

        for _ in range(2):
            forward().backward()
            opt.step()
            opt.clear_grad()
        steps[name] = (model, opt, forward)
    calls = {}
    for name, (_, _, forward) in steps.items():
        count = {}

        def tally(frame, event, arg, count=count):
            if event == "call":
                code = frame.f_code
                key = (code.co_filename.rsplit("site-packages/", 1)[-1]
                       .rsplit("paddle_tpu_torch/", 1)[-1]
                       + ":" + code.co_name)
                count[key] = count.get(key, 0) + 1

        sys.setprofile(tally)
        forward()
        sys.setprofile(None)
        top = sorted(count.items(), key=lambda kv: -kv[1])[:8]
        calls[name] = {"total": sum(count.values()), "top": top}
    torch.cuda.synchronize()
    before = [g["collections"] for g in _gc.get_stats()]
    parts = _host_ms_by_part({n: _step_parts(f, o)
                              for n, (_, o, f) in steps.items()}, reps)
    after = [g["collections"] for g in _gc.get_stats()]
    out = {"package": os.path.dirname(os.path.dirname(
               _cuda_common.__file__)),
           "host_ms_by_part": parts, "reps": reps,
           "gc_collections_by_generation": [b - a for a, b in
                                            zip(before, after)],
           "gc_tracked_objects": len(_gc.get_objects()),
           "python_calls_per_forward": calls, "device": _nvidia_smi()}
    _say("HOST_PARTS", out)


def _save_load(sd, name):
    """A state dict through paddle.save / paddle.load in a temporary
    directory: (the loaded dict, {"file_bytes", "save_s", "load_s",
    "bit_exact"}), bit_exact when the keys, dtypes, devices and every
    bit come back."""
    import tempfile

    import torch
    import paddle_tpu_torch as pt

    def bits(t):
        return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"{name}.pdparams")
        t0 = time.perf_counter()
        pt.save(sd, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = pt.load(path)
        load_s = time.perf_counter() - t0
    exact = list(back) == list(sd) and all(
        str(back[k].dtype) == str(v.dtype)
        and back[k]._data.device == v._data.device
        and torch.equal(bits(back[k]._data), bits(v._data))
        for k, v in sd.items())
    return back, {"file_bytes": size, "save_s": save_s, "load_s": load_s,
                  "bit_exact": exact}


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
    _cuda_common.build_kernels()
    _say("BUILD", {"seconds": time.perf_counter() - t0,
                   "kernels": sorted(_cuda_common.KERNEL_SOURCES)})
    tc_usage()
    decode_usage()
    qmm_usage()
    norm_usage()
    optim_usage()
    phases = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()

    flash = [flash_case(1, 16, 16, s) for s in (128, 500, 512, 1024)]
    flash.append(flash_case(1, 16, 4, 512))
    # K1 at the shape the LLaMA train step launches it
    flash_train = flash_case(TRAIN_BATCH, 16, 16, TRAIN_SEQ, residual=True)
    # K2 at the train shape, a GQA case and a ragged length
    bwd = [flash_bwd_case(TRAIN_BATCH, 16, 16, TRAIN_SEQ),
           flash_bwd_case(1, 16, 4, 512), flash_bwd_case(1, 16, 16, 500)]
    dec = decode_case()
    # the 1B serve's int4 matmuls: q/k/v/o, gate/up and down at decode (M
    # = 8 slots) and at two prefill buckets (M = 64, 512); the f32 lm_head
    # at 8 slots and at one
    qmm = {(m, k, n): qmm_case(m, k, n) for m in (8, 64, 512)
           for k, n in ((2048, 2048), (2048, 5504), (5504, 2048))}
    qmm_head = [qmm_case(m, 2048, 32000, "float32") for m in (8, 1)]
    dec_q = {fmt: quant_decode_case(fmt) for fmt in ("int8", "int4")}
    # two long contexts (2733 and 2608 tokens of a 4096-token table): the
    # case split-K is for
    dec_long = decode_case(seqs=2, max_len=4096, tag="long")
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
    flash64 = {"gpt": flash_case(GPT_BATCH, 16, 16, GPT_SEQ, 64,
                                 residual=True),
               "bert": flash_case(BERT_BATCH, 12, 12, BERT_SEQ, 64,
                                  causal=False, residual=True)}
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
    # F7: the flash family and the paged decode in float16
    f16 = f16_cases()
    phases["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    optim, counts_optim = optim_phase()
    phases["optim"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, counts, served = serve()
    profile_decode(model)
    counts_q4 = serve_quant(model, "int4", "int4", 16, "SERVE_Q4")
    counts_q8 = serve_quant(model, "int8", "int8", 8, "SERVE_Q8")
    profile_decode(model, tag="PROFILE_Q4", weight_quant="int4",
                   kv_cache_dtype="int4")
    profile_prefill(model)
    counts_prefix, prefixed = serve_prefix(model)
    profile_chunk(model)
    serve_graph_eager(model, served, prefixed)
    serve_graph_steady(model)
    del served, prefixed
    del model                     # the serving weights; TRAIN builds its own
    phases["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _clean_device()
    tmodel, opt, ids, counts_train, train_peak = train()
    profile_train(lambda: _train_step(tmodel, opt, ids, ids))
    train_unfused(tmodel, opt, ids)
    del tmodel, opt, ids
    phases["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    recompute = train_recompute()
    assert recompute["flash_resident"][1] < train_peak, (recompute,
                                                         train_peak)
    ce_chunk()
    counts_recompute = {g: c for g, (c, _) in recompute.items()}
    for cnt in (counts, counts_q4, counts_q8, counts_train,
                *counts_recompute.values(), *counts_prefix.values()):
        assert all(cnt[n] == 0 for n in LN_DROPOUT_KERNELS), cnt
    phases["train_recompute"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _clean_device()
    counts_gpt = train_gpt()
    _clean_device()
    counts_bert = train_bert()
    for cnt in (counts, counts_q4, counts_q8, counts_train, counts_gpt,
                counts_bert, *counts_recompute.values(),
                *counts_prefix.values()):
        assert all(cnt[n] == 0 for n in VARLEN_KERNELS + FM_KERNELS), cnt
    torch.cuda.empty_cache()
    phases["train_gpt_bert"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the bench's steps as it writes them: to_static, one captured CUDA
    # graph per key, beside the same steps run eagerly
    amp_mode_cost()
    counts_static = static_train()
    counts_static["STATIC_GPT"] = static_gpt()
    counts_static["STATIC_BERT"] = static_bert()
    counts_static["TRAIN_O1"] = train_o1()
    counts_f16 = train_f16_scaler()
    phases["static"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # K1v/K2v at the VARLEN batch; K9 at the FLASHMASK window and at a
    # ragged S with random start rows (straddling tiles everywhere)
    varlen = varlen_cases()
    fm = flashmask_cases(FM_SEQ, _fm_window_starts, "window")
    g = torch.Generator(device="cuda").manual_seed(3)
    flashmask_cases(4100, lambda s, h: torch.randint(
        1, s + 1, (1, h, s), device="cuda", generator=g,
        dtype=torch.int32), "random")
    torch.cuda.empty_cache()
    counts_varlen = varlen_phase()
    torch.cuda.empty_cache()
    counts_fm = flashmask_phase()
    phases["attention_apis"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the Tensor API: every op-table row on the card, then one 1B layer
    # trained on the Tensor surface, eagerly and captured
    tensor_ops()
    counts_dyg = dygraph()
    phases["tensor_surface"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the nn surface: the README quick start, then BERT-base's encoder as
    # nn layers through K1, K2 and K3-LN
    nn_quickstart()
    counts_nn = nn_transformer()
    phases["nn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the long tail: incubate.nn.functional's kernel paths, the signal
    # front end, and the three models' state dicts as Layers
    counts_incubate = incubate_fused()
    signal_phase()
    models_layer()
    host_dispatch()
    phases["long_tail"] = time.perf_counter() - t0
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
             counts_q4)):
        summary.append({
            "name": rec["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": cnt[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "launches_prefix_phases": {
                tag: c[rec["name"]] for tag, c in counts_prefix.items()}}
            | {k: rec[k] for k in ("varlen_full_ms", "body") if k in rec})
    # K8 at every timed shape: decode, prefill, the lm_head; launches are
    # SERVE_Q4's count (all its shapes)
    for rec in [*qmm.values(), *qmm_head]:
        m, k, n = rec["shape"]
        summary.append({
            "name": rec["name"], "case": f"M {m} x {k} x {n} {rec['dtype']}",
            "route": "cuda", "body": rec["body"],
            "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "paddle_tpu/ops/quantized.py:144",
            "launches": counts_q4[rec["name"]],
            "launches_prefix_phases": {
                tag: c[rec["name"]] for tag, c in counts_prefix.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
            | {k: rec[k] for k in ("replaced_ms", "replaced_body")
               if k in rec})
    # K1 at TRAIN's shape, launched by TRAIN's steps
    summary.append({
        "name": flash_train["name"], "case": "train", "route": "cuda",
        "body": flash_train["body"],
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_attention.py:104",
        "launches": counts_train[flash_train["name"]],
        "launches_recompute": {g: c[flash_train["name"]]
                               for g, c in counts_recompute.items()},
        "max_abs_err": flash_train["max_abs_err"], "ms": flash_train["ms"],
        "varlen_full_ms": flash_train["varlen_full_ms"],
        "plain_ms": flash_train["plain_ms"],
        "bound_ms": flash_train["bound_ms"],
        "bound_by": flash_train["bound_by"],
        "library_ms": flash_train["library_ms"]}
        | {k: flash_train[k] for k in RESIDUAL_KEYS})
    # K2's two kernels at the train shape, each with its own numbers
    for kname, key, line in (("flash_attention_bwd_dq", "dq", 263),
                             ("flash_attention_bwd_dkv", "dkv", 314)):
        rec = bwd[0][key]
        summary.append({
            "name": kname, "route": "cuda", "body": TC_BODY,
            "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
            "launches": counts_train[kname],
            "launches_recompute": {g: c[kname]
                                   for g, c in counts_recompute.items()},
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
            "launches_recompute": {g: c[rec["name"]]
                                   for g, c in counts_recompute.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
            | {k: rec[k] for k in _BWD_MEASURED if k in rec})
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
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
            | {k: rec[k] for k in _BWD_MEASURED if k in rec})
    # the fused optimizer pass at each training path's O2 parameter list
    # (one row per dtype group), launches from that path's counted steps;
    # Momentum, which no training path runs, from its OPTIM_STEP run
    for key, cnt in (("llama O2 bfloat16", counts_train),
                     ("gpt O2 bfloat16", counts_gpt),
                     ("gpt O2 float32", counts_gpt),
                     ("bert O2 bfloat16", counts_bert),
                     ("bert O2 float32", counts_bert),
                     ("llama O2 bfloat16 momentum",
                      counts_optim["Momentum"])):
        rec = optim[key]
        summary.append({
            "name": rec["name"], "case": rec["case"], "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_optimizer.cu",
            "replaces": "paddle_tpu/optimizer/fused.py:"
            + ("222" if rec["name"] == "fused_momentum" else "104"),
            "launches": cnt[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
            | {k: rec[k] for k in ("torch_fused_adamw_ms", "library")
               if k in rec})
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
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
            | {k: rec[k] for k in RESIDUAL_KEYS})
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
    # K1v/K2v from VARLEN, K9 from FLASHMASK
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
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
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
            (dec_long, "paged_decode.cu", paged_tpu, counts, "SERVE",
             "paged_decode_attention"),
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
    # F7's float16 kernels: K1 and K2 launched by TRAIN_F16_SCALER's
    # steps; the varlen, FlashMask and decode entries by their bf16 paths
    f16_launch = {"flash_attention_fwd": (counts_f16, "TRAIN_F16_SCALER"),
                  "flash_attention_bwd_dq": (counts_f16, "TRAIN_F16_SCALER"),
                  "flash_attention_bwd_dkv": (counts_f16,
                                              "TRAIN_F16_SCALER"),
                  "flash_attention_varlen_fwd": (counts_varlen, "VARLEN"),
                  "flash_attention_varlen_bwd_dq": (counts_varlen, "VARLEN"),
                  "flash_attention_varlen_bwd_dkv": (counts_varlen,
                                                     "VARLEN"),
                  "flashmask_fwd": (counts_fm, "FLASHMASK"),
                  "flashmask_bwd": (counts_fm, "FLASHMASK"),
                  "paged_decode_attention": (counts, "SERVE")}
    f16_src = {"flashmask": "flashmask_attention.cu",
               "paged": "paged_decode.cu", "bwd": "flash_attention_bwd.cu"}
    f16_line = {"flash_attention_fwd": 104, "flash_attention_bwd_dq": 263,
                "flash_attention_bwd_dkv": 314,
                "flash_attention_varlen_fwd": 104,
                "flash_attention_varlen_bwd_dq": 263,
                "flash_attention_varlen_bwd_dkv": 314,
                "flashmask_fwd": 856, "flashmask_bwd": 1017}
    for rec in f16:
        name = rec["name"]
        cnt, path = f16_launch[name]
        src = next((f for k, f in f16_src.items() if k in name),
                   "flash_attention_fwd.cu")
        kname = "flashmask_bwd_dq" if name == "flashmask_bwd" else name
        summary.append({
            "name": name, "case": rec["case"], "route": "cuda",
            "body": rec["body"], "source": f"paddle_tpu_torch/csrc/{src}",
            "replaces": paged_tpu if name.startswith("paged") else
            f"{attn}:{f16_line[name]}",
            "launches": cnt[kname], "launches_path": path,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    # the TRAIN-shape rows also carry their launches on the Tensor surface,
    # the BERT-shape rows theirs in NN_TRANSFORMER (its 6 captured steps)
    for row in summary:
        if "launches_recompute" in row or row.get("case") == \
                "llama O2 bfloat16":
            row["launches_dygraph"] = counts_dyg[row["name"]]
        if str(row.get("case", "")).startswith("bert"):
            row["launches_nn_transformer"] = counts_nn[row["name"]]
        if row["name"] in counts_incubate and "launches_path" not in row:
            row["launches_incubate_fused"] = counts_incubate[row["name"]]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--host-parts"]:
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        import torch
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            sys.exit(1)
        host_parts()
        sys.exit(0)
    sys.exit(main())
