#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (H100): the port's main
path, end to end, through its hand-written kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. environment: the card's name and power limit;
  2. build: every CUDA kernel of the port, from the sources in the
     checkout (nvcc, sm_90a, one process per source, in parallel);
  3. kernels: each kernel at the main path's shapes in bf16, held against
     its plain PyTorch version on the same inputs, and timed (CUDA events,
     median of 30 after warm-up) beside the plain version, one PyTorch
     library call as a yardstick, and the card's bound for the work;
  4. serve: LLaMA at the 1B geometry (hidden 2048, 20 layers, 16 heads,
     vocab 32000, bf16, random weights from seed 0) behind the paged
     ServingEngine (8 slots, 16-token blocks) answers 16 greedy requests;
     both kernels' launch counts must equal prefills x 20 and decode ticks
     x 20, and two requests' tokens are checked against a teacher-forced
     recompute through the plain attention functions;
  5. profile: device time of steady decode ticks by kernel kind, beside
     the host wall (torch.profiler).

The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}. Without a CUDA card it exits 1 and prints
no result.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core
#: rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
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

CFG_1B = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
              num_hidden_layers=20, num_attention_heads=16,
              max_position_embeddings=1024)


def _say(tag, obj):
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _time_ms(fn, flush=None, reps=30, warmup=5):
    """Median device time of fn() over `reps` launches (CUDA events).
    `flush` runs before each timed launch, outside the timed window."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def _nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def flash_case(b, hq, hkv, s, d=128):
    """Flash forward at one prefill shape: parity, times, bound."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)

    g = torch.Generator(device="cuda").manual_seed(s)
    q = torch.randn(b, hq, s, d, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    k = torch.randn(b, hkv, s, d, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    v = torch.randn(b, hkv, s, d, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = flash_attention_reference(q, k, v, True)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert err < KERNEL_TOL and lse_err < 1e-3, (err, lse_err)
    pairs = s * (s + 1) // 2                        # causal (row, col) pairs
    flops = 4 * b * hq * d * pairs
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) + 4 * b * hq * s
    bound, by = _bound_ms(flops, nbytes)
    rec = {"name": "flash_attention_fwd", "shape": [b, hq, hkv, s, d],
           "max_abs_err": err, "lse_max_abs_err": lse_err,
           "ms": _time_ms(lambda: flash_attention_fwd(q, k, v, True)),
           "plain_ms": _time_ms(
               lambda: flash_attention_reference(q, k, v, True)),
           "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=hq != hkv)),
           "bound_ms": bound, "bound_by": by}
    _say("KERNEL", rec)
    return rec


def decode_case(seqs=8, heads=16, d=128, bs=16, max_len=1024):
    """Paged decode at the serving shape: 8 sequences, ragged lengths up
    to the context, tables shuffled over the whole pool. The L2 cache is
    flushed before each timed launch: in serving, one layer's pool slice
    is evicted by the other 19 layers between two of its decode calls."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.paged_decode import (
        paged_decode_attention, paged_decode_attention_reference)

    rs = np.random.RandomState(0)
    pages = max_len // bs
    blocks = 1 + seqs * pages
    g = torch.Generator(device="cuda").manual_seed(1)
    kc = torch.randn(blocks, heads, bs, d, device="cuda", generator=g,
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
    kd = kc[tables.long()].permute(0, 2, 1, 3, 4).reshape(seqs, heads, t, d)
    vd = vc[tables.long()].permute(0, 2, 1, 3, 4).reshape(seqs, heads, t, d)
    mask = (torch.arange(t, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    tokens = int(lens_np.sum())
    flops = 4 * tokens * heads * d
    pages_read = int(np.ceil(lens_np / bs).sum())   # table entries used
    nbytes = 2 * (2 * tokens * heads * d + 2 * seqs * heads * d) \
        + 4 * (pages_read + seqs)
    bound, by = _bound_ms(flops, nbytes)
    rec = {"name": "paged_decode_attention",
           "shape": [seqs, heads, heads, d, bs, pages],
           "lens": lens_np.tolist(), "max_abs_err": err,
           "ms": _time_ms(lambda: paged_decode_attention(
               q, kc, vc, tables, lens), flush),
           "plain_ms": _time_ms(lambda: paged_decode_attention_reference(
               q, kc, vc, tables, lens), flush),
           "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
               q[:, :, None], kd, vd, attn_mask=mask), flush),
           "bound_ms": bound, "bound_by": by}
    _say("KERNEL", rec)
    return rec


def serve():
    """The main path: 16 greedy requests through the paged engine at the
    1B geometry. Returns the launch counts of the counted run."""
    import torch
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.ops import _cuda_common
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

    rs = np.random.RandomState(0)
    reqs = [(rs.randint(0, cfg.vocab_size, (int(rs.randint(64, 513)),)),
             int(rs.randint(32, 129))) for _ in range(16)]
    # warm-up engine (cuBLAS handles, allocator pools); not counted
    warm = ServingEngine(model, max_slots=8, kv_block_size=16)
    warm.add_request(reqs[0][0][:64], max_new_tokens=4)
    warm.run()
    del warm

    eng = ServingEngine(model, max_slots=8, kv_block_size=16)
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
    torch.cuda.synchronize()
    _cuda_common.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda_common.launch_counts()

    st = eng.stats()
    layers = cfg.num_hidden_layers
    for rid, (p, n) in zip(rids, reqs):
        toks = done[rid]
        assert len(toks) == n and eng.finish_reasons[rid] == "length", rid
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), rid
    assert st["requests_completed"] == len(reqs)
    assert st["kv_pool_free"] == st["kv_pool_blocks"] - 1
    assert counts["flash_attention_fwd"] == len(reqs) * layers, counts
    assert counts["paged_decode_attention"] == st["steps"] * layers, counts
    ttft = sorted(st["ttft_s"])
    _say("SERVE", {
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
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts})

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
            assert torch.isfinite(lg).all()
            top = lg.argmax(dim=-1)
            g = torch.from_numpy(gen).cuda()
            gap = (lg.gather(1, top[:, None])
                   - lg.gather(1, g[:, None]))[:, 0]
            agree += int((top == g).sum())
            total += n
            worst = max(worst, float(gap.max()))
    _say("TEACHER_FORCED", {"requests": 2, "tokens": total,
                            "argmax_agreement": agree / total,
                            "max_logit_gap": worst, "tie_bound": TIE_BOUND})
    assert worst < TIE_BOUND, worst
    assert agree / total >= 0.9, agree / total
    return model, counts


def profile_decode(model, ticks=10):
    """Where a decode tick's time goes: torch.profiler over `ticks` steady
    decode ticks of 8 slots (256-token prompts), device time by kernel
    kind beside the host wall. Not part of the counted run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import ServingEngine

    eng = ServingEngine(model, max_slots=8, kv_block_size=16)
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
    kinds = {"paged_decode": 0.0, "gemm": 0.0, "other": 0.0}
    per_kernel = {}
    for e in prof.key_averages():
        # device events only: CPU ops also report the time of the
        # kernels they launched, which would count it twice
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        low = e.key.lower()
        kind = ("paged_decode" if "paged_decode" in low else
                "gemm" if any(w in low for w in ("nvjet", "gemm", "gemv",
                                                 "xmma", "cutlass"))
                else "other")
        kinds[kind] += us / 1e3 / ticks
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3 / ticks
    device_ms = sum(kinds.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    _say("PROFILE", {
        "ticks": ticks, "slots": 8, "wall_ms_per_tick": 1e3 * wall / ticks,
        "device_ms_per_tick": device_ms,
        "device_busy_share": device_ms / (1e3 * wall / ticks),
        "device_ms_per_tick_by_kind": kinds,
        "top_kernels_ms_per_tick": [[k[:60], v] for k, v in top]})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import _cuda_common

    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"DEVICE {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    _cuda_common.build_kernels()
    _say("BUILD", {"seconds": time.perf_counter() - t0,
                   "kernels": sorted(_cuda_common.KERNEL_SOURCES)})

    flash = [flash_case(1, 16, 16, s) for s in (128, 500, 512, 1024)]
    flash.append(flash_case(1, 16, 4, 512))
    dec = decode_case()
    model, counts = serve()
    profile_decode(model)

    main_flash = flash[2]                  # S = 512, a prefill bucket
    summary = []
    for rec, src, replaces in (
            (main_flash, "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             "paddle_tpu/ops/pallas_attention.py:104"),
            (dec, "paddle_tpu_torch/csrc/paged_decode.cu",
             "paddle_tpu/ops/pallas_decode.py:71")):
        summary.append({
            "name": rec["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
