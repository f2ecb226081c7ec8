"""The subset of paddle_tpu's FLAGS_* that the port implements, with the
same names and environment override (a FLAGS_* environment variable seeds
the value at import), read with `flag` and written with `set_flags`.

Defaults are the reference's.
"""
from __future__ import annotations

import os


def _parse(text: str, default):
    if isinstance(default, bool):
        return text.lower() in ("1", "true", "yes", "on")
    return type(default)(text)


def _from_env(name: str, default):
    env = os.environ.get(name)
    return default if env is None else _parse(env, default)


_FLAGS = {
    # tokens per KV-cache block in the paged serving engine
    # (text/paged_cache.py); must be a multiple of 8
    "FLAGS_kv_block_size": _from_env("FLAGS_kv_block_size", 16),
    # paged KV cache storage dtype: "model" (the model's compute dtype) |
    # "int8" (per-block-scale quantized cache, blocks requantize on append)
    # | "int4" (the same, two tokens per byte)
    "FLAGS_kv_cache_dtype": _from_env("FLAGS_kv_cache_dtype", "model"),
    # default weight-only quantization of the serving engine's layer
    # matmuls and lm_head: "none" | "int8" (per-channel scales) | "int4"
    # (packed nibbles, per-channel scales)
    "FLAGS_weight_only_dtype": _from_env("FLAGS_weight_only_dtype", "none"),
    # speculative decoding on the paged serving engine
    # (inference/speculative.py): "off" | "ngram" (prompt lookup) | "draft"
    # (a draft model, passed through SpecConfig(draft_model=...)); greedy
    # outputs stay token-identical to the non-speculative engine
    "FLAGS_spec_decode": _from_env("FLAGS_spec_decode", "off"),
    # speculation depth: tokens proposed per verify window (each window
    # scores K + 1 candidate positions in one pass and emits 1..K + 1)
    "FLAGS_spec_k": _from_env("FLAGS_spec_k", 4),
    # slot count of the continuous-batching engine (inference/engine.py)
    "FLAGS_serving_slots": _from_env("FLAGS_serving_slots", 8),
    # content-hash full KV blocks in the serving engine and serve shared
    # prompt prefixes from cached blocks; finish releases hash-mapped
    # blocks to an LRU of refcount-0 blocks, copy-on-write guards a shared
    # block a request must partly overwrite
    "FLAGS_prefix_cache": _from_env("FLAGS_prefix_cache", True),
    # prefill prompts in chunks of at most this many tokens, one chunk per
    # scheduler tick between decode ticks; 0 = whole-prompt prefill
    # (cache-hit suffixes still take the chunk program)
    "FLAGS_chunked_prefill_tokens": _from_env(
        "FLAGS_chunked_prefill_tokens", 256),
    # cap on refcount-0 cached prefix blocks held in the LRU (0 = bounded
    # only by pool pressure)
    "FLAGS_prefix_cache_max_blocks": _from_env(
        "FLAGS_prefix_cache_max_blocks", 0),
    # route the LLaMA training forward's norms (+ residual add), rotary
    # and SwiGLU through the fused ops (nn.functional -> ops.fused_norm:
    # K3-K5 on CUDA tensors); False runs the plain compositions
    "FLAGS_pallas_fused_ops": _from_env("FLAGS_pallas_fused_ops", True),
    # fused_linear_cross_entropy's chunk axis: "vocab" | "tokens" | "auto"
    # (auto = vocab when a multiple-of-128 vocab divisor exists, else
    # tokens)
    "FLAGS_flce_chunk_axis": _from_env("FLAGS_flce_chunk_axis", "auto"),
    # tokens per [chunk, H] @ [H, V] GEMM of the token-chunked fused CE
    # path (<= 0 disables it)
    "FLAGS_flce_token_chunk": _from_env("FLAGS_flce_token_chunk", 1024),
    # global to_static toggle (jit.enable_to_static): off, a decorated
    # function runs eagerly
    "FLAGS_enable_to_static": _from_env("FLAGS_enable_to_static", True),
    # accepted for the reference's surface: a captured graph updates its
    # buffers in place, so there is nothing to donate
    "FLAGS_to_static_donate": _from_env("FLAGS_to_static_donate", True),
    # on a graph break run the function eagerly from then on (torch's
    # eager ops are the port's segments); False: the same, named eager
    "FLAGS_to_static_segmented": _from_env("FLAGS_to_static_segmented",
                                           True),
    # the jit shims of the reference's surface (recorded, not read)
    "FLAGS_jit_code_level": _from_env("FLAGS_jit_code_level", 100),
    "FLAGS_jit_verbosity": _from_env("FLAGS_jit_verbosity", 0),
    "FLAGS_jit_log_to_stdout": _from_env("FLAGS_jit_log_to_stdout", False),
    # dtype of the models' residual stream, which amp_dtype_for reads:
    # "float32" only (the port's models keep an f32 stream; "bfloat16" is
    # ROADMAP Queue 1's 'FLAGS_residual_dtype=bfloat16' item)
    "FLAGS_residual_dtype": _from_env("FLAGS_residual_dtype", "float32"),
    # VLOG-style verbosity of obs.get_logger(...).vlog(level, ...)
    "FLAGS_log_level": _from_env("FLAGS_log_level", 0),
    # JSONL event log path (obs/metrics.py): compile events, logger
    # records and registry snapshots append one line each; empty = off
    "FLAGS_obs_log_path": _from_env("FLAGS_obs_log_path", ""),
    # size cap in MB of the JSONL event log: past it the file rotates to
    # <path>.1 .. <path>.N between records (a line is never torn);
    # 0 = unbounded
    "FLAGS_obs_log_max_mb": _from_env("FLAGS_obs_log_max_mb", 64),
    # rolled JSONL event-log files kept (<path>.1 newest .. .N oldest)
    "FLAGS_obs_log_backups": _from_env("FLAGS_obs_log_backups", 3),
    # compile watchdog: more than this many distinct program keys for one
    # (site, family) is a recompile-storm warning in audit_recompiles
    "FLAGS_obs_compile_storm_threshold": _from_env(
        "FLAGS_obs_compile_storm_threshold", 8),
    # when > 0 every ServingEngine registers its metrics registry on the
    # shared endpoint http://127.0.0.1:<port>/metrics (and /healthz);
    # 0 = off
    "FLAGS_obs_http_port": _from_env("FLAGS_obs_http_port", 0),
    # per-engine flight-recorder ring capacity: finished request
    # timelines kept for dump_trace() (active requests are never evicted)
    "FLAGS_obs_flight_requests": _from_env("FLAGS_obs_flight_requests",
                                           256),
    # anomaly auto-dump directory of the flight recorder (a request
    # timeout, a TTFT SLO breach, a post-warmup capture); empty = record
    # but never dump
    "FLAGS_obs_flight_dir": _from_env("FLAGS_obs_flight_dir", ""),
    # TTFT SLO in ms of the flight recorder's anomaly trigger; 0 = none
    "FLAGS_obs_slo_ttft_ms": _from_env("FLAGS_obs_slo_ttft_ms", 0.0),
    # opt-in for obs instrumentation outside the serving engine: hapi's
    # fit() attaches a TelemetryCallback when set
    "FLAGS_obs_metrics": _from_env("FLAGS_obs_metrics", False),
    # count flops / bytes / peak memory of each program at its one eager
    # run before capture (obs/costs.py) into the compile event and the
    # cost ledger; off: the ledger rows carry no analysis
    "FLAGS_obs_cost_capture": _from_env("FLAGS_obs_cost_capture", True),
    # peak HBM GB/s the roofline_utilization gauges divide by; 0 = the
    # device's default (obs/costs.py PEAK_GBPS_DEFAULTS)
    "FLAGS_obs_peak_gbps": _from_env("FLAGS_obs_peak_gbps", 0.0),
    # audit_cost_regressions: a program whose bytes accessed grew more
    # than this percent over the baseline is a warning
    "FLAGS_obs_cost_regress_pct": _from_env("FLAGS_obs_cost_regress_pct",
                                            25.0),
    # training flight-recorder ring: finished step timelines kept
    "FLAGS_obs_train_flight_steps": _from_env(
        "FLAGS_obs_train_flight_steps", 64),
    # a step whose data_wait exceeds this many ms is a data_starvation
    # anomaly (and counts toward audit_train_steps' streak); 0 = off
    "FLAGS_obs_data_wait_ms": _from_env("FLAGS_obs_data_wait_ms", 100.0),
    # a step whose wall exceeds this factor times the rolling median of
    # recent steps (8 at least) is a step_spike anomaly; 0 = off
    "FLAGS_obs_step_spike_factor": _from_env("FLAGS_obs_step_spike_factor",
                                             3.0),
    # peak TFLOP/s the train_mfu gauges divide by; 0 = the device's
    # default (obs/goodput.py PEAK_TFLOPS_DEFAULTS)
    "FLAGS_obs_peak_tflops": _from_env("FLAGS_obs_peak_tflops", 0.0),
    # DataLoader workers hand batches over through the shared-memory
    # ring (csrc/ring_queue.cpp) when the native build is available
    "FLAGS_dataloader_use_shared_memory": _from_env(
        "FLAGS_dataloader_use_shared_memory", True),
    # checkpoint saves retry transient IO errors this many times with
    # exponential backoff before raising CheckpointSaveError
    "FLAGS_ckpt_save_retries": _from_env("FLAGS_ckpt_save_retries", 3),
    # base of that backoff: attempt k sleeps base * 2^k seconds
    "FLAGS_ckpt_retry_backoff_s": _from_env("FLAGS_ckpt_retry_backoff_s",
                                            0.05),
    # CheckpointCallback commits on the background thread (the device ->
    # host copy stays synchronous); off: every periodic save blocks
    "FLAGS_ckpt_async": _from_env("FLAGS_ckpt_async", True),
    # bound on queued async saves; AsyncCheckpointer.save() blocks past it
    "FLAGS_ckpt_max_in_flight": _from_env("FLAGS_ckpt_max_in_flight", 2),
    # retention: keep the newest N committed checkpoints (0 = all)
    "FLAGS_ckpt_keep_last_n": _from_env("FLAGS_ckpt_keep_last_n", 0),
    # a save whose wall exceeds this is an audit_ckpt_stalls warning and
    # a ckpt_stall anomaly of the training flight recorder
    "FLAGS_ckpt_stall_seconds": _from_env("FLAGS_ckpt_stall_seconds",
                                          300.0),
}


def _check(name: str, value) -> None:
    if name == "FLAGS_residual_dtype" \
            and str(value).lower() not in ("float32", "fp32", "f32"):
        raise NotImplementedError(
            f"FLAGS_residual_dtype={value!r}: the port's models keep an "
            "f32 residual stream; a bf16 stream is not ported yet (ROADMAP "
            "Queue 1, 'FLAGS_residual_dtype=bfloat16')")


for _name, _value in _FLAGS.items():
    _check(_name, _value)


def flag(name: str):
    return _FLAGS[name]


def set_flags(flags: dict) -> None:
    """Set registered flags ({name: value}); an unknown name raises."""
    for name, value in flags.items():
        key = name if name.startswith("FLAGS_") else "FLAGS_" + name
        if key not in _FLAGS:
            raise KeyError(f"unknown flag {name!r}")
        _check(key, value)
        _FLAGS[key] = value
