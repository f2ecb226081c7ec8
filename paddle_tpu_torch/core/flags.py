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
    # slot count of the continuous-batching engine (inference/engine.py)
    "FLAGS_serving_slots": _from_env("FLAGS_serving_slots", 8),
    # route the LLaMA training forward's norms (+ residual add), rotary
    # and SwiGLU through the fused ops (nn.functional -> ops.fused_norm:
    # K3-K5 on CUDA tensors); False runs the plain compositions
    "FLAGS_pallas_fused_ops": _from_env("FLAGS_pallas_fused_ops", True),
}


def flag(name: str):
    return _FLAGS[name]


def set_flags(flags: dict) -> None:
    """Set registered flags ({name: value}); an unknown name raises."""
    for name, value in flags.items():
        key = name if name.startswith("FLAGS_") else "FLAGS_" + name
        if key not in _FLAGS:
            raise KeyError(f"unknown flag {name!r}")
        _FLAGS[key] = value
