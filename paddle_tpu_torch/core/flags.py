"""The subset of paddle_tpu's FLAGS_* that the port implements, with the
same names, defaults and environment override (a FLAGS_* environment
variable seeds the value at import)."""
from __future__ import annotations

import os


def _from_env(name: str, default):
    env = os.environ.get(name)
    return default if env is None else type(default)(env)


_FLAGS = {
    # tokens per KV-cache block in the paged serving engine
    # (text/paged_cache.py); must be a multiple of 8
    "FLAGS_kv_block_size": _from_env("FLAGS_kv_block_size", 16),
    # paged KV cache storage dtype: "model" (the model's compute dtype);
    # the int8/int4 modes are not ported yet
    "FLAGS_kv_cache_dtype": _from_env("FLAGS_kv_cache_dtype", "model"),
    # slot count of the continuous-batching engine (inference/engine.py)
    "FLAGS_serving_slots": _from_env("FLAGS_serving_slots", 8),
}


def flag(name: str):
    return _FLAGS[name]
