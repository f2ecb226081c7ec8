"""Length bucketing, copied from paddle_tpu/jit/api.py so the port's
prompt and slot buckets match the reference's exactly."""
from __future__ import annotations


def default_buckets(n: int) -> int:
    """Round a dynamic length up to its bucket: next power of two up to 512,
    then multiples of 512."""
    if n <= 1:
        return 1
    if n <= 512:
        return 1 << (n - 1).bit_length()
    return ((n + 511) // 512) * 512
