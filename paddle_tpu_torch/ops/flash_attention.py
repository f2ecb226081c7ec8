"""Flash-attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Port of paddle_tpu/ops/pallas_attention.py's forward (`_fwd_kernel`
through `_flash_forward_x32`, entry `flash_attention_raw`), non-varlen.
The kernel lives in csrc/flash_attention_fwd.cu; its source note says
what bounds it on the H100 and how its design answers that.

Layout is the reference's [B, H, S, D]. K/V may carry fewer heads than Q
(GQA): the kernel indexes kv head h // (Hq / Hkv); the plain version
repeats, as `flash_attention_raw` does — the result is the same.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._cuda_common import (check_launch, count_launch, current_stream,
                           kernel_library)

_NAME = "flash_attention_fwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def flash_attention_reference(q, k, v, causal=True):
    """Plain PyTorch softmax(QK^T / sqrt(D)) V over [B, H, S, D], computed
    in f32. Causal masking aligns the last query row with the last key
    column. Returns (o in q.dtype, lse f32 [B, Hq, Sq])."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows + (sk - sq), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), lse


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd takes [B, H, S, D] tensors")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {k.shape[1]}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} is not supported "
                         "by the kernel")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtype {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, all alike")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd needs contiguous tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def flash_attention_fwd(q, k, v, causal=True):
    """(o, lse) for q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D]. CPU tensors take
    `flash_attention_reference`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn = kernel_library(_NAME).flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), b, hq, hkv, sq, sk, d, int(bool(causal)),
              _DTYPES[q.dtype], current_stream(q.device))
    check_launch(_NAME, code)
    count_launch(_NAME)
    return o, lse
