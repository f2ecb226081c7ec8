"""Low-bit weight storage and the int4 dequant-matmul: the hand-written
CUDA kernel (K8) and its plain PyTorch version.

Port of paddle_tpu/ops/quantized.py: split-half int4 packing, the int4
quantizer and dequantizer, `_qmm_kernel` (through `_qmm_x32`, entry
`quant_matmul_raw`) and the routed `quant_matmul`. The kernel lives in
csrc/quant_matmul.cu; its source note says what bounds it on the H100 and
how its design answers that.

Layout (split-half, not interleaved): a [K, N] int4 tensor packs as
[ceil(K/2), N] int8 where packed row i holds logical row i in the LOW
nibble and row ceil(K/2) + i in the HIGH nibble. Odd K pads one zero row.
The same rule applies along any axis (`axis=`), which is how the paged KV
cache packs int4 along its token axis. Values are symmetric, -7..7
(`INT4_QMAX`).

int8 and packed int4 weight pairs are told apart by shape: packed storage
has ceil(K/2) rows where x has K columns.

Routing: `quant_matmul_raw` takes its plain version for CPU tensors and
launches the kernel for CUDA tensors, or raises. There is no fallback.
`quant_matmul` sends what the kernel does not take (group-wise scales,
odd K, N not a multiple of 32, a dtype other than f32 or bf16) to the
reference's plain composition by a static gate, `kernel_gate_reason`, as
the reference's `quant_gate_reason` sends it to XLA.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda_common import (check_launch, count_launch, current_stream,
                           kernel_library)

_NAME = "quant_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: int4 value range: symmetric, -7..7 (the same form as the int8 127 rule)
INT4_QMAX = 7.0
#: the kernel's output tile: columns per block and x rows per block
KERNEL_COLS = 32
KERNEL_ROWS = 8
#: blocks the kernel aims to have in flight (two per SM of an H100): a
#: decode-sized call with fewer column tiles splits K to reach it
_TARGET_BLOCKS = 264
_MIN_SPLIT_ROWS = 128          # packed rows per K split, at least


def packed_rows(k: int) -> int:
    """Packed extent along the quantized axis for a logical extent k."""
    return (k + 1) // 2


# ---------------------------------------------------------------- pack bits

def int4_pack(q, axis=0):
    """Pack an int8 tensor holding int4 values (-8..7) two per byte along
    `axis` (split-half layout, see the module docstring). Odd extents pad
    one zero slot. Returns a contiguous int8 tensor with shape[axis] ==
    ceil(k/2)."""
    q = q.to(torch.int8)
    axis = axis % q.dim()
    k = q.shape[axis]
    h = packed_rows(k)
    lo = q.narrow(axis, 0, h)
    hi = q.narrow(axis, h, k - h)
    if k % 2:                       # pad the high half back to h slots
        shape = list(q.shape)
        shape[axis] = 1
        hi = torch.cat([hi, q.new_zeros(shape)], dim=axis)
    # int8 shifts wrap: exactly two's-complement nibble placement
    return ((hi << 4) | (lo & 0x0F)).contiguous()


def int4_unpack(p, k, axis=0):
    """Inverse of `int4_pack`: packed int8 -> int8 values in -8..7 with
    shape[axis] == k. The left shift wraps the low nibble into the sign
    position and the arithmetic right shift sign-extends it back."""
    p = p.to(torch.int8)
    axis = axis % p.dim()
    lo = (p << 4) >> 4
    hi = p >> 4
    return torch.cat([lo, hi], dim=axis).narrow(axis, 0, k)


# -------------------------------------------------------------- quantize

def quantize_int4(w, group_size: int = -1):
    """Symmetric int4 quantization of a [..., K, N] weight: per-output-
    channel absmax scales ([..., N]) or group-wise along K ([..., K //
    group_size, N]) when group_size > 0. The scale is taken in w's dtype
    (amax / 7, floored at 1e-8) and then widened to f32, as the reference
    does; codes round half to even. Returns (packed [..., ceil(K/2), N]
    int8, scale f32)."""
    k, n = w.shape[-2], w.shape[-1]
    if group_size and group_size > 0:
        if k % group_size:
            raise ValueError(
                f"group_size {group_size} does not divide K={k}")
        g = k // group_size
        wg = w.reshape(*w.shape[:-2], g, group_size, n)
        amax = wg.abs().amax(dim=-2)                           # [..., G, N]
        scale = torch.clamp_min(amax / INT4_QMAX, 1e-8).float()
        q = torch.clamp(torch.round(wg / scale[..., :, None, :]),
                        -INT4_QMAX, INT4_QMAX)
        q = q.reshape(w.shape).to(torch.int8)
    else:
        amax = w.abs().amax(dim=-2)                            # [..., N]
        scale = torch.clamp_min(amax / INT4_QMAX, 1e-8).float()
        q = torch.clamp(torch.round(w / scale[..., None, :]),
                        -INT4_QMAX, INT4_QMAX).to(torch.int8)
    return int4_pack(q, axis=-2), scale


def dequant_int4(packed, scale, k, dtype=torch.float32):
    """Materializing dequant: packed + scale -> [..., K, N] in `dtype`."""
    q = int4_unpack(packed, k, axis=-2).to(dtype)
    if scale.dim() == q.dim() - 1:                 # per-channel [..., N]
        return q * scale.to(dtype)[..., None, :]
    g = scale.shape[-2]
    wg = q.reshape(*q.shape[:-2], g, k // g, q.shape[-1])
    return (wg * scale.to(dtype)[..., :, None, :]).reshape(q.shape)


# ------------------------------------------------------------------ kernel

def quant_matmul_reference(x, packed, scale, k):
    """The plain PyTorch version of the kernel: unpack, then (x @ q) in
    f32 times the per-channel scale, rounded once to x's dtype. x [M, K];
    packed [ceil(K/2), N] int8; scale [N] f32."""
    q = int4_unpack(packed, k, axis=0)
    return ((x.float() @ q.float()) * scale.float()).to(x.dtype)


def _check(x, packed, scale, k):
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"quant_matmul_raw takes x [M, K], packed [K/2, N] "
                         f"and per-channel scale [N]; got x {tuple(x.shape)}, "
                         f"packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}")
    m, kx = x.shape
    n = packed.shape[1]
    if kx != k or k % 2 or packed.shape[0] != k // 2:
        raise ValueError(f"K={k} (x has {kx} columns, packed {packed.shape[0]}"
                         " rows): the kernel takes an even K with packed "
                         "rows K/2")
    if n % KERNEL_COLS or scale.shape[0] != n:
        raise ValueError(f"N={n} must be a multiple of {KERNEL_COLS} and "
                         f"match scale [{scale.shape[0]}]")
    if x.dtype not in _DTYPES or packed.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise ValueError(f"dtype x {x.dtype}, packed {packed.dtype}, scale "
                         f"{scale.dtype}: the kernel takes float32 or "
                         "bfloat16 x, int8 packed and float32 scale")
    if packed.data_ptr() % 16:
        raise ValueError("packed weight must be 16-byte aligned")
    for t in (x, packed, scale):
        if t.device != x.device:
            raise ValueError("all inputs must lie on one device")
        if not t.is_contiguous():
            raise ValueError("quant_matmul_raw needs contiguous inputs")


def kernel_splits(m: int, k: int, n: int) -> tuple:
    """(splits, packed rows per split) of K for an [m, k] @ [k, n] call:
    enough blocks to fill the card when the column tiles alone are few
    (decode), one split otherwise (prefill)."""
    kh = k // 2
    blocks = (n // KERNEL_COLS) * -(-m // KERNEL_ROWS)
    want = min(-(-_TARGET_BLOCKS // blocks), max(1, kh // _MIN_SPLIT_ROWS))
    rows = max(1, -(-kh // want))
    return max(1, -(-kh // rows)), rows


def quant_matmul_raw(x, packed, scale, k):
    """x [M, K] @ unpack(packed [K/2, N]) * scale [N] -> [M, N] in x's
    dtype. CPU tensors take `quant_matmul_reference`; CUDA tensors launch
    the kernel."""
    if all(t.device.type == "cpu" for t in (x, packed, scale)):
        return quant_matmul_reference(x, packed, scale, k)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul_raw: unsupported device {x.device}")
    _check(x, packed, scale, k)
    m, n = x.shape[0], packed.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    splits, rows = kernel_splits(m, k, n)
    partial = None
    if splits > 1:
        partial = torch.empty((splits, m, n), dtype=torch.float32,
                              device=x.device)
    fn = kernel_library(_NAME).quant_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
              out.data_ptr(), 0 if partial is None else partial.data_ptr(),
              m, k, n, splits, rows, _DTYPES[x.dtype],
              current_stream(x.device))
    check_launch(_NAME, code)
    count_launch(_NAME)
    return out


# --------------------------------------------------------------- routing

def kernel_gate_reason(k, n, dtype, grouped=False):
    """Why a packed-int4 matmul of x [.., k] (dtype) by a [k, n] weight
    does not take K8, or None when it does: the port's counterpart of the
    reference's `quant_gate_reason` (`paddle_tpu/ops/quantized.py`), with
    the kernel's own limits in place of the TPU's. A static decision from
    shapes and dtypes alone, the same on the CPU (where K8's plain version
    runs) and on the card."""
    if grouped:
        return ("group-wise scales ride the plain composition (the kernel "
                "streams per-channel scales only)")
    if dtype not in _DTYPES:
        return f"dtype {dtype} unsupported by the dequant-matmul kernel"
    if k % 2:
        return f"K={k} is odd (the kernel takes packed rows K/2)"
    if n % KERNEL_COLS:
        return f"N={n} is not a multiple of {KERNEL_COLS}"
    return None


def quant_matmul(x, w, scale, int4_matmul=quant_matmul_raw):
    """Dequant-matmul over a quantized weight pair: the one routine behind
    generation's `_mm` and the serving engine's matmuls.

    x [..., K]; (w, scale) is either int8 (w [K, N]) or packed int4 (w
    [ceil(K/2), N]), told apart by shape; scale [N] per-channel or [G, N]
    group-wise. Returns [..., N] in x's dtype. int8 is the reference's
    plain arithmetic; packed int4 goes through `int4_matmul` (the K8
    wrapper, or its plain version passed explicitly by a check) when
    `kernel_gate_reason` lets it, and through the reference's composition
    (unpack, matmul in x's dtype, scale) otherwise, on any device."""
    k = x.shape[-1]
    grouped = scale.dim() == 2
    if w.shape[0] == k:                  # int8: the reference's exact math
        if grouped:
            g = scale.shape[0]
            n = w.shape[1]
            wf = (w.reshape(g, k // g, n).to(x.dtype)
                  * scale.to(x.dtype)[:, None, :]).reshape(k, n)
            return x @ wf
        return (x @ w.to(x.dtype)) * scale.to(x.dtype)
    if w.shape[0] != packed_rows(k):
        raise ValueError(
            f"quantized weight rows {w.shape[0]} match neither K={k} "
            f"(int8) nor ceil(K/2)={packed_rows(k)} (packed int4)")
    n = w.shape[1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if kernel_gate_reason(k, n, x.dtype, grouped) is None:
        return int4_matmul(x2, w, scale, k).reshape(*lead, n)
    if grouped:
        wf = dequant_int4(w, scale, k, x.dtype)
        return (x2 @ wf).reshape(*lead, n)
    q = int4_unpack(w, k, axis=0)
    return ((x2 @ q.to(x.dtype)) * scale.to(x.dtype)).reshape(*lead, n)
