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
Inside the kernel, `kernel_route` picks the body by dtype and K alone:
bf16 x with K % 16 == 0 runs the tensor-core body (wgmma; x read by TMA,
whose boxes of x's high half start at column K/2 and so need K/2 * 2
bytes to be a multiple of 16), at a token tile `tc_tile_m(M)`; f32 x
(TF32 would change the results) and other K run the CUDA-core body.
`kernel_splits` splits K where the output tiles alone are too few to fill
the card.
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
#: the bodies (`kernel_route`)
TC_BODY, CORE_BODY = "tensor cores", "cuda cores"
#: the CUDA-core body's output tile: columns per block and x rows per
#: block (N must be a multiple of KERNEL_COLS on either body)
KERNEL_COLS = 32
KERNEL_ROWS = 8
#: blocks the kernel aims to have in flight (two per SM of an H100): a
#: decode-sized call with fewer output tiles splits K to reach it
_TARGET_BLOCKS = 264
_MIN_SPLIT_ROWS = 128          # packed rows per K split, at least
#: the tensor-core body: weight columns per block, packed rows per slab
#: (the step of its K walk and of its splits), and its token tiles
TC_COLS = 128
TC_SLAB = 64
TC_TILES_M = (8, 16, 32, 64)
#: an H100's SMs: a tensor-core tile of more than 16 tokens is bound by
#: operations, and one block on every SM fills the card; a smaller one is
#: bound by bytes and wants two in flight on every SM (_TARGET_BLOCKS).
#: A constant, not the device's count (as ops/paged_decode.py reads it),
#: so that the split is a function of the shape alone, which the CPU tests
#: pin without a card; a card with fewer SMs gets the same correct result
#: from a few more blocks than it holds at once
_SMS = 132


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


def kernel_route(k: int, dtype) -> str:
    """The body K8 runs for x [M, k] of `dtype`: bf16 with k % 16 == 0 on
    the tensor cores, anything else on the CUDA cores. A static decision
    from the dtype and K alone."""
    return TC_BODY if dtype == torch.bfloat16 and k % 16 == 0 else CORE_BODY


def tc_tile_m(m: int) -> int:
    """The tensor-core body's token tile (wgmma's n) for M rows of x: the
    smallest of TC_TILES_M that holds M, the largest above."""
    return next((t for t in TC_TILES_M if t >= m), TC_TILES_M[-1])


def kernel_splits(m: int, k: int, n: int, dtype) -> tuple:
    """(splits, packed rows per split) of K for an [m, k] @ [k, n] call on
    the body `kernel_route(k, dtype)` picks: enough blocks to fill the
    card when the output tiles alone are few (decode), one split
    otherwise (prefill)."""
    if kernel_route(k, dtype) == TC_BODY:
        return _tc_splits(m, k, n)
    return _core_splits(m, k, n)


def _tc_splits(m, k, n):
    """The tensor-core body's split: whole 64-row slabs, as many splits
    as the tiles leave room for under one block per SM (tiles of more
    than 16 tokens) or two (decode tiles), at most one slab each. A split
    costs its partial sums' bytes and the last block's pass over them:
    measured on the H100, splitting a prefill that already has ~one block
    per SM (M 512 x 2048 x 2048 at 128 tiles) made it slower."""
    bm = tc_tile_m(m)
    tiles = -(-n // TC_COLS) * -(-m // bm)
    slabs = -(-(k // 2) // TC_SLAB)
    target = _TARGET_BLOCKS if bm <= 16 else _SMS
    per = -(-slabs // min(max(1, target // tiles), slabs))
    return -(-slabs // per), per * TC_SLAB


def _core_splits(m, k, n):
    """The CUDA-core body's split: at least 128 packed rows each."""
    kh = k // 2
    blocks = (n // KERNEL_COLS) * -(-m // KERNEL_ROWS)
    want = min(-(-_TARGET_BLOCKS // blocks), max(1, kh // _MIN_SPLIT_ROWS))
    rows = max(1, -(-kh // want))
    return max(1, -(-kh // rows)), rows


_TICKETS: dict = {}


def _tickets(device, stream: int, count: int):
    """int32 zeros, one per output tile of a split tensor-core call on
    `stream`. The kernel's last block of a tile puts its ticket back to 0,
    so one buffer serves every call queued on the stream."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def quant_matmul_raw(x, packed, scale, k):
    """x [M, K] @ unpack(packed [K/2, N]) * scale [N] -> [M, N] in x's
    dtype. CPU tensors take `quant_matmul_reference`; CUDA tensors launch
    the kernel, on the body `kernel_route` picks."""
    if all(t.device.type == "cpu" for t in (x, packed, scale)):
        return quant_matmul_reference(x, packed, scale, k)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul_raw: unsupported device {x.device}")
    _check(x, packed, scale, k)
    tc = kernel_route(k, x.dtype) == TC_BODY
    if tc and x.data_ptr() % 16:
        raise ValueError("bf16 x must be 16-byte aligned on the tensor-core "
                         "body (its rows are read by TMA)")
    m, n = x.shape[0], packed.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    _launch(x, packed, scale, out, k, tc_tile_m(m) if tc else 0,
            *kernel_splits(m, k, n, x.dtype))
    count_launch(_NAME)
    return out


def _launch(x, packed, scale, out, k, tile_m, splits, rows):
    """One call of the C entry on `tile_m`'s body (0: the CUDA cores) with
    the K split (splits, rows); raises on a launch error."""
    m, n = out.shape
    stream = current_stream(x.device)
    partial = tickets = None
    if splits > 1:
        partial = torch.empty((splits, m, n), dtype=torch.float32,
                              device=x.device)
        if tile_m:
            tickets = _tickets(x.device, stream,
                               -(-n // TC_COLS) * -(-m // tile_m))
    fn = kernel_library(_NAME).quant_matmul
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
              out.data_ptr(), 0 if partial is None else partial.data_ptr(),
              0 if tickets is None else tickets.data_ptr(), m, k, n, splits,
              rows, tile_m, _DTYPES[x.dtype], stream)
    check_launch(_NAME, code)


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
