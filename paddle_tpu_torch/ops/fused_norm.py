"""Fused RMSNorm and LayerNorm (with and without the residual add),
rotary on Q and K, SwiGLU, and dropout + add: the hand-written CUDA
kernels, their plain PyTorch versions, and the differentiable ops built
from them.

Port of paddle_tpu/ops/pallas_norm.py: `_norm_forward` /
`_norm_backward` (K3, kernels `_norm_fwd_kernel`, `_norm_bwd_kernel`, RMS
and LayerNorm kinds), `_rope_apply` / `_tables2` (K4, `_rope_kernel`,
both directions), `_swiglu_call` (K5, `_swiglu_fwd_kernel`,
`_swiglu_bwd_kernel`), `dropout_add_fused` and its VJP (K6,
`_dropout_add_fwd_kernel`, `_dropout_add_bwd_kernel`), the custom VJPs
`rms_norm_fused`, `add_rms_norm_fused`, `layer_norm_fused`,
`add_layer_norm_fused`, `rope_qk_fused`, `swiglu_fused` and
`dropout_add_fused` (torch.autograd.Functions here), and the raw wrappers
that harmonise dtypes before them (`rms_norm_raw`, `add_rms_norm_raw`,
`layer_norm_raw`, `add_layer_norm_raw`, `rope_qk_raw`, `swiglu_raw`,
`dropout_add_raw`). The kernels live in csrc/fused_norm.cu, one source
with nine entry points and nine launch counters (`fused_rms_norm_fwd`,
`fused_rms_norm_bwd`, `fused_layer_norm_fwd`, `fused_layer_norm_bwd`,
`rope_qk`, `swiglu_fwd`, `swiglu_bwd`, `dropout_add_fwd`,
`dropout_add_bwd`); its note says what bounds them on the H100 (device
memory: each moves every input and output byte once and does a few f32
operations per element) and how the design answers that.

Numerics, as the TPU kernels: every reduction and product in f32, each
output rounded once to its dtype. The norms save only rstd (and, for
LayerNorm, the mean; f32, one each per row) and recompute the normalized
row in the backward; dw (and LayerNorm's db) are summed across rows in a
fixed order (no atomics). LayerNorm's variance is max(E[x^2] - mean^2, 0),
as the TPU kernel takes it. The add variants return (normed, summed) and
their backward gives both inputs dsum = dx + ds. Dropout + add reads a
0/1 mask in x's dtype that the caller drew, and saves only the mask.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback. Unlike the reference, there is no
size threshold: its `_MIN_ELEMS` is a crossover measured on a TPU v5e,
and here every CUDA tensor takes the kernel (so launch counts are exact);
`FLAGS_pallas_fused_ops` alone chooses between these ops and the plain
compositions (`nn.functional`), except for an empty tensor, which the
norms of `nn.functional` send to the composition as the reference's
`use_pallas` does (the kernels refuse it). The norms take rows of any
width: past `MAX_HIDDEN` (RMS) / `MAX_HIDDEN_LN` (LayerNorm) the
backward, and past 32768 elements the forward, take the kernels' wide
path (a second pass over device memory instead of a row in shared
memory), as does a backward whose rows are not 16-byte vectors
(`norm_bwd_plan`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._cuda_common import (check_launch, count_launch, current_stream,
                           kernel_library)

_NORM_FWD = "fused_rms_norm_fwd"
_NORM_BWD = "fused_rms_norm_bwd"
_ROPE = "rope_qk"
_SWIGLU_FWD = "swiglu_fwd"
_SWIGLU_BWD = "swiglu_bwd"
_LN_FWD = "fused_layer_norm_fwd"
_LN_BWD = "fused_layer_norm_bwd"
_DA_FWD = "dropout_add_fwd"
_DA_BWD = "dropout_add_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the widest rows the norm backward's row kernel takes: 12 (RMS) and 11
#: (LayerNorm) warps a row. Wider rows, and rows that are not 16-byte
#: vectors, take the two-pass wide path (csrc/fused_norm.cu); there is no
#: width limit
MAX_HIDDEN = 12288
MAX_HIDDEN_LN = 11264
#: K3 backward's row kernel (kGroupCols, kBlockWarps in the source, whose
#: launcher recomputes the layout from h; tests/test_torch_norm_bwd_grid.py
#: holds the two copies equal): a row group of ceil(h / _GROUP_COLS) warps
#: takes one row at a time, a lane 32 elements of it; a block holds max(1,
#: _BLOCK_WARPS // that) groups, one block per SM
_GROUP_COLS = 1024
_BLOCK_WARPS = 8
#: the wide path's row blocks per SM and its columns a block (kWideCols in
#: the source)
_WIDE_BLOCKS_PER_SM = 4
_WIDE_COLS = 2048


class NormBwdPlan(NamedTuple):
    """K3 backward's launch: `route` "rows" (the one-pass row kernel) or
    "wide" (the two-pass wide path); for "rows", `row_warps` warps a row
    group and `groups` groups a block; `blocks` row ranges of `rpb` rows,
    one f32 partial row of dw (and of db) each."""
    route: str
    row_warps: int
    groups: int
    blocks: int
    rpb: int


def _acc(dtype):
    """The plain versions' compute dtype: f32 (f64 inputs in f64)."""
    return torch.promote_types(dtype, torch.float32)


# ------------------------------------------------------- plain versions

def rms_norm_fwd_reference(x, res, w, eps, out_dtype=None):
    """Plain K3 forward: (y, s, rstd). xs = x (+ res) in f32; rstd =
    rsqrt(mean(xs^2) + eps) [rows] f32; y = xs * rstd * w in `out_dtype`
    (default x's); s = xs in x's dtype when `res` is given, else None."""
    acc = _acc(x.dtype)
    xs = x.to(acc) if res is None else x.to(acc) + res.to(acc)
    h = x.shape[-1]
    rstd = torch.rsqrt((xs * xs).sum(-1, keepdim=True) * (1.0 / h) + eps)
    y = (xs * rstd * w.to(acc)).to(x.dtype if out_dtype is None
                                   else out_dtype)
    s = None if res is None else xs.to(x.dtype)
    return y, s, rstd.reshape(-1)


def rms_norm_bwd_reference(s, w, rstd, dy, ds=None):
    """Plain K3 backward from the saved pre-norm row `s` and `rstd`:
    xhat = s * rstd, c2 = mean(w * dy * xhat), dx = rstd * (w * dy - xhat
    * c2) (+ ds) in s's dtype, dw = sum over rows of dy * xhat in w's."""
    acc = _acc(s.dtype)
    h = s.shape[-1]
    r = rstd.to(acc).reshape(s.shape[:-1] + (1,))
    xhat = s.to(acc) * r
    dyf = dy.to(acc)
    wdy = dyf * w.to(acc)
    c2 = (wdy * xhat).sum(-1, keepdim=True) * (1.0 / h)
    dx = r * (wdy - xhat * c2)
    if ds is not None:
        dx = dx + ds.to(acc)
    dw = (dyf * xhat).reshape(-1, h).sum(0)
    return dx.to(s.dtype), dw.to(w.dtype)


def layer_norm_fwd_reference(x, res, w, b, eps, out_dtype=None):
    """Plain K3-LN forward: (y, s, rstd, mean). xs = x (+ res) in f32;
    mean and rstd = rsqrt(max(mean(xs^2) - mean^2, 0) + eps) [rows] f32;
    y = (xs - mean) * rstd * w + b in `out_dtype` (default x's); s = xs in
    x's dtype when `res` is given, else None."""
    acc = _acc(x.dtype)
    xs = x.to(acc) if res is None else x.to(acc) + res.to(acc)
    h = x.shape[-1]
    mean = xs.sum(-1, keepdim=True) * (1.0 / h)
    var = torch.clamp_min((xs * xs).sum(-1, keepdim=True) * (1.0 / h)
                          - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    y = ((xs - mean) * rstd * w.to(acc) + b.to(acc)).to(
        x.dtype if out_dtype is None else out_dtype)
    s = None if res is None else xs.to(x.dtype)
    return y, s, rstd.reshape(-1), mean.reshape(-1)


def layer_norm_bwd_reference(s, w, rstd, mean, dy, ds=None):
    """Plain K3-LN backward from the saved pre-norm row `s`, `rstd` and
    `mean`: xhat = (s - mean) * rstd, c1 = mean(w * dy), c2 = mean(w * dy
    * xhat), dx = rstd * (w * dy - c1 - xhat * c2) (+ ds) in s's dtype;
    dw = sum over rows of dy * xhat and db = sum of dy, in w's dtype."""
    acc = _acc(s.dtype)
    h = s.shape[-1]
    shape = s.shape[:-1] + (1,)
    r = rstd.to(acc).reshape(shape)
    xhat = (s.to(acc) - mean.to(acc).reshape(shape)) * r
    dyf = dy.to(acc)
    wdy = dyf * w.to(acc)
    c1 = wdy.sum(-1, keepdim=True) * (1.0 / h)
    c2 = (wdy * xhat).sum(-1, keepdim=True) * (1.0 / h)
    dx = r * (wdy - c1 - xhat * c2)
    if ds is not None:
        dx = dx + ds.to(acc)
    dw = (dyf * xhat).reshape(-1, h).sum(0)
    db = dyf.reshape(-1, h).sum(0)
    return dx.to(s.dtype), dw.to(w.dtype), db.to(w.dtype)


def rope_qk_reference(q, k, cos, sin, backward=False):
    """Plain K4: q, k [B, S, H, D] and tables cos/sin [S, D] -> (qo, ko)
    in q's and k's dtypes. Forward a*cos + concat(-a2, a1)*sin; backward
    (the rotation's transpose) g*cos + concat((g*sin)_2, -(g*sin)_1)."""
    acc = _acc(q.dtype)
    c = cos.to(acc)[None, :, None, :]
    sn = sin.to(acc)[None, :, None, :]

    def rot(a):
        a = a.to(acc)
        dh = a.shape[-1] // 2
        if backward:
            gs = a * sn
            return a * c + torch.cat([gs[..., dh:], -gs[..., :dh]], dim=-1)
        return a * c + torch.cat([-a[..., dh:], a[..., :dh]], dim=-1) * sn

    return rot(q).to(q.dtype), rot(k).to(k.dtype)


def swiglu_fwd_reference(g, u):
    """Plain K5 forward: silu(g) * u in g's dtype."""
    acc = _acc(g.dtype)
    gf = g.to(acc)
    return (gf * torch.sigmoid(gf) * u.to(acc)).to(g.dtype)


def swiglu_bwd_reference(g, u, do):
    """Plain K5 backward: (dg, du) = (do * u * (sig + silu * (1 - sig)),
    do * silu), sig = sigmoid(g), silu = g * sig, in g's and u's dtypes."""
    acc = _acc(g.dtype)
    gf, uf, dof = g.to(acc), u.to(acc), do.to(acc)
    sig = torch.sigmoid(gf)
    silu = gf * sig
    return ((dof * uf * (sig + silu * (1.0 - sig))).to(g.dtype),
            (dof * silu).to(u.dtype))


def dropout_add_fwd_reference(x, y, mask, scale):
    """Plain K6 forward: x * mask * scale + y in f32, rounded once to x's
    dtype."""
    acc = _acc(x.dtype)
    return (x.to(acc) * mask.to(acc) * scale + y.to(acc)).to(x.dtype)


def dropout_add_bwd_reference(g, mask, scale):
    """Plain K6 backward: dx = g * mask * scale in g's dtype (dy = g)."""
    acc = _acc(g.dtype)
    return (g.to(acc) * mask.to(acc) * scale).to(g.dtype)


# ------------------------------------------------------------- wrappers

def _plain(name, *tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on one CUDA device (the kernel launches). Anything
    else raises."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or on one "
                         f"CUDA device, got {sorted(map(str, devices))}")
    return False


def _check_contiguous(name, *tensors):
    if not all(t is None or t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def _check_dtype(name, dtype):
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {dtype}; the kernel takes float32, "
                         "bfloat16 or float16")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _entry(name, argtypes):
    fn = getattr(kernel_library(name), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(name, fn, *args):
    check_launch(name, fn(*args))
    count_launch(name)


def _check_norm(name, x, params, param_dtype, out_dtype, *others):
    h = x.shape[-1] if x.dim() else 0
    if x.numel() == 0:
        raise ValueError(f"{name}: needs rows of 1 or more elements, got "
                         f"shape {tuple(x.shape)} (the routed ops send "
                         "empty tensors to the plain composition)")
    _check_dtype(name, x.dtype)
    for p in params:
        if p.shape != (h,) or p.dtype != param_dtype:
            raise ValueError(f"{name}: weight and bias must be [{h}] "
                             f"{param_dtype}, got {tuple(p.shape)} {p.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"{name}: output dtype {out_dtype} must be x's "
                         f"({x.dtype}) or float32")
    for t in others:
        if t is not None and t.shape != x.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} differs from "
                             f"x's {tuple(x.shape)}")
    _check_contiguous(name, x, *params, *others)


def _check_stats(name, rows, *stats):
    for t in stats:
        if t.shape != (rows,) or t.dtype != torch.float32:
            raise ValueError(f"{name}: rstd and mean must be float32 "
                             f"[{rows}], got {tuple(t.shape)} {t.dtype}")
    _check_contiguous(name, *stats)


def norm_bwd_plan(rows, h, sms, max_hidden, vec) -> NormBwdPlan:
    """K3 backward's plan for `rows` rows of `h` elements on a card of
    `sms` SMs. Rows of 16-byte vectors (`vec`: h a multiple of 16 bytes'
    elements, every pointer 16-byte aligned) up to `max_hidden` take the
    row kernel: ceil(h / 1024) warps a row (the layout switches past h =
    1024, 2048, ...), max(1, _BLOCK_WARPS // that) row groups a block, and
    one wave of at most one block per SM over even row ranges (fewer
    blocks when the rows fill fewer blocks' groups). Other rows take the
    wide path: ~4 blocks per SM over the rows and 2048-column slabs."""
    if vec and h <= max_hidden:
        row_warps = -(-h // _GROUP_COLS)
        groups = max(1, _BLOCK_WARPS // row_warps)
        rpb = -(-rows // min(sms, -(-rows // groups)))
        return NormBwdPlan("rows", row_warps, groups, -(-rows // rpb), rpb)
    slabs = -(-h // _WIDE_COLS)
    blocks = min(rows, max(1, _WIDE_BLOCKS_PER_SM * sms // slabs))
    rpb = -(-rows // blocks)
    return NormBwdPlan("wide", 0, 0, -(-rows // rpb), rpb)


def _vectors(h, *tensors) -> bool:
    """True when rows of `h` elements of the first tensor's dtype are
    16-byte vectors and every tensor starts on 16 bytes (the row kernel's
    condition, as csrc/fused_norm.cu checks it)."""
    return h % (16 // tensors[0].element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def norm_bwd_plan_for(s, w, dy, ds, max_hidden, sms) -> NormBwdPlan:
    """The plan a K3 backward launches for these tensors (ds None for the
    plain norm) on a card of `sms` SMs: `norm_bwd_plan` of their rows,
    width and 16-byte vectors."""
    h = s.shape[-1]
    return norm_bwd_plan(s.numel() // h, h, sms, max_hidden,
                         _vectors(h, s, w, dy, ds))


def _bwd_scratch(s, w, dy, ds, max_hidden, sums):
    """(plan, part, coef) of a K3 backward: the plan on this card, the f32
    partial rows [sums * blocks, h] and, on the wide path, the f32 [2 *
    rows] row sums (else None)."""
    h = s.shape[-1]
    rows = s.numel() // h
    sms = torch.cuda.get_device_properties(s.device).multi_processor_count
    plan = norm_bwd_plan_for(s, w, dy, ds, max_hidden, sms)
    part = torch.empty((sums * plan.blocks, h), dtype=torch.float32,
                       device=s.device)
    coef = torch.empty(2 * rows, dtype=torch.float32, device=s.device) \
        if plan.route == "wide" else None
    return plan, part, coef


def fused_rms_norm_fwd(x, res, w, eps, out_dtype=None):
    """K3 forward: (y, s, rstd) as `rms_norm_fwd_reference` for x [.., H]
    (+ res, same shape and dtype; None for the plain norm) and w [H] in
    x's dtype; `out_dtype` (y's) is x's (default) or float32. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if _plain(_NORM_FWD, x, res, w):
        return rms_norm_fwd_reference(x, res, w, eps, out_dtype)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _check_norm("fused RMSNorm", x, (w,), x.dtype, out_dtype, res)
    if res is not None and res.dtype != x.dtype:
        raise ValueError(f"fused RMSNorm: residual dtype {res.dtype} differs "
                         f"from x's {x.dtype}")
    h = x.shape[-1]
    rows = x.numel() // h
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    s = None if res is None else torch.empty_like(x)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    fn = _entry(_NORM_FWD, [ctypes.c_void_p] * 6
                + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p])
    _launch(_NORM_FWD, fn, x.data_ptr(), _ptr(res), w.data_ptr(),
            y.data_ptr(), _ptr(s), rstd.data_ptr(), rows, h, float(eps),
            _DTYPES[x.dtype], _DTYPES[out_dtype], current_stream(x.device))
    return y, s, rstd


def fused_rms_norm_bwd(s, w, rstd, dy, ds=None):
    """K3 backward: (dx, dw) as `rms_norm_bwd_reference`, from the saved
    pre-norm row s [.., H], w [H] and rstd [rows] f32, the output gradient
    dy (s's dtype or float32) and, for the add variant, the summed
    stream's gradient ds (added into dx). CPU tensors take the plain
    version; CUDA tensors launch the row kernel and the fixed-order dw
    sum."""
    if _plain(_NORM_BWD, s, w, rstd, dy, ds):
        return rms_norm_bwd_reference(s, w, rstd, dy, ds)
    name = "fused RMSNorm backward"
    _check_norm(name, s, (w,), s.dtype, dy.dtype, dy, ds)
    h = s.shape[-1]
    rows = s.numel() // h
    _check_stats(name, rows, rstd)
    if ds is not None and ds.dtype != s.dtype:
        raise ValueError(f"{name}: ds dtype {ds.dtype} differs from s's "
                         f"{s.dtype}")
    plan, part, coef = _bwd_scratch(s, w, dy, ds, MAX_HIDDEN, 1)
    dx = torch.empty_like(s)
    dw = torch.empty(h, dtype=s.dtype, device=s.device)
    fn = _entry(_NORM_BWD, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                + [ctypes.c_void_p])
    _launch(_NORM_BWD, fn, s.data_ptr(), w.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), _ptr(ds), dx.data_ptr(), dw.data_ptr(),
            part.data_ptr(), _ptr(coef), rows, h, plan.blocks, plan.rpb,
            _DTYPES[s.dtype], _DTYPES[dy.dtype], current_stream(s.device))
    return dx, dw


def fused_layer_norm_fwd(x, res, w, b, eps, out_dtype=None):
    """K3-LN forward: (y, s, rstd, mean) as `layer_norm_fwd_reference`
    for x [.., H] (+ res, same shape and dtype; None for the plain norm)
    and w, b [H] float32; `out_dtype` (y's) is x's (default) or float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if _plain(_LN_FWD, x, res, w, b):
        return layer_norm_fwd_reference(x, res, w, b, eps, out_dtype)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _check_norm("fused LayerNorm", x, (w, b), torch.float32, out_dtype, res)
    if res is not None and res.dtype != x.dtype:
        raise ValueError(f"fused LayerNorm: residual dtype {res.dtype} "
                         f"differs from x's {x.dtype}")
    h = x.shape[-1]
    rows = x.numel() // h
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    s = None if res is None else torch.empty_like(x)
    rstd, mean = (torch.empty(rows, dtype=torch.float32, device=x.device)
                  for _ in range(2))
    fn = _entry(_LN_FWD, [ctypes.c_void_p] * 8
                + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p])
    _launch(_LN_FWD, fn, x.data_ptr(), _ptr(res), w.data_ptr(),
            b.data_ptr(), y.data_ptr(), _ptr(s), rstd.data_ptr(),
            mean.data_ptr(), rows, h, float(eps), _DTYPES[x.dtype],
            _DTYPES[out_dtype], current_stream(x.device))
    return y, s, rstd, mean


def fused_layer_norm_bwd(s, w, rstd, mean, dy, ds=None):
    """K3-LN backward: (dx, dw, db) as `layer_norm_bwd_reference`, from
    the saved pre-norm row s [.., H], w [H] float32, rstd and mean [rows]
    float32, the output gradient dy (s's dtype or float32) and, for the
    add variant, the summed stream's gradient ds (added into dx); dw and
    db come back float32. CPU tensors take the plain version; CUDA
    tensors launch the row kernel and the fixed-order dw/db sum."""
    if _plain(_LN_BWD, s, w, rstd, mean, dy, ds):
        return layer_norm_bwd_reference(s, w, rstd, mean, dy, ds)
    name = "fused LayerNorm backward"
    _check_norm(name, s, (w,), torch.float32, dy.dtype, dy, ds)
    h = s.shape[-1]
    rows = s.numel() // h
    _check_stats(name, rows, rstd, mean)
    if ds is not None and ds.dtype != s.dtype:
        raise ValueError(f"{name}: ds dtype {ds.dtype} differs from s's "
                         f"{s.dtype}")
    plan, part, coef = _bwd_scratch(s, w, dy, ds, MAX_HIDDEN_LN, 2)
    dx = torch.empty_like(s)
    dw, db = (torch.empty(h, dtype=torch.float32, device=s.device)
              for _ in range(2))
    fn = _entry(_LN_BWD, [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                + [ctypes.c_void_p])
    _launch(_LN_BWD, fn, s.data_ptr(), w.data_ptr(), rstd.data_ptr(),
            mean.data_ptr(), dy.data_ptr(), _ptr(ds), dx.data_ptr(),
            dw.data_ptr(), db.data_ptr(), part.data_ptr(), _ptr(coef), rows,
            h, plan.blocks, plan.rpb, _DTYPES[s.dtype], _DTYPES[dy.dtype],
            current_stream(s.device))
    return dx, dw, db


def rope_qk(q, k, cos, sin, backward=False):
    """K4: (qo, ko) as `rope_qk_reference` for q, k [B, S, H, D] (one shape,
    D even) and tables cos, sin [S, D], all of one dtype; `backward`
    applies the transpose. One launch rotates both. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if _plain(_ROPE, q, k, cos, sin):
        return rope_qk_reference(q, k, cos, sin, backward)
    if q.dim() != 4 or q.shape != k.shape or q.shape[-1] % 2 \
            or cos.shape != (q.shape[1], q.shape[3]) \
            or sin.shape != cos.shape:
        raise ValueError(f"rope_qk takes q, k [B, S, H, D] of one shape, D "
                         f"even, and tables [S, D]; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, cos {tuple(cos.shape)}, sin "
                         f"{tuple(sin.shape)}")
    _check_dtype(_ROPE, q.dtype)
    if not k.dtype == cos.dtype == sin.dtype == q.dtype:
        raise ValueError(f"rope_qk: dtypes {q.dtype}/{k.dtype}/{cos.dtype}/"
                         f"{sin.dtype} must be alike")
    _check_contiguous(_ROPE, q, k, cos, sin)
    b, s, heads, d = q.shape
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    fn = _entry(_ROPE, [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _launch(_ROPE, fn, q.data_ptr(), k.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), qo.data_ptr(), ko.data_ptr(), b * s * heads, s,
            heads, d, int(bool(backward)), _DTYPES[q.dtype],
            current_stream(q.device))
    return qo, ko


def _check_elementwise(name, *tensors):
    t0 = tensors[0]
    _check_dtype(name, t0.dtype)
    if any(t.shape != t0.shape or t.dtype != t0.dtype for t in tensors):
        raise ValueError(f"{name} takes tensors of one shape and dtype, got "
                         + ", ".join(f"{tuple(t.shape)} {t.dtype}"
                                     for t in tensors))
    _check_contiguous(name, *tensors)


def swiglu_fwd(g, u):
    """K5 forward: silu(g) * u for g, u of one shape and dtype. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if _plain(_SWIGLU_FWD, g, u):
        return swiglu_fwd_reference(g, u)
    _check_elementwise("swiglu", g, u)
    o = torch.empty_like(g)
    fn = _entry(_SWIGLU_FWD, [ctypes.c_void_p] * 3
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    _launch(_SWIGLU_FWD, fn, g.data_ptr(), u.data_ptr(), o.data_ptr(),
            g.numel(), _DTYPES[g.dtype], current_stream(g.device))
    return o


def swiglu_bwd(g, u, do):
    """K5 backward: (dg, du) as `swiglu_bwd_reference`. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if _plain(_SWIGLU_BWD, g, u, do):
        return swiglu_bwd_reference(g, u, do)
    _check_elementwise("swiglu", g, u, do)
    dg, du = torch.empty_like(g), torch.empty_like(u)
    fn = _entry(_SWIGLU_BWD, [ctypes.c_void_p] * 5
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    _launch(_SWIGLU_BWD, fn, g.data_ptr(), u.data_ptr(), do.data_ptr(),
            dg.data_ptr(), du.data_ptr(), g.numel(), _DTYPES[g.dtype],
            current_stream(g.device))
    return dg, du


def dropout_add_fwd(x, y, mask, scale):
    """K6 forward: x * mask * scale + y for x, y and the 0/1 mask of one
    shape and dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if _plain(_DA_FWD, x, y, mask):
        return dropout_add_fwd_reference(x, y, mask, scale)
    _check_elementwise("dropout_add", x, y, mask)
    o = torch.empty_like(x)
    fn = _entry(_DA_FWD, [ctypes.c_void_p] * 4
                + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p])
    _launch(_DA_FWD, fn, x.data_ptr(), y.data_ptr(), mask.data_ptr(),
            o.data_ptr(), float(scale), x.numel(), _DTYPES[x.dtype],
            current_stream(x.device))
    return o


def dropout_add_bwd(g, mask, scale):
    """K6 backward: dx = g * mask * scale. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if _plain(_DA_BWD, g, mask):
        return dropout_add_bwd_reference(g, mask, scale)
    _check_elementwise("dropout_add", g, mask)
    dx = torch.empty_like(g)
    fn = _entry(_DA_BWD, [ctypes.c_void_p] * 3
                + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p])
    _launch(_DA_BWD, fn, g.data_ptr(), mask.data_ptr(), dx.data_ptr(),
            float(scale), g.numel(), _DTYPES[g.dtype],
            current_stream(g.device))
    return dx


# ---------------------------------------------------- differentiable ops

class RMSNorm(torch.autograd.Function):
    """y = rmsnorm(x) * w through K3 (the reference's `rms_norm_fused`);
    saves x, w and rstd."""

    @staticmethod
    def forward(ctx, x, w, eps, out_dtype):
        y, _, rstd = fused_rms_norm_fwd(x, None, w, eps, out_dtype)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        dx, dw = fused_rms_norm_bwd(x, w, rstd, dy.contiguous())
        return dx, dw, None, None


class AddRMSNorm(torch.autograd.Function):
    """(y, s) = (rmsnorm(x + res) * w, x + res) through K3 (the
    reference's `add_rms_norm_fused`); saves s, w and rstd. Both inputs
    get dsum = dx + ds."""

    @staticmethod
    def forward(ctx, x, res, w, eps, out_dtype):
        y, s, rstd = fused_rms_norm_fwd(x, res, w, eps, out_dtype)
        ctx.save_for_backward(s, w, rstd)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        s, w, rstd = ctx.saved_tensors
        dsum, dw = fused_rms_norm_bwd(s, w, rstd, dy.contiguous(),
                                      ds.contiguous())
        return dsum, dsum, dw, None, None


class LayerNorm(torch.autograd.Function):
    """y = layernorm(x) * w + b through K3-LN (the reference's
    `layer_norm_fused`); saves x, w, rstd and mean."""

    @staticmethod
    def forward(ctx, x, w, b, eps, out_dtype):
        y, _, rstd, mean = fused_layer_norm_fwd(x, None, w, b, eps,
                                                out_dtype)
        ctx.save_for_backward(x, w, rstd, mean)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd, mean = ctx.saved_tensors
        dx, dw, db = fused_layer_norm_bwd(x, w, rstd, mean, dy.contiguous())
        return dx, dw, db, None, None


class AddLayerNorm(torch.autograd.Function):
    """(y, s) = (layernorm(x + res) * w + b, x + res) through K3-LN (the
    reference's `add_layer_norm_fused`); saves s, w, rstd and mean. Both
    inputs get dsum = dx + ds."""

    @staticmethod
    def forward(ctx, x, res, w, b, eps, out_dtype):
        y, s, rstd, mean = fused_layer_norm_fwd(x, res, w, b, eps, out_dtype)
        ctx.save_for_backward(s, w, rstd, mean)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        s, w, rstd, mean = ctx.saved_tensors
        dsum, dw, db = fused_layer_norm_bwd(s, w, rstd, mean, dy.contiguous(),
                                            ds.contiguous())
        return dsum, dsum, dw, db, None, None


class RopeQK(torch.autograd.Function):
    """(qo, ko): q and k rotated by [S, D] tables through K4 (the
    reference's `rope_qk_fused`); the backward is the same kernel with
    `backward=True`. The tables get no gradient."""

    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope_qk(q, k, cos, sin)

    @staticmethod
    def backward(ctx, dqo, dko):
        cos, sin = ctx.saved_tensors
        dq, dk = rope_qk(dqo.contiguous(), dko.contiguous(), cos, sin,
                         backward=True)
        return dq, dk, None, None


class SwiGLU(torch.autograd.Function):
    """silu(gate) * up through K5 (the reference's `swiglu_fused`); saves
    gate and up."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return swiglu_fwd(g, u)

    @staticmethod
    def backward(ctx, do):
        g, u = ctx.saved_tensors
        return swiglu_bwd(g, u, do.contiguous())


class DropoutAdd(torch.autograd.Function):
    """x * mask * scale + y through K6 (the reference's
    `dropout_add_fused`); saves only the mask. dx = K6's backward, dy = g
    (no kernel); the mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, y, mask, scale):
        ctx.save_for_backward(mask)
        ctx.scale = scale
        return dropout_add_fwd(x, y, mask, scale)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        g = g.contiguous()
        return dropout_add_bwd(g, mask, ctx.scale), g, None, None


# --------------------------------------------- dtype-harmonising entries

def rms_norm_raw(x, w=None, eps=1e-6, out_dtype=None):
    """rmsnorm(x) * w (w None: ones in x's dtype). The output dtype is
    `out_dtype`, by default the promotion of x's and w's as in the
    reference; w is cast to x's dtype for the kernel (its gradient flows
    back through the cast). out_dtype=float32 over a bf16 x is the
    reference's O2 autocast of this op (x and w upcast, exactly, then an
    f32 norm), read straight from the bf16 tensors."""
    if w is None:
        w = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, w.dtype)
    return RMSNorm.apply(x.contiguous(), w.to(x.dtype).contiguous(),
                         float(eps), out_dtype)


def add_rms_norm_raw(x, res, w=None, eps=1e-6):
    """(rmsnorm(x + res) * w, x + res), x and res promoted to one dtype
    first; normed in the promotion of that and w's dtype, summed in the
    former."""
    ct = torch.promote_types(x.dtype, res.dtype)
    if w is None:
        w = torch.ones(x.shape[-1], dtype=ct, device=x.device)
    return AddRMSNorm.apply(x.to(ct).contiguous(), res.to(ct).contiguous(),
                            w.to(ct).contiguous(), float(eps),
                            torch.promote_types(ct, w.dtype))


def _promote(*dtypes):
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


def layer_norm_raw(x, w=None, b=None, eps=1e-5, out_dtype=None):
    """layernorm(x) * w + b (w None: ones, b None: zeros). w and b reach
    the kernel in f32 (their gradients flow back through the cast). With
    `out_dtype` None, the reference's dtypes: the norm written in x's
    dtype, then cast to the promotion of x's, w's and b's.
    out_dtype=float32 over a bf16 x is the reference's O2 autocast of
    this op (x, w and b upcast, exactly, then an f32 norm), read straight
    from the bf16 tensor and written in f32."""
    acc = _acc(x.dtype)
    h = x.shape[-1]
    promoted = _promote(x.dtype, *(p.dtype for p in (w, b) if p is not None))
    w = torch.ones(h, dtype=acc, device=x.device) if w is None else w.to(acc)
    b = torch.zeros(h, dtype=acc, device=x.device) if b is None \
        else b.to(acc)
    y = LayerNorm.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                        float(eps), x.dtype if out_dtype is None
                        else out_dtype)
    return y.to(promoted) if out_dtype is None else y


def add_layer_norm_raw(x, res, w=None, b=None, eps=1e-5):
    """(layernorm(x + res) * w + b, x + res), x and res promoted to one
    dtype first; the norm written in that dtype and cast to its promotion
    with w's and b's, the sum in the former (the reference's dtypes)."""
    ct = torch.promote_types(x.dtype, res.dtype)
    acc = _acc(ct)
    h = x.shape[-1]
    out_dt = _promote(ct, *(p.dtype for p in (w, b) if p is not None))
    w = torch.ones(h, dtype=acc, device=x.device) if w is None else w.to(acc)
    b = torch.zeros(h, dtype=acc, device=x.device) if b is None \
        else b.to(acc)
    y, s = AddLayerNorm.apply(x.to(ct).contiguous(), res.to(ct).contiguous(),
                              w.contiguous(), b.contiguous(), float(eps), ct)
    return y.to(out_dt), s


def _tables2(t, s, d):
    """A rope table broadcastable to [1, S, 1, D] (or [S, D]) -> [S, D]."""
    t2 = t.reshape(-1, t.shape[-1])
    if t2.shape[0] == 1 and s > 1:
        t2 = t2.expand(s, d)
    if t2.shape != (s, d):
        raise ValueError(f"rope table {tuple(t.shape)} does not give [S, D] "
                         f"= [{s}, {d}]")
    return t2.contiguous()


def rope_qk_raw(q, k, cos, sin):
    """(qo, ko): q, k [B, S, H, D] of one shape rotated by tables
    broadcastable to [1, S, 1, D], all four promoted to one dtype first
    (the reference promotes q and k each with the tables)."""
    ct = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                             torch.promote_types(cos.dtype, sin.dtype))
    s, d = q.shape[1], q.shape[3]
    return RopeQK.apply(q.to(ct).contiguous(), k.to(ct).contiguous(),
                        _tables2(cos, s, d).to(ct), _tables2(sin, s, d).to(ct))


def swiglu_raw(gate, up):
    """silu(gate) * up, both promoted to one dtype first."""
    ct = torch.promote_types(gate.dtype, up.dtype)
    return SwiGLU.apply(gate.to(ct).contiguous(), up.to(ct).contiguous())


def dropout_add_raw(x, y, mask, scale):
    """x * mask * scale + y, x and y (and the mask) promoted to one dtype
    first."""
    ct = torch.promote_types(x.dtype, y.dtype)
    return DropoutAdd.apply(x.to(ct).contiguous(), y.to(ct).contiguous(),
                            mask.to(ct).contiguous(), float(scale))
