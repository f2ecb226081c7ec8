"""Shared op-definition helpers.

Port of paddle_tpu/ops/_helpers.py. The ops' bodies work on torch
tensors; `core.dispatch.op` is the boundary that unwraps and wraps.
"""
from __future__ import annotations

import struct

import torch

from ..core import dtype as dtypes
from ..core.dispatch import op
from ..core.tensor import Tensor
from ..core.tensor import _raw as raw


def like(v, ref: torch.Tensor) -> torch.Tensor:
    """v (a torch tensor, or a Python / numpy scalar or list) as a tensor
    on ref's device. A Python int or float beside a floating `ref` takes
    ref's dtype (the reference's scalar promotion, `ops/__init__.py:104`
    `_ensure`); otherwise ints are int64, floats the default dtype."""
    # a Python scalar becomes a fill on ref's device (no host-to-device
    # copy, so a step captured into a CUDA graph can hold it)
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (int, float)) and not isinstance(v, bool) and (
            ref.is_floating_point() or ref.is_complex()):
        return torch.full((), v, dtype=ref.dtype, device=ref.device)
    if isinstance(v, float):
        return torch.full((), v, dtype=dtypes.get_default_dtype(),
                          device=ref.device)
    if isinstance(v, (bool, int)):
        return torch.full((), v, dtype=torch.bool if isinstance(v, bool)
                          else torch.int64, device=ref.device)
    t = torch.as_tensor(v, device=ref.device)
    if t.dtype == torch.float64:
        t = t.to(dtypes.get_default_dtype())
    return t


class _TieAbs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def tie_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the reference's derivative: +1 at 0, where torch's is 0
    (jnp.abs's rule, select(x >= 0, g, -g))."""
    if x.requires_grad and torch.is_grad_enabled() and \
            x.is_floating_point():
        return _TieAbs.apply(x)
    return torch.abs(x)


class _TieClamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        lo, hi = ctx.bounds
        m = x
        if lo is not None:
            g = torch.where(x > lo, g, torch.where(x == lo, g * 0.5, 0.0))
            m = torch.clamp_min(x, lo)
        if hi is not None:
            g = torch.where(m < hi, g, torch.where(m == hi, g * 0.5, 0.0))
        return g, None, None


def tie_clamp(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """torch.clamp between scalar bounds with the reference's derivative:
    its clip is a maximum then a minimum, each of which shares a tie's
    gradient equally, so x on a bound gets half of it (a quarter where
    lo == hi) where torch.clamp gives all."""
    if x.requires_grad and torch.is_grad_enabled() and \
            x.is_floating_point():
        return _TieClamp.apply(x, lo, hi)
    return torch.clamp(x, lo, hi)


def inexact(dtype) -> torch.dtype:
    """The floating dtype an integer (or bool) dtype promotes to where the
    reference's ops need one (`mean`, `divide`): float64 for 64-bit
    integers, float32 for the rest, as jnp's promotion under x64."""
    return torch.float64 if dtype in (torch.int64, torch.uint64) \
        else torch.float32


def pair(x, y):
    """Binary operands as tensors: a scalar beside a tensor by `like`."""
    if not isinstance(x, torch.Tensor):
        x = like(x, y)
    elif not isinstance(y, torch.Tensor):
        y = like(y, x)
    return x, y


def unary(tfn, opname):
    @op(opname)
    def f(x, name=None):
        return tfn(x)

    f.__name__ = f.__qualname__ = opname
    return f


def exact_scalar(v, ref: torch.Tensor) -> bool:
    """Whether Python number v can go to a torch op beside floating `ref`
    as it is: v exact in ref's dtype, so that torch (which computes a
    bf16 / f16 op with the number in f32) gives what the reference gives
    (the number cast to ref's dtype first). A number passed as it is
    costs no fill on the device."""
    if type(v) not in (int, float) or not ref.is_floating_point():
        return False
    dt = ref.dtype
    if dt in (torch.float32, torch.float64):
        return True
    if type(v) is int:
        return -256 <= v <= 256
    try:
        if dt == torch.bfloat16:
            packed = struct.pack("<f", v)
            return struct.unpack("<I", packed)[0] & 0xFFFF == 0 and \
                struct.unpack("<f", packed)[0] == v
        return dt == torch.float16 and \
            struct.unpack("<e", struct.pack("<e", v))[0] == v
    except OverflowError:
        return False


#: binary ops whose torch function takes a number as its second operand
#: and gives the reference's bits; pow only at 2 (x * x on both sides:
#: torch gives other numbers kernels of their own, a cube or a square
#: root, whose bits differ)
_NUMBER_SECOND = {"add", "subtract", "multiply", "divide", "pow",
                  "floor_divide", "mod", "remainder", "floor_mod"}
_COMMUTES = {"add", "multiply"}


def binary(tfn, opname):
    second = opname in _NUMBER_SECOND
    commutes = opname in _COMMUTES
    is_pow = opname == "pow"

    @op(opname)
    def f(x, y, name=None):
        if second and isinstance(x, torch.Tensor) and exact_scalar(y, x) \
                and (not is_pow or y == 2):
            return tfn(x, y)
        if commutes and isinstance(y, torch.Tensor) and exact_scalar(x, y):
            return tfn(y, x)
        return tfn(*pair(x, y))

    f.__name__ = f.__qualname__ = opname
    return f


def logical(tfn, opname):
    """A comparison / logical op: never differentiated."""

    @op(opname, n_diff=0)
    def f(x, y=None, name=None):
        if y is None:
            return tfn(x)
        return tfn(*pair(x, y))

    f.__name__ = f.__qualname__ = opname
    return f


def norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    elif isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(axis, ndim):
    """A reduction's dims for torch: all of them for None, a tuple of
    ints otherwise ([] and () reduce nothing in the reference; torch
    reads an empty dim list as all dims, so the caller checks)."""
    if axis is None:
        return tuple(range(ndim))
    return axis if isinstance(axis, tuple) else (axis,)


_HELPERS = {"op", "raw", "like", "pair", "inexact", "unary", "binary",
            "logical", "norm_axis", "dims", "inplace_variant", "public",
            "Tensor", "tie_abs", "tie_clamp", "exact_scalar"}


def public(namespace) -> list:
    """An op module's `__all__`: its public functions (not the helpers
    it imports)."""
    return [n for n, v in namespace.items()
            if not n.startswith("_") and n not in _HELPERS
            and callable(v) and not isinstance(v, type)
            and getattr(v, "__module__", "").startswith(
                "paddle_tpu_torch.ops")]


def inplace_variant(fn):
    """The Paddle `op_` (in place) of the functional op `fn`.

    As the reference's (`ops/_helpers.py:62`): on a leaf that requires
    grad, while grad is enabled, it raises RuntimeError; otherwise the
    out-of-place op runs and its value becomes x's (`Tensor._write`:
    rebinding `_data` where autograd records, so earlier ops keep the old
    value, a storage write where nothing records). On a torch tensor it
    is the op then `copy_`."""

    def op_(x, *args, **kwargs):
        if not isinstance(x, Tensor):
            out = fn(x, *args, **kwargs)
            if out.shape == x.shape and out.dtype == x.dtype:
                return x.copy_(out)
            return out
        d = x._data
        if d.requires_grad and d.grad_fn is None and torch.is_grad_enabled():
            raise RuntimeError(
                f"{fn.__name__}_(): an in-place operation on a leaf Tensor "
                "that requires grad is not allowed — operate on a "
                "computed value or use the out-of-place op")
        out = fn(x, *args, **kwargs)
        return x._write(out._data)

    op_.__name__ = op_.__qualname__ = fn.__name__ + "_"
    return op_
