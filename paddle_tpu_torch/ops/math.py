"""Elementwise and scalar math ops.

Port of paddle_tpu/ops/math.py (the reference composes them in XLA; the
port in torch's eager ops). Each runs through the op boundary under the
reference's op name.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import dtype as dtypes
from ..core.dispatch import op
from ..core.tensor import Tensor
from ._helpers import (binary, inexact, inplace_variant, like, logical,
                       norm_axis, pair, public, tie_abs, tie_clamp, unary)


def _imag(a):
    return torch.imag(a) if a.is_complex() else torch.zeros_like(a)


def _frac(a):
    return a - torch.trunc(a)


def _angle(a):
    """torch.angle; in f32 for a bf16 / f16 input (the card has no such
    kernel), cast back."""
    if a.dtype in (torch.bfloat16, torch.float16):
        return torch.angle(a.float()).to(a.dtype)
    return torch.angle(a)


_UNARY = {
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "square": torch.square,
    "abs": tie_abs, "neg": torch.neg, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
    "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "asinh": torch.asinh, "acosh": torch.acosh,
    "atanh": torch.atanh, "ceil": torch.ceil, "floor": torch.floor,
    "round": torch.round, "trunc": torch.trunc, "frac": _frac,
    "sign": torch.sign, "sigmoid": torch.sigmoid,
    "reciprocal": torch.reciprocal, "erf": torch.erf,
    "erfinv": torch.erfinv, "lgamma": torch.lgamma,
    "digamma": torch.digamma, "i0": torch.special.i0,
    "rad2deg": torch.rad2deg, "deg2rad": torch.deg2rad,
    "angle": _angle, "conj": torch.conj_physical, "real": torch.real,
    "imag": _imag,
}


def _divide(x, y):
    """x / y; two integer tensors divide in `inexact` of their dtype."""
    if not (x.is_floating_point() or x.is_complex()
            or y.is_floating_point() or y.is_complex()):
        dt = inexact(torch.promote_types(x.dtype, y.dtype))
        x, y = x.to(dt), y.to(dt)
    return torch.true_divide(x, y)


def _ldexp(x, y):
    return x * torch.pow(2.0, y)


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": _divide, "floor_divide": torch.floor_divide,
    "mod": torch.remainder, "remainder": torch.remainder,
    "floor_mod": torch.remainder, "pow": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum, "fmax": torch.fmax,
    "fmin": torch.fmin, "atan2": torch.atan2, "heaviside": torch.heaviside,
    "hypot": torch.hypot, "copysign": torch.copysign,
    "nextafter": torch.nextafter, "logaddexp": torch.logaddexp,
    "ldexp": _ldexp,
}

_LOGICAL_BIN = {
    "equal": torch.eq, "not_equal": torch.ne, "less_than": torch.lt,
    "less_equal": torch.le, "greater_than": torch.gt,
    "greater_equal": torch.ge, "logical_and": torch.logical_and,
    "logical_or": torch.logical_or, "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor, "gcd": torch.gcd, "lcm": torch.lcm,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
}

_LOGICAL_UN = {
    "logical_not": torch.logical_not, "bitwise_not": torch.bitwise_not,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "signbit": torch.signbit,
}

for _n, _f in _UNARY.items():
    globals()[_n] = unary(_f, _n)
for _n, _f in _BINARY.items():
    globals()[_n] = binary(_f, _n)
for _n, _f in _LOGICAL_BIN.items():
    globals()[_n] = logical(_f, _n)
for _n, _f in _LOGICAL_UN.items():
    globals()[_n] = logical(_f, _n)

negative = globals()["neg"]

_ACTS = {None: lambda v: v, "relu": torch.relu, "tanh": torch.tanh,
         "sigmoid": torch.sigmoid,
         "softmax": lambda v: torch.softmax(v, -1),
         "gelu": lambda v: F.gelu(v, approximate="tanh"),
         "leaky_relu": lambda v: F.leaky_relu(v, 0.01)}


@op("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    if act not in _ACTS:
        raise ValueError(f"scale: unsupported act {act!r}")
    fn = _ACTS[act]
    s, b = (v.detach() if isinstance(v, torch.Tensor) else v
            for v in (scale, bias))
    return fn(x * s + b) if bias_after_scale else fn((x + b) * s)


@op("clip")
def clip(x, min=None, max=None, name=None):
    """Clamp into [min, max]; an integer tensor with a float bound comes
    out float64, as the reference's promotion gives it. With neither
    bound, x as it is (the reference's clip does nothing)."""
    if min is None and max is None:
        return x
    if not (x.is_floating_point() or x.is_complex()) and any(
            isinstance(v, float) for v in (min, max)):
        x = x.to(torch.float64)
    lo, hi = (v.to(x.dtype) if isinstance(v, torch.Tensor) else v
              for v in (min, max))
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        if lo is not None:
            x = torch.maximum(x, like(lo, x))
        return x if hi is None else torch.minimum(x, like(hi, x))
    return tie_clamp(x, lo, hi)


@op("lerp")
def lerp(x, y, weight, name=None):
    x, y = pair(x, y)
    return x + weight * (y - x)


@op("logit")
def logit(x, eps=None, name=None):
    z = tie_clamp(x, eps, 1 - eps) if eps else x
    return torch.log(z / (1 - z))


@op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


@op("softplus")
def softplus(x, beta=1, threshold=20, name=None):
    """log(1 + exp(beta x)) / beta, x where beta x > threshold; an
    integer x computes in float64 beside a float beta (jnp's weak float)
    and in its own width's float otherwise."""
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float64 if isinstance(beta, float)
                 or x.dtype == torch.int64 else torch.float32)
    xb = x * beta
    return torch.where(xb > threshold, x,
                       torch.logaddexp(xb, torch.zeros_like(xb)) / beta)


@op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def increment(x, value=1.0, name=None):
    """x += value in place (the reference's buffer swap; an integer x
    with a float value becomes float64, as the reference's body computes
    it under x64)."""
    if isinstance(x, Tensor):
        d = x._data
        if isinstance(value, float) and not (d.is_floating_point()
                                             or d.is_complex()):
            d = d.to(torch.float64)
        return x._write(d + value)
    return x.add_(value)


def _flat(a, ax):
    return (a.reshape(-1), 0) if ax is None else (a, ax)


def _scan_dtype(a, dtype):
    """A scan's dtype: the given one, else the input's for an integer
    input (the reference keeps int32; torch would give int64)."""
    if dtype is not None:
        return dtypes.convert_dtype(dtype)
    if a.dtype != torch.bool and not (a.is_floating_point()
                                      or a.is_complex()):
        return a.dtype
    return None


@op("cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    a, ax = _flat(x, norm_axis(axis))
    return torch.cumsum(a, ax, dtype=_scan_dtype(a, dtype))


@op("cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    a, ax = _flat(x, norm_axis(dim))
    return torch.cumprod(a, ax, dtype=_scan_dtype(a, dtype))


@op("cummax")
def cummax(x, axis=None, dtype="int64", name=None):
    a, ax = _flat(x, norm_axis(axis))
    v, i = torch.cummax(a, ax)
    return v, i.to(dtypes.convert_dtype(dtype))


@op("cummin")
def cummin(x, axis=None, dtype="int64", name=None):
    a, ax = _flat(x, norm_axis(axis))
    v, i = torch.cummin(a, ax)
    return v, i.to(dtypes.convert_dtype(dtype))


@op("logcumsumexp")
def logcumsumexp(x, axis=None, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtypes.convert_dtype(dtype))
    a, ax = _flat(x, norm_axis(axis))
    return torch.logcumsumexp(a, ax)


@op("isclose", n_diff=0)
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@op("allclose", n_diff=0)
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@op("equal_all", n_diff=0)
def equal_all(x, y, name=None):
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return (x == y).all()


@op("multiplex")
def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs))
    idx = index.reshape(1, -1, *([1] * (stacked.dim() - 2))).long()
    return torch.gather(stacked, 0, idx.expand(1, *stacked.shape[1:]))[0]


# in-place variants (paddle `op_` convention)
for _n in ("add", "subtract", "multiply", "divide", "clip", "scale", "exp",
           "sqrt", "reciprocal", "round", "ceil", "floor", "sigmoid",
           "tanh"):
    globals()[_n + "_"] = inplace_variant(globals()[_n])

__all__ = public(globals())
