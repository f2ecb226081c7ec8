"""paddle_tpu_torch.ops: the Tensor API's op library, and the port's
hand-written CUDA kernels (`flash_attention`, `paged_decode`,
`fused_norm`, ...), each beside its plain version.

Port of paddle_tpu/ops/__init__.py: importing it attaches the operators
and the ops' methods to `Tensor` (the reference's rule, :111-160, with its
`_SKIP` list) and makes the `op_` in-place twins of `_INPLACE_BASES`
(:169-190), `getitem` / `setitem` and the rest of its own ops. The op
modules import torch and numpy only, so `import
paddle_tpu_torch.ops.fused_norm` costs a few tens of ms more than before.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import CUDAPinnedPlace, Place, device_of
from ..core.dispatch import op
from ..core.tensor import Tensor, to_tensor  # noqa: F401
from . import creation as _creation
from . import extras as _extras
from . import linalg as _linalg
from . import manipulation as _manip
from . import math as _math
from . import random as _random
from . import reduction as _reduction
from ._helpers import inplace_variant as _inplace_variant
from ._helpers import raw as _raw

# the op modules' public names, in the reference's order: later modules'
# names win
_SOURCES = [_math, _creation, _reduction, _manip, _linalg, _random, _extras]
for _mod in _SOURCES:
    globals().update({n: getattr(_mod, n) for n in _mod.__all__})


# ---------------------------------------------------------------- indexing
def _index_item(it, dev):
    if isinstance(it, Tensor):
        it = it._data
    if isinstance(it, (list, np.ndarray)):
        it = torch.as_tensor(np.asarray(it), device=dev)
    if isinstance(it, torch.Tensor) and it.device != dev:
        it = it.to(dev)
    return it


def _consumes(it, ndim):
    """How many of the tensor's dims an index item takes."""
    if it is None:
        return 0
    if isinstance(it, torch.Tensor) and it.dtype == torch.bool:
        return it.dim()
    return 1


def _norm_index(a, item):
    """A Paddle index for torch: tensors and lists as index tensors on a's
    device, and slices with a negative step (which torch refuses) applied
    first as index_select, as jnp's indexing takes them."""
    items = list(item) if isinstance(item, tuple) else [item]
    items = [_index_item(it, a.device) for it in items]
    if not builtins.any(isinstance(it, builtins.slice)
                        and it.step is not None and int(it.step) < 0
                        for it in items):
        return a, tuple(items)
    n_used = builtins.sum(_consumes(it, a.dim()) for it in items
                          if it is not Ellipsis)
    dim = 0
    for k, it in enumerate(items):
        if it is Ellipsis:
            dim += a.dim() - n_used
            continue
        if isinstance(it, builtins.slice) and it.step is not None and \
                int(it.step) < 0:
            idx = range(*it.indices(a.shape[dim]))
            a = torch.index_select(a, dim, torch.tensor(
                list(idx), dtype=torch.long, device=a.device))
            items[k] = builtins.slice(None)
        dim += _consumes(it, a.dim())
    return a, tuple(items)


@op("getitem")
def _getitem(a, item):
    a, idx = _norm_index(a, item)
    return a[idx]


def getitem(x, item):
    return _getitem(x, item)


def setitem(x, item, value):
    """x[item] = value: into the storage where `Tensor._stores` says so
    and the value needs no grad, else a differentiable copy with the
    slice replaced (the reference's buffer swap: earlier ops keep the
    old value)."""
    if not isinstance(x, Tensor):
        a, idx = _norm_index(x, item)
        a[idx] = _raw(value)
        return x
    d = x._data
    v = _raw(value)
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v), dtype=d.dtype, device=d.device)
    v = v.to(d.dtype)
    _, idx = _norm_index(d, item)
    if x._stores() and not (v.requires_grad and torch.is_grad_enabled()):
        with torch.no_grad():
            d[idx] = v
    else:
        new = d.clone()
        new[idx] = v
        x._data = new
    return x


def _tensor_to(x, *args, **kwargs):
    """Tensor.to(device | dtype | tensor, ...)."""
    dtype = kwargs.get("dtype")
    device = kwargs.get("device")
    for a in args:
        if isinstance(a, str):
            if a in dtypes._STR2DTYPE:
                dtype = a
            else:
                device = a
        elif isinstance(a, (torch.dtype, np.dtype, type)):
            dtype = a
        elif isinstance(a, (Place, torch.device)):
            device = a
        elif isinstance(a, Tensor):
            dtype, device = a.dtype, a.place
    out = x
    if dtype is not None:
        out = cast(out, dtype)
    if device is not None:
        d = out._data
        if isinstance(device, CUDAPinnedPlace):
            out = Tensor._wrap(d.cpu().pin_memory())
        else:
            out = Tensor._wrap(d.to(device_of(device)))
    return out


# ------------------------------------------------------------ dunder wiring
def _bool_or(logic, bitwise):
    return lambda s, o: logic(s, o) if s.dtype == dtypes.bool_ \
        else bitwise(s, o)


def _ensure(v, ref):
    """The other operand of an arithmetic operator, as the reference's
    `_ensure` makes it: a Python int beside an integer Tensor is an int64
    array there, so the result is int64 (`int8 + 300` and `int32 + 3`
    alike; the functional ops keep the Tensor's dtype); here the Tensor
    goes to int64 instead, which gives the same dtype and values."""
    if type(v) is int and not ref._data.is_floating_point() and \
            not ref._data.is_complex() and ref._data.dtype not in (
                torch.int64, torch.bool):
        return v, cast(ref, "int64")
    return v, ref


def _arith(fn, swap=False):
    def method(s, o):
        o, s = _ensure(o, s)
        return fn(o, s) if swap else fn(s, o)

    return method


_METHODS = {
    "__add__": _arith(add),
    "__radd__": _arith(add, True),
    "__sub__": _arith(subtract),
    "__rsub__": _arith(subtract, True),
    "__mul__": _arith(multiply),
    "__rmul__": _arith(multiply, True),
    "__truediv__": _arith(divide),
    "__rtruediv__": _arith(divide, True),
    "__floordiv__": _arith(floor_divide),
    "__rfloordiv__": _arith(floor_divide, True),
    "__mod__": _arith(mod),
    "__rmod__": _arith(mod, True),
    "__pow__": _arith(pow),
    "__rpow__": _arith(pow, True),
    "__matmul__": lambda s, o: matmul(s, o),
    "__rmatmul__": lambda s, o: matmul(o, s),
    "__neg__": lambda s: neg(s),
    "__abs__": lambda s: _math.abs(s),
    "__invert__": lambda s: logical_not(s) if s.dtype == dtypes.bool_
    else bitwise_not(s),
    "__eq__": lambda s, o: equal(s, o),
    "__ne__": lambda s, o: not_equal(s, o),
    "__lt__": lambda s, o: less_than(s, o),
    "__le__": lambda s, o: less_equal(s, o),
    "__gt__": lambda s, o: greater_than(s, o),
    "__ge__": lambda s, o: greater_equal(s, o),
    "__and__": _bool_or(logical_and, bitwise_and),
    "__or__": _bool_or(logical_or, bitwise_or),
    "__xor__": _bool_or(logical_xor, bitwise_xor),
    "__getitem__": getitem,
    "__setitem__": setitem,
}

for _n, _f in _METHODS.items():
    setattr(Tensor, _n, _f)

# the functional ops as Tensor methods (paddle exposes ~all of these)
_SKIP = {"zeros", "ones", "full", "empty", "arange", "linspace", "logspace",
         "eye", "meshgrid", "to_tensor", "rand", "randn", "randint",
         "randperm", "tril_indices", "triu_indices", "create_parameter",
         "scatter_nd", "uniform", "gaussian", "standard_normal",
         "log_normal", "normal"}

for _mod in _SOURCES:
    for _n in _mod.__all__:
        if _n in _SKIP or hasattr(Tensor, _n):
            continue
        setattr(Tensor, _n, getattr(_mod, _n))

# ------------------------------------------------- bulk in-place (`op_`) sweep
_INPLACE_BASES = (
    "abs acos acosh addmm asin asinh atan atanh bitwise_and bitwise_invert "
    "bitwise_left_shift bitwise_not bitwise_or bitwise_right_shift "
    "bitwise_xor copysign cos cosh cumprod cumsum digamma equal erfinv "
    "floor_divide floor_mod frac gammainc gammaincc gammaln gcd "
    "greater_equal greater_than hypot i0 index_fill index_put lcm ldexp "
    "lerp less less_equal less_than lgamma log log10 log1p log2 logical_and "
    "logical_not logical_or logical_xor logit masked_fill masked_scatter "
    "mod multigammaln multiply nan_to_num neg not_equal pow polygamma "
    "put_along_axis relu remainder renorm rsqrt scatter_nd_add sin sinc "
    "sinh subtract tan tanh trunc index_add log_normal square t erf expm1 "
    "tril triu"
).split()

_INPLACE = []
for _bn in _INPLACE_BASES:
    _ipname = _bn + "_"
    _base = globals().get(_bn)
    if _base is None or _ipname in globals():
        continue
    globals()[_ipname] = _inplace_variant(_base)
    _INPLACE.append(_ipname)
    if not hasattr(Tensor, _ipname):
        setattr(Tensor, _ipname, globals()[_ipname])


def _fill_random(name, draw):
    """An in-place distribution fill (cauchy_ / geometric_): x's contents
    replaced by samples, shape and dtype kept."""

    def op_(x, *args, **kwargs):
        return _random._fill(x, lambda dev, d: draw(dev, d, *args, **kwargs))

    op_.__name__ = op_.__qualname__ = name
    setattr(Tensor, name, op_)
    return op_


def _uniform_open(dev, d):
    return torch.empty(d.shape, device=dev, dtype=torch.float32).uniform_(
        1e-6, 1 - 1e-6, generator=_random._gen(dev))


cauchy_ = _fill_random("cauchy_", lambda dev, d, loc=0, scale=1, **kw:
                       loc + scale * torch.tan(
                           np.pi * (_uniform_open(dev, d) - 0.5)))
geometric_ = _fill_random("geometric_", lambda dev, d, probs=0.5, **kw:
                          torch.ceil(torch.log(_uniform_open(dev, d))
                                     / torch.log1p(-torch.as_tensor(
                                         _raw(probs), device=dev))))


def _where_x_first(x, condition, y, name=None):
    return where(condition, x, y)


def where_(condition, x, y, name=None):
    """In place on x (not on the condition)."""
    return _inplace_variant(_where_x_first)(x, condition, y)


Tensor.where_ = where_


def set_(x, source):
    """Adopt source's value and shape (set_value broadcasts into x's)."""
    v = _raw(source)
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v), device=x._data.device)
    x._data = v.detach().clone()
    return x


def resize_(x, shape):
    """x resized to `shape`: its flattened values, repeated or cut (numpy
    resize)."""
    d = x._data.detach().reshape(-1)
    n = int(np.prod(shape))
    reps = -(-n // builtins.max(d.numel(), 1))
    x._data = d.repeat(reps)[:n].reshape(tuple(shape))
    return x


Tensor.set_ = set_
Tensor.resize_ = resize_
Tensor.mean_all = lambda self: mean(self)


@op("add_n")
def _add_n(arrs):
    out = arrs[0]
    for a in arrs[1:]:
        out = out + a
    return out


def add_n(inputs, name=None):
    if isinstance(inputs, (Tensor, torch.Tensor)):
        return inputs
    return _add_n(list(inputs))


Tensor.add_n = staticmethod(add_n)


def numel(x, name=None):
    d = _raw(x)
    return Tensor._wrap(torch.tensor(d.numel(), dtype=torch.int64,
                                     device=d.device))


def shape(x):
    d = _raw(x)
    return Tensor._wrap(torch.tensor(list(d.shape), dtype=torch.int32,
                                     device=d.device))


def rank(x):
    d = _raw(x)
    return Tensor._wrap(torch.tensor(d.dim(), dtype=torch.int32,
                                     device=d.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def is_floating_point(x):
    return dtypes.is_floating_point(x.dtype if hasattr(x, "dtype") else x)


def is_complex(x):
    return dtypes.is_complex(x.dtype if hasattr(x, "dtype") else x)


def is_integer(x):
    return dtypes.is_integer(x.dtype if hasattr(x, "dtype") else x)


def iinfo(dtype):
    return dtypes.iinfo(dtype)


def finfo(dtype):
    return dtypes.finfo(dtype)


Tensor.numel_t = numel
Tensor.cauchy_ = cauchy_
Tensor.geometric_ = geometric_

__all__ = sorted(
    {n for m in _SOURCES for n in m.__all__}
    | set(_INPLACE)
    | {"getitem", "setitem", "cauchy_", "geometric_", "where_", "set_",
       "resize_", "add_n", "numel", "shape", "rank", "is_tensor",
       "is_floating_point", "is_complex", "is_integer", "iinfo", "finfo"})
