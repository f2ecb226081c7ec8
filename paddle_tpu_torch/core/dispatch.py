"""Grad mode and the op boundary.

Port of paddle_tpu/core/dispatch.py's grad mode (`no_grad`,
`enable_grad`, `set_grad_enabled`, `grad_enabled`; :77-113) on torch's
grad mode, so `paddle_tpu_torch.no_grad()` and `torch.no_grad()` are one
switch, and of its op funnel (`op_call`, :503) as one decorator, `op`.

`op(name, n_diff=None)` makes a torch function a Paddle op: its
`Tensor` arguments (positional and keyword, and inside lists and tuples)
are unwrapped to their torch tensors and its DType arguments become torch
dtypes, the body runs through
`amp.amp_op` under the reference's op name (cast by the AMP rule when
`auto_cast` is on, counted by `amp.debugging`), and torch tensors in its
result are wrapped as `Tensor`s. Given torch tensors it returns torch
tensors, so the port's torch code can call the same ops; given neither
(the creation ops) it returns Tensors. `n_diff=0` marks an op the
reference does not differentiate (comparisons, searches, samplers, ...):
its body runs under `no_grad`, so its outputs carry no history.

The reference's jit cache of eager ops (`_cached_dispatch`,
`eager_cache_info`, `eager_cache_clear`), lazy mode (`core/lazy.py`) and
lock-order checking (`core/lockdep.py`) are XLA machinery with no
counterpart on eager torch: their public entries raise
NotImplementedError naming ROADMAP.md Queue 1 item 1d's exclusions.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from ..amp import amp_op
from .dtype import DType
from .tensor import Tensor


# ---------------------------------------------------------------- grad mode
def grad_enabled() -> bool:
    return torch.is_grad_enabled()


@contextlib.contextmanager
def set_grad_enabled(mode: bool):
    with torch.set_grad_enabled(bool(mode)):
        yield


class no_grad(contextlib.ContextDecorator):
    """paddle.no_grad: a context manager and a decorator."""

    def __enter__(self):
        self._old = torch.is_grad_enabled()
        torch.set_grad_enabled(False)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._old)
        return False


class enable_grad(contextlib.ContextDecorator):
    def __enter__(self):
        self._old = torch.is_grad_enabled()
        torch.set_grad_enabled(True)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._old)
        return False


_NOT_PORTED = ("is XLA machinery the port does not carry (ROADMAP.md "
               "Queue 1 item 1d, 'left out')")


def eager_cache_info() -> dict:
    raise NotImplementedError(f"eager_cache_info: the eager jit cache "
                              f"{_NOT_PORTED}")


def eager_cache_clear():
    raise NotImplementedError(f"eager_cache_clear: the eager jit cache "
                              f"{_NOT_PORTED}")


def lazy_mode(*args, **kwargs):
    raise NotImplementedError(f"lazy_mode: lazy evaluation {_NOT_PORTED}")


# ------------------------------------------------------------- the boundary
def wrap(x):
    """x with every torch tensor (also in lists and tuples) wrapped."""
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    if isinstance(x, (list, tuple)):
        return type(x)(wrap(v) for v in x)
    return x


def _scan(seq):
    """(unwrapped seq, saw a Tensor, saw a torch tensor). A DType becomes
    its torch dtype."""
    saw_t = saw_raw = False
    out = []
    for a in seq:
        if isinstance(a, Tensor):
            saw_t = True
            a = a._data
        elif isinstance(a, torch.Tensor):
            saw_raw = True
        elif isinstance(a, DType):
            a = a.torch
        elif isinstance(a, (list, tuple)) and a:
            inner, t, r = _scan(a)
            if t:
                saw_t = True
                a = type(a)(inner)
            saw_raw = saw_raw or r
        out.append(a)
    return out, saw_t, saw_raw


#: Integer promotion at the boundary (F10). The reference computes as jnp
#: does under x64: an op that needs a floating input takes an integer
#: (or bool) one as float64 when it is 64-bit and float32 otherwise
#: (`_INEXACT`); an op that scales its input by a Python float takes it
#: as float64 at every width (`_FLOAT64`, jnp's weak float beside an
#: integer). Here the op's first tensor operand, when it is integer or
#: bool, is cast so before the body runs; the ops that already promote
#: in their bodies (`mean`, `divide`, `cumsum`, `clip`) are not listed.
_INEXACT = frozenset((
    "acos acosh asin asinh atan atanh cos cosh sin sinh tan tanh exp expm1 "
    "log log10 log1p log2 sqrt reciprocal deg2rad rad2deg logit gammaln "
    "i0 i0e i1 i1e sinc multigammaln polygamma logsumexp median nanmedian "
    "quantile nanquantile cov corrcoef trapezoid std var nanmean qr pinv "
    "svd lu cond matrix_rank frexp histogram_bin_edges det slogdet inverse "
    "eigvalsh eigh eig eigvals cholesky gelu log_sigmoid log_softmax "
    "softmax mish selu softsign tanhshrink adaptive_avg_pool1d "
    "adaptive_avg_pool2d adaptive_avg_pool3d group_norm instance_norm"
    ).split())
_FLOAT64 = frozenset((
    "angle cumulative_trapezoid norm renorm scale stanh celu elu hardshrink "
    "hardsigmoid hardswish hardtanh leaky_relu relu6 softshrink "
    "thresholded_relu normalize label_smooth max_pool1d_with_index "
    "max_pool2d_with_index max_pool3d_with_index").split())


def _promote_int(opname, args, kwargs):
    """args with the first tensor operand cast by the integer rule of
    op `opname` (note above)."""
    if opname == "norm" and kwargs.get("p") in (float("inf"),
                                                 float("-inf")):
        return args
    for i, a in enumerate(args):
        if isinstance(a, torch.Tensor):
            if not (a.is_floating_point() or a.is_complex()):
                wide = opname in _FLOAT64 or a.dtype == torch.int64
                args[i] = a.to(torch.float64 if wide else torch.float32)
            return args
    return args


def _funnel(fn, opname=None, nograd=False):
    """fn behind the boundary: its Tensor arguments unwrapped, and its
    torch results wrapped where it was given a Tensor, or no torch tensor
    at all when `opname` is set (the creation ops). With `opname` the
    body runs through `amp_op` under that name; `nograd` runs it under
    `no_grad`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args, saw_t, saw_raw = _scan(args)
        if kwargs:
            vals, kt, kr = _scan(kwargs.values())
            kwargs = dict(zip(kwargs, vals))
            saw_t, saw_raw = saw_t or kt, saw_raw or kr
        if opname is None:
            out = fn(*args, **kwargs)
            return wrap(out) if saw_t else out
        if opname in _INEXACT or opname in _FLOAT64:
            args = _promote_int(opname, args, kwargs)
        if nograd:
            with torch.no_grad():
                out = amp_op(opname, fn, *args, **kwargs)
        else:
            out = amp_op(opname, fn, *args, **kwargs)
        return wrap(out) if saw_t or not saw_raw else out

    return wrapper


def boundary(fn):
    """The op boundary without the AMP step, for the port's torch-level
    entry points that run their own `amp_op` (`nn.functional`, the
    models' `forward`): Tensors in, Tensors out; torch in, torch out."""
    return _funnel(fn)


def op(name=None, n_diff=None):
    """Decorator: the torch function becomes the Paddle op `name` (module
    note)."""

    def deco(fn):
        return _funnel(fn, name or fn.__name__, n_diff == 0)

    return deco
