"""paddle.incubate.autograd: jvp, vjp, grad, Jacobian and Hessian over
functions of Tensors.

Port of paddle_tpu/incubate/autograd.py, whose transforms are jax's
(`jax.jvp`, `jax.vjp`, `jax.jacrev`, `jax.hessian`). Here they are
`torch.autograd.functional`'s over the function lifted to torch tensors
(its arguments wrapped as Tensors, its results unwrapped): the same
values, in the reference's return structure.
"""
from __future__ import annotations

import torch
from torch.autograd import functional as AF

from ..core.dispatch import wrap
from ..core.tensor import Tensor


def _unwrap(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


def _lift(func):
    """A function of Tensors as a function of torch tensors."""

    def pure(*arrs):
        return _unwrap(func(*[Tensor._wrap(a) for a in arrs]))

    return pure


def _prims(xs):
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    return tuple(_unwrap(x).detach() for x in xs)


def _ones(out):
    if isinstance(out, (list, tuple)):
        return type(out)(_ones(o) for o in out)
    return torch.ones_like(out)


def jvp(func, xs, v=None):
    """Forward-mode JVP: (outputs, the tangent of the outputs). xs: a
    Tensor or a sequence; v: the tangents (ones when None)."""
    prim = _prims(xs)
    if v is None:
        tang = tuple(torch.ones_like(p) for p in prim)
    else:
        tang = tuple(_unwrap(t) for t in (v if isinstance(v, (list, tuple))
                                          else [v]))
    out, tan = AF.jvp(_lift(func), prim, tang)
    return wrap(out), wrap(tan)


def vjp(func, xs, v=None):
    """Reverse-mode VJP: (outputs, the cotangent of each input; one
    Tensor for one input). v: the output cotangents (ones when None)."""
    prim = _prims(xs)
    pure = _lift(func)
    if v is None:
        v = _ones(pure(*prim))
    out, grads = AF.vjp(pure, prim, _unwrap(v))
    grads = grads[0] if len(grads) == 1 else list(grads)
    return wrap(out), wrap(grads)


def grad(func, xs, v=None):
    """The gradient of a scalar-output func (vjp's second result)."""
    return vjp(func, xs, v)[1]


def _index(j, idx):
    """j[idx] as Tensors, through nested tuples (one entry per input)."""
    if isinstance(j, tuple):
        return tuple(_index(a, idx) for a in j)
    return Tensor._wrap(j if idx == slice(None) else j[idx])


class Jacobian:
    """The Jacobian of func at xs, computed when first indexed (`J[:]`
    the whole; one array per input when there are several)."""

    def __init__(self, func, xs, is_batched=False):
        self._prim = _prims(xs)
        self._fn = _lift(func)
        self._jac = None
        self._is_batched = is_batched

    def _compute(self):
        return AF.jacobian(self._fn, self._prim)

    def _materialize(self):
        if self._jac is None:
            j = self._compute()
            self._jac = j[0] if len(self._prim) == 1 else j
        return self._jac

    def __getitem__(self, idx):
        return _index(self._materialize(), idx)

    @property
    def shape(self):
        j = self._materialize()
        return tuple((j[0] if isinstance(j, tuple) else j).shape)


class Hessian(Jacobian):
    """The Hessian of a scalar-output func at xs."""

    def _compute(self):
        return AF.hessian(self._fn, self._prim)

    def _materialize(self):
        if self._jac is None:
            h = self._compute()
            while isinstance(h, tuple) and len(self._prim) == 1:
                h = h[0]
            self._jac = h
        return self._jac
