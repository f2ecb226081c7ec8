"""paddle_tpu_torch.autograd: `backward`, `PyLayer`, `jacobian`,
`hessian`, `saved_tensors_hooks`.

Port of paddle_tpu/autograd/__init__.py (:20-175) on torch autograd.
`PyLayer` is a `torch.autograd.Function` made per subclass: the user's
`forward(ctx, *args)` and `backward(ctx, *grads)` see `Tensor`s and
return them, and the context offers Paddle's `save_for_backward`,
`saved_tensor()`, `mark_non_differentiable` and
`set_materialize_grads`. `backward` returns one gradient per Tensor
argument of `forward` (or one per argument that requires grad, as the
reference maps them).
"""
from __future__ import annotations

import torch

from ..core.dispatch import (enable_grad, no_grad,  # noqa: F401
                             set_grad_enabled)
from ..core.engine import grad, run_backward  # noqa: F401
from ..core.tensor import Tensor, _raw

__all__ = ["backward", "grad", "PyLayer", "PyLayerContext", "jacobian",
           "hessian", "saved_tensors_hooks", "no_grad", "enable_grad",
           "set_grad_enabled"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    tensors = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    for t, g in zip(tensors, grad_tensors):
        run_backward(t, g, retain_graph)


def _wrapped(x):
    return Tensor._wrap(x) if isinstance(x, torch.Tensor) else x


class PyLayerContext:
    """What `PyLayer.forward` and `backward` share (over torch's
    FunctionCtx)."""

    def __init__(self, tctx):
        self._tctx = tctx
        self._other = ()

    def save_for_backward(self, *tensors):
        raw = [_raw(t) for t in tensors]
        if all(t is None or isinstance(t, torch.Tensor) for t in raw):
            self._tctx.save_for_backward(*raw)
        else:
            self._other = tensors

    def saved_tensor(self):
        if self._other:
            return tuple(self._other)
        return tuple(_wrapped(t) for t in self._tctx.saved_tensors)

    saved_tensors = saved_tensor

    def mark_non_differentiable(self, *tensors):
        self._tctx.mark_non_differentiable(*[_raw(t) for t in tensors])

    def set_materialize_grads(self, value):
        self._tctx.set_materialize_grads(bool(value))


def _function_of(cls):
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(tctx, kwargs, *args):
            ctx = PyLayerContext(tctx)
            tctx.pyctx = ctx
            tctx.n_args = len(args)
            tctx.tensor_pos = [i for i, a in enumerate(args)
                               if isinstance(a, torch.Tensor)]
            tctx.diff_pos = [i for i in tctx.tensor_pos
                             if args[i].requires_grad]
            outs = cls.forward(ctx, *[_wrapped(a) for a in args], **kwargs)
            tctx.single = not isinstance(outs, (tuple, list))
            raw = [_raw(o) for o in ([outs] if tctx.single else outs)]
            return raw[0] if tctx.single else tuple(raw)

        @staticmethod
        def backward(tctx, *grads):
            gin = cls.backward(tctx.pyctx, *[_wrapped(g) for g in grads])
            gin = [gin] if gin is None or isinstance(
                gin, (Tensor, torch.Tensor)) else list(gin)
            pos = tctx.tensor_pos if len(gin) == len(tctx.tensor_pos) \
                else tctx.diff_pos
            out = [None] * (tctx.n_args + 1)
            for p, g in zip(pos, gin):
                out[p + 1] = _raw(g)
            return tuple(out)

    _Fn.__name__ = _Fn.__qualname__ = cls.__name__
    cls._torch_function = _Fn
    return _Fn


class PyLayer:
    """Custom autograd function: subclass with @staticmethod
    forward(ctx, *args) and backward(ctx, *grads)."""

    @classmethod
    def apply(cls, *args, **kwargs):
        out = _function_of(cls).apply(kwargs, *[_raw(a) for a in args])
        if isinstance(out, torch.Tensor):
            return Tensor._wrap(out)
        return type(out)(_wrapped(o) for o in out)

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError


def _raw_fn(func, seq):
    """func over Tensors as a function over torch tensors."""

    def f(*a):
        ts = [Tensor._wrap(ai) for ai in a]
        out = func(*ts) if seq else func(ts[0])
        return _raw(out)

    return f


def _batched(fn, arrs, batch_axis):
    if batch_axis is None:
        return fn(*arrs)
    outs = [fn(*[a[i] for a in arrs]) for i in range(arrs[0].shape[0])]

    def stack(items):
        if isinstance(items[0], torch.Tensor):
            return torch.stack(items)
        return type(items[0])(stack([it[j] for it in items])
                              for j in range(len(items[0])))

    return stack(outs)


def _tree_wrap(x):
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    return tuple(_tree_wrap(v) for v in x)


def jacobian(func, xs, batch_axis=None):
    """d func(xs) / d xs, dense; batch_axis=0 gives one jacobian per
    sample of the leading axis ([B, *out, *in] without the batch axis),
    as the reference's vmap."""
    if batch_axis not in (None, 0):
        raise ValueError("jacobian: batch_axis must be None or 0")
    seq = isinstance(xs, (list, tuple))
    arrs = [_raw(x).detach() for x in (xs if seq else [xs])]
    f = _raw_fn(func, seq)

    def jac(*a):
        j = torch.autograd.functional.jacobian(f, tuple(a))
        return tuple(j) if isinstance(j, (list, tuple)) else (j,)

    out = _tree_wrap(_batched(jac, arrs, batch_axis))
    return out[0] if not seq and len(out) == 1 else out


def hessian(func, xs, batch_axis=None):
    """d^2 func(xs) / d xs^2 of a scalar func; batch_axis=0: per sample."""
    if batch_axis not in (None, 0):
        raise ValueError("hessian: batch_axis must be None or 0")
    seq = isinstance(xs, (list, tuple))
    arrs = [_raw(x).detach() for x in (xs if seq else [xs])]
    f = _raw_fn(func, seq)

    def hes(*a):
        h = torch.autograd.functional.hessian(f, tuple(a))
        return tuple(tuple(r) for r in h)

    out = _tree_wrap(_batched(hes, arrs, batch_axis))
    if not seq:
        out = out[0][0]
    return out


class saved_tensors_hooks:
    """pack_hook(Tensor) -> anything, unpack_hook(that) -> Tensor, run on
    every tensor autograd saves for backward inside the block (activation
    offloading, compression)."""

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook
        self._ctx = None

    def __enter__(self):
        self._ctx = torch.autograd.graph.saved_tensors_hooks(
            lambda t: self.pack_hook(Tensor._wrap(t)),
            lambda p: _raw(self.unpack_hook(p)))
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)
