"""The Paddle Tensor: a wrapper over one torch tensor.

Port of paddle_tpu/core/tensor.py. The reference's Tensor holds a
`jax.Array` in `_data` and records its own tape; the port's holds a
`torch.Tensor` in `_data` and its tape is torch autograd on it. It is a
plain class, not a `torch.Tensor` subclass: Paddle gives many of torch's
names other meanings (`size` is the element count, `shape` a list, `dim`
a property, `transpose(perm)`, `split(num_or_sections)`, `gather` with
`index_select`'s meaning, `sort` the values only, `max(axis)` a tensor,
...), and torch's own Python code (`torch.nn.functional`,
`torch.utils.checkpoint`, the port's models and kernels) calls those
names on its arguments. Code below the Tensor API sees `_data` only: the
op boundary (`core.dispatch.op`) unwraps arguments and wraps results.

`stop_gradient` is `not _data.requires_grad` in both directions (a
non-floating tensor keeps the flag on the wrapper, as torch cannot mark
it). `grad` reads `_data.grad`. Parameters default to
`stop_gradient=False`.

Writes. The reference's in-place ops swap the buffer (`_assign_raw`):
earlier ops that saved the old value keep it. While grad is enabled the
port follows it by rebinding `_data` (a constant that some op saved, as
x in `z = x * w`, keeps its old value for z's backward, and torch's
version counter sees no write). It writes into the storage instead
(`_stores`) under `no_grad` and inside a `jit.to_static` call, which is
what a captured CUDA graph can replay, and into a leaf that requires
grad, whose `_data` is the torch leaf an optimizer keys its state by.

The operator and op methods are attached by `paddle_tpu_torch.ops` at
import, as the reference's are.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtypes
from .device import Place, device_of


class Tensor:
    __slots__ = ("_data", "_sg", "_gc", "_nm", "__weakref__", "__dict__")

    _iid = 0
    persistable = False

    def __init__(self, data, dtype=None, place=None, stop_gradient=True,
                 _internal=False):
        self._data = data if _internal else _to_torch(data, dtype, place)
        self._sg = True
        self._gc = None
        self._nm = None
        if not stop_gradient:
            self.stop_gradient = False

    @staticmethod
    def _wrap(t: torch.Tensor) -> "Tensor":
        """A Tensor over torch tensor `t` (no copy)."""
        o = object.__new__(Tensor)
        o._data = t
        o._sg = True
        o._gc = None
        o._nm = None
        return o

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    dim = ndim

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self):
        """The Paddle dtype (`core.dtype.DType`): prints as "float32" and
        equals the name, the numpy dtype and the torch dtype."""
        return dtypes.of(self._data.dtype)

    @property
    def place(self):
        return Place(self._data.device)

    @property
    def name(self):
        if self._nm is None:
            Tensor._iid += 1
            self._nm = f"tensor_{Tensor._iid}"
        return self._nm

    @name.setter
    def name(self, v):
        self._nm = v

    @property
    def stop_gradient(self):
        d = self._data
        if d.requires_grad:
            return False
        return True if d.is_floating_point() or d.is_complex() else self._sg

    @stop_gradient.setter
    def stop_gradient(self, v):
        d = self._data
        if v:
            if d.requires_grad:
                if d.grad_fn is None:
                    d.requires_grad_(False)
                else:
                    self._data = d.detach()
            self._sg = True
            return
        self._sg = False
        if not d.requires_grad and (d.is_floating_point() or d.is_complex()):
            if d.grad_fn is None:
                d.requires_grad_(True)

    @property
    def grad(self):
        d = self._data
        if d.grad_fn is not None and not d.retains_grad:
            return None
        g = d.grad
        if g is None:
            self._gc = None
            return None
        gc = self._gc
        if gc is None or gc._data is not g:
            gc = self._gc = Tensor._wrap(g)
        return gc

    @grad.setter
    def grad(self, value):
        self._data.grad = None if value is None else _raw(value)
        self._gc = None

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    @property
    def _node(self):
        """The autograd node that produced this value (None for a leaf):
        the reference's GradNode link, here torch's `grad_fn`."""
        return self._data.grad_fn

    def retain_grads(self):
        if self._data.grad_fn is not None:
            self._data.retain_grad()

    def register_hook(self, hook):
        """hook(grad Tensor) -> Tensor or None, run on each gradient that
        reaches this tensor; returns a handle with `remove()`."""

        def fn(g):
            out = hook(Tensor._wrap(g))
            return None if out is None else _raw(out)

        return self._data.register_hook(fn)

    # ------------------------------------------------------------ conversion
    def numpy(self):
        """The value as a numpy array (bfloat16 and float8 values as
        float32: numpy has no such dtypes without ml_dtypes; a lazily
        conjugated or negated view, as `torch.fft.ihfft` returns,
        materialized)."""
        d = self._data.detach().resolve_conj().resolve_neg()
        if d.dtype not in dtypes._TO_NUMPY:
            d = d.float()
        return d.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._data.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def detach(self) -> "Tensor":
        return Tensor._wrap(self._data.detach())

    def clone(self) -> "Tensor":
        return Tensor._wrap(self._data.clone())

    def numel(self):
        return self.size

    def element_size(self):
        return self._data.element_size()

    # ------------------------------------------------------------ autograd
    def backward(self, grad_tensor=None, retain_graph=False):
        from .engine import run_backward

        run_backward(self, grad_tensor, retain_graph)

    def clear_grad(self):
        self._data.grad = None
        self._gc = None

    def clear_gradient(self, set_to_zero=False):
        g = self._data.grad
        if set_to_zero and g is not None:
            g.zero_()          # in place: a captured step replays it
        else:
            self.clear_grad()

    # ------------------------------------------------------------ writes
    def _stores(self) -> bool:
        """Whether a write goes into the storage (module note): grad
        disabled, a `to_static` call running, or a leaf that requires
        grad; else it rebinds `_data`."""
        from ..jit.api import compiled_call_active

        d = self._data
        return (not torch.is_grad_enabled() or compiled_call_active()
                or (d.requires_grad and d.grad_fn is None))

    def _write(self, value: torch.Tensor) -> "Tensor":
        """Make `value` this tensor's contents: into the storage where
        `_stores` says so and it has this shape and dtype, else by
        rebinding `_data`."""
        d = self._data
        if value.shape == d.shape and value.dtype == d.dtype and (
                not value.requires_grad or not torch.is_grad_enabled()) \
                and self._stores():
            if value is not d:
                if value.untyped_storage().data_ptr() == \
                        d.untyped_storage().data_ptr():
                    value = value.clone()        # a view of d (t_, ...)
                with torch.no_grad():
                    d.copy_(value)
        else:
            self._data = value
        return self

    def set_value(self, value):
        d = self._data
        v = _raw(value) if isinstance(value, Tensor) else value
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        v = v.detach().to(device=d.device, dtype=d.dtype)
        if tuple(v.shape) != tuple(d.shape):
            v = v.broadcast_to(d.shape)
        if self._stores():
            with torch.no_grad():
                d.copy_(v)
        else:
            self._data = v.clone()
        return self

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    def zero_(self):
        return self.fill_(0)

    def fill_(self, value):
        d = self._data
        if self._stores():
            with torch.no_grad():
                d.fill_(_raw(value))
        else:
            self._data = torch.full_like(d.detach(), _raw(value))
        return self

    # ------------------------------------------------------------ misc parity
    def to(self, *args, **kwargs):
        from ..ops import _tensor_to

        return _tensor_to(self, *args, **kwargs)

    def cuda(self, device_id=None, blocking=True):
        return self.to(f"gpu:{device_id or 0}")

    def cpu(self):
        return self.to("cpu")

    def pin_memory(self):
        return Tensor._wrap(self._data.pin_memory())

    def contiguous(self):
        d = self._data
        return self if d.is_contiguous() else Tensor._wrap(d.contiguous())

    def is_contiguous(self):
        return self._data.is_contiguous()

    @property
    def T(self):
        from ..ops import transpose

        return transpose(self, list(range(self.ndim))[::-1])

    @property
    def mT(self):
        from ..ops import transpose

        perm = list(range(self.ndim))
        perm[-2], perm[-1] = perm[-1], perm[-2]
        return transpose(self, perm)

    def astype(self, dtype):
        from ..ops import cast

        return cast(self, dtype)

    def __len__(self):
        if self._data.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        return bool(self._data.detach())

    def __int__(self):
        return int(self._data.detach())

    def __float__(self):
        return float(self._data.detach())

    def __index__(self):
        return int(self._data.detach())

    def __hash__(self):
        return id(self)

    def __repr__(self):
        prefix = "Parameter" if isinstance(self, Parameter) else "Tensor"
        return (f"{prefix}(shape={self.shape}, "
                f"dtype={dtypes.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n{self.numpy()})")

    def __getstate__(self):
        return {"data": self.numpy(), "dtype": dtypes.dtype_name(self.dtype),
                "stop_gradient": self.stop_gradient, "name": self.name,
                "persistable": self.persistable}

    def __setstate__(self, state):
        Tensor.__init__(self, state["data"], dtype=state["dtype"],
                        stop_gradient=state["stop_gradient"])
        self.name = state["name"]
        self.persistable = state["persistable"]


class Parameter(Tensor):
    """A trainable tensor (the reference's EagerParamBase):
    stop_gradient=False and persistable."""

    def __init__(self, data, dtype=None, trainable=True, place=None,
                 _internal=False):
        super().__init__(data, dtype=dtype, place=place,
                         stop_gradient=not trainable, _internal=_internal)
        self.persistable = True

    @property
    def trainable(self):
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, v):
        self.stop_gradient = not v


def _raw(x):
    return x._data if isinstance(x, Tensor) else x


def _numpy_of(data):
    if isinstance(data, (list, tuple)) and any(
            isinstance(v, (Tensor, torch.Tensor)) for v in data):
        return np.stack([_numpy_of(v) for v in data])
    if isinstance(data, Tensor):
        return data.numpy()
    if isinstance(data, torch.Tensor):
        return Tensor._wrap(data).numpy()
    return np.asarray(data)


def _to_torch(data, dtype=None, place=None) -> torch.Tensor:
    """`data` (a Tensor, torch tensor, numpy array, Python number or
    nested list) copied into a torch tensor on `place` (the current device
    when None). Without a dtype, float64 data takes the default dtype
    (float32), integers int64, as the reference's `_to_jax`."""
    dt = dtypes.convert_dtype(dtype)
    dev = device_of(place)
    if isinstance(data, (Tensor, torch.Tensor)):
        t = _raw(data).detach()
        return t.to(device=dev, dtype=dt or t.dtype, copy=True)
    arr = _numpy_of(data)
    if arr.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        t = torch.from_numpy(arr.astype(np.float32)).to(
            dtypes.convert_dtype(arr.dtype.name))
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
        if dt is None and arr.dtype == np.float64:
            dt = dtypes.get_default_dtype()
    return t.to(device=dev, dtype=dt or t.dtype)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """paddle.to_tensor: a copy of `data` on `place` (the current device,
    the card unless `set_device` chose another)."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)
