"""nn.Layer: the base class of the Paddle layers.

Port of paddle_tpu/nn/layer_base.py. A Layer keeps registries of
parameters (the Tensor API's `Parameter`s), buffers (Tensors) and
sublayers, filled by attribute assignment as the reference's
(`__setattr__`); `state_dict` has the reference's structured keys, and
`set_state_dict` writes values into the live parameters in place (their
torch leaves stay the ones an optimizer holds). Forward pre / post
hooks, `train` / `eval`, `apply`, `clear_gradients` and the dtype moves
(`to(dtype=)`, `astype`, `float`, `bfloat16`, `half`) are the
reference's.

Devices: a parameter is made on the current device of the Tensor API
(`set_device`; the card unless the caller chose the CPU), so with no card
and no `set_device("cpu")` making a layer raises RuntimeError.
`to(device)` moves every parameter and buffer there (the card raises
without one). A parameter keeps its torch leaf through every move (its
`.data` moves), so an optimizer built before a dtype move
(`amp.decorate`) still updates it; build the optimizer after a device
move, as its step scalars live on the parameters' device.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterator

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import _parse, current_device
from ..core.tensor import Parameter, Tensor
from ..ops._cuda_common import resolve_device


class HookRemoveHelper:
    _next_id = 0

    def __init__(self, hooks: dict):
        self._hooks = hooks
        self._id = HookRemoveHelper._next_id
        HookRemoveHelper._next_id += 1

    def remove(self):
        self._hooks.pop(self._id, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = dtypes.convert_dtype(dtype)
        self._parameters: dict[str, Parameter] = collections.OrderedDict()
        self._buffers: dict[str, Tensor] = collections.OrderedDict()
        self._sub_layers: dict[str, Layer] = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks: dict[int, Callable] = \
            collections.OrderedDict()
        self._forward_post_hooks: dict[int, Callable] = \
            collections.OrderedDict()
        self._casted_by_pure_fp16 = False
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # ------------------------------------------------------------ registration
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning "
                                   "parameters")
            params[name] = value
            for d in (layers, buffers):
                if d is not None:
                    d.pop(name, None)
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ before assigning "
                                   "sublayers")
            layers[name] = value
            for d in (params, buffers):
                if d is not None:
                    d.pop(name, None)
            self.__dict__.pop(name, None)
        elif buffers is not None and name in buffers:
            if value is None:
                buffers.pop(name)
            elif isinstance(value, Tensor):
                buffers[name] = value
            else:
                object.__setattr__(self, name, value)
        else:
            if params is not None and name in params and value is None:
                params.pop(name)
                return
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(f"'{type(self).__name__}' object has no "
                             f"attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def add_parameter(self, name, parameter):
        setattr(self, name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A Parameter of `shape` on the current device, filled by the
        initializer: `attr.initializer`, else `default_initializer`, else
        zeros for a bias and XavierNormal otherwise (the reference's
        rule)."""
        from .initializer import Constant, XavierNormal

        dt = dtypes.convert_dtype(dtype) if dtype else self._dtype
        init = default_initializer
        if attr is not None and getattr(attr, "initializer", None) is not None:
            init = attr.initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierNormal()
        p = Parameter(torch.zeros(tuple(int(s) for s in shape), dtype=dt,
                                  device=current_device()), _internal=True)
        init(p)
        if attr is not None:
            if getattr(attr, "learning_rate", None) is not None:
                p.optimize_attr = {"learning_rate": attr.learning_rate}
            if getattr(attr, "trainable", True) is False:
                p.stop_gradient = True
            if getattr(attr, "regularizer", None) is not None:
                p.regularizer = attr.regularizer
            if getattr(attr, "name", None):
                p.name = attr.name
        return p

    # ------------------------------------------------------------ iteration
    def named_parameters(self, prefix="", include_sublayers=True) -> Iterator:
        memo = set()
        for _, layer_prefix, layer in self._walk(prefix):
            for pname, p in layer._parameters.items():
                if p is not None and id(p) not in memo:
                    memo.add(id(p))
                    yield (layer_prefix + pname, p)
            if not include_sublayers:
                break

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        memo = set()
        for _, layer_prefix, layer in self._walk(prefix):
            for bname, b in layer._buffers.items():
                if b is not None and id(b) not in memo:
                    memo.add(id(b))
                    yield (layer_prefix + bname, b)
            if not include_sublayers:
                break

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix.rstrip("."), self
        for name, sub in self._sub_layers.items():
            if sub is None:
                continue
            p = f"{prefix}{name}"
            yield p, sub
            yield from sub.named_sublayers(prefix=p + ".")

    def sublayers(self, include_self=False):
        return [layer for _, layer in self.named_sublayers(
            include_self=include_self)]

    def children(self):
        return iter(layer for layer in self._sub_layers.values()
                    if layer is not None)

    def named_children(self):
        return iter((n, layer) for n, layer in self._sub_layers.items()
                    if layer is not None)

    def _walk(self, prefix=""):
        yield ("", prefix, self)
        for name, sub in self._sub_layers.items():
            if sub is None:
                continue
            yield from sub._walk(prefix=f"{prefix}{name}.")

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # ------------------------------------------------------------ modes
    def train(self):
        for layer in self.sublayers(include_self=True):
            layer.training = True
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            layer.training = False
        return self

    # ------------------------------------------------------------ state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None \
            else collections.OrderedDict()
        if include_sublayers:
            for name, p in self.named_parameters(
                    prefix=structured_name_prefix):
                dest[name] = p
            for _, lp, layer in self._walk(prefix=structured_name_prefix):
                for bname, b in layer._buffers.items():
                    if b is not None and \
                            bname not in layer._non_persistable_buffer_names:
                        dest[f"{lp}{bname}" if lp else bname] = b
        else:
            for name, p in self._parameters.items():
                if p is not None:
                    dest[f"{structured_name_prefix}{name}"] = p
            for bname, b in self._buffers.items():
                if b is not None and \
                        bname not in self._non_persistable_buffer_names:
                    dest[f"{structured_name_prefix}{bname}"] = b
        if use_hook:
            for hook in getattr(self, "_state_dict_hooks", {}).values():
                out = hook(dest)
                if out is not None:
                    dest = out
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Write each value (a Tensor, torch tensor or numpy array) into
        the live parameter or buffer of its key, in place and in that
        tensor's dtype. Returns (missing keys, unexpected keys)."""
        own = self.state_dict(use_hook=False)
        if not use_structured_name:
            by_name = {getattr(p, "name", None): k for k, p in own.items()}
            state_dict = {by_name.get(k, k): v for k, v in state_dict.items()}
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k in own:
                if not isinstance(v, (Tensor, torch.Tensor)):
                    v = np.asarray(v)
                with torch.no_grad():
                    own[k].set_value(v)
            else:
                unexpected.append(k)
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ------------------------------------------------------------ hooks
    def register_forward_pre_hook(self, hook):
        h = HookRemoveHelper(self._forward_pre_hooks)
        self._forward_pre_hooks[h._id] = hook
        return h

    def register_forward_post_hook(self, hook):
        h = HookRemoveHelper(self._forward_post_hooks)
        self._forward_post_hooks[h._id] = hook
        return h

    # ------------------------------------------------------------ movement
    def to(self, device=None, dtype=None, blocking=None):
        """Move every parameter and buffer to `device` (a name, Place or
        torch device; the card raises RuntimeError without one) and cast
        the floating ones to `dtype`."""
        if device is not None:
            dev = _parse(device).device
            if dev.type == "cuda":
                dev = resolve_device(dev)
            self._apply_to_tensors(lambda t: t.to(dev), floating_only=False)
        if dtype is not None:
            self._to_dtype(dtypes.convert_dtype(dtype))
        return self

    def _apply_to_tensors(self, fn, floating_only=True, buffers=True):
        """t -> fn(t) on every parameter (its torch leaf's `.data`, and
        its gradient) and, with `buffers`, every buffer (rebound), the
        floating ones only unless told otherwise."""
        with torch.no_grad():
            for p in self.parameters():
                d = p._data
                if floating_only and not d.is_floating_point():
                    continue
                d.data = fn(d.data)
                if d.grad is not None:
                    g = fn(d.grad)
                    d.grad = g if g.dtype == d.dtype else None
            for b in self.buffers() if buffers else ():
                if floating_only and not b._data.is_floating_point():
                    continue
                b._data = fn(b._data)

    def _to_dtype(self, dt, only_float=True):
        self._apply_to_tensors(lambda t: t.to(dt), floating_only=only_float)
        for layer in self.sublayers(include_self=True):
            layer._dtype = dt
        return self

    def astype(self, dtype):
        return self._to_dtype(dtypes.convert_dtype(dtype))

    def float(self):
        return self._to_dtype(torch.float32)

    def bfloat16(self):
        return self._to_dtype(torch.bfloat16)

    def half(self):
        return self._to_dtype(torch.float16)

    # ------------------------------------------------------------ call
    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            o = hook(self, inputs, outputs)
            if o is not None:
                outputs = o
        return outputs

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, sub in self._sub_layers.items():
            sub_repr = repr(sub).split("\n")
            sub_repr = [sub_repr[0]] + ["  " + s for s in sub_repr[1:]]
            lines.append(f"  ({name}): " + "\n".join(sub_repr))
        main = f"{type(self).__name__}({extra}"
        if lines:
            return main + "\n" + "\n".join(lines) + "\n)"
        return main + ")"

    def full_name(self):
        return self._name_scope

    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            p.clear_gradient(set_to_zero)
