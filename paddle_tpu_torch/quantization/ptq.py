"""Post-training quantization (port of paddle_tpu/quantization/ptq.py).

q_model = PTQ(config).quantize(model) -> run calibration batches ->
PTQ.convert(q_model) freezes int8 weights and scales (`QuantizedLinear`).
`ptq_state_dict` / `load_ptq_state_dict` export and restore weight-only
checkpoints in `weight_quantize`'s layout.
"""
from __future__ import annotations

import copy
import warnings

import torch

from ..core.dispatch import op
from ..core.tensor import Tensor
from ..core.tensor import _raw as raw
from ..nn.layer_base import Layer
from ..ops.quantized import int8_matmul


class _ObservedLayer(Layer):
    """Wraps one layer with activation and weight observers during
    calibration."""

    def __init__(self, inner, act_observer=None, weight_observer=None):
        super().__init__()
        self.inner = inner
        self.act_observer = act_observer() if isinstance(act_observer, type) \
            else act_observer
        self.weight_observer = weight_observer() \
            if isinstance(weight_observer, type) else weight_observer
        if self.weight_observer is not None and hasattr(inner, "weight"):
            self.weight_observer(inner.weight)

    def forward(self, x):
        if self.act_observer is not None:
            x = self.act_observer(x)
        return self.inner(x)


@op("quantized_linear")
def _quantized_linear(x, bias, w8, ws, act_scale, qmax):
    """The two paths of `QuantizedLinear.forward`: full int8 (act_scale
    set: x quantized to int8, an exact int32 product, dequantized by
    act_scale * weight_scale) or weight-only (x @ (w8 * ws)). x and the
    bias take gradients, the weight and its scale none."""
    if act_scale is not None:
        x8 = torch.clamp(torch.round(x / act_scale), -qmax - 1,
                         qmax).to(torch.int8)
        k = x8.shape[-1]
        acc = int8_matmul(x8.reshape(-1, k), w8).reshape(
            *x8.shape[:-1], -1)
        out = acc.to(x.dtype) * (act_scale * ws)
    else:
        w = w8.to(x.dtype) * ws
        out = x.to(w.dtype) @ w
    return out if bias is None else out + bias


class QuantizedLinear(Layer):
    """int8 weight + float scale, with two execution paths:

    - weight-only (act_scale None): the dequantized weight in the GEMM;
    - full int8 (act_scale given): activations quantize to int8 and the
      product runs int8 x int8 -> int32 (`ops.quantized.int8_matmul`:
      `torch._int_mm`, cuBLASLt, on a card), dequantized by
      act_scale * weight_scale.

    weight_scale is a float (per tensor) or a per-output-channel vector
    [out_features]. Codes clip to [-128, 127], as the reference's."""

    def __init__(self, linear, weight_scale, act_scale: float | None = None,
                 bit_length: int = 8):
        super().__init__()
        qmax = float(2 ** (bit_length - 1) - 1)
        w = linear.weight._data
        ws = torch.as_tensor(raw(weight_scale), dtype=torch.float32,
                             device=w.device)
        wq = w.to(torch.promote_types(w.dtype, ws.dtype))
        self.w_int8 = torch.clamp(torch.round(wq / ws), -qmax - 1,
                                  qmax).to(torch.int8)
        self.per_channel = ws.dim() > 0
        self.weight_scale = ws if self.per_channel else float(weight_scale)
        self.act_scale = None if act_scale is None else float(act_scale)
        self.bias = getattr(linear, "bias", None)
        self.bit_length = bit_length

    def forward(self, x):
        qmax = float(2 ** (self.bit_length - 1) - 1)
        return _quantized_linear(x, self.bias, self.w_int8,
                                 self.weight_scale, self.act_scale, qmax)


class PTQ:
    def __init__(self, config):
        self.config = config

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        if not inplace:
            model = copy.deepcopy(model)
        from ..nn import Linear

        for name, child in list(model.named_sublayers()):
            cfg = self.config.config_for(name, child)
            if cfg is None:
                continue
            if not isinstance(child, Linear):
                _warn_unsupported(name, child)
                continue
            wrapped = _ObservedLayer(child, cfg.activation, cfg.weight)
            _replace_child(model, name, wrapped)
        return model

    def convert(self, model: Layer, inplace: bool = False) -> Layer:
        if not inplace:
            model = copy.deepcopy(model)
        for name, child in list(model.named_sublayers()):
            if isinstance(child, _ObservedLayer):
                w_scale = child.weight_observer.scales() \
                    if child.weight_observer else None
                a_scale = child.act_observer.scales() \
                    if child.act_observer else None
                if w_scale is None:
                    _replace_child(model, name, child.inner)
                    continue
                _replace_child(model, name,
                               QuantizedLinear(child.inner, w_scale, a_scale))
        return model


# ------------------------------------------------- weight-only PTQ export

def ptq_state_dict(model: Layer, algo: str = "weight_only_int8",
                   group_size: int = -1, sample_inputs=None) -> dict:
    """Calibrate and quantize every Linear weight: the model's state dict
    with each Linear's ``n.weight`` replaced by ``weight_quantize``'s
    codes (int8 [K, N], or the packed int4 [ceil(K/2), N]) plus
    ``n.weight_scale``, the rule the weight-only serving path applies to
    live weights. So `load_ptq_state_dict` then serving with
    ``weight_quant=<mode>`` re-derives the same integers.

    ``sample_inputs`` (an iterable of model inputs or input tuples) runs
    a calibration pass with a forward-pre-hook on every Linear recording
    the activation absmax; each calibrated layer adds an ``n.act_scale``
    scalar (absmax / 127), the act_scale a full-int8 QuantizedLinear
    wants. Weight-only serving ignores it."""
    from ..incubate.nn.functional import weight_quantize
    from ..nn import Linear

    if algo not in ("weight_only_int8", "weight_only_int4"):
        raise ValueError(f"ptq_state_dict: unknown algo {algo!r}")
    linears = [(n, lay) for n, lay in model.named_sublayers()
               if isinstance(lay, Linear)]

    act_amax: dict = {}
    if sample_inputs is not None:
        hooks = []

        def make_hook(name):
            def hook(layer, inputs):
                a = raw(inputs[0]).detach().abs().max().float()
                prev = act_amax.get(name)
                act_amax[name] = a if prev is None else torch.maximum(prev, a)
            return hook

        for n, lay in linears:
            hooks.append(lay.register_forward_pre_hook(make_hook(n)))
        try:
            with torch.no_grad():
                for batch in sample_inputs:
                    args = batch if isinstance(batch, (tuple, list)) \
                        else (batch,)
                    model(*args)
        finally:
            for h in hooks:
                h.remove()

    state = dict(model.state_dict())
    for n, lay in linears:
        wkey = f"{n}.weight" if n else "weight"
        if wkey not in state:
            continue
        q, scale = weight_quantize(lay.weight, algo=algo,
                                   group_size=group_size)
        state[wkey] = q
        state[f"{n}.weight_scale" if n else "weight_scale"] = scale
        if n in act_amax:
            state[f"{n}.act_scale"] = Tensor._wrap(act_amax[n] / 127.0)
    return state


def load_ptq_state_dict(model: Layer, state: dict) -> Layer:
    """Restore a `ptq_state_dict` artifact into a full-precision model:
    each (weight, weight_scale) pair dequantizes back into the Linear's
    weight dtype (int8 or packed int4 told apart by the layer's logical
    K), act_scale entries are dropped, and the rest goes through
    set_state_dict. In f32 the restored weights are the quantization
    lattice, so quantizing them again at serve time is lossless."""
    from ..incubate.nn.functional import weight_dequantize
    from ..nn import Linear
    from ..ops.quantized import packed_rows

    state = dict(state)
    for n, lay in model.named_sublayers():
        if not isinstance(lay, Linear):
            continue
        wkey = f"{n}.weight" if n else "weight"
        skey = f"{n}.weight_scale" if n else "weight_scale"
        if skey not in state:
            continue
        q = state.pop(wkey)
        scale = state.pop(skey)
        state.pop(f"{n}.act_scale", None)
        k = int(lay.weight.shape[0])
        rows = int(q.shape[-2]) if q.ndim >= 2 else int(q.shape[0])
        algo = "weight_only_int4" \
            if rows != k and rows == packed_rows(k) else "weight_only_int8"
        dev = lay.weight._data.device
        state[wkey] = weight_dequantize(
            _on(q, dev), _on(scale, dev), algo=algo, k=k,
            out_dtype=str(lay.weight.dtype))
    state = {k: v for k, v in state.items() if not k.endswith(".act_scale")}
    model.set_state_dict(state)
    return model


def _on(t, device):
    """A Tensor (or array) on `device`, as a Tensor."""
    if isinstance(t, Tensor):
        return t if t._data.device == device else Tensor._wrap(t._data.to(device))
    return Tensor._wrap(torch.as_tensor(t).to(device))


def _warn_unsupported(name: str, layer) -> None:
    warnings.warn(
        f"quantization: layer '{name}' ({type(layer).__name__}) matched the "
        "QuantConfig but only Linear is quantizable so far — it is left "
        "unquantized", stacklevel=3)


def _replace_child(model: Layer, dotted: str, new: Layer):
    parts = dotted.split(".")
    node = model
    for p in parts[:-1]:
        node = getattr(node, p) if not p.isdigit() else node[int(p)]
    last = parts[-1]
    if last.isdigit() and hasattr(node, "__setitem__"):
        node[int(last)] = new
    elif hasattr(node, "add_sublayer"):
        node.add_sublayer(last, new)
    else:
        setattr(node, last, new)
